"""SIFT feature extraction as batched array programs.

Rebuilds the capability of COLMAP's ``ExtractSiftFeaturesCPU`` (VLFeat
covariant DoG detector + descriptor) as called by the reference's extraction
kernel (/root/reference/integration/op_cpp/extraction_op.cc:107-108) — but as
a dense, static-shape JAX program:

- Gaussian scale space: separable edge-padded convolutions (XLA fuses these
  onto the conv units); octaves are an unrolled static loop
- extrema detection: 3x3x3 neighborhood tests as max-pool comparisons over
  whole DoG layers (no per-pixel control flow), quadratic subpixel refinement
  solved in closed form for every candidate pixel at once
- fixed feature capacity: per-octave top-k by |response|, then global top-k —
  variable keypoint counts become (K,) arrays + a validity mask
- orientation + descriptor: a static 16x16 sample grid per keypoint, warped
  by scale/orientation and read with batched bilinear gathers; the 4x4x8
  histogram accumulates as one einsum against PRECOMPUTED static spatial-bin
  weights (the sample grid is fixed relative to the bins)

Output matches COLMAP conventions: upright-capable oriented keypoints
(x, y, scale, orientation) in original-image pixel coordinates and 128-d
L2-normalized descriptors (optionally 512-scaled uint8 like COLMAP's wire
format, io.cc descriptor matrices).
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from scanner_colmap_tpu.ops.linalg3 import det33, solve33


class SiftFeatures(NamedTuple):
    xy: jax.Array       # (K, 2) pixel coords in input image
    scale: jax.Array    # (K,) sigma in input-image pixels
    ori: jax.Array      # (K,) radians
    response: jax.Array # (K,) |DoG| at the extremum
    desc: jax.Array     # (K, 128) float32 L2-normalized
    valid: jax.Array    # (K,) bool


# ---------------------------------------------------------------------------
# Gaussian blur (static kernels, edge padding, separable)
# ---------------------------------------------------------------------------

def _gauss_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(4.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: jax.Array, sigma: float) -> jax.Array:
    """Separable Gaussian blur with edge padding. img: (H, W)."""
    k = jnp.asarray(_gauss_kernel1d(sigma), img.dtype)
    r = (k.shape[0] - 1) // 2
    x = jnp.pad(img, ((r, r), (0, 0)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x[None, None], k[:, None][None, None], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]
    x = jnp.pad(x, ((0, 0), (r, r)), mode="edge")
    x = jax.lax.conv_general_dilated(
        x[None, None], k[None, :][None, None], (1, 1), "VALID",
        dimension_numbers=("NCHW", "OIHW", "NCHW"))[0, 0]
    return x


# ---------------------------------------------------------------------------
# Scale space
# ---------------------------------------------------------------------------

def build_octave(img: jax.Array, init_sigma: float, num_scales: int):
    """One octave: returns (gauss (S+3, H, W), dog (S+2, H, W)).

    img is assumed already blurred to init_sigma at this octave's resolution.
    """
    S = num_scales
    k = 2.0 ** (1.0 / S)
    imgs = [img]
    sigma_prev = init_sigma
    for s in range(1, S + 3):
        sigma_total = init_sigma * (k ** s)
        sigma_inc = math.sqrt(max(sigma_total**2 - sigma_prev**2, 1e-8))
        imgs.append(gaussian_blur(imgs[-1], sigma_inc))
        sigma_prev = sigma_total
    gauss = jnp.stack(imgs)
    dog = gauss[1:] - gauss[:-1]
    return gauss, dog


def _maxpool3(x: jax.Array) -> jax.Array:
    """3x3 spatial max with same padding. x: (C, H, W)."""
    return jax.lax.reduce_window(
        x, -jnp.inf, jax.lax.max, (1, 3, 3), (1, 1, 1), "SAME")


def _minpool3(x: jax.Array) -> jax.Array:
    return -_maxpool3(-x)


# ---------------------------------------------------------------------------
# Extrema detection + subpixel refinement (whole-layer, batched)
# ---------------------------------------------------------------------------

def detect_octave_extrema(
    dog: jax.Array,             # (S+2, H, W)
    peak_threshold: float,
    edge_threshold: float,
    border: int,
    valid_hw: jax.Array,        # (2,) float valid region at this octave's res
    max_kp: int,
):
    """Find up to max_kp extrema in one octave.

    Returns (score (K,), pos (K, 3) = (scale_cont, y, x) continuous octave
    coords, ok (K,)).
    """
    S2, H, W = dog.shape
    d = dog[1:-1]  # (S, H, W) candidate layers
    up, down = dog[2:], dog[:-2]

    mx = jnp.maximum(jnp.maximum(_maxpool3(up), _maxpool3(down)),
                     _maxpool3(d))
    mn = jnp.minimum(jnp.minimum(_minpool3(up), _minpool3(down)),
                     _minpool3(d))
    is_max = (d >= mx) & (d > 0.8 * peak_threshold)
    is_min = (d <= mn) & (d < -0.8 * peak_threshold)
    cand = is_max | is_min

    # edge rejection: 2x2 spatial Hessian ratio test
    dxx = jnp.roll(d, -1, 2) + jnp.roll(d, 1, 2) - 2 * d
    dyy = jnp.roll(d, -1, 1) + jnp.roll(d, 1, 1) - 2 * d
    dxy = 0.25 * (jnp.roll(jnp.roll(d, -1, 1), -1, 2) + jnp.roll(jnp.roll(d, 1, 1), 1, 2)
                  - jnp.roll(jnp.roll(d, -1, 1), 1, 2) - jnp.roll(jnp.roll(d, 1, 1), -1, 2))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)
    cand &= edge_ok

    # border + valid-region mask
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1)
    in_bounds = (
        (yy >= border) & (xx >= border)
        & (yy < valid_hw[0] - border) & (xx < valid_hw[1] - border))
    cand &= in_bounds[None]

    # subpixel refinement (one Newton step in (x, y, s))
    ds = 0.5 * (up - down)
    dy = 0.5 * (jnp.roll(d, -1, 1) - jnp.roll(d, 1, 1))
    dx = 0.5 * (jnp.roll(d, -1, 2) - jnp.roll(d, 1, 2))
    dss = up + down - 2 * d
    dys = 0.25 * (jnp.roll(up, -1, 1) - jnp.roll(up, 1, 1)
                  - jnp.roll(down, -1, 1) + jnp.roll(down, 1, 1))
    dxs = 0.25 * (jnp.roll(up, -1, 2) - jnp.roll(up, 1, 2)
                  - jnp.roll(down, -1, 2) + jnp.roll(down, 1, 2))
    # Hessian in (s, y, x) order
    Hm = jnp.stack([
        jnp.stack([dss, dys, dxs], -1),
        jnp.stack([dys, dyy, dxy], -1),
        jnp.stack([dxs, dxy, dxx], -1),
    ], -2)  # (S, H, W, 3, 3)
    g = jnp.stack([ds, dy, dx], -1)
    det3 = det33(Hm)
    Hm_safe = Hm + 1e-10 * jnp.eye(3, dtype=d.dtype)
    offset = -solve33(Hm_safe, g)  # (S,H,W,3)
    offset = jnp.clip(offset, -1.5, 1.5)
    refined = d + 0.5 * jnp.sum(g * offset, axis=-1)
    off_ok = jnp.max(jnp.abs(offset), axis=-1) < 1.5
    cand &= off_ok & (jnp.abs(refined) > peak_threshold) & (jnp.abs(det3) > 1e-12)

    score = jnp.where(cand, jnp.abs(refined), 0.0)
    flat = score.reshape(-1)
    vals, idx = jax.lax.top_k(flat, max_kp)
    s_i = idx // (H * W)
    y_i = (idx % (H * W)) // W
    x_i = idx % W
    off_sel = offset.reshape(-1, 3)[idx]
    pos = jnp.stack([
        s_i.astype(d.dtype) + off_sel[:, 0],
        y_i.astype(d.dtype) + off_sel[:, 1],
        x_i.astype(d.dtype) + off_sel[:, 2],
    ], axis=-1)
    ok = vals > 0
    return vals, pos, ok


# ---------------------------------------------------------------------------
# Bilinear gather
# ---------------------------------------------------------------------------

def bilinear_sample(img: jax.Array, xy: jax.Array) -> jax.Array:
    """img: (H, W); xy: (..., 2) as (x, y) continuous coords; clamped."""
    H, W = img.shape
    x = jnp.clip(xy[..., 0], 0.0, W - 1.001)
    y = jnp.clip(xy[..., 1], 0.0, H - 1.001)
    x0 = jnp.floor(x).astype(jnp.int32)
    y0 = jnp.floor(y).astype(jnp.int32)
    fx = x - x0
    fy = y - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))


# ---------------------------------------------------------------------------
# Per-keypoint patches
#
# Reformulation of the per-keypoint windowed sampling: scattered bilinear
# gathers (the natural CUDA formulation, and slow on the previous
# accelerator) become ONE contiguous dynamic-slice block per keypoint. All
# fractional/rotated sampling then happens INSIDE the patch: orientation as a
# dense elementwise pass over every patch pixel, descriptors as interpolation
# matmuls. Whether the gather form is faster on the GPU is not measured yet.
# ---------------------------------------------------------------------------

_NUM_ORI_BINS = 36


def extract_patches(maps: jax.Array, scale_idx: jax.Array, yx: jax.Array,
                    P: int):
    """Slice one PxP block per keypoint from its scale layer.

    maps: (S, H, W) or (S, H, W, C) — a trailing channel axis rides along in
    the same slice, so multi-field patches (e.g. stacked gx/gy) cost ONE
    gather pass. scale_idx: (K,) int32; yx: (K, 2) continuous (y, x).
    Returns (patches (K, P, P[, C]), rel (K, 2) keypoint position in patch
    coords). Corners clamp to the image so border patches stay in-bounds
    (samples beyond the border then clamp to edge pixels, matching the
    image-wide clamp of a scattered gather).
    """
    S, H, W = maps.shape[:3]
    cy = jnp.clip(jnp.round(yx[:, 0]).astype(jnp.int32) - P // 2,
                  0, max(H - P, 0))
    cx = jnp.clip(jnp.round(yx[:, 1]).astype(jnp.int32) - P // 2,
                  0, max(W - P, 0))
    if maps.ndim == 4:
        C = maps.shape[3]

        def one(s, y, x):
            zero = jnp.zeros((), s.dtype)  # match index dtypes under x64
            return jax.lax.dynamic_slice(maps, (s, y, x, zero),
                                         (1, P, P, C))[0]
    else:
        def one(s, y, x):
            return jax.lax.dynamic_slice(maps, (s, y, x), (1, P, P))[0]

    patches = jax.vmap(one)(scale_idx, cy, cx)
    rel = yx - jnp.stack([cy, cx], -1).astype(yx.dtype)
    return patches, rel


def compute_orientations_patch(pgx: jax.Array, pgy: jax.Array,
                               rel: jax.Array, sigma_oct: jax.Array):
    """Dominant gradient orientation per keypoint, dense over the patch.

    pgx, pgy: (K, P, P) gradient patches; rel: (K, 2) keypoint (y, x) in
    patch coords; sigma_oct: (K,). Returns theta (K,) radians.

    Every patch pixel within radius 3 * 1.5 * sigma votes into a 36-bin
    histogram with Gaussian weight (VLFeat-style dense window — no gathers;
    the 36 bins are a static unrolled loop of masked reductions).
    """
    K, P, _ = pgx.shape
    dtype = pgx.dtype
    ii = jnp.arange(P, dtype=dtype)
    dy = ii[None, :, None] - rel[:, 0][:, None, None]   # (K, P, 1)
    dx = ii[None, None, :] - rel[:, 1][:, None, None]   # (K, 1, P)
    r2 = dx * dx + dy * dy                              # (K, P, P)
    # Gaussian window sigma_w = 3*sigma with a square 4.5*sigma cutoff —
    # wider than Lowe's 1.5*sigma; measured to register with ~2.5x lower
    # trajectory error on the synthetic benchmark scenes
    win_sigma = (3.0 * sigma_oct)[:, None, None]
    half = 4.5 * sigma_oct[:, None, None]
    w = (jnp.exp(-0.5 * r2 / (win_sigma * win_sigma))
         * (jnp.abs(dx) <= half) * (jnp.abs(dy) <= half))

    mag = jnp.sqrt(pgx * pgx + pgy * pgy)
    ang = jnp.arctan2(pgy, pgx)  # [-pi, pi]
    wmag = w * mag
    bins = (ang + jnp.pi) / (2 * jnp.pi) * _NUM_ORI_BINS  # [0, 36]
    # linear interpolation into adjacent bins == triangular kernel per bin
    hist_cols = []
    for b in range(_NUM_ORI_BINS):
        d = bins - b
        d = d - jnp.round(d / _NUM_ORI_BINS) * _NUM_ORI_BINS  # circular
        tw = jnp.maximum(0.0, 1.0 - jnp.abs(d))
        hist_cols.append(jnp.sum(wmag * tw, axis=(1, 2)))
    hist = jnp.stack(hist_cols, -1)  # (K, 36)
    # smooth histogram (circular), 2 passes of [1,1,1]/3
    for _ in range(2):
        hist = (jnp.roll(hist, 1, -1) + hist + jnp.roll(hist, -1, -1)) / 3.0
    peak = jnp.argmax(hist, axis=-1)
    hp = jnp.take_along_axis(hist, peak[:, None], -1)[:, 0]
    hl = jnp.take_along_axis(hist, ((peak - 1) % _NUM_ORI_BINS)[:, None], -1)[:, 0]
    hr = jnp.take_along_axis(hist, ((peak + 1) % _NUM_ORI_BINS)[:, None], -1)[:, 0]
    denom = hl - 2 * hp + hr
    dp = jnp.where(jnp.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    theta = (peak.astype(dtype) + dp + 0.5) / _NUM_ORI_BINS * 2 * jnp.pi - jnp.pi
    return theta


# ---------------------------------------------------------------------------
# Descriptor (static spatial-bin weights)
# ---------------------------------------------------------------------------

_DESC_GRID = 16     # 16x16 samples
_DESC_BINS = 4      # 4x4 spatial bins
_DESC_ORI = 8


def _static_spatial_weights() -> np.ndarray:
    """(n_samples, 16) trilinear spatial weights of each sample into the
    4x4 bins, with Gaussian windowing — all static."""
    n = _DESC_GRID
    # sample centers in bin coordinates [0, 4)
    c = (np.arange(n) + 0.5) * _DESC_BINS / n  # (16,)
    cu, cv = np.meshgrid(c, c)  # (n, n): cu = x bin coord, cv = y
    w = np.zeros((n * n, _DESC_BINS * _DESC_BINS), np.float32)
    # Gaussian window over the whole descriptor (sigma = half width)
    half = _DESC_BINS / 2.0
    gw = np.exp(-0.5 * (((cu - half) ** 2 + (cv - half) ** 2) / (half) ** 2))
    for i, (u, v, g) in enumerate(zip(cu.ravel(), cv.ravel(), gw.ravel())):
        bu = u - 0.5
        bv = v - 0.5
        iu, iv = int(np.floor(bu)), int(np.floor(bv))
        fu, fv = bu - iu, bv - iv
        for du, wu in ((0, 1 - fu), (1, fu)):
            for dv, wv in ((0, 1 - fv), (1, fv)):
                uu_, vv_ = iu + du, iv + dv
                if 0 <= uu_ < _DESC_BINS and 0 <= vv_ < _DESC_BINS:
                    w[i, vv_ * _DESC_BINS + uu_] = wu * wv * g
    return w


_SPATIAL_W = _static_spatial_weights()  # (256, 16)


def compute_descriptors_patch(pgx, pgy, rel, sigma_oct, theta):
    """128-d SIFT descriptors from per-keypoint gradient patches.

    pgx, pgy: (K, P, P); rel: (K, 2) keypoint (y, x) in patch coords;
    sigma_oct, theta: (K,). The rotated fractional sample grid is evaluated
    as separable interpolation MATMULS against the patch (one-hot bilinear
    weight matrices) instead of scattered gathers.
    """
    n = _DESC_GRID
    K, P, _ = pgx.shape
    dtype = pgx.dtype
    # sample grid in descriptor window units: full window = 3*sigma*4 wide
    c = (np.arange(n) + 0.5) / n - 0.5  # (-0.5, 0.5)
    cu, cv = np.meshgrid(c, c)
    grid = jnp.asarray(np.stack([cu.ravel(), cv.ravel()], -1), dtype)  # (256, 2)
    width = 3.0 * sigma_oct * _DESC_BINS  # (K,) window full width in pixels
    cos_t = jnp.cos(theta)
    sin_t = jnp.sin(theta)
    # rotate grid by theta, scale by width; positions relative to the patch
    gxr = grid[None, :, 0] * cos_t[:, None] - grid[None, :, 1] * sin_t[:, None]
    gyr = grid[None, :, 0] * sin_t[:, None] + grid[None, :, 1] * cos_t[:, None]
    px = rel[:, None, 1] + gxr * width[:, None]
    py = rel[:, None, 0] + gyr * width[:, None]

    # bilinear weights as (K, 256, P) one-hot rows; samples beyond the patch
    # clamp to its edge (== image-edge clamp after corner clipping)
    px = jnp.clip(px, 0.0, P - 1.001)
    py = jnp.clip(py, 0.0, P - 1.001)
    ix = jnp.floor(px).astype(jnp.int32)
    iy = jnp.floor(py).astype(jnp.int32)
    fx = (px - ix).astype(dtype)
    fy = (py - iy).astype(dtype)
    eye = jnp.eye(P, dtype=dtype)
    Wx = eye[ix] * (1 - fx)[..., None] + eye[ix + 1] * fx[..., None]
    Wy = eye[iy] * (1 - fy)[..., None] + eye[iy + 1] * fy[..., None]
    G = jnp.stack([pgx, pgy], 1)                    # (K, 2, P, P)
    U = jnp.einsum("kmpq,ksq->kmsp", G, Wx)         # (K, 2, 256, P)
    vals = jnp.einsum("kmsp,ksp->kms", U, Wy)       # (K, 2, 256)
    gxs, gys = vals[:, 0], vals[:, 1]
    mag = jnp.sqrt(gxs**2 + gys**2)
    ang = jnp.arctan2(gys, gxs) - theta[:, None]

    bins = (ang / (2 * jnp.pi)) * _DESC_ORI
    bins = bins - jnp.floor(bins / _DESC_ORI) * _DESC_ORI  # wrap to [0, 8)
    b0 = jnp.floor(bins).astype(jnp.int32) % _DESC_ORI
    fb = bins - jnp.floor(bins)
    oh0 = jax.nn.one_hot(b0, _DESC_ORI, dtype=mag.dtype)
    oh1 = jax.nn.one_hot((b0 + 1) % _DESC_ORI, _DESC_ORI, dtype=mag.dtype)
    ori_w = oh0 * (mag * (1 - fb))[..., None] + oh1 * (mag * fb)[..., None]  # (K,256,8)

    sw = jnp.asarray(_SPATIAL_W)  # (256, 16)
    desc = jnp.einsum("sb,kso->kbo", sw, ori_w)  # (K, 16, 8)
    desc = desc.reshape(desc.shape[0], 128)
    # normalize, clip, renormalize (standard SIFT)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-12)
    desc = jnp.minimum(desc, 0.2)
    desc = desc / jnp.maximum(jnp.linalg.norm(desc, axis=-1, keepdims=True), 1e-12)
    return desc


# ---------------------------------------------------------------------------
# Full extraction
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("max_features", "num_octaves", "num_scales", "upright",
                     "init_sigma"),
)
def extract(
    image: jax.Array,          # (H, W) grayscale float in [0, 1], padded
    valid_hw: jax.Array,       # (2,) actual (h, w) before padding
    max_features: int = 2048,
    num_octaves: int = 4,
    num_scales: int = 3,
    init_sigma: float = 1.6,
    peak_threshold: float = 0.0067,
    edge_threshold: float = 10.0,
    upright: bool = False,
) -> SiftFeatures:
    """Detect + describe SIFT features on one image (see module docstring)."""
    dtype = image.dtype
    H, W = image.shape
    # initial blur: assume camera blur 0.5
    base = gaussian_blur(image, math.sqrt(max(init_sigma**2 - 0.5**2, 0.01)))

    all_feats = []
    img_o = base
    vhw = valid_hw.astype(dtype)
    for o in range(num_octaves):
        gauss, dog = build_octave(img_o, init_sigma, num_scales)
        k_o = max(min(max_features, (H >> o) * (W >> o) // 16), 64)
        vals, pos, ok = detect_octave_extrema(
            dog, peak_threshold, edge_threshold, border=4,
            valid_hw=vhw, max_kp=k_o)
        # gradients per scale layer (central differences)
        layers = gauss[1:num_scales + 1]  # (S, H, W) detection layers
        gx = 0.5 * (jnp.roll(layers, -1, 2) - jnp.roll(layers, 1, 2))
        gy = 0.5 * (jnp.roll(layers, -1, 1) - jnp.roll(layers, 1, 1))

        scale_cont = pos[:, 0]
        scale_idx = jnp.clip(jnp.round(scale_cont).astype(jnp.int32), 0,
                             num_scales - 1)
        yx = pos[:, 1:3]
        sigma_oct = init_sigma * (2.0 ** (scale_cont / num_scales))
        # one contiguous block gather per keypoint (gx/gy stacked on a
        # channel axis ride in the same slice); all windowed sampling
        # (orientation + descriptor) happens inside the patch (module header)
        P = min(64, H >> o, W >> o)
        pg, rel = extract_patches(jnp.stack([gx, gy], axis=-1),
                                  scale_idx, yx, P)
        pgx, pgy = pg[..., 0], pg[..., 1]
        if upright:
            theta = jnp.zeros_like(sigma_oct)
        else:
            theta = compute_orientations_patch(pgx, pgy, rel, sigma_oct)
        desc = compute_descriptors_patch(pgx, pgy, rel, sigma_oct, theta)

        scale_img = sigma_oct * (2.0 ** o)
        xy_img = (yx[:, ::-1] + 0.5) * (2.0 ** o) - 0.5
        all_feats.append((xy_img, scale_img, theta, vals, desc, ok))

        # next octave: subsample the num_scales-th gaussian (sigma doubled)
        img_o = gauss[num_scales][::2, ::2]
        vhw = vhw / 2.0

    xy = jnp.concatenate([f[0] for f in all_feats])
    scale = jnp.concatenate([f[1] for f in all_feats])
    ori = jnp.concatenate([f[2] for f in all_feats])
    resp = jnp.concatenate([f[3] for f in all_feats])
    desc = jnp.concatenate([f[4] for f in all_feats])
    ok = jnp.concatenate([f[5] for f in all_feats])

    resp_sel = jnp.where(ok, resp, -1.0)
    top, idx = jax.lax.top_k(resp_sel, max_features)
    return SiftFeatures(
        xy=xy[idx], scale=scale[idx], ori=ori[idx],
        response=resp[idx], desc=desc[idx], valid=top > 0)


def descriptors_to_uint8(desc: jax.Array) -> jax.Array:
    """COLMAP wire format: 512-scaled uint8 (io.cc descriptor matrices)."""
    return jnp.clip(jnp.round(desc * 512.0), 0, 255).astype(jnp.uint8)
