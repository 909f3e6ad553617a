"""PatchMatch multi-view stereo as dense array programs.

Rebuilds the capability of COLMAP's CUDA ``mvs::PatchMatch`` as driven by the
reference's kernel (integration/op_cpp/patch_match.cc:74-114: per reference
image, a window of source views, random-init depth/normal, propagation,
bilateral-NCC window cost) — redesigned as whole-image array programs that
XLA compiles (SURVEY §7.4.5):

- instead of CUDA's sequential red/black sweeps with per-pixel dynamic
  view-selection state, each iteration is a JACOBI update: a static set of
  candidate (depth, normal) proposals per pixel — self, 4+4 shifted
  neighbors at two distances (checkerboard-style long-range propagation),
  a perturbation, and a fresh random sample — is scored for ALL pixels and
  ALL source views at once, and the argmin wins
- the plane-induced homography warp + bilateral-weighted NCC accumulate
  over static window offsets as fully-vectorized (S, H, W) map operations:
  everything is elementwise work + bilinear gathers, no data-dependent
  control flow
- occlusion robustness: per-pixel cost = mean of the best half of the
  source views (replaces COLMAP's probabilistic view selection)

Outputs depth, normal, and best-cost maps (the cost map feeds fusion's
confidence filter, replacing geom-consistency reruns which the reference
disables anyway — patch_match.cc:84).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp


class PatchMatchProblem(NamedTuple):
    ref_image: jax.Array   # (H, W) grayscale float
    src_images: jax.Array  # (S, H, W)
    K_ref: jax.Array       # (3, 3)
    K_src: jax.Array       # (S, 3, 3)
    R: jax.Array           # (S, 3, 3) ref-cam -> src-cam rotation
    t: jax.Array           # (S, 3)
    depth_min: jax.Array   # ()
    depth_max: jax.Array   # ()
    src_valid: jax.Array   # (S,) bool — padded source slots


def _bilinear(img: jax.Array, x: jax.Array, y: jax.Array):
    """img: (H, W); x, y: any shape. Returns samples + in-bounds mask."""
    H, W = img.shape
    inb = (x >= 0) & (x <= W - 1.001) & (y >= 0) & (y <= H - 1.001)
    xc = jnp.clip(x, 0.0, W - 1.001)
    yc = jnp.clip(y, 0.0, H - 1.001)
    x0 = jnp.floor(xc).astype(jnp.int32)
    y0 = jnp.floor(yc).astype(jnp.int32)
    fx = xc - x0
    fy = yc - y0
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    v = (1 - fy) * ((1 - fx) * v00 + fx * v01) + fy * ((1 - fx) * v10 + fx * v11)
    return v, inb


def _window_offsets(radius: int, step: int = 1):
    import numpy as np

    r = np.arange(-radius, radius + 1, step)
    du, dv = np.meshgrid(r, r)
    return du.ravel().astype(np.float32), dv.ravel().astype(np.float32)


def plane_costs(
    problem: PatchMatchProblem,
    depth: jax.Array,    # (H, W)
    normal: jax.Array,   # (H, W, 3) unit, facing camera (n_z < 0)
    window_radius: int = 3,
    window_step: int = 1,
    sigma_spatial: float = 3.0,
    sigma_color: float = 0.2,
    src_depths: jax.Array | None = None,  # (S, H, W) for geom consistency
    geom_weight: float = 0.3,
    max_geom_error: float = 3.0,
    sampling: str = "field",
):
    """Bilateral-NCC matching cost of a (depth, normal) field. Returns
    (H, W) aggregated cost in [0, 2] (lower better).

    sampling="field" (default): each source is warped ONCE through the
    candidate plane FIELD (one gather per view) and window moments come from
    cheap jnp.roll shifts of the warped image — neighbors lie on their own
    candidate planes, which for the coherent fields PatchMatch proposes is
    an equally valid sampling of the local surface. sampling="exact" warps
    every window offset through the center pixel's plane (COLMAP's slanted
    window): 49 scattered gathers per candidate instead of 1, far slower
    wherever random gathers dominate.

    With ``src_depths`` (COLMAP geom_consistency, second PatchMatch pass):
    per source view the cost gains ``geom_weight * min(err_fb,
    max_geom_error)`` where err_fb is the forward-backward reprojection
    error — ref pixel -> src at the candidate depth, back-projected through
    the source's own depth map, reprojected into ref (px)."""
    H, W = problem.ref_image.shape
    S = problem.src_images.shape[0]
    dtype = problem.ref_image.dtype
    # uniform dtype (host-supplied K/R/t may be f64; scan carries need one)
    problem = problem._replace(
        src_images=problem.src_images.astype(dtype),
        K_ref=problem.K_ref.astype(dtype), K_src=problem.K_src.astype(dtype),
        R=problem.R.astype(dtype), t=problem.t.astype(dtype))
    depth = depth.astype(dtype)
    normal = normal.astype(dtype)

    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(dtype)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(dtype)

    Kr = problem.K_ref
    fx, fy = Kr[0, 0], Kr[1, 1]
    cx, cy = Kr[0, 2], Kr[1, 2]

    # 3D point at each pixel: X = d * K^-1 [x, y, 1]
    xn = (xx - cx) / fx
    yn = (yy - cy) / fy
    X = jnp.stack([xn * depth, yn * depth, depth], axis=-1)  # (H, W, 3)
    # plane distance term: n . X
    ndotX = jnp.sum(normal * X, axis=-1)  # (H, W)
    ndotX = jnp.where(jnp.abs(ndotX) < 1e-9, 1e-9, ndotX)

    # per-source plane homography (in normalized coords):
    # x_src_cam ~ (R - t n^T / (n.X)) x_ref_cam
    # Build per-pixel per-source 3x3 implicitly: apply to window points.
    du, dv = _window_offsets(window_radius, window_step)
    nw = len(du)
    du = jnp.asarray(du, dtype)
    dv = jnp.asarray(dv, dtype)
    # bilateral weights: spatial gaussian x color similarity to center
    w_sp = jnp.exp(-(du**2 + dv**2) / (2.0 * sigma_spatial**2))  # (nw,)

    center_ref = problem.ref_image  # (H, W)
    Rm = problem.R          # (S, 3, 3)
    tm = problem.t          # (S, 3)
    Ks = problem.K_src      # (S, 3, 3)
    n_over = normal / ndotX[..., None]  # (H, W, 3)

    if sampling == "field":
        return _plane_costs_field(
            problem, xx, yy, xn, yn, depth, n_over, Rm, tm, Ks,
            fx, fy, cx, cy, window_radius, window_step,
            sigma_spatial, sigma_color, src_depths, geom_weight,
            max_geom_error)

    def window_step(acc, offs):
        """One window offset: accumulate weighted NCC moments. Runs under
        lax.scan so the compiled graph holds ONE copy of this body (the
        naive unrolled form made PatchMatch compiles minutes-long)."""
        sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs = acc
        dui, dvi, wsp_i = offs
        qx = xx + dui
        qy = yy + dvi
        ref_val, ref_inb = _bilinear(problem.ref_image, qx, qy)  # (H, W)
        w_col = jnp.exp(-((ref_val - center_ref) ** 2) / (2.0 * sigma_color**2))
        w = wsp_i * w_col * ref_inb  # (H, W)

        # normalized ref coords of the window point
        qxn = (qx - cx) / fx
        qyn = (qy - cy) / fy
        # plane-induced homography per source. For the plane through X with
        # normal n, a ref-ray point x_ref = λ q with λ = (n·X)/(n·q), so
        # x_src = R x_ref + t  ∝  R q + t (n·q)/(n·X).
        q = jnp.stack([qxn, qyn, jnp.ones_like(qxn)], axis=-1)  # (H, W, 3)
        ndq = jnp.sum(n_over * q, axis=-1)                      # (H, W)
        Rq = jnp.einsum("sij,hwj->shwi", Rm, q)
        h = Rq + tm[:, None, None, :] * ndq[None, ..., None]    # (S, H, W, 3)
        hz = jnp.where(jnp.abs(h[..., 2]) < 1e-9, 1e-9, h[..., 2])
        ux = h[..., 0] / hz
        uy = h[..., 1] / hz
        px = Ks[:, 0, 0][:, None, None] * ux + Ks[:, 0, 2][:, None, None]
        py = Ks[:, 1, 1][:, None, None] * uy + Ks[:, 1, 2][:, None, None]

        src_val, src_inb = jax.vmap(_bilinear)(problem.src_images, px, py)
        behind = hz <= 1e-9
        ws = w[None] * src_inb * (~behind)                       # (S, H, W)

        return (sum_w + ws,
                sum_r + ws * ref_val[None],
                sum_s + ws * src_val,
                sum_rr + ws * ref_val[None] ** 2,
                sum_ss + ws * src_val**2,
                sum_rs + ws * ref_val[None] * src_val), None

    zeros = jnp.zeros((S, H, W), dtype)
    (sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs), _ = jax.lax.scan(
        window_step, (zeros,) * 6, (du, dv, w_sp))

    geom_cost = None
    if src_depths is not None:
        # center-pixel forward-backward consistency per source view
        X = jnp.stack([xn * depth, yn * depth, depth], axis=-1)  # (H, W, 3)
        Xs = jnp.einsum("sij,hwj->shwi", Rm, X) + tm[:, None, None, :]
        zs_ = jnp.where(jnp.abs(Xs[..., 2]) < 1e-9, 1e-9, Xs[..., 2])
        px = Ks[:, 0, 0][:, None, None] * (Xs[..., 0] / zs_) \
            + Ks[:, 0, 2][:, None, None]
        py = Ks[:, 1, 1][:, None, None] * (Xs[..., 1] / zs_) \
            + Ks[:, 1, 2][:, None, None]
        d_src, d_inb = jax.vmap(_bilinear)(src_depths.astype(dtype), px, py)
        # back-project through the source's depth, return to ref camera
        sxn = (px - Ks[:, 0, 2][:, None, None]) / Ks[:, 0, 0][:, None, None]
        syn = (py - Ks[:, 1, 2][:, None, None]) / Ks[:, 1, 1][:, None, None]
        Xs2 = jnp.stack([sxn * d_src, syn * d_src, d_src], axis=-1)
        Xr = jnp.einsum("sji,shwj->shwi", Rm, Xs2 - tm[:, None, None, :])
        zr = jnp.where(jnp.abs(Xr[..., 2]) < 1e-9, 1e-9, Xr[..., 2])
        bx = fx * (Xr[..., 0] / zr) + cx
        by = fy * (Xr[..., 1] / zr) + cy
        err = jnp.hypot(bx - xx[None], by - yy[None])
        ok = d_inb & (d_src > 1e-6) & (zs_ > 1e-9) & (zr > 1e-9)
        geom_cost = geom_weight * jnp.where(
            ok, jnp.minimum(err, max_geom_error), max_geom_error)

    return _ncc_finish((sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs), nw,
                       geom_cost, problem.src_valid, geom_weight,
                       max_geom_error)


def _ncc_finish(sums, nw, geom_cost, src_valid, geom_weight, max_geom_error):
    """Moments -> NCC cost -> geom term -> masks -> best-half aggregation."""
    sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs = sums
    S = sum_w.shape[0]
    eps = 1e-6
    wsafe = jnp.maximum(sum_w, eps)
    mr = sum_r / wsafe
    ms = sum_s / wsafe
    var_r = sum_rr / wsafe - mr**2
    var_s = sum_ss / wsafe - ms**2
    cov = sum_rs / wsafe - mr * ms
    ncc = cov / jnp.sqrt(jnp.maximum(var_r * var_s, eps * eps))
    cost = 1.0 - jnp.clip(ncc, -1.0, 1.0)  # (S, H, W) in [0, 2]
    bad = 2.0 if geom_cost is None else 2.0 + geom_weight * max_geom_error
    if geom_cost is not None:
        cost = cost + geom_cost
    # low-support windows are unreliable
    cost = jnp.where(sum_w > 0.1 * nw, cost, bad)
    cost = jnp.where(src_valid[:, None, None], cost, bad)

    # aggregate: mean of best half of valid sources
    k = max(1, S // 2)
    best = -jax.lax.top_k(-cost.transpose(1, 2, 0), k)[0]  # (H, W, k)
    return jnp.mean(best, axis=-1)


def _plane_costs_field(problem, xx, yy, xn, yn, depth, n_over, Rm, tm, Ks,
                       fx, fy, cx, cy, window_radius, window_step,
                       sigma_spatial, sigma_color, src_depths, geom_weight,
                       max_geom_error):
    """Gradient-corrected field-warp sampling (see plane_costs).

    Exact slanted-window sampling needs a scattered gather per window
    offset (scattered gathers — their cost grows linearly with the offset
    count).
    Here each source is gathered ONCE per candidate (value + 2 gradient
    images at the center-warp coordinates); every window tap is then
    reconstructed by a first-order expansion around the ROLLED center warp:

        I(H_p(p+o)) ~ I(H_{p+o}(p+o)) + nabla I . (H_p(p+o) - H_{p+o}(p+o))

    The delta term (computable elementwise: the plane homography is LINEAR
    in the offset) restores the dependence of pixel p's window cost on p's
    OWN candidate plane — a plain warp-and-roll scheme loses it, breaking
    the per-pixel Jacobi argmin. Taps whose correction exceeds the trust
    radius are dropped from the moments."""
    import numpy as np

    H, W = problem.ref_image.shape
    S = problem.src_images.shape[0]
    dtype = problem.ref_image.dtype

    # center warp through each pixel's own candidate plane:
    # h ~ R q + t (n·q)/(n·X), q = [xn, yn, 1]
    q = jnp.stack([xn, yn, jnp.ones_like(xn)], axis=-1)      # (H, W, 3)
    ndq = jnp.sum(n_over * q, axis=-1)                        # (H, W)
    Rq = jnp.einsum("sij,hwj->shwi", Rm, q)
    h = Rq + tm[:, None, None, :] * ndq[None, ..., None]      # (S, H, W, 3)
    hz = jnp.where(jnp.abs(h[..., 2]) < 1e-9, 1e-9, h[..., 2])
    px = Ks[:, 0, 0][:, None, None] * (h[..., 0] / hz) \
        + Ks[:, 0, 2][:, None, None]
    py = Ks[:, 1, 1][:, None, None] * (h[..., 1] / hz) \
        + Ks[:, 1, 2][:, None, None]
    # ONE nearest-index gather of a packed [value, gx, gy] field per source
    # per candidate (slice_size (1,1,3): one contiguous fetch), then a
    # first-order correction to the exact continuous coordinates — replaces
    # 3 separate bilinear gathers (12 taps) with the same first-order
    # interpolation accuracy. Gather taps bound PatchMatch, so tap count
    # is wall time.
    def grad_xy(img):
        gx = 0.5 * (jnp.roll(img, -1, 1) - jnp.roll(img, 1, 1))
        gy = 0.5 * (jnp.roll(img, -1, 0) - jnp.roll(img, 1, 0))
        return gx, gy

    sgx, sgy = jax.vmap(grad_xy)(problem.src_images)
    pack = jnp.stack([problem.src_images, sgx, sgy], axis=-1)  # (S, H, W, 3)

    def sample_pack(field, x, y):
        Hs, Ws = field.shape[:2]
        xi = jnp.clip(jnp.round(x), 0, Ws - 1).astype(jnp.int32)
        yi = jnp.clip(jnp.round(y), 0, Hs - 1).astype(jnp.int32)
        inb = (x >= 0.0) & (x <= Ws - 1.0) & (y >= 0.0) & (y <= Hs - 1.0)
        smp = field[yi, xi]                                    # (H, W, 3)
        return smp, inb, xi.astype(field.dtype), yi.astype(field.dtype)

    smp, inb, xi_f, yi_f = jax.vmap(sample_pack)(pack, px, py)
    wgx = smp[..., 1]
    wgy = smp[..., 2]
    warped = smp[..., 0] + wgx * (px - xi_f) + wgy * (py - yi_f)
    src_ok = (inb & (hz > 1e-9)).astype(dtype)                # (S, H, W)

    geom_cost = None
    if src_depths is not None:
        # forward-backward consistency reusing the SAME center projection
        d_src, d_inb = jax.vmap(_bilinear)(src_depths.astype(dtype), px, py)
        sxn = (px - Ks[:, 0, 2][:, None, None]) / Ks[:, 0, 0][:, None, None]
        syn = (py - Ks[:, 1, 2][:, None, None]) / Ks[:, 1, 1][:, None, None]
        Xs2 = jnp.stack([sxn * d_src, syn * d_src, d_src], axis=-1)
        Xr = jnp.einsum("sji,shwj->shwi", Rm, Xs2 - tm[:, None, None, :])
        zr = jnp.where(jnp.abs(Xr[..., 2]) < 1e-9, 1e-9, Xr[..., 2])
        bx = fx * (Xr[..., 0] / zr) + cx
        by = fy * (Xr[..., 1] / zr) + cy
        err = jnp.hypot(bx - xx[None], by - yy[None])
        ok = d_inb & (d_src > 1e-6) & (hz > 1e-9) & (zr > 1e-9)
        geom_cost = geom_weight * jnp.where(
            ok, jnp.minimum(err, max_geom_error), max_geom_error)

    du_f, dv_f = _window_offsets(window_radius, window_step)
    nw = len(du_f)
    # jnp: sigma_spatial is traced under the patch_match jit
    w_sp = jnp.exp(-(jnp.asarray(du_f, dtype)**2 + jnp.asarray(dv_f, dtype)**2)
                   / (2.0 * sigma_spatial**2))
    du_i = jnp.asarray(du_f.astype(np.int32))
    dv_i = jnp.asarray(dv_f.astype(np.int32))
    center_ref = problem.ref_image
    # the plane homography is linear in the offset:
    # h(p+o) = h(p) + du_n R e_x + dv_n R e_y + t (n_x du_n + n_y dv_n)
    Rcol0 = Rm[:, :, 0][:, None, None, :]   # (S, 1, 1, 3)
    Rcol1 = Rm[:, :, 1][:, None, None, :]
    trust = 2.0  # px: beyond this the first-order correction extrapolates

    def win_step(acc, offs):
        sum_w, sum_r, sum_s, sum_rr, sum_ss, sum_rs = acc
        dui, dvi, wsp_i = offs
        # value at p + o == roll by -o (wraparound masked by the bounds test)
        shift2 = (-dvi, -dui)
        ref_val = jnp.roll(center_ref, shift2, axis=(0, 1))
        xb = xx + dui.astype(dtype)
        yb = yy + dvi.astype(dtype)
        inb_ref = ((xb >= 0) & (xb <= W - 1) & (yb >= 0)
                   & (yb <= H - 1)).astype(dtype)
        w_col = jnp.exp(-((ref_val - center_ref) ** 2)
                        / (2.0 * sigma_color**2))
        w = wsp_i * w_col * inb_ref                        # (H, W)

        # target coordinates of p+o under p's OWN plane (elementwise)
        du_n = dui.astype(dtype) / fx
        dv_n = dvi.astype(dtype) / fy
        h_o = (h + du_n * Rcol0 + dv_n * Rcol1
               + tm[:, None, None, :]
               * (n_over[..., 0] * du_n + n_over[..., 1] * dv_n)[None, ..., None])
        hz_o = jnp.where(jnp.abs(h_o[..., 2]) < 1e-9, 1e-9, h_o[..., 2])
        px_o = Ks[:, 0, 0][:, None, None] * (h_o[..., 0] / hz_o) \
            + Ks[:, 0, 2][:, None, None]
        py_o = Ks[:, 1, 1][:, None, None] * (h_o[..., 1] / hz_o) \
            + Ks[:, 1, 2][:, None, None]
        dx = px_o - jnp.roll(px, shift2, axis=(1, 2))
        dy = py_o - jnp.roll(py, shift2, axis=(1, 2))
        s_val = (jnp.roll(warped, shift2, axis=(1, 2))
                 + jnp.roll(wgx, shift2, axis=(1, 2)) * dx
                 + jnp.roll(wgy, shift2, axis=(1, 2)) * dy)
        s_ok = (jnp.roll(src_ok, shift2, axis=(1, 2))
                * (jnp.abs(dx) < trust) * (jnp.abs(dy) < trust)
                * (hz_o > 1e-9))
        ws = w[None] * s_ok                                # (S, H, W)
        return (sum_w + ws,
                sum_r + ws * ref_val[None],
                sum_s + ws * s_val,
                sum_rr + ws * ref_val[None] ** 2,
                sum_ss + ws * s_val**2,
                sum_rs + ws * ref_val[None] * s_val), None

    zeros = jnp.zeros((S, H, W), dtype)
    sums, _ = jax.lax.scan(win_step, (zeros,) * 6, (du_i, dv_i, w_sp))
    return _ncc_finish(sums, nw, geom_cost, problem.src_valid,
                       geom_weight, max_geom_error)


def _random_normals(key, shape, dtype):
    """Random unit normals with n_z < 0 (facing the camera)."""
    v = jax.random.normal(key, shape + (3,), dtype)
    v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-9)
    nz = -jnp.abs(v[..., 2])
    return jnp.concatenate([v[..., :2], nz[..., None]], axis=-1)


@functools.partial(jax.jit, static_argnames=(
    "num_iterations", "window_radius", "window_step", "sampling"))
def patch_match(
    key,
    problem: PatchMatchProblem,
    num_iterations: int = 5,
    window_radius: int = 3,
    window_step: int = 1,
    sigma_spatial: float = 3.0,
    sigma_color: float = 0.2,
    src_depths: jax.Array | None = None,   # (S, H, W): geom-consistency pass
    geom_weight: float = 0.3,
    max_geom_error: float = 3.0,
    init_depth: jax.Array | None = None,   # (H, W) warm start (pass 1 result)
    init_normal: jax.Array | None = None,  # (H, W, 3)
    sampling: str = "field",
) -> tuple:
    """Estimate (depth (H,W), normal (H,W,3), cost (H,W)) for the ref view.

    Precision: XLA's default for f32 products (the pose transforms are
    3x3 einsums; TF32 may be used on tensor-core GPUs)."""
    H, W = problem.ref_image.shape
    dtype = problem.ref_image.dtype
    dmin, dmax = problem.depth_min, problem.depth_max

    k0, k1, key = jax.random.split(key, 3)
    depth = (init_depth.astype(dtype) if init_depth is not None
             else jax.random.uniform(k0, (H, W), dtype, dmin, dmax))
    normal = (init_normal.astype(dtype) if init_normal is not None
              else _random_normals(k1, (H, W), dtype))

    def cost_of(d, n):
        return plane_costs(problem, d, n, window_radius, window_step,
                           sigma_spatial, sigma_color,
                           src_depths=src_depths, geom_weight=geom_weight,
                           max_geom_error=max_geom_error, sampling=sampling)

    cost = cost_of(depth, normal)

    def shift2(a, dy, dx):
        return jnp.roll(a, (dy, dx), axis=(0, 1))

    def body(it, carry):
        depth, normal, cost, key = carry
        keys = jax.random.split(key, 5)

        # candidate proposals (Jacobi propagation at two distances)
        shifts = [(0, 1), (0, -1), (1, 0), (-1, 0),
                  (0, 3), (0, -3), (3, 0), (-3, 0)]
        cands = []
        for dy, dx in shifts:
            cands.append((shift2(depth, dy, dx), shift2(normal, dy, dx)))
        # perturbation around current (shrinking with iteration)
        scale = 0.5 ** (it.astype(dtype) + 1.0)
        pd = depth * (1.0 + scale * jax.random.uniform(keys[0], (H, W), dtype, -0.5, 0.5))
        pd = jnp.clip(pd, dmin, dmax)
        pn = normal + scale * jax.random.normal(keys[1], (H, W, 3), dtype)
        pn = pn / jnp.maximum(jnp.linalg.norm(pn, axis=-1, keepdims=True), 1e-9)
        pn = jnp.concatenate([pn[..., :2], -jnp.abs(pn[..., 2:])], axis=-1)
        cands.append((pd, pn))
        # fresh random sample
        rd = jax.random.uniform(keys[2], (H, W), dtype, dmin, dmax)
        rn = _random_normals(keys[3], (H, W), dtype)
        cands.append((rd, rn))

        # evaluate candidates under lax.scan: one compiled copy of the
        # cost evaluation serves all 10 proposals
        cand_d = jnp.stack([c[0] for c in cands])       # (C, H, W)
        cand_n = jnp.stack([c[1] for c in cands])       # (C, H, W, 3)

        def eval_cand(state, cand):
            depth, normal, cost = state
            cd, cn = cand
            c = cost_of(cd, cn)
            better = c < cost
            return (jnp.where(better, cd, depth),
                    jnp.where(better[..., None], cn, normal),
                    jnp.where(better, c, cost)), None

        (depth, normal, cost), _ = jax.lax.scan(
            eval_cand, (depth, normal, cost), (cand_d, cand_n))
        return depth, normal, cost, keys[4]

    depth, normal, cost, _ = jax.lax.fori_loop(
        0, num_iterations, body, (depth, normal, cost, key))
    return depth, normal, cost


def patch_match_tiled(
    key,
    problem: PatchMatchProblem,
    tile_rows: int,
    halo_rows: int = 48,
    src_depths: jax.Array | None = None,
    init_depth: jax.Array | None = None,
    init_normal: jax.Array | None = None,
    **kwargs,
) -> tuple:
    """`patch_match` over horizontal REF-image bands with an overlap halo —
    the memory-bounding plan for reference-resolution dense work
    (VERDICT r3 #6; the reference ships full-resolution bitmaps into its
    CUDA stage, prepare_patch_match.cc:63-69).

    The per-pixel working set (candidate stacks, NCC accumulators — all
    (S, H, W) over REF pixels) scales with the band, while SOURCE images
    (and source depth banks for the geometric-consistency term) stay whole,
    so warps near band edges sample exactly what the untiled solve would.
    Each band solves rows [y0 - halo, y0 + tile + halo) of the ref view and
    contributes its center rows; the halo covers the Jacobi propagation
    reach (3 px/sweep x num_iterations, default budgets ~21-32 rows).
    Cropping the ref view is exact: the band's K_ref shifts cy by the crop
    offset. Bands use fold_in(key, band) so results are deterministic for
    a given tiling (they differ bitwise from the untiled solve — the
    random init is drawn per band shape).
    """
    H, W = problem.ref_image.shape
    if tile_rows <= 0 or H <= tile_rows + 2 * halo_rows:
        return patch_match(key, problem, src_depths=src_depths,
                           init_depth=init_depth, init_normal=init_normal,
                           **kwargs)
    n_bands = -(-H // tile_rows)
    outs_d, outs_n, outs_c = [], [], []
    for b in range(n_bands):
        y0 = b * tile_rows
        y1 = min(y0 + tile_rows, H)
        ya = max(0, y0 - halo_rows)
        # uniform compute-band height (tile + 2*halo) so every band hits
        # ONE compiled shape; edge bands shift their window inward
        hb = min(tile_rows + 2 * halo_rows, H)
        ya = min(ya, H - hb)
        yb = ya + hb
        K_band = problem.K_ref.at[1, 2].add(-ya)
        prob_b = problem._replace(ref_image=problem.ref_image[ya:yb],
                                  K_ref=K_band)
        kw = dict(kwargs)
        if src_depths is not None:
            kw["src_depths"] = src_depths      # source-indexed: stays whole
        if init_depth is not None:
            kw["init_depth"] = init_depth[ya:yb]
        if init_normal is not None:
            kw["init_normal"] = init_normal[ya:yb]
        d, n, c = patch_match(jax.random.fold_in(key, b), prob_b, **kw)
        outs_d.append(d[y0 - ya: y1 - ya])
        outs_n.append(n[y0 - ya: y1 - ya])
        outs_c.append(c[y0 - ya: y1 - ya])
    return (jnp.concatenate(outs_d, axis=0),
            jnp.concatenate(outs_n, axis=0),
            jnp.concatenate(outs_c, axis=0))
