"""Stereo fusion: multi-view consistent depth-map fusion -> colored points.

The reference's fusion stage exists only as a non-compiling WIP port of
COLMAP's StereoFusion (/root/reference/integration/op_cpp/stereo_fusion.cc —
SURVEY §8.2); its intended semantics (per-pixel region growing with
depth-error / reprojection-error / normal-angle consistency gates,
stereo_fusion.cc:141-173) come from COLMAP's ``mvs::StereoFusion``.

Data-parallel reformulation (SURVEY §2.2): the serial pixel-BFS traversal
becomes BATCHED CONSISTENCY VOTING — every pixel of every depth map is
back-projected and checked against every other view's depth map in one
vectorized pass; a pixel emits a fused point iff it has enough consistent
supporters AND it is the LEADER (lowest image index) of its support set,
which replaces the BFS visited-marking dedup with a parallel ownership rule.
Fused position/normal/color average over the supporting views' estimates,
like COLMAP's accumulation over the traversal.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from scanner_colmap_tpu.models import geometry as geom


class FusionInput(NamedTuple):
    depths: jax.Array    # (N, H, W)
    normals: jax.Array   # (N, H, W, 3) in CAMERA frame of each view
    colors: jax.Array    # (N, H, W, 3) float [0,1] or uint8
    qvecs: jax.Array     # (N, 4) world->cam
    tvecs: jax.Array     # (N, 3)
    Ks: jax.Array        # (N, 3, 3)
    valid: jax.Array     # (N, H, W) bool (e.g. cost-filtered)


def _backproject(depth, K, qvec, tvec):
    """Per-pixel world points for one view. depth: (H, W)."""
    H, W = depth.shape
    dtype = depth.dtype
    yy = jax.lax.broadcasted_iota(jnp.int32, (H, W), 0).astype(dtype)
    xx = jax.lax.broadcasted_iota(jnp.int32, (H, W), 1).astype(dtype)
    xn = (xx - K[0, 2]) / K[0, 0]
    yn = (yy - K[1, 2]) / K[1, 1]
    x_cam = jnp.stack([xn * depth, yn * depth, depth], axis=-1)
    qi, ti = geom.pose_inverse(qvec, tvec)
    return geom.quat_rotate(qi[None, None], x_cam) + ti


def _sample_nearest(img, x, y):
    """Nearest-neighbor sample with in-bounds mask. img: (H, W) or (H, W, C)."""
    H, W = img.shape[:2]
    xi = jnp.round(x).astype(jnp.int32)
    yi = jnp.round(y).astype(jnp.int32)
    inb = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
    xi = jnp.clip(xi, 0, W - 1)
    yi = jnp.clip(yi, 0, H - 1)
    return img[yi, xi], inb


@functools.partial(jax.jit, static_argnames=("window",))
def fuse_depth_maps(
    inp: FusionInput,
    max_depth_error: float = 0.01,
    max_normal_error_rad: float = 0.1745,
    min_num_consistent: int = 2,
    window: int | None = None,
):
    """Consistency-voted fusion over a WINDOW of views along the ordered axis.

    ``window`` bounds voting to views [i-window, i+window] — the stencil
    analog of COLMAP's fusion traversal caps (the reference's WIP port
    carries the same bound, stereo_fusion.cc:210-240 max_traversal_depth):
    memory is O(N*H*W*window), not O(N*H*W*N). window=None (or >= N-1)
    votes all-pairs — identical outputs to the unwindowed form.

    Returns per-pixel (N, H, W) fields:
      fused_xyz (N, H, W, 3), fused_rgb, fused_normal (world frame),
      num_consistent (N, H, W) int32, emit (N, H, W) bool (leader + enough
      support), visibility (N, H, W, 2*window+1) bool — slot s of row i is
      view i-window+s (self at slot `window`); "window" (static int).
    Host code compacts emit=True pixels into the point list.
    """
    N, H, W = inp.depths.shape
    if window is not None and window < 1:
        # the FusionConfig sentinels (0 = auto, -1 = all-pairs) are
        # translated by run_fusion; silently clamping them here to a
        # 1-view window collapsed num_consistent for direct callers
        raise ValueError(
            f"window must be >= 1 or None (all-pairs); got {window}. "
            "FusionConfig sentinel values are resolved in stages.run_fusion.")
    Wd = N - 1 if window is None else max(min(window, N - 1), 1)
    dtype = inp.depths.dtype
    # uniform dtype: pose/K inputs may arrive f64 from the host model while
    # depth maps are f32 — mixed precision would break the fori_loop carry
    inp = inp._replace(
        normals=inp.normals.astype(dtype), colors=inp.colors.astype(dtype),
        qvecs=inp.qvecs.astype(dtype), tvecs=inp.tvecs.astype(dtype),
        Ks=inp.Ks.astype(dtype))

    # world points + world normals per view
    X = jax.vmap(_backproject)(inp.depths, inp.Ks, inp.qvecs, inp.tvecs)
    qinv = geom.quat_conj(inp.qvecs)
    n_world = geom.quat_rotate(qinv[:, None, None, :], inp.normals)

    def check_pair(i, j):
        """Consistency of view i's pixels against view j's depth map.
        Returns (ok (H,W), Xj_at (H,W,3), nj_at (H,W,3))."""
        Xi = X[i]  # (H, W, 3)
        # project into view j
        x_cam = geom.quat_rotate(inp.qvecs[j][None, None], Xi) + inp.tvecs[j]
        z = x_cam[..., 2]
        zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
        u = inp.Ks[j][0, 0] * x_cam[..., 0] / zs + inp.Ks[j][0, 2]
        v = inp.Ks[j][1, 1] * x_cam[..., 1] / zs + inp.Ks[j][1, 2]
        dj, inb = _sample_nearest(inp.depths[j], u, v)
        vj, _ = _sample_nearest(inp.valid[j], u, v)
        # relative depth consistency
        derr = jnp.abs(z - dj) / jnp.maximum(dj, 1e-9)
        ok = inb & vj & (z > 1e-9) & (derr < max_depth_error)
        # normal agreement (world frame)
        njs, _ = _sample_nearest(n_world[j].reshape(H, W, 3), u, v)
        cosang = jnp.sum(n_world[i] * njs, axis=-1)
        ok &= cosang > jnp.cos(max_normal_error_rad)
        Xjs, _ = _sample_nearest(X[j].reshape(H, W, 3), u, v)
        cjs, _ = _sample_nearest(inp.colors[j], u, v)
        return ok, Xjs, njs, cjs

    # windowed voting: scan over slot s -> view j = i - Wd + s. Slots keep
    # the visibility tensor bounded at 2*Wd+1 regardless of collection size.
    S = 2 * Wd + 1

    def per_view(i):
        def body(s, acc):
            count, emit_leader, xs, ns, cs, vis = acc
            off = s - Wd
            j = jnp.clip(i + off, 0, N - 1)
            ok, Xjs, njs, cjs = check_pair(i, j)
            inrange = (off != 0) & (i + off >= 0) & (i + off <= N - 1)
            ok = ok & inrange & inp.valid[i]
            count = count + ok.astype(jnp.int32)
            w = ok.astype(dtype)[..., None]
            xs = xs + w * Xjs
            ns = ns + w * njs
            cs = cs + w * cjs.astype(dtype)
            # leadership: no supporting view with smaller index
            emit_leader = emit_leader & ~(ok & (j < i))
            vis = vis.at[..., s].set(ok)
            return count, emit_leader, xs, ns, cs, vis

        init = (jnp.zeros((H, W), jnp.int32),
                jnp.ones((H, W), bool),
                jnp.zeros((H, W, 3), dtype),
                jnp.zeros((H, W, 3), dtype),
                jnp.zeros((H, W, 3), dtype),
                jnp.zeros((H, W, S), bool))
        count, leader, xs, ns, cs, vis = jax.lax.fori_loop(0, S, body, init)

        wtot = (count.astype(dtype) + 1.0)[..., None]
        fused_x = (xs + X[i]) / wtot
        fused_n = (ns + n_world[i]) / wtot
        fused_n = fused_n / jnp.maximum(
            jnp.linalg.norm(fused_n, axis=-1, keepdims=True), 1e-9)
        fused_c = (cs + inp.colors[i].astype(dtype)) / wtot
        # the pixel itself counts as one consistent view
        emit = inp.valid[i] & leader & (count + 1 >= min_num_consistent)
        vis = vis.at[..., Wd].set(inp.valid[i])
        return fused_x, fused_c, fused_n, count + 1, emit, vis

    out = jax.lax.map(per_view, jnp.arange(N))
    fused_xyz, fused_rgb, fused_normal, num_consistent, emit, visibility = out
    return {
        "xyz": fused_xyz, "rgb": fused_rgb, "normal": fused_normal,
        "num_consistent": num_consistent, "emit": emit,
        "visibility": visibility, "window": Wd,
    }


def count_emitted(result) -> int:
    """Download ONE scalar: how many pixels will emit a fused point."""
    return int(jnp.sum(result["emit"]))


@functools.partial(jax.jit, static_argnames=("k",))
def _gather_emitted(result, k: int):
    """Device-side compaction: pack the first k emitted pixels' fields into
    ONE buffer. Downloading the full per-pixel fields (incl. the
    (N, H, W, S) visibility tensor) cost hundreds of MB at 48+ views; this
    reduces the transfer to O(points)."""
    N = result["emit"].shape[0]
    S = result["visibility"].shape[-1]
    HW = result["emit"].shape[1] * result["emit"].shape[2]
    emit_flat = result["emit"].reshape(-1)
    # top_k on 0/1 flags returns emitted indices first (ties keep index
    # order), padded with non-emitted indices; the host masks by flag
    flags, idx = jax.lax.top_k(emit_flat.astype(jnp.float32), k)
    xyz = result["xyz"].reshape(-1, 3)[idx]
    rgb = result["rgb"].reshape(-1, 3)[idx]
    nrm = result["normal"].reshape(-1, 3)[idx]
    nc = result["num_consistent"].reshape(-1)[idx].astype(jnp.float32)
    view = (idx // HW).astype(jnp.float32)  # owning view index per point
    packed = jnp.concatenate(
        [xyz, rgb, nrm, nc[:, None], flags[:, None], view[:, None]],
        axis=1)  # (k, 12)
    # windowed visibility as a bit-packed uint8 mask: (k, ceil(S/8));
    # slot s of point from view i means view i - window + s
    vis = result["visibility"].reshape(-1, S)[idx]
    pad = (-S) % 8
    vis = jnp.pad(vis, ((0, 0), (0, pad)))
    bits = (vis.reshape(k, -1, 8)
            * jnp.asarray([1, 2, 4, 8, 16, 32, 64, 128], jnp.uint8)
            ).sum(-1).astype(jnp.uint8)
    return packed, bits


def _expand_windowed_vis(vis_w: np.ndarray, views: np.ndarray, N: int,
                         Wd: int) -> np.ndarray:
    """Windowed slots (P, 2*Wd+1) -> global (P, N) bool: slot s of a point
    owned by view i is view i - Wd + s."""
    P = len(views)
    out = np.zeros((P, N), bool)
    if P == 0:
        return out
    cols = views[:, None] - Wd + np.arange(vis_w.shape[1])[None, :]
    inb = (cols >= 0) & (cols < N)
    rows = np.broadcast_to(np.arange(P)[:, None], cols.shape)
    out[rows[inb], cols[inb]] = vis_w[inb]
    return out


def compact_fused_points_device(result, max_points: int | None = None):
    """Like compact_fused_points, but gathers on DEVICE and downloads one
    O(points) buffer. Returns the same dict (visibility as unpacked
    global-width (P, N) bool)."""
    N = result["emit"].shape[0]
    Wd = int(result["window"])
    S = result["visibility"].shape[-1]
    n_emit = count_emitted(result)
    if n_emit == 0:
        return {"xyz": np.zeros((0, 3)), "rgb": np.zeros((0, 3)),
                "normal": np.zeros((0, 3)),
                "num_consistent": np.zeros(0, np.int64),
                "visibility": np.zeros((0, N), bool)}
    k = 64
    while k < n_emit:
        k *= 2
    total = int(np.prod(result["emit"].shape))
    k = min(k, total)
    if max_points is not None:
        k = min(k, max(max_points, 64))
    packed, bits = _gather_emitted(result, k)
    packed = np.asarray(packed)
    bits = np.asarray(bits)
    keep = packed[:, 10] > 0.5
    if max_points is not None and keep.sum() > max_points:
        support = packed[:, 9]
        order = np.argsort(-support[keep])
        sel = np.flatnonzero(keep)[order[:max_points]]
    else:
        sel = np.flatnonzero(keep)
    vis_w = np.unpackbits(bits[sel], axis=1, bitorder="little")[:, :S] > 0
    views = packed[sel, 11].astype(np.int64)
    return {
        "xyz": packed[sel, 0:3],
        "rgb": packed[sel, 3:6],
        "normal": packed[sel, 6:9],
        "num_consistent": packed[sel, 9].astype(np.int64),
        "visibility": _expand_windowed_vis(vis_w, views, N, Wd),
    }


def compact_fused_points(result, max_points: int | None = None):
    """Host-side compaction of emit=True pixels into arrays."""
    emit = np.asarray(result["emit"])
    idx = np.nonzero(emit.reshape(-1))[0]
    if max_points is not None and len(idx) > max_points:
        # keep the most-supported points
        support = np.asarray(result["num_consistent"]).reshape(-1)[idx]
        idx = idx[np.argsort(-support)[:max_points]]
    def flat(a, d):
        return np.asarray(a).reshape(-1, d)[idx]
    N, H, W = emit.shape
    Wd = int(result["window"])
    S = np.asarray(result["visibility"]).shape[-1]
    vis_w = np.asarray(result["visibility"]).reshape(-1, S)[idx]
    views = idx // (H * W)
    return {
        "xyz": flat(result["xyz"], 3),
        "rgb": flat(result["rgb"], 3),
        "normal": flat(result["normal"], 3),
        "num_consistent": np.asarray(result["num_consistent"]).reshape(-1)[idx],
        "visibility": _expand_windowed_vis(vis_w, views, N, Wd),
    }


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray | None = None,
              normal: np.ndarray | None = None):
    """Binary little-endian PLY export of the fused cloud."""
    n = len(xyz)
    props = ["property float x", "property float y", "property float z"]
    cols = [xyz.astype("<f4")]
    if normal is not None:
        props += ["property float nx", "property float ny", "property float nz"]
        cols.append(normal.astype("<f4"))
    if rgb is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
        r = rgb
        if r.dtype != np.uint8:
            r = np.clip(r * (255.0 if r.max() <= 1.0 + 1e-6 else 1.0), 0, 255).astype(np.uint8)
        cols.append(r)
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}", *props, "end_header", ""])
    rec = np.zeros(n, dtype=np.dtype([(f"f{i}", c.dtype, c.shape[1]) for i, c in enumerate(cols)]))
    for i, c in enumerate(cols):
        rec[f"f{i}"] = c
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())
