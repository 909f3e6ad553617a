"""Surface meshing: TSDF volumetric fusion + marching tetrahedra.

The reference's step 8 is Poisson meshing — listed as "coming soon"
(/root/reference/README.md:69) with ``poisson_recon`` linked into the build
(/root/reference/integration/op_cpp/CMakeLists.txt:91) but no kernel, no
runner, nothing shipped. This module ships the stage as dense array
programs: instead of
an irregular octree Poisson solve (pointer-chasing and data-dependent
refinement, hostile to XLA), the surface is recovered by

1. **Truncated-signed-distance fusion** of the depth maps on a dense voxel
   grid — one batched transform-project-gather pass per view folded with
   ``lax.scan`` (static shapes, batched pose transforms, a single
   nearest gather per voxel per view), KinectFusion-style; and
2. **vectorized marching tetrahedra** over the grid (host numpy on active
   cells only): each cube splits into the 6 tetrahedra sharing its main
   diagonal, each tetrahedron emits 0-2 triangles by sign-classification of
   its 4 corners with linear zero-crossing interpolation. Vertices are
   deduplicated by grid-edge identity, so shared edges produce shared
   vertices and the surface is watertight wherever the TSDF is observed.

The zero level set of the fused TSDF is the same least-squares surface the
depth maps support; marching tetrahedra needs no case table beyond the
four-point sign enumeration derived here from first principles.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import jax
import jax.numpy as jnp

from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.ops.fusion import FusionInput


class TsdfGrid(NamedTuple):
    tsdf: np.ndarray     # (nx, ny, nz) f32 in [-1, 1] (units of trunc)
    weight: np.ndarray   # (nx, ny, nz) f32 accumulated view weights
    color: np.ndarray    # (nx, ny, nz, 3) f32 [0,1] weighted mean
    origin: np.ndarray   # (3,) world position of grid point (0,0,0)
    voxel: float         # voxel edge length (world units)


# ---------------------------------------------------------------------------
# TSDF fusion (device)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("dims",))
def _tsdf_scan(depths, valid, colors, qvecs, tvecs, Ks, origin, voxel,
               dims, trunc):
    """Fold all views into (tsdf_sum, weight_sum, color_sum) over the grid.

    Projective TSDF: for voxel center p seen by view i at camera depth z
    with measured depth d at its pixel, sdf = d - z, truncated to
    [-trunc, trunc]; voxels more than one truncation band BEHIND the
    measured surface are unobserved (not carved), as in
    ``mvs::StereoFusion``'s bounded consistency band
    (/root/reference/integration/op_cpp/stereo_fusion.cc:141-150 uses the
    same relative depth-error gating idea).
    """
    nx, ny, nz = dims
    f32 = depths.dtype
    idx = jnp.arange(nx * ny * nz, dtype=jnp.int32)
    iz = idx % nz
    iy = (idx // nz) % ny
    ix = idx // (nz * ny)
    pts = origin[None, :] + voxel * jnp.stack(
        [ix, iy, iz], axis=-1).astype(f32)              # (V, 3)

    def one_view(carry, view):
        tsdf_s, w_s, c_s, cw_s = carry
        depth, vmask, color, q, t, K = view
        x_cam = geom.quat_rotate(q[None], pts) + t[None]  # (V, 3)
        z = x_cam[:, 2]
        u = K[0, 0] * x_cam[:, 0] / jnp.where(z == 0, 1.0, z) + K[0, 2]
        v = K[1, 1] * x_cam[:, 1] / jnp.where(z == 0, 1.0, z) + K[1, 2]
        H, W = depth.shape
        ui = jnp.round(u).astype(jnp.int32)
        vi = jnp.round(v).astype(jnp.int32)
        inb = (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H) & (z > 1e-6)
        ui = jnp.clip(ui, 0, W - 1)
        vi = jnp.clip(vi, 0, H - 1)
        flat = vi * W + ui
        d = depth.reshape(-1)[flat]
        ok = inb & vmask.reshape(-1)[flat] & (d > 0)
        sdf = d - z
        obs = ok & (sdf > -trunc)                 # within band or in front
        tsdf = jnp.clip(sdf / trunc, -1.0, 1.0)
        w = obs.astype(f32)
        near = ok & (jnp.abs(sdf) < trunc)        # color only near surface
        cw = near.astype(f32)
        c = color.reshape(-1, 3)[flat]
        return (tsdf_s + w * tsdf, w_s + w, c_s + cw[:, None] * c,
                cw_s + cw), None

    V = pts.shape[0]
    init = (jnp.zeros(V, f32), jnp.zeros(V, f32), jnp.zeros((V, 3), f32),
            jnp.zeros(V, f32))
    (tsdf_s, w_s, c_s, cw_s), _ = jax.lax.scan(
        one_view, init, (depths, valid, colors, qvecs, tvecs, Ks))
    tsdf = jnp.where(w_s > 0, tsdf_s / jnp.maximum(w_s, 1e-9), 1.0)
    color = c_s / jnp.maximum(cw_s[:, None], 1e-9)
    return (tsdf.reshape(dims), w_s.reshape(dims),
            color.reshape(dims + (3,)))


def fuse_tsdf(inp: FusionInput, origin, voxel: float, dims,
              trunc_voxels: float = 3.0) -> TsdfGrid:
    """Fuse all depth maps of ``inp`` into a TSDF grid."""
    origin = jnp.asarray(origin, jnp.float32)
    colors = inp.colors.astype(jnp.float32)
    if colors.ndim == 3:
        colors = colors[..., None].repeat(3, -1)
    # normalization keyed off the INPUT dtype, not the data range: integer
    # imagery is 0-255 even when uniformly dark (a max<=1 uint8 frame must
    # not be mistaken for already-normalized floats)
    if np.issubdtype(inp.colors.dtype, np.integer):
        colors = colors / 255.0
    trunc = float(trunc_voxels) * float(voxel)
    tsdf, w, c = _tsdf_scan(
        inp.depths.astype(jnp.float32), inp.valid, colors,
        inp.qvecs.astype(jnp.float32), inp.tvecs.astype(jnp.float32),
        inp.Ks.astype(jnp.float32), origin, jnp.float32(voxel),
        tuple(int(d) for d in dims), jnp.float32(trunc))
    return TsdfGrid(np.asarray(tsdf), np.asarray(w), np.asarray(c),
                    np.asarray(origin, np.float32), float(voxel))


def grid_from_bounds(lo, hi, resolution: int = 128, margin_voxels: int = 4):
    """Choose (origin, voxel, dims) so the box [lo, hi] fits with margin and
    the longest axis has ``resolution`` cells."""
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    span = np.maximum(hi - lo, 1e-6)
    voxel = float(span.max()) / float(resolution)
    origin = lo - margin_voxels * voxel
    dims = tuple(int(np.ceil(s / voxel)) + 2 * margin_voxels + 1
                 for s in span)
    return origin.astype(np.float32), voxel, dims


# ---------------------------------------------------------------------------
# Marching tetrahedra (host, vectorized over active cells)
# ---------------------------------------------------------------------------

# six tetrahedra sharing the cube's main diagonal (corner 0 -> corner 7):
# the 3! axis orders 0 -> a -> a|b -> 7. Corner id = dx + 2*dy + 4*dz.
_TETS = np.array([
    [0, 1, 3, 7],
    [0, 1, 5, 7],
    [0, 2, 3, 7],
    [0, 2, 6, 7],
    [0, 4, 5, 7],
    [0, 4, 6, 7],
], np.int64)
_CORNER_OFF = np.array([[dx, dy, dz] for dz in (0, 1) for dy in (0, 1)
                        for dx in (0, 1)], np.int64)  # id = dx+2dy+4dz


def _edge_vertices(gidx_a, gidx_b, va, vb, pts_a, pts_b):
    """Zero crossing on edges (a, b) with va<0<=vb (or any mixed signs)."""
    t = va / (va - vb)
    t = np.clip(t, 0.0, 1.0)[:, None]
    pos = pts_a + t * (pts_b - pts_a)
    lo = np.minimum(gidx_a, gidx_b)
    hi = np.maximum(gidx_a, gidx_b)
    return pos, lo, hi


def marching_tetrahedra(grid: TsdfGrid, min_weight: float = 1.0,
                        iso: float = 0.0):
    """Extract the iso-surface triangle mesh from a TSDF grid.

    Returns (verts (M,3) f32, faces (T,3) i32, vert_rgb (M,3) f32).
    Only cells whose 8 corners are all observed (weight >= min_weight)
    participate; faces are oriented so normals point toward positive TSDF
    (free space), consistent across the mesh.
    """
    F = grid.tsdf.astype(np.float64) - iso
    Wt = grid.weight
    nx, ny, nz = F.shape
    obs = Wt >= min_weight
    neg = (F < 0) & obs

    # active cells: observed on all 8 corners, mixed sign
    def corner_view(A, off):
        dx, dy, dz = off
        return A[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]

    all_obs = np.ones((nx - 1, ny - 1, nz - 1), bool)
    any_neg = np.zeros_like(all_obs)
    all_neg = np.ones_like(all_obs)
    for off in _CORNER_OFF:
        all_obs &= corner_view(obs, off)
        cn = corner_view(neg, off)
        any_neg |= cn
        all_neg &= cn
    active = all_obs & any_neg & ~all_neg
    cix, ciy, ciz = np.nonzero(active)
    if len(cix) == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.float32))

    # per-active-cell corner values, global grid indices, world positions
    cvals = np.empty((len(cix), 8), np.float64)
    gidx = np.empty((len(cix), 8), np.int64)
    for c, (dx, dy, dz) in enumerate(_CORNER_OFF):
        xs, ys, zs = cix + dx, ciy + dy, ciz + dz
        cvals[:, c] = F[xs, ys, zs]
        gidx[:, c] = (xs * ny + ys) * nz + zs

    def gpos(g):
        zs = g % nz
        ys = (g // nz) % ny
        xs = g // (nz * ny)
        return (grid.origin[None, :]
                + grid.voxel * np.stack([xs, ys, zs], -1).astype(np.float64))

    tri_pos = []   # (k, 3, 3) positions per triangle
    tri_lo = []    # (k, 3) edge-key lows
    tri_hi = []

    for tet in _TETS:
        v = cvals[:, tet]                     # (M, 4)
        g = gidx[:, tet]                      # (M, 4)
        inside = v < 0
        k = inside.sum(1)

        # one corner on its own side -> one triangle from its 3 edges
        for lone_inside in (True, False):
            count = 1 if lone_inside else 3
            sel = np.nonzero(k == count)[0]
            if len(sel) == 0:
                continue
            ins = inside[sel] if lone_inside else ~inside[sel]
            lone = np.argmax(ins, axis=1)
            # argsort(False-first) puts the 3 non-lone corners up front
            others = np.argsort(ins, axis=1, kind="stable")[:, :3]
            va = v[sel, lone]
            ga = g[sel, lone]
            pa = gpos(ga)
            corners = []
            for j in range(3):
                ob = others[:, j]
                pos, lo, hi = _edge_vertices(
                    ga, g[sel, ob], va, v[sel, ob], pa, gpos(g[sel, ob]))
                corners.append((pos, lo, hi))
            tri_pos.append(np.stack([c[0] for c in corners], axis=1))
            tri_lo.append(np.stack([c[1] for c in corners], axis=1))
            tri_hi.append(np.stack([c[2] for c in corners], axis=1))

        # two/two split -> quad over the 4 crossing edges -> two triangles
        sel = np.nonzero(k == 2)[0]
        if len(sel):
            ins = inside[sel]
            a = np.argsort(~ins, axis=1, kind="stable")[:, :2]  # inside pair
            b = np.argsort(ins, axis=1, kind="stable")[:, :2]   # outside pair
            quad = []
            # order around the quad: (a0,b0), (a0,b1), (a1,b1), (a1,b0)
            for (ai, bi) in ((0, 0), (0, 1), (1, 1), (1, 0)):
                ia = a[:, ai]
                ib = b[:, bi]
                pos, lo, hi = _edge_vertices(
                    g[sel, ia], g[sel, ib], v[sel, ia], v[sel, ib],
                    gpos(g[sel, ia]), gpos(g[sel, ib]))
                quad.append((pos, lo, hi))
            for tri in ((0, 1, 2), (0, 2, 3)):
                tri_pos.append(np.stack([quad[i][0] for i in tri], axis=1))
                tri_lo.append(np.stack([quad[i][1] for i in tri], axis=1))
                tri_hi.append(np.stack([quad[i][2] for i in tri], axis=1))

    pos = np.concatenate(tri_pos, axis=0)       # (T, 3, 3)
    lo = np.concatenate(tri_lo, axis=0)
    hi = np.concatenate(tri_hi, axis=0)

    # dedup vertices by grid-edge identity -> watertight connectivity
    NG = nx * ny * nz
    keys = (lo.astype(np.int64) * NG + hi).reshape(-1)
    uniq, inv = np.unique(keys, return_inverse=True)
    verts = np.zeros((len(uniq), 3), np.float64)
    verts[inv] = pos.reshape(-1, 3)
    faces = inv.reshape(-1, 3).astype(np.int32)

    # drop degenerate faces (duplicate vertices after dedup)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    faces = faces[good]

    # orient: face normal should point toward positive TSDF (free space).
    # The gradient must not see unobserved voxels as the iso value 0 (that
    # flips boundary faces where observed free space is ~+1): fill
    # unobserved voxels with the mean of their observed 6-neighbors first.
    def _shift(a, ax, sh):
        out = np.zeros_like(a)
        src = [slice(None)] * 3
        dst = [slice(None)] * 3
        if sh > 0:
            dst[ax], src[ax] = slice(sh, None), slice(None, -sh)
        else:
            dst[ax], src[ax] = slice(None, sh), slice(-sh, None)
        out[tuple(dst)] = a[tuple(src)]
        return out

    F_fill = np.where(obs, F, 0.0)
    obs_f = obs.copy()
    for _ in range(2):
        acc = np.zeros_like(F_fill)
        cnt = np.zeros_like(F_fill)
        for ax in range(3):
            for sh in (1, -1):
                acc += _shift(np.where(obs_f, F_fill, 0.0), ax, sh)
                cnt += _shift(obs_f.astype(F_fill.dtype), ax, sh)
        newly = ~obs_f & (cnt > 0)
        F_fill = np.where(newly, acc / np.maximum(cnt, 1.0), F_fill)
        obs_f |= newly
    gx, gy, gz = np.gradient(F_fill)
    cent = verts[faces].mean(axis=1)
    ci = np.clip(np.round((cent - grid.origin) / grid.voxel).astype(np.int64),
                 0, [nx - 1, ny - 1, nz - 1])
    gvec = np.stack([gx[ci[:, 0], ci[:, 1], ci[:, 2]],
                     gy[ci[:, 0], ci[:, 1], ci[:, 2]],
                     gz[ci[:, 0], ci[:, 1], ci[:, 2]]], axis=-1)
    e1 = verts[faces[:, 1]] - verts[faces[:, 0]]
    e2 = verts[faces[:, 2]] - verts[faces[:, 0]]
    nrm = np.cross(e1, e2)
    flip = (nrm * gvec).sum(-1) < 0
    faces[flip] = faces[flip][:, ::-1]

    # vertex colors: nearest grid point of the fused color volume
    vi = np.clip(np.round((verts - grid.origin) / grid.voxel).astype(np.int64),
                 0, [nx - 1, ny - 1, nz - 1])
    rgb = grid.color[vi[:, 0], vi[:, 1], vi[:, 2]].astype(np.float32)
    return verts.astype(np.float32), faces, rgb


def write_ply_mesh(path: str, verts: np.ndarray, faces: np.ndarray,
                   rgb: Optional[np.ndarray] = None) -> None:
    """Binary little-endian PLY mesh (vertices + faces, optional color)."""
    n, m = len(verts), len(faces)
    has_c = rgb is not None and len(rgb) == n
    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    if has_c:
        header += ["property uchar red", "property uchar green",
                   "property uchar blue"]
    header += [f"element face {m}",
               "property list uchar int vertex_indices", "end_header"]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode())
        if has_c:
            vt = np.empty(n, dtype=[("xyz", np.float32, 3),
                                    ("rgb", np.uint8, 3)])
            vt["xyz"] = verts
            c = np.asarray(rgb)
            if c.dtype != np.uint8:
                scale = 255.0 if (c.size == 0 or c.max() <= 1.5) else 1.0
                c = np.clip(c * scale, 0, 255).astype(np.uint8)
            vt["rgb"] = c
        else:
            vt = np.empty(n, dtype=[("xyz", np.float32, 3)])
            vt["xyz"] = verts
        f.write(vt.tobytes())
        ft = np.empty(m, dtype=[("n", np.uint8), ("idx", np.int32, 3)])
        ft["n"] = 3
        ft["idx"] = faces
        f.write(ft.tobytes())
