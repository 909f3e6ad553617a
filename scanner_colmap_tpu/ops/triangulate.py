"""Triangulation: batched two-view and multi-view DLT with quality gates.

Rebuilds the capability of COLMAP's ``TriangulateImage`` / estimators used by
the reference's mapping kernel
(/root/reference/integration/op_cpp/incremental_mapping.cc:49-57): given
tracks of observations across registered images, produce 3D points, with
cheirality, reprojection-error, and triangulation-angle acceptance tests.

Batched: a whole batch of tracks triangulates as one vmapped eigh of 4x4
normal matrices (multi-view DLT in homogeneous coordinates); no per-point
Python control flow.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.ops.linalg3 import f32_matmuls


def projection_matrices(qvecs: jax.Array, tvecs: jax.Array) -> jax.Array:
    """(M, 4) + (M, 3) world->cam poses -> (M, 3, 4) projection [R|t]."""
    R = geom.quat_to_rotmat(qvecs)
    return jnp.concatenate([R, tvecs[..., None]], axis=-1)


def triangulate_dlt(P: jax.Array, xn: jax.Array, mask: jax.Array) -> jax.Array:
    """Multi-view DLT for ONE track.

    P: (M, 3, 4) projections; xn: (M, 2) normalized image coords (z=1 plane);
    mask: (M,) which views observe the track. Returns (3,) world point.

    Uses the 4x4 normal-matrix eigen formulation: rows a_i = x_i P_i[2] - P_i[j],
    accumulate A^T A with masked weights, smallest eigenvector = homogeneous X.
    """
    r1 = xn[:, 0:1] * P[:, 2, :] - P[:, 0, :]  # (M, 4)
    r2 = xn[:, 1:2] * P[:, 2, :] - P[:, 1, :]
    A = jnp.concatenate([r1, r2], axis=0)  # (2M, 4)
    w = jnp.concatenate([mask, mask]).astype(A.dtype)
    AtA = (A * w[:, None]).T @ A
    _, V = jnp.linalg.eigh(AtA)
    X = V[:, 0]
    return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, X[3])


triangulate_dlt_batch = jax.vmap(triangulate_dlt, in_axes=(0, 0, 0))
"""(B, M, 3, 4), (B, M, 2), (B, M) -> (B, 3): one eigh batch on device."""


@functools.partial(jax.jit, static_argnames=())
@f32_matmuls
def triangulate_tracks(
    qvecs: jax.Array,      # (B, M, 4) per-track observing-camera poses
    tvecs: jax.Array,      # (B, M, 3)
    xn: jax.Array,         # (B, M, 2) normalized coords
    mask: jax.Array,       # (B, M) observation mask
    max_reproj_error_n: jax.Array,  # () or (B,) threshold in NORMALIZED units
    min_tri_angle: float = 0.0262,  # rad (1.5 deg)
):
    """Batched multi-view triangulation + acceptance tests.

    Returns (xyz (B,3), ok (B,), per_view_ok (B,M)).
    A track is accepted if >=2 observations pass cheirality + reprojection
    gates and the max pairwise triangulation angle >= min_tri_angle.

    Precision: float32 matmuls at the highest precision (f32_matmuls); the
    packed variant inherits it.
    """
    P = projection_matrices(qvecs, tvecs)  # (B, M, 3, 4)
    xyz = triangulate_dlt_batch(P, xn, mask)  # (B, 3)

    # reprojection + cheirality per view
    x_cam = jnp.einsum("bmij,bj->bmi", P[..., :3], xyz) + P[..., 3]
    z = x_cam[..., 2]
    proj = x_cam[..., :2] / jnp.where(jnp.abs(z) < 1e-12, 1e-12, z)[..., None]
    err = jnp.linalg.norm(proj - xn, axis=-1)
    thr = jnp.broadcast_to(jnp.asarray(max_reproj_error_n), err.shape[:1])[:, None]
    view_ok = mask & (z > 1e-6) & (err < thr)

    # max pairwise triangulation angle among accepted views
    centers = geom.projection_center(qvecs, tvecs)  # (B, M, 3)
    rays = centers - xyz[:, None, :]
    rn = rays / jnp.maximum(jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    cosang = jnp.einsum("bmi,bni->bmn", rn, rn)
    pair_ok = view_ok[:, :, None] & view_ok[:, None, :]
    ang = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))
    max_ang = jnp.max(jnp.where(pair_ok, ang, 0.0), axis=(1, 2))

    ok = (jnp.sum(view_ok, axis=-1) >= 2) & (max_ang >= min_tri_angle)
    return xyz, ok, view_ok


@jax.jit
def triangulate_tracks_packed(data: jax.Array, max_reproj_error_n: jax.Array,
                              min_tri_angle: jax.Array):
    """Single-upload / single-download variant for the host engine.

    data: (B, T, 10) rows of [qvec(4), tvec(3), xn(2), mask(1)].
    Returns one (B, 4 + T) array of [xyz(3), ok(1), view_ok(T)] so callers
    pay ONE device->host transfer.
    """
    qv = data[..., 0:4]
    tv = data[..., 4:7]
    xn = data[..., 7:9]
    mask = data[..., 9] > 0.5
    xyz, ok, view_ok = triangulate_tracks(qv, tv, xn, mask,
                                          max_reproj_error_n, min_tri_angle)
    return jnp.concatenate(
        [xyz, ok[:, None].astype(xyz.dtype), view_ok.astype(xyz.dtype)],
        axis=1)


def two_view_triangulation_angle(q1, t1, q2, t2, xyz):
    c1 = geom.projection_center(q1, t1)
    c2 = geom.projection_center(q2, t2)
    return geom.triangulation_angle(c1, c2, xyz)
