"""Absolute pose (PnP): batched DLT solver + RANSAC + Gauss-Newton refinement.

Rebuilds the capability of COLMAP's ``RegisterNextImage`` absolute-pose
RANSAC (P3P + refinement) used by the reference's mapping kernel
(integration/op_cpp/incremental_mapping.cc:329), batched: a static batch of
S minimal samples is solved by one vmapped eigen-solve of 12x12 normal
matrices (6-point DLT), all hypotheses are scored against all
correspondences in one einsum, and the winner is polished with a fixed-trip
Gauss-Newton pose refinement (pose-only bundle adjustment).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.ops.linalg3 import f32_matmuls

NEG_LOGIT = -1e9


class PnPResult(NamedTuple):
    qvec: jax.Array         # (4,)
    tvec: jax.Array         # (3,)
    inlier_mask: jax.Array  # (N,)
    num_inliers: jax.Array  # () int32
    ok: jax.Array           # () bool


# ---------------------------------------------------------------------------
# Linear PnP (DLT) — works for >= 6 points, batch-friendly
# ---------------------------------------------------------------------------

def pnp_dlt(x3d: jax.Array, xn: jax.Array, mask: jax.Array | None = None,
            exact: bool = True):
    """Estimate world->cam pose from 2D-3D correspondences.

    x3d: (..., K, 3) world points; xn: (..., K, 2) normalized image coords.
    Returns (qvec (...,4), tvec (...,3)).

    exact=False (minimal 6-point samples only): the null vector comes from
    modified Gram-Schmidt over 11 of the 12 equation rows instead of a
    batched 12x12 eigh — batched small factorizations serialize on the
    scalar unit and dominated the PnP trial batch (same trick as two-view's
    _null_vec_fast; one dropped row leaves a rank-11 system whose null
    direction matches the DLT solution to noise order, plenty for RANSAC
    hypotheses that are MSAC-scored and GN-polished).
    """
    if mask is None:
        mask = jnp.ones(x3d.shape[:-1], bool)
    X, Y, Z = x3d[..., 0], x3d[..., 1], x3d[..., 2]
    u, v = xn[..., 0], xn[..., 1]
    o = jnp.ones_like(X)
    z = jnp.zeros_like(X)
    # rows of A p = 0 with p = vec(P) row-major (12,)
    r1 = jnp.stack([X, Y, Z, o, z, z, z, z, -u * X, -u * Y, -u * Z, -u], axis=-1)
    r2 = jnp.stack([z, z, z, z, X, Y, Z, o, -v * X, -v * Y, -v * Z, -v], axis=-1)
    A = jnp.concatenate([r1 * mask[..., None], r2 * mask[..., None]], axis=-2)
    if exact:
        AtA = jnp.einsum("...ki,...kj->...ij", A, A)
        _, V = jnp.linalg.eigh(AtA)
        p = V[..., :, 0]
    else:
        from scanner_colmap_tpu.ops.two_view import _null_vec_fast

        p = _null_vec_fast(A[..., :-1, :])
    P = p.reshape(p.shape[:-1] + (3, 4))

    M = P[..., :3]
    # fix global sign so that points end up in front: use mean depth sign
    w = mask.astype(x3d.dtype)
    depth = jnp.einsum("...j,...kj->...k", M[..., 2, :], x3d) + P[..., 2, 3][..., None]
    mean_depth = jnp.sum(depth * w, axis=-1) / jnp.maximum(jnp.sum(w, axis=-1), 1.0)
    sgn = jnp.where(mean_depth < 0, -1.0, 1.0)
    P = P * sgn[..., None, None]
    M = P[..., :3]

    # orthogonalize: M = s R with R = U V^T
    U, S, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(jnp.einsum("...ij,...jk->...ik", U, Vt))
    D = jnp.concatenate(
        [jnp.ones_like(S[..., :2]), det[..., None]], axis=-1)
    R = jnp.einsum("...ij,...j,...jk->...ik", U, D, Vt)
    s = jnp.maximum(jnp.mean(S, axis=-1), 1e-12)
    t = P[..., 3] / s[..., None]
    return geom.rotmat_to_quat(R), t


# ---------------------------------------------------------------------------
# Pose-only Gauss-Newton refinement (fixed trip count)
# ---------------------------------------------------------------------------

def refine_pose(qvec, tvec, x3d, xn, weights, num_iters: int = 10,
                damping: float = 1e-4):
    """Minimize sum_i w_i |proj(R x_i + t) - xn_i|^2 over (R, t).

    Parameterization: left-multiplied angle-axis delta on R, additive on t.
    weights: (N,) — inlier mask (0/1) or robust weights. Fixed GN trips,
    Levenberg damping; jit-safe.
    """
    w2 = jnp.repeat(weights, 2)

    def body(_, carry):
        q0, t0 = carry
        params0 = jnp.zeros(6, x3d.dtype)

        def res_fn(p):
            aa, dt = p[:3], p[3:]
            q = geom.quat_mul(geom.angle_axis_to_quat(aa), q0)
            x_cam = geom.quat_rotate(q[None, :], x3d) + (t0 + dt)
            z = jnp.where(jnp.abs(x_cam[:, 2]) < 1e-9, 1e-9, x_cam[:, 2])
            proj = x_cam[:, :2] / z[:, None]
            return (proj - xn).reshape(-1)

        r = res_fn(params0)
        J = jax.jacfwd(res_fn)(params0)  # (2N, 6)
        Jw = J * w2[:, None]
        H = Jw.T @ J + damping * jnp.eye(6, dtype=x3d.dtype)
        g = Jw.T @ r
        delta = -jnp.linalg.solve(H, g)
        q_new = geom.quat_normalize(geom.quat_mul(geom.angle_axis_to_quat(delta[:3]), q0))
        t_new = t0 + delta[3:]
        # accept only if the weighted cost improves
        cost_old = jnp.sum(w2 * r**2)
        x_cam = geom.quat_rotate(q_new[None, :], x3d) + t_new
        z = jnp.where(jnp.abs(x_cam[:, 2]) < 1e-9, 1e-9, x_cam[:, 2])
        proj = x_cam[:, :2] / z[:, None]
        cost_new = jnp.sum(weights * jnp.sum((proj - xn) ** 2, axis=-1))
        good = cost_new < cost_old
        return (jnp.where(good, q_new, q0), jnp.where(good, t_new, t0))

    q, t = jax.lax.fori_loop(0, num_iters, body, (qvec, tvec))
    return q, t


# ---------------------------------------------------------------------------
# RANSAC PnP
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("num_trials", "sample_size", "refine_iters"))
@f32_matmuls
def pnp_ransac(
    key,
    x3d: jax.Array,   # (N, 3)
    xn: jax.Array,    # (N, 2) normalized coords
    valid: jax.Array, # (N,)
    max_error_n: jax.Array,  # () threshold in normalized units
    min_num_inliers: int | jax.Array = 30,
    min_inlier_ratio: float = 0.25,
    num_trials: int = 256,
    sample_size: int = 6,
    refine_iters: int = 10,
) -> PnPResult:
    """Absolute-pose RANSAC with DLT minimal solves + GN polish.

    Precision: float32 matmuls at the highest precision (f32_matmuls); the
    packed variants inherit it."""
    n = x3d.shape[0]
    thr2 = max_error_n * max_error_n
    logits = jnp.where(valid, 0.0, NEG_LOGIT)
    samples = jax.random.categorical(
        key, logits[None, :], axis=-1, shape=(num_trials, sample_size))
    q_h, t_h = pnp_dlt(x3d[samples], xn[samples], exact=False)  # (S,4), (S,3)

    # score all hypotheses
    x_cam = geom.quat_rotate(q_h[:, None, :], x3d[None]) + t_h[:, None, :]
    z = x_cam[..., 2]
    proj = x_cam[..., :2] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)[..., None]
    err2 = jnp.sum((proj - xn[None]) ** 2, axis=-1)
    err2 = jnp.where((z > 1e-6) & valid[None], err2, thr2)
    score = jnp.sum(jnp.minimum(err2, thr2), axis=-1)
    best = jnp.argmin(score)
    qb, tb = q_h[best], t_h[best]
    inl = (err2[best] < thr2) & valid

    # polish on inliers then recount; two LO rounds tighten the inlier set
    q_f, t_f, inl_f = qb, tb, inl
    for _ in range(2):
        qr, tr = refine_pose(q_f, t_f, x3d, xn, inl_f.astype(x3d.dtype),
                             num_iters=refine_iters)
        x_cam = geom.quat_rotate(qr[None, :], x3d) + tr
        z = x_cam[:, 2]
        proj = x_cam[:, :2] / jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)[:, None]
        err2r = jnp.sum((proj - xn) ** 2, axis=-1)
        inl_r = (err2r < thr2) & (z > 1e-6) & valid
        better = jnp.sum(inl_r) >= jnp.sum(inl_f)
        q_f = jnp.where(better, qr, q_f)
        t_f = jnp.where(better, tr, t_f)
        inl_f = jnp.where(better, inl_r, inl_f)

    n_inl = jnp.sum(inl_f)
    nv = jnp.maximum(jnp.sum(valid), 1)
    ok = (n_inl >= min_num_inliers) & (
        n_inl.astype(jnp.float32) >= min_inlier_ratio * nv.astype(jnp.float32))
    return PnPResult(geom.quat_normalize(q_f), t_f, inl_f,
                     n_inl.astype(jnp.int32), ok)


@functools.partial(jax.jit, static_argnames=("num_trials", "sample_size",
                                             "refine_iters"))
def pnp_ransac_packed(key, x3d, xn, valid, max_error_n,
                      min_num_inliers=30, min_inlier_ratio: float = 0.25,
                      num_trials: int = 256, sample_size: int = 6,
                      refine_iters: int = 10) -> jax.Array:
    """`pnp_ransac` packed into ONE (9 + N,) float array:
    [qvec(4), tvec(3), num_inliers(1), ok(1), inlier_mask(N)] — a single
    device->host transfer for the engine's registration loop."""
    res = pnp_ransac(key, x3d, xn, valid, max_error_n,
                     min_num_inliers=min_num_inliers,
                     min_inlier_ratio=min_inlier_ratio,
                     num_trials=num_trials, sample_size=sample_size,
                     refine_iters=refine_iters)
    dt = res.tvec.dtype
    return jnp.concatenate([
        res.qvec.astype(dt), res.tvec,
        res.num_inliers.astype(dt)[None], res.ok.astype(dt)[None],
        res.inlier_mask.astype(dt)])


@functools.partial(jax.jit, static_argnames=("num_trials", "sample_size",
                                             "refine_iters"))
def pnp_ransac_packed_cols(key, data, max_error_n,
                           min_num_inliers=30, min_inlier_ratio: float = 0.25,
                           num_trials: int = 256, sample_size: int = 6,
                           refine_iters: int = 10) -> jax.Array:
    """Packed-input variant: data (N, 6) = [x3d(3), xn(2), valid(1)];
    output as in `pnp_ransac_packed`. One upload + one download."""
    return pnp_ransac_packed(key, data[:, 0:3], data[:, 3:5], data[:, 5] > 0.5,
                             max_error_n,
                             min_num_inliers=min_num_inliers,
                             min_inlier_ratio=min_inlier_ratio,
                             num_trials=num_trials, sample_size=sample_size,
                             refine_iters=refine_iters)
