"""Two-view geometry: batched minimal solvers + batched RANSAC + config decision.

Rebuilds COLMAP's ``TwoViewGeometry::Estimate`` as used by the reference's
matching kernel (integration/op_cpp/sequential_matching.cc:84-101): RANSAC
over F/E/H models, inlier classification, configuration enum, and
relative-pose (qvec/tvec, tri_angle) recovery — the fields the reference
serializes per pair (io.cc:237-246).

Batched design: instead of the sequential hypothesize-and-verify loop with
early exit, we draw a STATIC batch of S minimal samples, solve all hypotheses
with one vmapped linear solve, score all N correspondences against all S
hypotheses with one einsum, and pick the best — then refit on inliers
(one LO step). Static shapes, no data-dependent control flow, everything
on the device. Unlike the reference (defect: dummy cameras,
sequential_matching.cc:89), real intrinsics are used when available.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.ops.linalg3 import f32_matmuls, inv33 as _inv33

# COLMAP TwoViewGeometry configuration enum (interchange-compatible)
UNDEFINED = 0
DEGENERATE = 1
CALIBRATED = 2
UNCALIBRATED = 3
PLANAR = 4
PANORAMIC = 5
PLANAR_OR_PANORAMIC = 6
WATERMARK = 7
MULTIPLE = 8


class TwoViewGeometry(NamedTuple):
    """Result for one pair, fixed-shape. Mirrors colmap::TwoViewGeometry."""
    config: jax.Array        # () int32
    E: jax.Array             # (3,3)
    F: jax.Array             # (3,3)
    H: jax.Array             # (3,3)
    qvec: jax.Array          # (4,) relative pose cam1->cam2
    tvec: jax.Array          # (3,)
    tri_angle: jax.Array     # () median triangulation angle (rad)
    inlier_mask: jax.Array   # (N,) bool over input matches
    num_inliers: jax.Array   # () int32


# ---------------------------------------------------------------------------
# Normalization + DLT solvers (all batch-friendly; shapes (..., K, 2))
# ---------------------------------------------------------------------------

def _normalize_points(pts: jax.Array, mask: jax.Array):
    """Hartley normalization: centroid 0, mean dist sqrt(2). Masked."""
    w = mask.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1.0)
    mean = jnp.sum(pts * w[..., None], axis=-2, keepdims=True) / n[..., None]
    d = jnp.linalg.norm(pts - mean, axis=-1)
    mean_d = jnp.sum(d * w, axis=-1, keepdims=True) / n
    scale = jnp.sqrt(2.0) / jnp.maximum(mean_d, 1e-12)
    normed = (pts - mean) * scale[..., None]
    # T maps raw -> normalized homogeneous
    zeros = jnp.zeros_like(scale[..., 0])
    ones = jnp.ones_like(zeros)
    s = scale[..., 0]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    T = jnp.stack([
        s, zeros, -s * mx,
        zeros, s, -s * my,
        zeros, zeros, ones,
    ], axis=-1).reshape(scale.shape[:-1] + (3, 3))
    return normed, T


def _smallest_eigvec(A: jax.Array):
    """Right null vector of A (..., m, n): eigenvector of A^T A with smallest
    eigenvalue. Uses eigh — exact but expensive in large batches
    (iterative sweeps); RANSAC trial batches use _null_vec_fast."""
    AtA = jnp.einsum("...ki,...kj->...ij", A, A)
    _, V = jnp.linalg.eigh(AtA)
    return V[..., :, 0]


def _null_vec_fast(A: jax.Array, iters: int = 2):
    """Approximate right null vector of A (..., m, n), m < n, with NO linear
    solves: modified Gram-Schmidt over the m sample rows (static unrolled
    loop of batched dot/axpy — pure elementwise work), then the null
    direction as the largest column of the residual projector I - Q^T Q.
    Batched small LU/eigh factorizations are iterative and dominated
    two-view verification on the previous accelerator. Degenerate samples
    yield garbage hypotheses that MSAC scores out; refits use exact eigh."""
    m, n = A.shape[-2], A.shape[-1]
    rows = []
    for i in range(m):
        r = A[..., i, :]
        for q in rows:
            r = r - jnp.sum(r * q, -1, keepdims=True) * q
        r = r * jax.lax.rsqrt(
            jnp.maximum(jnp.sum(r * r, -1, keepdims=True), 1e-30))
        rows.append(r)
    Q = jnp.stack(rows, -2)                                   # (..., m, n)
    P = (jnp.eye(n, dtype=A.dtype)
         - jnp.einsum("...ki,...kj->...ij", Q, Q))            # projector
    best = jnp.argmax(jnp.sum(P * P, axis=-2), axis=-1)
    v = jnp.einsum("...ij,...j->...i", P,
                   jax.nn.one_hot(best, n, dtype=A.dtype))
    for _ in range(max(iters - 1, 0)):
        # re-project: squeezes out Gram-Schmidt rounding in the row span
        v = v - jnp.einsum("...kj,...k->...j", Q,
                           jnp.einsum("...ki,...i->...k", Q, v))
    v = v * jax.lax.rsqrt(jnp.maximum(jnp.sum(v * v, -1, keepdims=True),
                                      1e-30))
    return jnp.where(jnp.isfinite(v), v, 1.0 / (n ** 0.5))


def fundamental_8pt(x1: jax.Array, x2: jax.Array, mask: jax.Array | None = None,
                    exact: bool = True):
    """8-point fundamental matrix. x1, x2: (..., K>=8, 2); mask optional.

    Returns F (..., 3, 3), rank-2 enforced, unit norm, de-normalized.
    """
    if mask is None:
        mask = jnp.ones(x1.shape[:-1], bool)
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    ones = jnp.ones_like(u1)
    # row per correspondence: x2^T F x1 = 0
    A = jnp.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, ones], axis=-1)
    A = A * mask[..., None]
    f = _smallest_eigvec(A) if exact else _null_vec_fast(A)
    Fm = f.reshape(f.shape[:-1] + (3, 3))
    # rank-2 enforcement is LOAD-BEARING even for trial scoring: an
    # unconstrained 3x3 "F" has no epipolar geometry and its MSAC score can
    # beat every valid hypothesis (observed: registration collapse). Trials
    # use a closed-form projection; refits use exact SVD.
    Fm = enforce_rank2(Fm) if exact else _rank2_project_fast(Fm)
    Fm = jnp.swapaxes(T2, -1, -2) @ Fm @ T1
    norm = jnp.linalg.norm(Fm, axis=(-2, -1), keepdims=True)
    return Fm / jnp.maximum(norm, 1e-12)


def enforce_rank2(Fm: jax.Array) -> jax.Array:
    """Project (..., 3, 3) onto rank-2 by zeroing the smallest singular value."""
    U, S, Vt = jnp.linalg.svd(Fm)
    S = S.at[..., 2].set(0.0)
    return U @ (S[..., None] * Vt)


def _rank2_project_fast(F: jax.Array) -> jax.Array:
    """Approximate rank-2 projection of (..., 3, 3) without SVD: the smallest
    singular pair (u3, v3) via two closed-form inverse iterations (adjugate
    inv33) on F^T F and F F^T, then subtract sigma3 * u3 v3^T. Accurate when
    sigma3 << sigma2 (any usable hypothesis); degenerate samples produce bad
    models that MSAC scores out regardless."""

    def _smallest_vec(M):
        tr = jnp.einsum("...ii->...", M)[..., None, None]
        Minv = _inv33(M + (1e-6 * tr + 1e-25) * jnp.eye(3, dtype=M.dtype))
        v = jnp.sum(Minv, axis=-1)               # Minv @ ones
        v = v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)
        v = jnp.einsum("...ij,...j->...i", Minv, v)
        return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True), 1e-30)

    v3 = _smallest_vec(jnp.einsum("...ki,...kj->...ij", F, F))
    u3 = _smallest_vec(jnp.einsum("...ik,...jk->...ij", F, F))
    s3 = jnp.einsum("...i,...ij,...j->...", u3, F, v3)
    F2 = F - s3[..., None, None] * u3[..., :, None] * v3[..., None, :]
    return jnp.where(jnp.isfinite(F2), F2, 0.0)


def essential_8pt(x1n: jax.Array, x2n: jax.Array, mask: jax.Array | None = None,
                  exact: bool = True):
    """Essential matrix from >=8 K-normalized correspondences (z=1 plane
    coords). Enforces the (1,1,0) singular structure (exact path only; the
    RANSAC winner is re-constrained before pose recovery)."""
    E = fundamental_8pt(x1n, x2n, mask, exact=exact)
    if not exact:
        return E
    U, S, Vt = jnp.linalg.svd(E)
    s = 0.5 * (S[..., 0] + S[..., 1])
    Snew = jnp.stack([s, s, jnp.zeros_like(s)], axis=-1)
    return U @ (Snew[..., None] * Vt)


def homography_dlt(x1: jax.Array, x2: jax.Array, mask: jax.Array | None = None,
                   exact: bool = True):
    """DLT homography from >=4 correspondences: x2 ~ H x1. (..., K, 2)."""
    if mask is None:
        mask = jnp.ones(x1.shape[:-1], bool)
    x1n, T1 = _normalize_points(x1, mask)
    x2n, T2 = _normalize_points(x2, mask)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    o = jnp.ones_like(u1)
    z = jnp.zeros_like(u1)
    r1 = jnp.stack([-u1, -v1, -o, z, z, z, u2 * u1, u2 * v1, u2], axis=-1)
    r2 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], axis=-1)
    A = jnp.concatenate([r1 * mask[..., None], r2 * mask[..., None]], axis=-2)
    h = _smallest_eigvec(A) if exact else _null_vec_fast(A)
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    Hm = jnp.linalg.solve(T2, Hn @ T1)
    return Hm / jnp.maximum(jnp.abs(Hm[..., 2:3, 2:3]), 1e-12) * jnp.sign(
        jnp.where(Hm[..., 2:3, 2:3] == 0, 1.0, Hm[..., 2:3, 2:3]))


# ---------------------------------------------------------------------------
# Residuals
# ---------------------------------------------------------------------------

def sampson_error(F: jax.Array, x1: jax.Array, x2: jax.Array):
    """Squared Sampson distance. F: (..., 3, 3); x1, x2: (..., N, 2)."""
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    p2 = jnp.concatenate([x2, ones], axis=-1)
    Fx1 = jnp.einsum("...ij,...nj->...ni", F, p1)
    Ftx2 = jnp.einsum("...ji,...nj->...ni", F, p2)
    x2Fx1 = jnp.sum(p2 * Fx1, axis=-1)
    denom = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return x2Fx1**2 / jnp.maximum(denom, 1e-12)


def homography_error(H: jax.Array, x1: jax.Array, x2: jax.Array):
    """Squared transfer error |x2 - H x1|^2."""
    ones = jnp.ones_like(x1[..., :1])
    p1 = jnp.concatenate([x1, ones], axis=-1)
    Hx1 = jnp.einsum("...ij,...nj->...ni", H, p1)
    w = Hx1[..., 2]
    proj = Hx1[..., :2] / jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)[..., None]
    return jnp.sum((x2 - proj) ** 2, axis=-1)


# ---------------------------------------------------------------------------
# Static-batch RANSAC
# ---------------------------------------------------------------------------

def _draw_samples(key, num_trials, sample_size, n_points, weights):
    """(S, k) indices into the correspondence set, valid-weighted."""
    logits = jnp.where(weights > 0, 0.0, NEG_LOGIT)
    return jax.random.categorical(key, logits[None, :], axis=-1,
                                  shape=(num_trials, sample_size))


NEG_LOGIT = -1e9


@functools.partial(jax.jit, static_argnames=("solver", "residual_fn", "num_trials", "sample_size"))
def ransac(key, x1, x2, valid, solver, residual_fn, num_trials: int,
           sample_size: int, max_error: float):
    """Generic static-shape RANSAC. x1,x2: (N,2); valid: (N,) bool.

    Returns (model (3,3), inlier_mask (N,), num_inliers, best_score).
    Scoring is MSAC (truncated squared error), matching LO-RANSAC behavior
    more closely than plain inlier counting.
    """
    n = x1.shape[0]
    thr = max_error * max_error
    samples = _draw_samples(key, num_trials, sample_size, n, valid)
    sx1 = x1[samples]  # (S, k, 2)
    sx2 = x2[samples]
    # trials use the fast inverse-iteration null vector; the single refit
    # below uses exact eigh (hypothesis noise is absorbed by MSAC scoring)
    models = solver(sx1, sx2, None, False)  # (S, 3, 3)

    # preemptive two-stage MSAC (Nister): score EVERY trial on a small
    # correspondence subset, then rescore only the top trials on all N —
    # full S x N scoring was the dominant FLOP cost of verification
    SUB = 192
    TOP = 128
    if num_trials > TOP and n > SUB:
        sub_idx = _draw_samples(jax.random.fold_in(key, 1), 1, SUB, n,
                                valid)[0]  # (SUB,)
        errs_sub = residual_fn(models, x1[sub_idx][None], x2[sub_idx][None])
        errs_sub = jnp.where(valid[sub_idx][None, :], errs_sub, thr)
        pre_score = jnp.sum(jnp.minimum(errs_sub, thr), axis=-1)
        _, top_idx = jax.lax.top_k(-pre_score, TOP)
        models = models[top_idx]  # (TOP, 3, 3)
    errs = residual_fn(models, x1[None], x2[None])  # (S', N)
    errs = jnp.where(valid[None, :], errs, thr)
    score = jnp.sum(jnp.minimum(errs, thr), axis=-1)  # lower is better
    best = jnp.argmin(score)
    best_model = models[best]
    best_err = errs[best]
    inliers = (best_err < thr) & valid

    # Local optimization: refit on inliers (masked), keep if better
    refit = solver(x1[None], x2[None], inliers[None])[0]
    errs2 = jnp.where(valid, residual_fn(refit[None], x1[None], x2[None])[0], thr)
    score2 = jnp.sum(jnp.minimum(errs2, thr))
    use2 = (score2 < score[best]) & (jnp.sum(inliers) >= sample_size)
    model = jnp.where(use2, refit, best_model)
    err_f = jnp.where(use2, errs2, best_err)
    inl = (err_f < thr) & valid
    return model, inl, jnp.sum(inl), jnp.minimum(score2, score[best])


def _solver_with_mask(solver):
    """Adapt solver(x1, x2, mask, exact) to the ransac calling convention."""
    def run(x1, x2, mask=None, exact=True):
        return solver(x1, x2, mask, exact=exact)
    return run


@functools.partial(jax.jit, static_argnames=(
    "solver", "residual_fn", "max_num_trials", "min_num_trials",
    "sample_size", "confidence", "chunk"))
def ransac_adaptive(key, x1, x2, valid, solver, residual_fn,
                    max_num_trials: int, sample_size: int, max_error: float,
                    confidence: float = 0.999, min_num_trials: int = 30,
                    chunk: int = 128):
    """Confidence-adaptive RANSAC (COLMAP trial-count semantics,
    colmap.proto:23-29: confidence + min/max_num_trials, which the
    reference's kernel forwards to TwoViewGeometry::Estimate,
    sequential_matching.cc:56-60).

    Batched form: trials run in fixed-size CHUNKS inside a
    lax.while_loop — each chunk is one fully batched hypothesize+score pass
    (static shapes), and the loop stops once
    trials >= clamp(log(1-confidence)/log(1-inlier_ratio^k),
    min_num_trials, max_num_trials). Good pairs converge in one chunk;
    hard pairs run to max_num_trials like the static batch did.

    Returns (model, inlier_mask, num_inliers, best_score, trials_used).
    """
    n = x1.shape[0]
    dtype = x1.dtype
    thr = max_error * max_error
    n_valid = jnp.maximum(jnp.sum(valid), 1)
    max_chunks = -(-max_num_trials // chunk)
    log_nom = math.log(max(1.0 - confidence, 1e-12))

    SUB = 192
    TOP = 32
    use_pre = n > SUB

    def dyn_bound(best_ninl):
        ratio = jnp.clip(best_ninl.astype(dtype) / n_valid.astype(dtype),
                         0.0, 1.0)
        p_good = jnp.clip(ratio ** sample_size, 1e-12, 1.0 - 1e-9)
        return log_nom / jnp.log1p(-p_good)

    def cond(state):
        c, best_score, best_model, best_ninl = state
        trials = (c * chunk).astype(dtype)
        need = (trials < min_num_trials) | (trials < dyn_bound(best_ninl))
        return (c < max_chunks) & need

    def body(state):
        c, best_score, best_model, best_ninl = state
        kd = jax.random.fold_in(key, c)
        samples = _draw_samples(jax.random.fold_in(kd, 0), chunk,
                                sample_size, n, valid)
        models = solver(x1[samples], x2[samples], None, False)
        if use_pre:
            # preemptive two-stage MSAC (as in the static path): subset
            # score all trials, full-score only the top candidates
            sub_idx = _draw_samples(jax.random.fold_in(kd, 1), 1, SUB, n,
                                    valid)[0]
            errs_sub = residual_fn(models, x1[sub_idx][None],
                                   x2[sub_idx][None])
            errs_sub = jnp.where(valid[sub_idx][None, :], errs_sub, thr)
            pre_score = jnp.sum(jnp.minimum(errs_sub, thr), axis=-1)
            _, top_idx = jax.lax.top_k(-pre_score, min(TOP, chunk))
            models = models[top_idx]
        errs = residual_fn(models, x1[None], x2[None])
        errs = jnp.where(valid[None, :], errs, thr)
        score = jnp.sum(jnp.minimum(errs, thr), axis=-1)
        b = jnp.argmin(score)
        better = score[b] < best_score
        ninl_b = jnp.sum((errs[b] < thr) & valid).astype(jnp.int32)
        best_model = jnp.where(better, models[b], best_model)
        best_ninl = jnp.where(better, ninl_b, best_ninl)
        best_score = jnp.minimum(score[b], best_score)
        return c + 1, best_score, best_model, best_ninl

    init = (jnp.int32(0),
            jnp.asarray(thr * (n + 1), dtype),
            jnp.eye(3, dtype=dtype),
            jnp.int32(0))
    c_fin, best_score, best_model, _ = jax.lax.while_loop(cond, body, init)

    best_err = residual_fn(best_model[None], x1[None], x2[None])[0]
    best_err = jnp.where(valid, best_err, thr)
    inliers = (best_err < thr) & valid

    # Local optimization: refit on inliers (masked), keep if better
    refit = solver(x1[None], x2[None], inliers[None])[0]
    errs2 = jnp.where(valid, residual_fn(refit[None], x1[None], x2[None])[0],
                      thr)
    score2 = jnp.sum(jnp.minimum(errs2, thr))
    use2 = (score2 < best_score) & (jnp.sum(inliers) >= sample_size)
    model = jnp.where(use2, refit, best_model)
    err_f = jnp.where(use2, errs2, best_err)
    inl = (err_f < thr) & valid
    return (model, inl, jnp.sum(inl), jnp.minimum(score2, best_score),
            c_fin * chunk)


# ---------------------------------------------------------------------------
# Pose recovery from E
# ---------------------------------------------------------------------------

def _triangulate_simple(R, t, x1n, x2n):
    """Cheap triangulation for cheirality checks.

    R,t: cam1->cam2. x1n/x2n: (N,2) normalized coords. Returns (N,3) points
    in cam1 frame and depths in both cams.
    """
    # closed-form MIDPOINT triangulation (no per-point eigh): rays d1 from
    # cam1 origin, d2 from cam2 center c2 = -R^T t, both in cam1 frame;
    # solve the 2x2 normal equations of min |s d1 - (c2 + u d2)|^2
    ones = jnp.ones_like(x1n[:, :1])
    d1 = jnp.concatenate([x1n, ones], axis=-1)                 # (N, 3)
    d2 = jnp.concatenate([x2n, ones], axis=-1) @ R             # R^T [x2n;1]
    c2 = -(R.T @ t)
    a = jnp.sum(d1 * d1, axis=-1)
    b = jnp.sum(d1 * d2, axis=-1)
    c = jnp.sum(d2 * d2, axis=-1)
    e1 = d1 @ c2
    e2 = d2 @ c2
    det = a * c - b * b
    det = jnp.where(jnp.abs(det) < 1e-12, 1e-12, det)  # parallel rays
    s = (c * e1 - b * e2) / det
    u = (b * e1 - a * e2) / det
    X = 0.5 * (s[:, None] * d1 + c2 + u[:, None] * d2)         # (N, 3) cam1
    z1 = X[:, 2]
    z2 = (X @ R.T + t)[:, 2]
    return X, z1, z2


def pose_from_essential(E, x1n, x2n, inliers):
    """Decompose E into (R, t), resolving the 4-fold ambiguity by cheirality
    voting over inlier correspondences. Returns (qvec, tvec, tri_angle,
    num_good)."""
    U, _, Vt = jnp.linalg.svd(E)
    # ensure proper rotations
    U = U * jnp.sign(jnp.linalg.det(U))
    Vt = Vt * jnp.sign(jnp.linalg.det(Vt))
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    def score(R, tv):
        X, z1, z2 = _triangulate_simple(R, tv, x1n, x2n)
        ok = (z1 > 1e-6) & (z2 > 1e-6) & inliers
        # triangulation angles at accepted points
        c2 = -R.T @ tv  # cam2 center in cam1 frame
        ang = geom.triangulation_angle(jnp.zeros(3), c2, X)
        return jnp.sum(ok), ok, ang

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    counts = []
    oks = []
    angs = []
    for R, tv in cands:
        c, ok, ang = score(R, tv)
        counts.append(c)
        oks.append(ok)
        angs.append(ang)
    counts = jnp.stack(counts)
    best = jnp.argmax(counts)
    Rb = jnp.stack([c[0] for c in cands])[best]
    tb = jnp.stack([c[1] for c in cands])[best]
    okb = jnp.stack(oks)[best]
    angb = jnp.stack(angs)[best]
    # median angle over good points (masked median via sort)
    ang_sorted = jnp.sort(jnp.where(okb, angb, jnp.inf))
    ngood = jnp.sum(okb)
    med_idx = jnp.clip(ngood // 2, 0, angb.shape[0] - 1)
    tri_angle = jnp.where(ngood > 0, ang_sorted[med_idx], 0.0)
    return geom.rotmat_to_quat(Rb), tb, tri_angle, counts[best]


# ---------------------------------------------------------------------------
# Pose from H (planar / panoramic configurations)
# ---------------------------------------------------------------------------

def decompose_homography(Hc):
    """Candidate (R, t, n) triples from a CALIBRATED homography.

    Constructive SVD decomposition (Ma-Soatto-Kosecka, "An Invitation to 3-D
    Vision" Thm 5.19): scale by the middle singular value, build the two
    in-plane directions u1/u2 from the singular structure of H^T H, recover
    R from the frame correspondence and t = (H - R) n. Returns stacked
    (4,3,3) R, (4,3) t (plane-relative scale), (4,3) n. Pure-rotation H
    degenerates gracefully: u1 = u2 and t -> 0.
    """
    _, S0, _ = jnp.linalg.svd(Hc)
    H = Hc / jnp.maximum(S0[1], 1e-12)
    _, S, Vt = jnp.linalg.svd(H)
    V = jnp.swapaxes(Vt, -1, -2)
    V = V * jnp.sign(jnp.linalg.det(V))
    v1, v2, v3 = V[:, 0], V[:, 1], V[:, 2]
    s1, s3 = S[0], S[2]
    denom = jnp.maximum(s1 * s1 - s3 * s3, 1e-12)
    a = jnp.sqrt(jnp.clip((1.0 - s3 * s3) / denom, 0.0, None))
    b = jnp.sqrt(jnp.clip((s1 * s1 - 1.0) / denom, 0.0, None))
    u1 = a * v1 + b * v3
    u2 = a * v1 - b * v3

    def sol(u):
        nvec = jnp.cross(v2, u)
        U1 = jnp.stack([v2, u, nvec], axis=1)
        W = jnp.stack([H @ v2, H @ u, jnp.cross(H @ v2, H @ u)], axis=1)
        R = W @ U1.T
        t = (H - R) @ nvec
        return R, t, nvec

    R1, t1, n1 = sol(u1)
    R2, t2, n2 = sol(u2)
    Rs = jnp.stack([R1, R1, R2, R2])
    ts = jnp.stack([t1, -t1, t2, -t2])
    ns = jnp.stack([n1, -n1, n2, -n2])
    return Rs, ts, ns


def pose_from_homography(H, K1, K2, x1n, x2n, inliers):
    """Relative pose for PLANAR_OR_PANORAMIC pairs (COLMAP
    PoseFromHomographyMatrix, reached through TwoViewGeometry pose recovery
    that the reference's kernel invokes, sequential_matching.cc:94-101):
    decompose K2^-1 H K1, resolve the 4-fold ambiguity by cheirality voting
    over inlier correspondences. Returns (qvec, tvec (unit; ZERO when the
    pair is panoramic), tri_angle, num_good)."""
    Hc = _inv33(K2) @ H @ K1
    # sign-normalize: valid planar correspondences have p2 . (Hc p1) > 0
    ones = jnp.ones_like(x1n[:, :1])
    p1 = jnp.concatenate([x1n, ones], axis=-1)
    p2 = jnp.concatenate([x2n, ones], axis=-1)
    s = jnp.sum(jnp.where(inliers, jnp.sum(p2 * (p1 @ Hc.T), -1), 0.0))
    Hc = Hc * jnp.where(s < 0, -1.0, 1.0)
    Rs, ts, ns = decompose_homography(Hc)
    t_norms = jnp.linalg.norm(ts, axis=-1)
    tu = ts / jnp.maximum(t_norms, 1e-12)[:, None]

    def score(R, tv):
        X, z1, z2 = _triangulate_simple(R, tv, x1n, x2n)
        ok = (z1 > 1e-6) & (z2 > 1e-6) & inliers
        c2 = -R.T @ tv
        ang = geom.triangulation_angle(jnp.zeros(3), c2, X)
        return jnp.sum(ok), ok, ang

    counts, oks, angs = jax.vmap(score)(Rs, tu)
    best = jnp.argmax(counts)
    Rb, tb, okb, angb = Rs[best], tu[best], oks[best], angs[best]
    # panoramic: the plane-relative baseline vanishes -> pure rotation
    panoramic = t_norms[best] < 1e-3
    tb = jnp.where(panoramic, jnp.zeros(3, tb.dtype), tb)
    ang_sorted = jnp.sort(jnp.where(okb, angb, jnp.inf))
    ngood = jnp.sum(okb)
    med_idx = jnp.clip(ngood // 2, 0, angb.shape[0] - 1)
    tri_angle = jnp.where((ngood > 0) & ~panoramic, ang_sorted[med_idx], 0.0)
    return geom.rotmat_to_quat(Rb), tb, tri_angle, counts[best]


# ---------------------------------------------------------------------------
# Watermark detection (COLMAP DetectWatermark semantics)
# ---------------------------------------------------------------------------

def detect_watermark(x1, x2, inliers, size1, size2, max_error: float,
                     min_inlier_ratio: float = 0.7,
                     border_size: float = 0.1,
                     max_candidates: int = 128,
                     key=None):
    """True iff the pair's inliers look like a static overlay: a pure 2D
    translation supported by >= min_inlier_ratio of the inliers, with the
    supporting matches concentrated in the image border region (COLMAP
    TwoViewGeometry config enum 7, serialized by the reference's kernel —
    the config field at io.cc:237).

    Batched form of the 1-point translation RANSAC: every (subsampled)
    inlier's displacement is a hypothesis; one (C, N) residual pass scores them all.
    size1/size2: (width, height) per image.
    """
    if key is None:
        key = jax.random.PRNGKey(7)
    d = x2 - x1                                        # (N, 2)
    thr = max_error * max_error
    cand_idx = _draw_samples(key, 1, max_candidates, x1.shape[0],
                             inliers)[0]               # (C,)
    cand = d[cand_idx]                                 # (C, 2)
    err = jnp.sum((cand[:, None, :] - d[None, :, :]) ** 2, -1)  # (C, N)
    votes = jnp.sum((err < thr) & inliers[None, :], axis=-1)
    votes = jnp.where(inliers[cand_idx], votes, -1)    # candidates must be inliers
    best = jnp.argmax(votes)
    trans_inl = (err[best] < thr) & inliers
    n_trans = jnp.sum(trans_inl)
    n_inl = jnp.maximum(jnp.sum(inliers), 1)

    def in_border(x, size):
        bx = border_size * size[0]
        by = border_size * size[1]
        return ((x[:, 0] < bx) | (x[:, 0] > size[0] - bx)
                | (x[:, 1] < by) | (x[:, 1] > size[1] - by))

    border = trans_inl & in_border(x1, size1) & in_border(x2, size2)
    frac_trans = n_trans.astype(x1.dtype) / n_inl.astype(x1.dtype)
    frac_border = (jnp.sum(border).astype(x1.dtype)
                   / jnp.maximum(n_trans, 1).astype(x1.dtype))
    return (frac_trans >= min_inlier_ratio) & (frac_border >= min_inlier_ratio)


# ---------------------------------------------------------------------------
# Full two-view estimation (COLMAP Estimate semantics)
# ---------------------------------------------------------------------------

@functools.partial(
    jax.jit,
    static_argnames=("num_trials", "calibrated", "min_num_trials",
                     "confidence", "watermark_detection"),
)
@f32_matmuls
def estimate_two_view_geometry(
    key,
    x1, x2,            # (N, 2) pixel coords of matched keypoints
    valid,             # (N,) bool
    K1, K2,            # (3, 3) calibration matrices
    calibrated: bool = True,
    max_error: float = 4.0,
    min_num_inliers: int = 15,
    min_inlier_ratio: float = 0.25,
    num_trials: int = 512,          # max_num_trials (colmap.proto:29)
    min_num_trials: int = 30,       # colmap.proto:26
    confidence: float = 0.999,      # colmap.proto:23
    watermark_detection: bool = True,
    size1=None, size2=None,         # (2,) image (width, height); None -> 2*pp
) -> TwoViewGeometry:
    """Estimate E/F/H + config + relative pose for one verified pair.

    COLMAP decision logic (TwoViewGeometry::Estimate, which the reference's
    kernel calls at sequential_matching.cc:94-101):
      - estimate F (always), H (always), E (if calibrated), each with
        confidence-adaptive trial counts (min/max_num_trials honored)
      - config CALIBRATED if E has comparable support to F, else UNCALIBRATED
      - PLANAR_OR_PANORAMIC if H explains >= 0.8 of the best epipolar
        inliers; pose then comes from the H DECOMPOSITION (not E)
      - WATERMARK if the H inliers are a border-concentrated 2D translation
      - DEGENERATE if too few inliers

    Precision: float32 matmuls at the highest precision (f32_matmuls).
    """
    kF, kH, kE = jax.random.split(key, 3)
    n = x1.shape[0]

    F, inl_F, n_F, _, _ = ransac_adaptive(
        kF, x1, x2, valid, _solver_with_mask(fundamental_8pt), sampson_error,
        num_trials, 8, max_error, confidence=confidence,
        min_num_trials=min_num_trials)
    # the winner may be an unconstrained trial model (fast path skips the
    # per-trial SVD); project onto rank-2 once here
    F = enforce_rank2(F)
    F = F / jnp.maximum(jnp.linalg.norm(F), 1e-12)
    H, inl_H, n_H, _, _ = ransac_adaptive(
        kH, x1, x2, valid, _solver_with_mask(homography_dlt),
        homography_error, num_trials, 4, max_error, confidence=confidence,
        min_num_trials=min_num_trials)

    # Normalized coords for E + pose
    f1 = 0.5 * (K1[0, 0] + K1[1, 1])
    f2 = 0.5 * (K2[0, 0] + K2[1, 1])
    x1n = (x1 - K1[:2, 2]) / jnp.array([K1[0, 0], K1[1, 1]])
    x2n = (x2 - K2[:2, 2]) / jnp.array([K2[0, 0], K2[1, 1]])

    if calibrated:
        # threshold in normalized units
        thr_n = max_error / (0.5 * (f1 + f2))
        E, inl_E, n_E, _, _ = ransac_adaptive(
            kE, x1n, x2n, valid, _solver_with_mask(essential_8pt),
            sampson_error, num_trials, 8, thr_n, confidence=confidence,
            min_num_trials=min_num_trials)
    else:
        E = K2.T @ F @ K1
        inl_E, n_E = inl_F, n_F

    use_E = jnp.asarray(calibrated) & (n_E.astype(jnp.float32) >= 0.95 * n_F.astype(jnp.float32))
    epi_inl = jnp.where(use_E, inl_E, inl_F)
    n_epi = jnp.where(use_E, n_E, n_F)

    planar = n_H.astype(jnp.float32) > 0.8 * n_epi.astype(jnp.float32)
    enough = (n_epi >= min_num_inliers) & (
        n_epi.astype(jnp.float32)
        >= min_inlier_ratio * jnp.maximum(jnp.sum(valid), 1).astype(jnp.float32)
    )

    config = jnp.where(
        ~enough, DEGENERATE,
        jnp.where(planar, PLANAR_OR_PANORAMIC, jnp.where(use_E, CALIBRATED, UNCALIBRATED)),
    ).astype(jnp.int32)

    if watermark_detection:
        s1 = (2.0 * K1[:2, 2] if size1 is None else jnp.asarray(size1))
        s2 = (2.0 * K2[:2, 2] if size2 is None else jnp.asarray(size2))
        wm = detect_watermark(x1, x2, inl_H, s1, s2, max_error,
                              key=jax.random.fold_in(key, 7))
        config = jnp.where(enough & wm, WATERMARK, config).astype(jnp.int32)
        planar = planar & ~wm

    # Pose from E over epipolar inliers (always computed; gated by config)
    E_pose = jnp.where(use_E, E, K2.T @ F @ K1)
    # re-enforce essential structure for pose recovery
    Ue, Se, Vte = jnp.linalg.svd(E_pose)
    s = 0.5 * (Se[0] + Se[1])
    E_pose = Ue @ (jnp.array([s, s, 0.0])[:, None] * Vte)
    qvec_e, tvec_e, tri_angle_e, _ = pose_from_essential(E_pose, x1n, x2n,
                                                         epi_inl)
    # PLANAR_OR_PANORAMIC pairs take their pose from the H decomposition
    # (COLMAP PoseFromHomographyMatrix); H inliers drive the pair then too
    qvec_h, tvec_h, tri_angle_h, _ = pose_from_homography(H, K1, K2,
                                                          x1n, x2n, inl_H)
    qvec = jnp.where(planar, qvec_h, qvec_e)
    tvec = jnp.where(planar, tvec_h, tvec_e)
    tri_angle = jnp.where(planar, tri_angle_h, tri_angle_e)
    pair_inl = jnp.where(planar, inl_H, epi_inl)
    n_pair = jnp.where(planar, n_H, n_epi)

    inlier_mask = pair_inl & enough
    return TwoViewGeometry(
        config=config,
        E=E_pose,
        F=F,
        H=H,
        qvec=qvec,
        tvec=tvec,
        tri_angle=tri_angle,
        inlier_mask=inlier_mask,
        num_inliers=jnp.where(enough, n_pair, 0).astype(jnp.int32),
    )


@functools.partial(
    jax.jit,
    static_argnames=("num_trials", "calibrated", "max_models",
                     "min_num_trials", "confidence", "watermark_detection"),
)
@f32_matmuls
def estimate_two_view_geometry_multiple(
    key,
    x1, x2,            # (N, 2) pixel coords of matched keypoints
    valid,             # (N,) bool
    K1, K2,            # (3, 3) calibration matrices
    calibrated: bool = True,
    max_error: float = 4.0,
    min_num_inliers: int = 15,
    min_inlier_ratio: float = 0.25,
    num_trials: int = 512,
    max_models: int = 3,
    min_num_trials: int = 30,
    confidence: float = 0.999,
    watermark_detection: bool = True,
    size1=None, size2=None,
) -> TwoViewGeometry:
    """COLMAP ``TwoViewGeometry::EstimateMultiple`` semantics (the
    reference's multiple_models flag, sequential_matching.cc:94-100 +
    colmap.proto:38): greedily estimate a geometry, remove its inliers,
    re-estimate on the remainder, up to ``max_models`` rounds.

    Batched form: a lax.scan of the single-model estimator with a
    shrinking validity mask — fixed trip count, masked convergence. Returns
    a TwoViewGeometry pytree with a leading ``max_models`` axis; round r is
    meaningful where ``num_inliers[r] > 0``. If >= 2 rounds found support,
    callers should treat the pair's config as MULTIPLE (COLMAP behavior).
    """
    def round_fn(carry, k):
        remaining = carry
        g = estimate_two_view_geometry(
            k, x1, x2, remaining, K1, K2, calibrated=calibrated,
            max_error=max_error, min_num_inliers=min_num_inliers,
            min_inlier_ratio=min_inlier_ratio, num_trials=num_trials,
            min_num_trials=min_num_trials, confidence=confidence,
            watermark_detection=watermark_detection,
            size1=size1, size2=size2)
        found = g.num_inliers >= min_num_inliers
        # zero out failed rounds so downstream sees a clean miss
        g = g._replace(
            inlier_mask=g.inlier_mask & found,
            num_inliers=jnp.where(found, g.num_inliers, 0),
            config=jnp.where(found, g.config, DEGENERATE).astype(jnp.int32))
        return remaining & ~g.inlier_mask, g

    keys = jax.random.split(key, max_models)
    _, models = jax.lax.scan(round_fn, valid, keys)
    return models
