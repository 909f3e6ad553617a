"""Bundle adjustment: Levenberg-Marquardt with Schur complement, on device.

Rebuilds the capability of COLMAP's Ceres/PBA bundle adjustment as driven by
the reference's mapping kernel (integration/op_cpp/
incremental_mapping.cc:59-139: AdjustGlobalBundle / IterativeLocal/Global
Refinement) — but as a dense-block, static-shape LM solver built from
batched matmuls instead of a sparse CPU solver:

- observations are grouped BY POINT with a fixed max track length T: all
  Jacobians (closed form) evaluate as one (P, T, ...) elementwise batch
- per-point 3x3 landmark blocks V_j invert in batch (closed-form adjugate)
- the reduced camera system (Schur complement S = U - B V^{-1} B^T) is built
  with chunked einsums — scatter-by-camera is a one_hot matmul — and solved
  densely (6-8 params x M cameras, M <= ~10^2, so S is a few-hundred-square
  dense matrix: trivial on the device)
- the LM loop (damping adaptation, accept/reject) runs fully in-graph via
  lax.while_loop -> zero host round-trips per iteration

Camera model inside BA: per-image SIMPLE_RADIAL (pose 6 + log-focal + k), the
model the extraction stage synthesizes (reference extraction_op.cc:43-64).
Residuals are in PIXELS with a smooth robust loss, matching COLMAP's
convergence criteria semantics.

Multi-chip: points partition across devices (each device owns a point shard
and its observations); U, g_c, S are psum-reduced across devices — see
scanner_colmap_tpu/parallel/dist_ba.py.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.ops.linalg3 import f32_matmuls, inv33 as _inv33


class BundleParams(NamedTuple):
    """Optimizable state. M = max cameras (images), P = max points."""
    qvec: jax.Array    # (M, 4)
    tvec: jax.Array    # (M, 3)
    log_f: jax.Array   # (M,) log focal length (pixels)
    k1: jax.Array      # (M,) radial distortion
    xyz: jax.Array     # (P, 3)


class BundleObs(NamedTuple):
    """Observations grouped by point, padded to track length T."""
    cam_idx: jax.Array   # (P, T) int32 camera index per observation
    uv: jax.Array        # (P, T, 2) pixel coords (principal-point NOT removed)
    valid: jax.Array     # (P, T) bool


class BundleConfig(NamedTuple):
    cc: jax.Array          # (M, 2) principal points (held fixed)
    cam_valid: jax.Array   # (M,) participating cameras
    pose_free: jax.Array   # (M, 6) per-parameter pose freedom mask (float 0/1):
                           # gauge fixing COLMAP-style = zero rows for the
                           # first image + zero one tvec component of a second
    pt_valid: jax.Array    # (P,)
    refine_focal: jax.Array      # () bool
    refine_distortion: jax.Array # () bool
    loss_scale: jax.Array  # () robust-loss scale in pixels (Cauchy)
    # Gaussian priors on intrinsics (weights in cost units per unit^2; 0 =
    # off). Per-image focal+distortion on weak-parallax data is
    # near-degenerate with scene depth — a modest prior pins the gauge the
    # data cannot (COLMAP leans on better-conditioned real imagery instead).
    prior_log_f: jax.Array       # (M,) prior focal (log px)
    prior_k1: jax.Array          # (M,)
    prior_weight_f: jax.Array    # (M,) per-slot weight (shared-camera groups
    prior_weight_k: jax.Array    # (M,)  divide the physical camera's prior)
    # shared-camera intrinsic tying: slot -> LEADER slot of its physical
    # camera. None (default) = per-image intrinsics. When set, the Schur
    # solve aggregates the intrinsic Jacobian columns of each group into the
    # leader's column (an exact in-solve equality constraint — COLMAP's
    # shared-camera parameter block), replacing the old post-hoc averaging.
    cam_group: jax.Array | None = None   # (M,) int32


def make_pose_free(M: int, fixed_full=(), fixed_tvec0=()):
    """Standard gauge mask: fully fix images in `fixed_full`, fix the x
    translation of images in `fixed_tvec0` (COLMAP's 7-dof gauge).
    Returns host numpy (callers pass it into jitted solves)."""
    import numpy as np

    m = np.ones((M, 6), np.float32)
    for i in fixed_full:
        m[i] = 0.0
    for i in fixed_tvec0:
        m[i, 3] = 0.0
    return m


NUM_CAM_PARAMS = 8  # aa(3) + t(3) + log_f(1) + k1(1)


# ---------------------------------------------------------------------------
# Residuals + closed-form Jacobians
# ---------------------------------------------------------------------------

def _project_residual(params: BundleParams, obs: BundleObs, cfg: BundleConfig):
    """Residuals r (P, T, 2) in pixels and validity (P, T).

    Cheirality: observations with z <= 0 get zero weight (they would
    otherwise pull the solve toward reflections).
    """
    q = params.qvec[obs.cam_idx]          # (P, T, 4)
    t = params.tvec[obs.cam_idx]          # (P, T, 3)
    f = jnp.exp(params.log_f)[obs.cam_idx]
    k1 = params.k1[obs.cam_idx]
    cc = cfg.cc[obs.cam_idx]              # (P, T, 2)

    y = geom.quat_rotate(q, params.xyz[:, None, :])  # (P, T, 3) rotated
    x_cam = y + t
    z = x_cam[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-8, jnp.where(z < 0, -1e-8, 1e-8), z)
    xn = x_cam[..., :2] / zs[..., None]
    r2 = jnp.sum(xn * xn, axis=-1)
    d = xn * (1.0 + k1[..., None] * r2[..., None])
    proj = f[..., None] * d + cc
    r = proj - obs.uv
    ok = obs.valid & (z > 1e-6)
    ok &= cfg.pt_valid[:, None]
    ok &= cfg.cam_valid[obs.cam_idx]
    return r, ok, (y, x_cam, zs, xn, r2, f, k1)


def _jacobians(params: BundleParams, obs: BundleObs, cfg: BundleConfig):
    """Closed-form J_cam (P,T,2,8) and J_pt (P,T,2,3) + residuals/weights."""
    r, ok, (y, x_cam, zs, xn, r2, f, k1) = _project_residual(params, obs, cfg)

    inv_z = 1.0 / zs
    # d xn / d x_cam : (P,T,2,3)
    zero = jnp.zeros_like(inv_z)
    dxn_dxc = jnp.stack([
        jnp.stack([inv_z, zero, -xn[..., 0] * inv_z], axis=-1),
        jnp.stack([zero, inv_z, -xn[..., 1] * inv_z], axis=-1),
    ], axis=-2)

    # d d / d xn = (1 + k r2) I + 2 k xn xn^T : (P,T,2,2)
    a = 1.0 + k1[..., None, None] * r2[..., None, None]
    dd_dxn = a * jnp.eye(2, dtype=r.dtype) + 2.0 * k1[..., None, None] * (
        xn[..., :, None] * xn[..., None, :])

    # chain to x_cam: f * dd_dxn @ dxn_dxc : (P,T,2,3)
    dpx_dxc = f[..., None, None] * jnp.einsum("...ij,...jk->...ik", dd_dxn, dxn_dxc)

    # rotation (left-perturbation): d x_cam / d aa = -[y]x
    J_aa = -jnp.einsum("...ij,...jk->...ik", dpx_dxc, geom.skew(y))
    J_t = dpx_dxc
    # focal (log): d proj / d log f = f * d
    d_vec = xn * (1.0 + k1[..., None] * r2[..., None])
    J_logf = (f[..., None] * d_vec)[..., None]  # (P,T,2,1)
    J_k1 = (f[..., None] * xn * r2[..., None])[..., None]

    J_logf = J_logf * jnp.where(cfg.refine_focal, 1.0, 0.0)
    J_k1 = J_k1 * jnp.where(cfg.refine_distortion, 1.0, 0.0)

    J_cam = jnp.concatenate([J_aa, J_t, J_logf, J_k1], axis=-1)  # (P,T,2,8)

    # points: d x_cam / d X = R
    R = geom.quat_to_rotmat(params.qvec)[obs.cam_idx]  # (P,T,3,3)
    J_pt = jnp.einsum("...ij,...jk->...ik", dpx_dxc, R)

    # gauge fixing: zero Jacobian columns of frozen pose params (per-param);
    # intrinsics columns stay live (refine flags already applied above)
    free8 = jnp.concatenate([
        cfg.pose_free.astype(J_cam.dtype),
        jnp.ones((cfg.pose_free.shape[0], 2), J_cam.dtype)], axis=1)  # (M, 8)
    J_cam = J_cam * free8[obs.cam_idx][..., None, :]

    # robust (Cauchy) weights on residual norm: w = 1 / (1 + (|r|/s)^2)
    s = cfg.loss_scale
    rn2 = jnp.sum(r * r, axis=-1)
    w = 1.0 / (1.0 + rn2 / (s * s))
    w = jnp.where(ok, w, 0.0)
    return r, w, J_cam, J_pt, ok


def robust_cost(params: BundleParams, obs: BundleObs, cfg: BundleConfig,
                axis_name=None):
    """Total Cauchy cost: sum s^2/2 * log(1 + |r|^2/s^2), plus raw stats.

    With axis_name set (points sharded over a mesh axis inside shard_map),
    the sums reduce across devices via psum so every shard sees global values.
    """
    r, ok, _ = _project_residual(params, obs, cfg)
    rn2 = jnp.sum(r * r, axis=-1)
    s2 = cfg.loss_scale**2
    c = 0.5 * s2 * jnp.log1p(rn2 / s2)
    cost = jnp.sum(jnp.where(ok, c, 0.0))
    n = jnp.sum(ok)
    err_sum = jnp.sum(jnp.where(ok, jnp.sqrt(rn2), 0.0))
    if axis_name is not None:
        cost = jax.lax.psum(cost, axis_name)
        n = jax.lax.psum(n, axis_name)
        err_sum = jax.lax.psum(err_sum, axis_name)
    # prior term added post-psum: camera params are replicated, so this
    # contributes exactly once regardless of sharding
    cost = cost + 0.5 * jnp.sum(
        cfg.prior_weight_f * (params.log_f - cfg.prior_log_f) ** 2
        + cfg.prior_weight_k * (params.k1 - cfg.prior_k1) ** 2)
    n = jnp.maximum(n, 1)
    return cost, err_sum / n, n


# ---------------------------------------------------------------------------
# One LM solve step (given damping), fully batched
# ---------------------------------------------------------------------------

def _build_normal_eqs(params, obs, cfg, lam, chunk: int, axis_name=None):
    """Build Schur system: returns (S (MC, MC), rhs (MC,), Vinv (P,3,3),
    g_p (P,3), W stored implicitly via recompute in backsub).

    MC = M * NUM_CAM_PARAMS.
    """
    M = params.qvec.shape[0]
    P = params.xyz.shape[0]
    MC = M * NUM_CAM_PARAMS

    r, w, J_cam, J_pt, ok = _jacobians(params, obs, cfg)
    # weighted blocks
    wJc = J_cam * w[..., None, None]
    wJp = J_pt * w[..., None, None]

    # V_j = sum_t Jp^T W Jp  (P,3,3); g_p = -Jp^T W r
    V = jnp.einsum("ptri,ptrj->pij", wJp, J_pt)
    g_p = -jnp.einsum("ptri,ptr->pi", wJp, r)
    # multiplicative damping on diagonal (Ceres-style)
    Vd = V + lam * jnp.eye(3, dtype=V.dtype) * jnp.maximum(
        jnp.einsum("pii->p", V), 1e-6)[:, None, None] / 3.0
    Vd = Vd + 1e-8 * jnp.eye(3, dtype=V.dtype)
    Vinv = _inv33(Vd)

    # camera-side: U (M,8,8), g_c (M,8) via segment sums — as fast as the
    # one-hot einsum on the previous accelerator, and avoids the (P, T, M)
    # one-hot (200 MB at M=256/P=49k); the one-hot remains only where the B coupling blocks
    # genuinely need the dense scatter (chunk_body below)
    U = _segsum_cam(jnp.einsum("ptri,ptrj->ptij", wJc, J_cam),
                    obs.cam_idx, M)
    g_c = -_segsum_cam(jnp.einsum("ptri,ptr->pti", wJc, r), obs.cam_idx, M)

    # W_j blocks: per-obs (8,3) coupling; B_j = scatter-by-camera (M,8,3)
    # S_pt = sum_j B_j Vinv_j B_j^T ; rhs_pt = sum_j B_j Vinv_j g_p_j
    def chunk_body(carry, idx):
        S_acc, rhs_acc = carry
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, idx * chunk, chunk, 0)
        Wc = jnp.einsum("ptri,ptrj->ptij", sl(wJc), sl(J_pt))  # (c,T,8,3)
        # per-chunk one-hot: (c, T, M) lives only inside this scan step
        oh = jax.nn.one_hot(sl(obs.cam_idx), M, dtype=r.dtype)
        B = jnp.einsum("ptm,ptij->pmij", oh, Wc)  # (c,M,8,3)
        B = B.reshape(B.shape[0], MC, 3)
        BV = jnp.einsum("pai,pij->paj", B, sl(Vinv))
        S_acc = S_acc + jnp.einsum("pai,pbi->ab", BV, B)
        rhs_acc = rhs_acc + jnp.einsum("pai,pi->a", BV, sl(g_p))
        return (S_acc, rhs_acc), None

    n_chunks = P // chunk
    S0 = jnp.zeros((MC, MC), dtype=r.dtype)
    rhs0 = jnp.zeros((MC,), dtype=r.dtype)
    (S_pt, rhs_pt), _ = jax.lax.scan(
        chunk_body, (S0, rhs0), jnp.arange(n_chunks))

    if axis_name is not None:
        # camera-side systems reduce over the point-sharded mesh axis;
        # every shard then solves the identical replicated camera system
        U, g_c, S_pt, rhs_pt = jax.lax.psum((U, g_c, S_pt, rhs_pt), axis_name)

    U = U.reshape(MC // NUM_CAM_PARAMS, NUM_CAM_PARAMS, NUM_CAM_PARAMS)
    # intrinsic priors: quadratic pull toward (prior_log_f, prior_k1)
    wf = cfg.prior_weight_f
    wk = cfg.prior_weight_k
    U = U.at[:, 6, 6].add(wf)
    U = U.at[:, 7, 7].add(wk)
    g_c = g_c.at[:, 6].add(-wf * (params.log_f - cfg.prior_log_f))
    g_c = g_c.at[:, 7].add(-wk * (params.k1 - cfg.prior_k1))
    Ud = U + lam * jnp.eye(NUM_CAM_PARAMS, dtype=U.dtype) * jnp.maximum(
        jnp.einsum("mii->m", U), 1e-6)[:, None, None] / NUM_CAM_PARAMS
    # block-diagonal U into dense MC x MC (einsum scatter, no python loop)
    S = -S_pt
    eye_m = jnp.eye(M, dtype=U.dtype)
    S = S + jnp.einsum("mn,mij->minj", eye_m, Ud).reshape(MC, MC)
    rhs = g_c.reshape(MC) - rhs_pt

    # per-parameter freedom: pose params per the gauge mask; intrinsic params
    # need a valid camera + the refine flag
    intr8 = jnp.stack([cfg.refine_focal, cfg.refine_distortion])
    free8 = jnp.concatenate([
        cfg.pose_free > 0,
        jnp.broadcast_to(intr8[None, :], (M, 2)),
    ], axis=1)  # (M, 8) bool
    pmask = (free8 & cfg.cam_valid[:, None]).reshape(MC)
    S = jnp.where(pmask[:, None] & pmask[None, :], S, 0.0)
    S = S + jnp.where(pmask, 0.0, 1.0)[:, None] * jnp.eye(MC, dtype=S.dtype)
    rhs = jnp.where(pmask, rhs, 0.0)
    return S, rhs, Vinv, g_p, (r, w, J_cam, J_pt, pmask)


def _intrinsic_tie_matrix(cam_group, M: int, dtype):
    """Column-merging matrix A (MC, MC) for shared-camera intrinsics:
    pose columns stay per-slot; the intrinsic columns (log_f, k1) of every
    slot redirect to its group LEADER's columns. The reduced system is
    A^T S A with dc = A dc' — an exact equality constraint, so tied slots
    receive identical updates and stay bitwise equal through the solve."""
    k = jnp.arange(NUM_CAM_PARAMS)
    slot = jnp.arange(M)
    col_pose = slot[:, None] * NUM_CAM_PARAMS + k[None, :]
    col_tied = cam_group[:, None] * NUM_CAM_PARAMS + k[None, :]
    col = jnp.where(k[None, :] < 6, col_pose, col_tied)      # (M, 8)
    return jax.nn.one_hot(col.reshape(-1), M * NUM_CAM_PARAMS, dtype=dtype)


def _apply_delta(params: BundleParams, dc: jax.Array, dp: jax.Array,
                 cfg: BundleConfig) -> BundleParams:
    M = params.qvec.shape[0]
    dc = dc.reshape(M, NUM_CAM_PARAMS)
    valid = cfg.cam_valid.astype(dc.dtype)[:, None]
    if cfg.cam_group is not None:
        # tied slots apply the group's intrinsic delta even while invalid
        # (not yet registered), so group intrinsics stay exactly equal.
        # O(M) segment reduction — the (M, M) same-group matrix this
        # replaces was quadratic per LM trial at 1k-10k tied cameras
        grp = cfg.cam_group.astype(jnp.int32)
        grp_alive = jax.ops.segment_max(
            cfg.cam_valid.astype(jnp.int32), grp,
            num_segments=M)[grp] > 0
        intr_mask = grp_alive.astype(dc.dtype)[:, None]
    else:
        intr_mask = valid
    free8 = jnp.concatenate([
        cfg.pose_free.astype(dc.dtype), jnp.ones((M, 2), dc.dtype)], axis=1)
    vmask8 = jnp.concatenate([jnp.broadcast_to(valid, (M, 6)),
                              jnp.broadcast_to(intr_mask, (M, 2))], axis=1)
    dc = dc * free8 * vmask8
    dq = geom.angle_axis_to_quat(dc[:, 0:3])
    q_new = geom.quat_normalize(geom.quat_mul(dq, params.qvec))
    t_new = params.tvec + dc[:, 3:6]
    f_new = params.log_f + dc[:, 6]
    k_new = params.k1 + dc[:, 7]
    xyz_new = params.xyz + dp * cfg.pt_valid[:, None].astype(dp.dtype)
    return BundleParams(q_new, t_new, f_new, k_new, xyz_new)


def _lm_trial(params, obs, cfg, lam, chunk, axis_name=None):
    """Solve the damped system once; return candidate params."""
    S, rhs, Vinv, g_p, (r, w, J_cam, J_pt, pmask) = _build_normal_eqs(
        params, obs, cfg, lam, chunk, axis_name)
    if cfg.cam_group is not None:
        # exact shared-camera intrinsics: merge tied columns, solve the
        # reduced system, broadcast the leader's delta back to every slot.
        # The solve-side A zeroes dead rows (no identity-diag pollution from
        # invalid/frozen slots); the APPLY-side A keeps them, so e.g. a
        # not-yet-registered slot still tracks its group's intrinsics and
        # joins the solve in sync when it registers.
        MC = S.shape[0]
        A_apply = _intrinsic_tie_matrix(cfg.cam_group.astype(jnp.int32),
                                        params.qvec.shape[0], S.dtype)
        A = A_apply * pmask.astype(S.dtype)[:, None]
        St = A.T @ S @ A
        alive = jnp.sum(A, axis=0) > 0
        St = St + jnp.where(alive, 0.0, 1.0)[:, None] * jnp.eye(
            MC, dtype=S.dtype)
        rhst = A.T @ rhs
        dct = jax.scipy.linalg.solve(St, rhst, assume_a="pos")
        dc = A_apply @ dct
    else:
        # dense solve via Cholesky with jitter fallback to solve
        dc = jax.scipy.linalg.solve(S, rhs, assume_a="pos")
    dc = jnp.where(jnp.all(jnp.isfinite(dc)), dc, jnp.zeros_like(dc))

    # back-substitute points: dp_j = Vinv_j (g_p_j - B_j^T dc)
    M = params.qvec.shape[0]
    dc_cam = dc.reshape(M, NUM_CAM_PARAMS)
    wJc = J_cam * w[..., None, None]
    Wc = jnp.einsum("ptri,ptrj->ptij", wJc, J_pt)      # (P,T,8,3)
    dc_per_obs = dc_cam[obs.cam_idx]                   # (P,T,8)
    Bt_dc = jnp.einsum("ptij,pti->pj", Wc, dc_per_obs) # (P,3)
    dp = jnp.einsum("pij,pj->pi", Vinv, g_p - Bt_dc)
    return _apply_delta(params, dc, dp, cfg)


def _segsum_cam(vals, cam_idx, M):
    """Sum per-observation values (P, T, ...) into camera slots (M, ...)."""
    flat = vals.reshape((-1,) + vals.shape[2:])
    return jax.ops.segment_sum(flat, cam_idx.reshape(-1), num_segments=M)


def _lm_trial_cg(params, obs, cfg, lam, cg_iters: int, cg_tol: float = 1e-4,
                 axis_name=None, chunk: int | None = None,
                 cg_segsum: str = "auto"):
    """LM trial solving the Schur camera system MATRIX-FREE with
    diagonally-preconditioned CG (Ceres ITERATIVE_SCHUR + SCHUR_JACOBI).

    The dense path materializes S (MC, MC) and pays O(P·MC²) accumulation —
    the `merge.final_ba_max_images` bound. Here S is only ever APPLIED:
    each CG iteration costs O(P·T) gather/segment-sum work plus an
    (M, 8, 8) block product, so one global solve scales to 1k-10k cameras
    on a single chip. Shared-camera intrinsic ties (cfg.cam_group) are
    applied functionally (broadcast-from-leader / sum-to-leader), the same
    exact equality constraint as the dense tie matrix.

    Memory: all per-observation products (Jacobians and their temporaries,
    the matvec/back-substitution intermediates) stream through lax.scan in
    point chunks; the only full-P residents are the stacked CG working set
    Wc (P,T,8,3) + Vinv (P,3,3) + g_p (P,3) — ~27 floats/obs, a fixed bound
    of ~0.5 GB at P=1M,T=4 f32 regardless of chunk size.
    """
    M = params.qvec.shape[0]
    Pn = params.xyz.shape[0]
    T = obs.uv.shape[1]
    dtype = params.xyz.dtype
    if chunk is None or chunk > Pn:
        chunk = Pn
    n_chunks = Pn // chunk
    assert Pn % chunk == 0, f"points {Pn} must divide by chunk {chunk}"
    # CG matvec gather/scatter plan: the "onehot" plan expresses the
    # camera gather AND the segment_sum scatter as (c*T, M) bf16 one-hot
    # matmuls (the one-hot is exact in bf16; x/z quantize to bf16, an
    # inner-solver perturbation the LM accept gate absorbs — convergence
    # parity asserted in tests and the multichip dryrun). It won where
    # row gathers and scatters are slow; gated to larger M where the
    # one-hot fits comfortably. Its A/B on the GPU is not measured yet.
    use_onehot = (cg_segsum == "onehot"
                  or (cg_segsum == "auto"
                      and M >= 512 and chunk * T * M * 2 <= 1 << 30))

    def slice_p(start):
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, start, chunk, 0)
        p = params._replace(xyz=sl(params.xyz))
        o = BundleObs(cam_idx=sl(obs.cam_idx), uv=sl(obs.uv),
                      valid=sl(obs.valid))
        c = cfg._replace(pt_valid=sl(cfg.pt_valid))
        return p, o, c

    eye3 = jnp.eye(3, dtype=dtype)

    def build_chunk(carry, ci):
        U_a, g_a, rhs_a, d_a = carry
        p_c, o_c, c_c = slice_p(ci * chunk)
        r, w, J_cam, J_pt, _ = _jacobians(p_c, o_c, c_c)
        wJc = J_cam * w[..., None, None]
        wJp = J_pt * w[..., None, None]
        # landmark blocks (identical to the dense path)
        V = jnp.einsum("ptri,ptrj->pij", wJp, J_pt)
        g_p = -jnp.einsum("ptri,ptr->pi", wJp, r)
        Vd = V + lam * eye3 * jnp.maximum(
            jnp.einsum("pii->p", V), 1e-6)[:, None, None] / 3.0
        Vd = Vd + 1e-8 * eye3
        Vinv = _inv33(Vd)
        Wc = jnp.einsum("ptri,ptrj->ptij", wJc, J_pt)        # (c,T,8,3)
        # camera blocks via segment sums — no (c, T, M) one-hot
        U_a = U_a + _segsum_cam(jnp.einsum("ptri,ptrj->ptij", wJc, J_cam),
                                o_c.cam_idx, M)
        g_a = g_a - _segsum_cam(jnp.einsum("ptri,ptr->pti", wJc, r),
                                o_c.cam_idx, M)
        # rhs subtraction term B Vinv g_p and Schur-Jacobi diagonal
        y0 = jnp.einsum("pij,pj->pi", Vinv, g_p)
        rhs_a = rhs_a + _segsum_cam(jnp.einsum("ptij,pj->pti", Wc, y0),
                                    o_c.cam_idx, M)
        d_obs = jnp.einsum("ptij,pjk,ptik->pti", Wc, Vinv, Wc)
        d_a = d_a + _segsum_cam(d_obs, o_c.cam_idx, M)
        return (U_a, g_a, rhs_a, d_a), (Wc, Vinv, g_p)

    zeros_m8 = jnp.zeros((M, NUM_CAM_PARAMS), dtype)
    (U, g_c, rhs_sub, d_sub), (Wc_s, Vinv_s, g_p_s) = jax.lax.scan(
        build_chunk,
        (jnp.zeros((M, NUM_CAM_PARAMS, NUM_CAM_PARAMS), dtype),
         zeros_m8, zeros_m8, zeros_m8),
        jnp.arange(n_chunks))
    cam_idx_s = obs.cam_idx.reshape(n_chunks, chunk, T)
    if axis_name is not None:
        # points sharded over the mesh axis: camera-side systems reduce
        # across devices; priors/damping apply to the replicated result below
        U, g_c, rhs_sub, d_sub = jax.lax.psum(
            (U, g_c, rhs_sub, d_sub), axis_name)

    wf = cfg.prior_weight_f
    wk = cfg.prior_weight_k
    U = U.at[:, 6, 6].add(wf)
    U = U.at[:, 7, 7].add(wk)
    g_c = g_c.at[:, 6].add(-wf * (params.log_f - cfg.prior_log_f))
    g_c = g_c.at[:, 7].add(-wk * (params.k1 - cfg.prior_k1))
    Ud = U + lam * jnp.eye(NUM_CAM_PARAMS, dtype=dtype) * jnp.maximum(
        jnp.einsum("mii->m", U), 1e-6)[:, None, None] / NUM_CAM_PARAMS

    rhs = g_c - rhs_sub

    intr8 = jnp.stack([cfg.refine_focal, cfg.refine_distortion])
    free8 = jnp.concatenate([
        cfg.pose_free > 0,
        jnp.broadcast_to(intr8[None, :], (M, 2)),
    ], axis=1)
    pmask = free8 & cfg.cam_valid[:, None]                   # (M, 8)

    group = (cfg.cam_group.astype(jnp.int32) if cfg.cam_group is not None
             else jnp.arange(M, dtype=jnp.int32))
    is_leader = group == jnp.arange(M, dtype=jnp.int32)
    intr_alive = jax.ops.segment_max(
        pmask[:, 6:8].astype(jnp.int32), group, num_segments=M) > 0
    # reduced coordinates: pose per slot; intrinsics live on group leaders
    rmask = jnp.concatenate(
        [pmask[:, :6], intr_alive & is_leader[:, None]], axis=1)

    def expand(xr):      # A_apply: leader intrinsics broadcast to all slots
        return jnp.concatenate([xr[:, :6], xr[group, 6:8]], axis=1)

    def reduce_(x):      # A^T: intrinsic rows sum into their leader slot
        return jnp.concatenate([
            x[:, :6],
            jax.ops.segment_sum(x[:, 6:8], group, num_segments=M)], axis=1)

    pm = pmask.astype(dtype)
    rm = rmask.astype(dtype)

    def matvec(xr):
        x = expand(xr * rm) * pm                             # (M, 8)
        ux = jnp.einsum("mij,mj->mi", Ud, x)

        def mv_chunk(acc, xs):
            Wc_c, Vinv_c, ci_c = xs
            if use_onehot:
                oh = (ci_c.reshape(-1, 1)
                      == jnp.arange(M)[None, :]).astype(jnp.bfloat16)
                xc = jax.lax.dot_general(
                    oh, x.astype(jnp.bfloat16), (((1,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32
                ).reshape(ci_c.shape + (NUM_CAM_PARAMS,))
            else:
                xc = x[ci_c]                                 # (c, T, 8)
            u = jnp.einsum("ptij,pti->pj", Wc_c, xc)         # B^T x
            yv = jnp.einsum("pij,pj->pi", Vinv_c, u)
            z = jnp.einsum("ptij,pj->pti", Wc_c, yv)
            if use_onehot:
                sub_c = jax.lax.dot_general(
                    oh, z.reshape(-1, NUM_CAM_PARAMS).astype(jnp.bfloat16),
                    (((0,), (0,)), ((), ())),
                    preferred_element_type=jnp.float32)
                return acc + sub_c, None
            return acc + _segsum_cam(z, ci_c, M), None

        sub, _ = jax.lax.scan(mv_chunk, zeros_m8,
                              (Wc_s, Vinv_s, cam_idx_s))
        if axis_name is not None:
            # one psum per CG iteration — the (M, 8) partial, not O(M^2)
            sub = jax.lax.psum(sub, axis_name)
        return reduce_((ux - sub) * pm) * rm

    b = reduce_(rhs * pm) * rm
    # Schur-Jacobi diagonal preconditioner on the reduced system
    # (d_sub accumulated + psum-reduced in the build scan above)
    diag_full = (jnp.einsum("mii->mi", Ud) - d_sub) * pm
    diag_red = reduce_(diag_full) * rm
    precond = jnp.where(diag_red > 1e-8,
                        1.0 / jnp.maximum(diag_red, 1e-8), 1.0) * rm

    b2 = jnp.sum(b * b)
    tol2 = (cg_tol * cg_tol) * b2

    def cg_body(i, st):
        def step(x, res, p, rz, done):
            Ap = matvec(p)
            alpha = rz / jnp.maximum(jnp.sum(p * Ap), 1e-30)
            x2 = x + alpha * p
            r2 = res - alpha * Ap
            z2 = precond * r2
            rz2 = jnp.sum(r2 * z2)
            beta = rz2 / jnp.maximum(rz, 1e-30)
            return x2, r2, z2 + beta * p, rz2, jnp.sum(r2 * r2) < tol2

        return jax.lax.cond(st[4], lambda *a: a, step, *st)

    z0 = precond * b
    xr, _, _, _, _ = jax.lax.fori_loop(
        0, cg_iters, cg_body,
        (jnp.zeros_like(b), b, z0, jnp.sum(b * z0), jnp.asarray(False)))
    dc_cam = expand(xr * rm)                                 # A_apply @ dct
    dc_cam = jnp.where(jnp.all(jnp.isfinite(dc_cam)), dc_cam,
                       jnp.zeros_like(dc_cam))

    # back-substitute points: dp_j = Vinv_j (g_p_j - B_j^T dc)
    def bs_chunk(_, xs):
        Wc_c, Vinv_c, g_p_c, ci_c = xs
        Bt_dc = jnp.einsum("ptij,pti->pj", Wc_c, dc_cam[ci_c])
        return None, jnp.einsum("pij,pj->pi", Vinv_c, g_p_c - Bt_dc)

    _, dp_s = jax.lax.scan(bs_chunk, None, (Wc_s, Vinv_s, g_p_s, cam_idx_s))
    dp = dp_s.reshape(Pn, 3)
    return _apply_delta(params, dc_cam.reshape(M * NUM_CAM_PARAMS), dp, cfg)


@functools.partial(jax.jit, static_argnames=("max_iterations", "chunk",
                                             "axis_name", "solver",
                                             "cg_iters"))
@f32_matmuls
def bundle_adjust(
    params: BundleParams,
    obs: BundleObs,
    cfg: BundleConfig,
    max_iterations: int = 25,
    chunk: int = 1024,
    initial_lambda: float = 1e-4,
    function_tolerance: float = 1e-6,
    axis_name: str | None = None,
    solver: str = "dense",
    cg_iters: int = 64,
):
    """Full in-graph LM loop with accept/reject damping adaptation.

    solver="dense" factorizes the Schur complement (exact, O(MC²) memory);
    solver="cg" applies it matrix-free with preconditioned CG
    (_lm_trial_cg) — the path that scales past `final_ba_max_images`.

    Returns (params, info dict of (costs over iters, final mean px error,
    num accepted steps)).

    Precision: float32 matmuls at the highest precision (f32_matmuls); the
    callers (bundle_adjust_packed / _flat, the distributed solver) inherit
    it.
    """
    if solver not in ("dense", "cg"):
        raise ValueError(f"solver must be 'dense' or 'cg', got {solver!r}")
    P = params.xyz.shape[0]
    assert P % chunk == 0, f"max_points {P} must be divisible by chunk {chunk}"
    cost0, _, _ = robust_cost(params, obs, cfg, axis_name)

    # FIXED-trip fori_loop with convergence masking, NOT lax.while_loop: a
    # data-dependent while copies its condition to the host every
    # iteration; masked no-op iterations after convergence keep the whole
    # solve one uninterrupted device program. The LM trial itself sits behind
    # a lax.cond so converged trips cost ~nothing on device (HLO
    # Conditional executes one branch) — with dead trips free, long
    # max_iterations budgets can run as ONE program (see
    # bundle_adjust_flat_segmented's one-shot threshold).
    def body(it, state):
        p, lam, cost, done, n_applied = state

        def trial(p, lam, cost, done, n_applied):
            if solver == "cg":
                cand = _lm_trial_cg(p, obs, cfg, lam, cg_iters,
                                    axis_name=axis_name, chunk=chunk)
            else:
                cand = _lm_trial(p, obs, cfg, lam, chunk, axis_name)
            new_cost, _, _ = robust_cost(cand, obs, cfg, axis_name)
            accept = new_cost < cost
            p2 = jax.tree.map(lambda a, b: jnp.where(accept, a, b), cand, p)
            cost2 = jnp.where(accept, new_cost, cost)
            lam2 = jnp.where(accept, jnp.maximum(lam / 3.0, 1e-10),
                             jnp.minimum(lam * 10.0, 1e6))
            rel = jnp.abs(cost - cost2) / jnp.maximum(cost, 1e-12)
            done2 = (accept & (rel < function_tolerance)) | (lam2 > 1e5)
            return (p2, lam2, cost2, done2, n_applied + 1)

        def skip(p, lam, cost, done, n_applied):
            return (p, lam, cost, done, n_applied)

        return jax.lax.cond(done, skip, trial, p, lam, cost, done, n_applied)

    p_f, lam_f, cost_f, _, it = jax.lax.fori_loop(
        0, max_iterations, body,
        (params, jnp.asarray(initial_lambda, params.xyz.dtype), cost0,
         jnp.asarray(False), jnp.asarray(0, jnp.int32)))
    _, mean_px, n_obs = robust_cost(p_f, obs, cfg, axis_name)
    info = {"initial_cost": cost0, "final_cost": cost_f,
            "iterations": it, "mean_reproj_px": mean_px, "num_obs": n_obs,
            "final_lambda": lam_f}
    return p_f, info


@functools.partial(jax.jit, static_argnames=("max_iterations", "chunk",
                                             "axis_name", "solver",
                                             "cg_iters"))
def bundle_adjust_packed(
    params: BundleParams,
    obs: BundleObs,
    cfg: BundleConfig,
    max_iterations: int = 25,
    chunk: int = 1024,
    initial_lambda: float = 1e-4,
    function_tolerance: float = 1e-6,
    axis_name: str | None = None,
    solver: str = "dense",
    cg_iters: int = 64,
):
    """`bundle_adjust` with results packed into 3 arrays — (cam (M, 9),
    xyz (P, 3), stats (6,)) — so host engines pay 3 device->host transfers
    instead of ~10.

    cam rows are [qvec(4), tvec(3), log_f(1), k1(1)]; stats is
    [initial_cost, final_cost, iterations, mean_reproj_px, num_obs,
    final_lambda].
    """
    p, info = bundle_adjust(params, obs, cfg, max_iterations=max_iterations,
                            chunk=chunk, initial_lambda=initial_lambda,
                            function_tolerance=function_tolerance,
                            axis_name=axis_name, solver=solver,
                            cg_iters=cg_iters)
    dt = p.xyz.dtype
    cam = jnp.concatenate([p.qvec.astype(dt), p.tvec.astype(dt),
                           p.log_f.astype(dt)[:, None],
                           p.k1.astype(dt)[:, None]], axis=1)
    stats = jnp.stack([info["initial_cost"].astype(dt),
                       info["final_cost"].astype(dt),
                       info["iterations"].astype(dt),
                       info["mean_reproj_px"].astype(dt),
                       info["num_obs"].astype(dt),
                       info["final_lambda"].astype(dt)])
    return cam, p.xyz, stats


# per-call accounting of the segmented host driver, for scale-run
# utilization reports: (solver, M, P, T, applied_iters, cg_iters, seconds)
PERF_LOG: list = []

NUM_CAM_IN = 22  # qvec4 t3 logf k1 cc2 cam_valid pose_free6 plogf pk1 pwf pwk
# optional 23rd column: shared-camera group LEADER slot (see
# BundleConfig.cam_group). A (M, 22) cam_in keeps per-image intrinsics.
NUM_CAM_IN_TIED = 23


@functools.partial(jax.jit, static_argnames=("max_iterations", "chunk",
                                             "solver", "cg_iters"))
def bundle_adjust_flat(cam_in, pt_in, obs_in, scal_in,
                       max_iterations: int = 25, chunk: int = 1024,
                       function_tolerance: float = 1e-6,
                       solver: str = "dense", cg_iters: int = 64):
    """Fully packed LM solve for host engines: ONE upload block + ONE
    download.

    cam_in  (M, 22): [qvec(4), tvec(3), log_f, k1, cc(2), cam_valid,
                      pose_free(6), prior_log_f, prior_k1,
                      prior_weight_f, prior_weight_k]
    pt_in   (P, 4):  [xyz(3), pt_valid]
    obs_in  (P, T, 4): [cam_idx, u, v, valid]
    scal_in (4,):    [refine_focal, refine_distortion, loss_scale,
                      initial_lambda (<=0 -> default 1e-4; segmented
                      continuations pass the previous segment's adapted
                      damping — resetting it wasted ~2 extra segments per
                      solve re-adapting)]
                      (a length-3 scal_in is accepted: default lambda)

    Returns flat (M*9 + P*3 + 6,): cam rows [qvec, tvec, log_f, k1],
    xyz rows, stats [initial_cost, final_cost, iterations,
    mean_reproj_px, num_obs, final_lambda].
    """
    M = cam_in.shape[0]
    P = pt_in.shape[0]
    if scal_in.shape[0] < 4:
        scal_in = jnp.concatenate([jnp.asarray(scal_in),
                                   jnp.zeros(1, jnp.float32)])
    lam0 = jnp.where(scal_in[3] > 0, scal_in[3], 1e-4)
    params = BundleParams(qvec=cam_in[:, 0:4], tvec=cam_in[:, 4:7],
                          log_f=cam_in[:, 7], k1=cam_in[:, 8],
                          xyz=pt_in[:, 0:3])
    if obs_in.dtype == jnp.uint16:
        # quantized wire format: [cam_idx, u*16, v*16, valid] — halves the
        # dominant per-solve upload; 1/16 px is far below keypoint noise.
        # Valid ONLY for in-image coordinates (0 <= uv < 4096 px — always
        # true for detected keypoints); out-of-range uv must use f32
        obs = BundleObs(cam_idx=obs_in[..., 0].astype(jnp.int32),
                        uv=obs_in[..., 1:3].astype(jnp.float32) * (1.0 / 16.0),
                        valid=obs_in[..., 3] > 0)
    else:
        obs = BundleObs(cam_idx=obs_in[..., 0].astype(jnp.int32),
                        uv=obs_in[..., 1:3], valid=obs_in[..., 3] > 0.5)
    cfg = BundleConfig(
        cc=cam_in[:, 9:11], cam_valid=cam_in[:, 11] > 0.5,
        pose_free=cam_in[:, 12:18], pt_valid=pt_in[:, 3] > 0.5,
        refine_focal=scal_in[0] > 0.5, refine_distortion=scal_in[1] > 0.5,
        loss_scale=scal_in[2],
        prior_log_f=cam_in[:, 18], prior_k1=cam_in[:, 19],
        prior_weight_f=cam_in[:, 20], prior_weight_k=cam_in[:, 21],
        cam_group=(cam_in[:, 22].astype(jnp.int32)
                   if cam_in.shape[1] >= NUM_CAM_IN_TIED else None))
    cam, xyz, stats = bundle_adjust_packed(
        params, obs, cfg, max_iterations=max_iterations, chunk=chunk,
        initial_lambda=lam0, function_tolerance=function_tolerance,
        solver=solver, cg_iters=cg_iters)
    return jnp.concatenate([cam.reshape(M * 9), xyz.reshape(P * 3), stats])


def bundle_adjust_flat_segmented(cam_in, pt_in, obs_in, scal_in,
                                 max_iterations: int = 25, chunk: int = 1024,
                                 segment: int = 0,
                                 function_tolerance: float = 1e-6,
                                 segment_improvement_tol: float = 1e-3,
                                 solver: str = "dense", cg_iters: int = 64):
    """Host driver over fixed-size `bundle_adjust_flat` segments.

    The in-graph LM loop has a STATIC trip count (a data-dependent while
    costs a host sync per iteration — see bundle_adjust). segment=0
    (default) picks a LATENCY-BALANCED schedule from an ASSUMED trip cost
    (~1 ms per 16k observation cells) against an assumed ~40 ms
    continuation round trip: small solves run ALL max_iterations as ONE
    program (wasted post-convergence trips are cheaper than any extra round
    trip) and large solves use segments sized so each segment's device time
    matches the latency it amortizes. Both costs are design assumptions
    from the previous accelerator, not measured on the GPU yet. Explicit
    positive segments override.
    """
    import numpy as np
    import time as _time

    _t_start = _time.time()
    if segment <= 0:
        obs_cells = float(obs_in.shape[0] * obs_in.shape[1])
        trip_ms = obs_cells * 6.5e-5   # assumed ~1 ms per trip at 16k cells
        # converged trips are ~free (lax.cond skip in bundle_adjust), so the
        # one-shot threshold prices the WORST case against saved round
        # trips: typical solves converge well inside the budget and pay
        # only converged_iters * trip_ms. 1 s cap (250 ms made merged-model
        # solves at 1M obs cells run 3 escalating segments, paying extra
        # compiles + D2H downloads that cost more than the worst-case
        # wasted trips)
        if max_iterations * trip_ms <= 1000.0:
            segment = max(int(max_iterations), 1)
        else:
            seg = max(int(40.0 / max(trip_ms, 1e-3)), 8)
            segment = 1 << (seg.bit_length() - 1)  # floor pow2, >= 8

    cam_in = np.asarray(cam_in, np.float32).copy()
    pt_in = np.asarray(pt_in, np.float32).copy()
    scal = np.zeros(4, np.float32)
    scal[: len(np.asarray(scal_in))] = np.asarray(scal_in, np.float32)
    M = cam_in.shape[0]
    P = pt_in.shape[0]
    total_used = 0
    initial_cost = None
    out = None
    remaining = max(int(max_iterations), 1)
    seg = segment
    while remaining > 0:
        out = np.asarray(bundle_adjust_flat(
            cam_in, pt_in, obs_in, scal, max_iterations=seg,
            chunk=chunk, function_tolerance=function_tolerance,
            solver=solver, cg_iters=cg_iters))
        stats = out[M * 9 + P * 3:]
        used = int(stats[2])
        if initial_cost is None:
            initial_cost = float(stats[0])
        total_used += min(used, remaining)
        remaining -= seg
        if used < seg or remaining <= 0:
            break
        # host-level stop: LM's per-iteration tolerance (1e-6) rarely fires
        # inside one segment, but a segment that barely moved the cost will
        # not move it next segment either — don't pay another round trip
        rel_drop = (float(stats[0]) - float(stats[1])) / max(
            abs(float(stats[0])), 1e-12)
        if rel_drop < segment_improvement_tol:
            break
        # continue from the segment's solution: carry the adapted damping
        # (restarting at lambda=1e-4 wasted iterations re-adapting). The
        # segment size stays CONSTANT: escalating (8 -> 16 -> 32) compiled
        # THREE program sizes per shape bucket — ~20 s of one-time remote
        # compile each at merged-model shapes — to save two ~50 ms round
        # trips; one compiled size per bucket wins on every cold path
        cam = out[: M * 9].reshape(M, 9)
        cam_in[:, 0:9] = cam
        pt_in[:, 0:3] = out[M * 9: M * 9 + P * 3].reshape(P, 3)
        scal[3] = max(float(stats[5]), 1e-10)
    out = out.copy()
    out[M * 9 + P * 3 + 0] = initial_cost
    out[M * 9 + P * 3 + 2] = total_used
    # utilization accounting (read + cleared by scale harnesses):
    # (solver, M, P, T, applied LM iterations, cg_iters, wall seconds)
    PERF_LOG.append((solver, M, P, int(obs_in.shape[1]), total_used,
                     cg_iters, _time.time() - _t_start))
    return out
