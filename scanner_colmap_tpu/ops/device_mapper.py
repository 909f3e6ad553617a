"""Device-resident incremental mapper: one jitted program per cluster.

The host-driven engine (engine/incremental.py) replicates COLMAP's control
loop (reference incremental_mapping.cc:305-361) with one device solve per
refinement round — correct, but the ~20 host round trips per cluster
bound the mapping wall-clock whenever a round trip costs more than the
solve.

This module is the device-resident alternative: the ENTIRE cluster solve
runs as ONE device program with static shapes and `lax`-level control flow —
SURVEY §7.4.2's "host-driven outer loop" replaced by a fixed registration
schedule precomputed from the match graph (engine/device_cluster.py):

  for step in fori_loop(order):            # fixed schedule + retry pass
      PnP-RANSAC the step's image against the current point set
      triangulate every pending track with >= 2 registered views
      masked LM bundle adjustment (ops/ba.bundle_adjust, in-graph LM loop)
      demote observations/points that stopped fitting

Track structure is data-independent: tracks are connected components of the
verified-match graph (union-find), so the full padded observation tensor
uploads once and membership is pure masking. COLMAP's dynamic
complete/merge-tracks becomes implicit: every candidate observation is
already in its track's slot row and the per-step reprojection gate decides
whether it participates — re-admission is automatic because the gate is
recomputed from scratch each step (host path completion: engine/
incremental.py complete_tracks/merge_tracks).

Trade-off vs the host engine: the registration ORDER is a static heuristic
(match-connectivity greedy) instead of COLMAP's visible-points ranking, and
local refinement is a whole-cluster masked BA instead of a neighbor window.
At cluster scale (<= ~32 images) the whole-cluster solve is small per LM
trip, and sequential collections register in chain order anyway.

Reference behavior covered here: FindInitialImagePair/RegisterInitialImagePair
(incremental_mapping.cc:305-313), RegisterNextImage (:329), TriangulateImage
(:49-57), local/global refinement (:86-139), point filtering (:141-178).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.ops import ba, pnp
from scanner_colmap_tpu.ops.linalg3 import det33, solve33


def _obs_errors(cam, xyz, obs_cam, obs_uv, cc):
    """Pixel reprojection error (P, T) + camera-frame depth under `cam`.

    cam rows: [qvec(4), tvec(3), log_f, k1] (same layout as ops.ba packed
    camera rows).
    """
    q = cam[obs_cam, 0:4]
    t = cam[obs_cam, 4:7]
    f = jnp.exp(cam[obs_cam, 7])
    k1 = cam[obs_cam, 8]
    xc = geom.quat_rotate(q, xyz[:, None, :]) + t
    z = xc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-8, jnp.where(z < 0, -1e-8, 1e-8), z)
    xn = xc[..., :2] / zs[..., None]
    r2 = jnp.sum(xn * xn, axis=-1)
    proj = f[..., None] * xn * (1.0 + k1[..., None] * r2[..., None]) + cc[obs_cam]
    err = jnp.linalg.norm(proj - obs_uv, axis=-1)
    return err, z


def _triangulate_all(cam, registered, obs_cam, obs_xn, obs_present,
                     tri_thr_n, min_tri_angle):
    """Masked inhomogeneous multi-view DLT for EVERY track at once.

    Solves A[:, :3] X = -A[:, 3] per track over its registered observations
    via closed-form 3x3 normal equations (ops/linalg3) — pure elementwise
    work; the homogeneous 4x4 eigen form (ops/triangulate.py) batches an
    iterative eigh, unaffordable inside a per-step loop.
    The inhomogeneous form only fails for points AT infinity, which the
    acceptance gates reject anyway.

    Returns (xyz (P,3), ok (P,), view_ok (P,T)).
    """
    q = cam[obs_cam, 0:4]
    t = cam[obs_cam, 4:7]
    R = geom.quat_to_rotmat(q)                     # (P, T, 3, 3)
    m = (obs_present & registered[obs_cam]).astype(cam.dtype)  # (P, T)

    u = obs_xn[..., 0]
    v = obs_xn[..., 1]
    # rows of [u*P2 - P0; v*P2 - P1] with P = [R | t]
    r1 = u[..., None] * R[..., 2, :] - R[..., 0, :]            # (P, T, 3)
    r2 = v[..., None] * R[..., 2, :] - R[..., 1, :]
    b1 = -(u * t[..., 2] - t[..., 0])                          # (P, T)
    b2 = -(v * t[..., 2] - t[..., 1])
    A = jnp.concatenate([r1 * m[..., None], r2 * m[..., None]], axis=1)
    bb = jnp.concatenate([b1 * m, b2 * m], axis=1)
    AtA = jnp.einsum("pki,pkj->pij", A, A)
    Atb = jnp.einsum("pki,pk->pi", A, bb)
    xyz = solve33(AtA + 1e-12 * jnp.eye(3, dtype=A.dtype), Atb)
    nondegen = jnp.abs(det33(AtA)) > 1e-12

    # acceptance: per-view cheirality + normalized reprojection + angle
    xc = jnp.einsum("ptij,pj->pti", R, xyz) + t
    z = xc[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, 1e-9, z)
    err_n = jnp.linalg.norm(xc[..., :2] / zs[..., None] - obs_xn, axis=-1)
    view_ok = (m > 0) & (z > 1e-6) & (err_n < tri_thr_n[:, None])

    centers = -jnp.einsum("ptji,ptj->pti", R, t)               # (P, T, 3)
    rays = centers - xyz[:, None, :]
    rn = rays / jnp.maximum(jnp.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    cosang = jnp.einsum("pti,psi->pts", rn, rn)
    pair_ok = view_ok[:, :, None] & view_ok[:, None, :]
    ang = jnp.arccos(jnp.clip(cosang, -1.0, 1.0))
    max_ang = jnp.max(jnp.where(pair_ok, ang, 0.0), axis=(1, 2))

    ok = nondegen & (jnp.sum(view_ok, axis=-1) >= 2) & (max_ang >= min_tri_angle)
    return xyz, ok, view_ok


def _map_cluster_impl(key, cam_in, order, forced, reg_init,
                      obs_cam, obs_uv, obs_xn, obs_present,
                      pnp_thr_n, tri_thr_n, scal,
                      pnp_trials: int = 256, ba_iters: int = 8,
                      final_iters: int = 40, chunk: int = 1024):
    """Run one cluster's full incremental reconstruction on device.

    Inputs (all f32 unless noted; M camera slots, P tracks, T track slots,
    S schedule steps):
      key         (2,) uint32 RANSAC seed
      cam_in      (M, 22) packed cameras, columns as ba.bundle_adjust_flat:
                  [qvec, tvec, log_f, k1, cc(2), cam_valid, pose_free(6),
                  prior_log_f, prior_k1, prior_wf, prior_wk]. Init-pair rows
                  carry their relative pose; pose_free encodes the gauge.
      order       (S,) int32 camera slot registered at each step (-1 pad);
                  includes a retry pass (already-registered slots skip).
      forced      (S,) f32: 1 -> register without PnP (the second init image,
                  whose pose comes from the two-view geometry).
      reg_init    (M,) f32 initially-registered mask (the first init image).
      obs_cam     (P, T) int32 camera slot per observation
      obs_uv      (P, T, 2) pixel coords
      obs_xn      (P, T, 2) normalized coords (initial intrinsics)
      obs_present (P, T) f32 slot-occupied mask
      pnp_thr_n   (M,) PnP inlier threshold per slot (normalized units)
      tri_thr_n   (P,) triangulation reprojection gate per track (normalized)
      scal        (8,) [refine_focal, refine_distortion, loss_scale_px,
                  min_tri_angle_rad, abs_pose_min_num_inliers,
                  abs_pose_min_inlier_ratio, filter_max_reproj_px, unused]

    Returns flat f32 (M*9 + P*3 + P + P*T + M + 4):
      [cam (M,9) | xyz (P,3) | pt_valid (P) | obs_ok (P,T) | registered (M) |
       stats (n_registered, n_points, mean_err_px, n_obs)]
    """
    M = cam_in.shape[0]
    P, T = obs_cam.shape
    S = order.shape[0]
    f32 = cam_in.dtype

    cc = cam_in[:, 9:11]
    cam_valid_in = cam_in[:, 11] > 0.5
    pose_free = cam_in[:, 12:18]
    prior_log_f = cam_in[:, 18]
    prior_k1 = cam_in[:, 19]
    prior_wf = cam_in[:, 20]
    prior_wk = cam_in[:, 21]
    # optional 23rd column: shared-camera group leader (exact intrinsic
    # tying inside every BA solve — ba.BundleConfig.cam_group)
    cam_group = (cam_in[:, 22].astype(jnp.int32)
                 if cam_in.shape[1] >= ba.NUM_CAM_IN_TIED else None)

    refine_focal = scal[0] > 0.5
    refine_dist = scal[1] > 0.5
    loss_scale = scal[2]
    min_tri_angle = scal[3]
    abs_min_inl = scal[4]
    abs_min_ratio = scal[5]
    filter_px = scal[6]

    obs_present_b = obs_present > 0.5

    def ok_mask(cam, xyz, registered, pt_valid):
        err, z = _obs_errors(cam, xyz, obs_cam, obs_uv, cc)
        return (obs_present_b & registered[obs_cam] & pt_valid[:, None]
                & (z > 1e-6) & (err < filter_px))

    def run_ba(cam, xyz, registered, pt_valid, iters):
        vmask = ok_mask(cam, xyz, registered, pt_valid)
        params = ba.BundleParams(qvec=cam[:, 0:4], tvec=cam[:, 4:7],
                                 log_f=cam[:, 7], k1=cam[:, 8], xyz=xyz)
        obs = ba.BundleObs(cam_idx=obs_cam, uv=obs_uv, valid=vmask)
        cfgb = ba.BundleConfig(
            cc=cc, cam_valid=cam_valid_in & registered, pose_free=pose_free,
            pt_valid=pt_valid, refine_focal=refine_focal,
            refine_distortion=refine_dist, loss_scale=loss_scale,
            prior_log_f=prior_log_f, prior_k1=prior_k1,
            prior_weight_f=prior_wf, prior_weight_k=prior_wk,
            cam_group=cam_group)
        p2, _ = ba.bundle_adjust(params, obs, cfgb, max_iterations=iters,
                                 chunk=chunk)
        cam2 = jnp.concatenate(
            [p2.qvec, p2.tvec, p2.log_f[:, None], p2.k1[:, None]], axis=1
        ).astype(f32)
        # demote points whose support fell under 2 fitting observations
        vm2 = ok_mask(cam2, p2.xyz, registered, pt_valid)
        pt_valid2 = pt_valid & (jnp.sum(vm2, axis=1) >= 2)
        return cam2, p2.xyz.astype(f32), pt_valid2

    def grow_and_refine(cam, xyz, pt_valid, registered, iters):
        xyz_new, new_ok, _ = _triangulate_all(
            cam, registered, obs_cam, obs_xn, obs_present_b,
            tri_thr_n, min_tri_angle)
        take = (~pt_valid) & new_ok
        xyz = jnp.where(take[:, None], xyz_new, xyz)
        pt_valid = pt_valid | take
        return run_ba(cam, xyz, registered, pt_valid, iters)

    def step(s, carry):
        cam, xyz, pt_valid, registered = carry
        img = order[s]
        img_c = jnp.clip(img, 0, M - 1)
        frc = forced[s] > 0.5
        # weak-support re-registration: a slot registered early (few valid
        # points -> PnP accepted a barely-supported, possibly wrong pose)
        # can end the run with < 3 fitting observations, which the host
        # support filter then drops (the measured 47/48 case). The schedule's
        # retry pass re-attempts such slots against the NOW-triangulated
        # point set; 3 matches _unpack's min-support filter. Init-pair slots
        # are excluded (forced) — their poses carry the gauge.
        sup = jnp.sum(ok_mask(cam, xyz, registered, pt_valid)
                      & (obs_cam == img_c))
        weak = registered[img_c] & (sup < 3) & (~frc)
        needs = (img >= 0) & ((~registered[img_c]) | weak)

        def do(cam, xyz, pt_valid, registered):
            key_s = jax.random.fold_in(key, s)
            # PnP correspondences: one per valid track observing img
            has = obs_present_b & (obs_cam == img_c)
            has_any = jnp.any(has, axis=1) & pt_valid
            tsel = jnp.argmax(has, axis=1)
            xn_i = jnp.take_along_axis(
                obs_xn, tsel[:, None, None], axis=1)[:, 0, :]
            n_corr = jnp.sum(has_any)
            min_inl = jnp.minimum(abs_min_inl,
                                  jnp.maximum(6.0, n_corr.astype(f32) / 2.0))
            res = pnp.pnp_ransac(
                key_s, xyz, xn_i, has_any, pnp_thr_n[img_c],
                min_num_inliers=min_inl, min_inlier_ratio=0.0,
                num_trials=pnp_trials)
            # the ratio gate uses the VALID-correspondence count, matching
            # the host engine (inlier_ratio over 2D-3D candidates)
            ratio_ok = (res.num_inliers.astype(f32)
                        >= abs_min_ratio * jnp.maximum(n_corr.astype(f32), 1.0))
            ok = (res.ok & ratio_ok) | frc
            qv = jnp.where(frc, cam[img_c, 0:4], res.qvec.astype(f32))
            tv = jnp.where(frc, cam[img_c, 4:7], res.tvec.astype(f32))
            row = cam[img_c]
            row = row.at[0:4].set(jnp.where(ok, qv, row[0:4]))
            row = row.at[4:7].set(jnp.where(ok, tv, row[4:7]))
            cam = cam.at[img_c].set(row)
            registered = registered.at[img_c].set(registered[img_c] | ok)

            cam, xyz, pt_valid = jax.lax.cond(
                ok,
                lambda c, x, p, r: grow_and_refine(c, x, p, r, ba_iters),
                lambda c, x, p, r: (c, x, p),
                cam, xyz, pt_valid, registered)
            return cam, xyz, pt_valid, registered

        return jax.lax.cond(needs, do, lambda c, x, p, r: (c, x, p, r),
                            cam, xyz, pt_valid, registered)

    cam0 = cam_in[:, 0:9]
    xyz0 = jnp.zeros((P, 3), f32)
    ptv0 = jnp.zeros((P,), bool)
    reg0 = reg_init > 0.5

    cam_f, xyz_f, ptv_f, reg_f = jax.lax.fori_loop(
        0, S, step, (cam0, xyz0, ptv0, reg0))

    # final global refinement: retriangulate + long BA, twice
    # (the host engine's IterativeGlobalRefinement, ref :116-139)
    for _ in range(2):
        cam_f, xyz_f, ptv_f = grow_and_refine(
            cam_f, xyz_f, ptv_f, reg_f, final_iters)

    vmask = ok_mask(cam_f, xyz_f, reg_f, ptv_f)
    ptv_f = ptv_f & (jnp.sum(vmask, axis=1) >= 2)
    vmask = vmask & ptv_f[:, None]
    err, _ = _obs_errors(cam_f, xyz_f, obs_cam, obs_uv, cc)
    n_obs = jnp.sum(vmask)
    mean_err = jnp.sum(jnp.where(vmask, err, 0.0)) / jnp.maximum(n_obs, 1)
    stats = jnp.stack([jnp.sum(reg_f & cam_valid_in).astype(f32),
                       jnp.sum(ptv_f).astype(f32),
                       mean_err.astype(f32),
                       n_obs.astype(f32)])
    return jnp.concatenate([
        cam_f.reshape(M * 9),
        xyz_f.reshape(P * 3),
        ptv_f.astype(f32),
        vmask.astype(f32).reshape(P * T),
        reg_f.astype(f32),
        stats])


@functools.partial(jax.jit, static_argnames=("pnp_trials", "ba_iters",
                                             "final_iters", "chunk"))
def map_cluster(key, cam_in, order, forced, reg_init,
                obs_cam, obs_uv, obs_xn, obs_present,
                pnp_thr_n, tri_thr_n, scal,
                pnp_trials: int = 256, ba_iters: int = 8,
                final_iters: int = 40, chunk: int = 1024):
    """Single-cluster entry point (see _map_cluster_impl for the contract).

    Traced under full-f32 matmul precision: a backend default that
    reduces the f32 mantissa (bf16 passes, or TF32 on tensor-core GPUs)
    flips the mapper's RANSAC/triangulation margins (observed on the
    previous accelerator: a cluster registering 2/8 vs 8/8 on CPU). The
    mapper's matmuls are small, so full precision costs little.
    """
    with jax.default_matmul_precision("float32"):
        return _map_cluster_impl(
            key, cam_in, order, forced, reg_init, obs_cam, obs_uv, obs_xn,
            obs_present, pnp_thr_n, tri_thr_n, scal, pnp_trials=pnp_trials,
            ba_iters=ba_iters, final_iters=final_iters, chunk=chunk)


@functools.partial(jax.jit, static_argnames=("pnp_trials", "ba_iters",
                                             "final_iters", "chunk"))
def map_cluster_batch(key, cam_in, order, forced, reg_init,
                      obs_cam, obs_uv, obs_xn, obs_present,
                      pnp_thr_n, tri_thr_n, scal,
                      pnp_trials: int = 256, ba_iters: int = 8,
                      final_iters: int = 40, chunk: int = 1024):
    """vmapped `_map_cluster_impl`: every array gains a leading cluster axis.

    All clusters of a collection solve as ONE device program — the device
    analog of the reference shipping clusters to independent Scanner
    workers (SURVEY §2.2 parallelism #3), here as one batched program's
    leading axis.

    Slower than async per-cluster `map_cluster` dispatches on one device
    (4.4x at 16 images / 3 clusters on the previous accelerator; not
    measured on the GPU yet). vmap lowers
    `lax.cond` to select, so the conditionals this program's economics
    depend on — converged LM trips (ops/ba.py body), inactive schedule
    steps, failed registrations skipping grow_and_refine — all execute
    BOTH branches for every lane. Async dispatch already pipelines
    clusters back-to-back on device with zero host syncs in between, and
    keeps real single-branch conditionals. This entry point stays for
    data-parallel lane sharding across devices (where lanes pay the select
    cost but devices multiply), gated by MapperConfig.device_batch_clusters.
    """
    fn = functools.partial(_map_cluster_impl, pnp_trials=pnp_trials,
                           ba_iters=ba_iters, final_iters=final_iters,
                           chunk=chunk)
    with jax.default_matmul_precision("float32"):  # see map_cluster
        return jax.vmap(fn)(key, cam_in, order, forced, reg_init, obs_cam,
                            obs_uv, obs_xn, obs_present, pnp_thr_n,
                            tri_thr_n, scal)
