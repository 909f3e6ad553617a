"""Packing a Reconstruction into padded bundle-adjustment pytrees and back.

The boundary between the host control plane (ragged tracks in the
Reconstruction container) and the static-shape device solve (ops.ba).
Shapes are bucketed (next power of two) so jit recompiles a bounded number
of times per run.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import jax.numpy as jnp

from scanner_colmap_tpu.models import cameras as camlib
from scanner_colmap_tpu.models.reconstruction import Reconstruction
from scanner_colmap_tpu.ops import ba


def next_pow2(n: int, lo: int = 1) -> int:
    v = lo
    while v < n:
        v *= 2
    return v


def bucket_points(n: int, lo: int = 512) -> int:
    """Point-count bucket: pow2 up to 128k, then multiples of 64k.

    Pow2 alone wastes up to 2x at collection scale — a 550k-point merged
    model padded to 1M carries a ~1.6 GB CG working set (Wc is P*T*96
    bytes) and ran a device out of memory on a 10k run. Above 128k each
    solve is a one-off large shape anyway, so the finer 64k steps cost at
    most one extra compile per run while capping pad waste at 12%."""
    if n <= 131072:
        return next_pow2(max(n, 1), lo)
    step = 65536
    return ((n + step - 1) // step) * step


def pack_bundle_flat(
    rec: Reconstruction,
    image_ids: Sequence[int],
    max_track: int = 16,
    min_images: int = 16,
    min_points: int = 512,
):
    """Pack directly into the flat arrays of `ba.bundle_adjust_flat`:
    (cam_in (M, 22) f32, pt_in (P, 4) f32, obs_in (P, T, 4) f32, meta).

    Column layout documented on bundle_adjust_flat. pose_free defaults to
    all-free and priors to zero-weight; the caller edits those columns.
    Generous bucket floors (min_images 16, min_points 512): every distinct
    shape costs a compile, which dwarfs the padded FLOPs.
    """
    image_ids = [i for i in image_ids if rec.images[i].registered]
    M = next_pow2(max(len(image_ids), 1), min_images)

    # gather observations from the per-image assignment arrays (vectorized;
    # scanning every model point's track per call made packing the mapping
    # hot spot). Points kept: >= 2 observations within image_ids.
    obs_slot_l, obs_pid_l, obs_uv_l = [], [], []
    for s, iid in enumerate(image_ids):
        im = rec.images[iid]
        mask = im.point3D_ids >= 0
        if not mask.any():
            continue
        obs_slot_l.append(np.full(int(mask.sum()), s, np.int64))
        obs_pid_l.append(im.point3D_ids[mask])
        obs_uv_l.append(im.xys[mask])
    if obs_pid_l:
        obs_slot = np.concatenate(obs_slot_l)
        obs_pid = np.concatenate(obs_pid_l)
        obs_uv = np.concatenate(obs_uv_l)
        uniq, inv, counts = np.unique(obs_pid, return_inverse=True,
                                      return_counts=True)
        sel = counts >= 2
        point_ids = [int(p) for p in uniq[sel]]
        keep_obs = sel[inv]
        obs_pid = obs_pid[keep_obs]
        obs_slot = obs_slot[keep_obs]
        obs_uv = obs_uv[keep_obs]
    else:
        obs_slot = obs_pid = np.zeros(0, np.int64)
        obs_uv = np.zeros((0, 2))
        point_ids = []
    P = bucket_points(max(len(point_ids), 1), min_points)

    # shared-camera groups: images on one physical camera tie their
    # intrinsic columns to the group LEADER inside the Schur solve (exact
    # equality constraint — ba._intrinsic_tie_matrix). The 23rd column is
    # emitted only when a group is nontrivial, so per-image solves keep the
    # plain 22-column program.
    leader_slot: Dict[int, int] = {}
    group_col = np.zeros(M, np.float32)
    tied = False
    for s, iid in enumerate(image_ids):
        cid = rec.images[iid].camera_id
        if cid in leader_slot:
            tied = True
        group_col[s] = leader_slot.setdefault(cid, s)

    width = ba.NUM_CAM_IN_TIED if tied else ba.NUM_CAM_IN
    cam_in = np.zeros((M, width), np.float32)
    cam_in[:, 0] = 1.0         # identity qvec
    cam_in[:, 12:18] = 1.0     # pose_free
    if tied:
        cam_in[:, 22] = group_col
        # padded slots tie to themselves
        cam_in[len(image_ids):, 22] = np.arange(len(image_ids), M)
    for s, iid in enumerate(image_ids):
        im = rec.images[iid]
        cam = rec.cameras[im.camera_id]
        cam_in[s, 0:4] = im.qvec
        cam_in[s, 4:7] = im.tvec
        fx = cam.params[0]
        log_f = np.log(max(fx, 1e-6))
        if cam.model_id == camlib.PINHOLE:
            log_f = np.log(max(0.5 * (cam.params[0] + cam.params[1]), 1e-6))
            cam_in[s, 9:11] = cam.params[2:4]
        else:
            cam_in[s, 9:11] = cam.params[1:3]
            if cam.model_id != camlib.SIMPLE_PINHOLE:
                cam_in[s, 8] = cam.params[3]
        cam_in[s, 7] = log_f
        cam_in[s, 11] = 1.0    # cam_valid
        cam_in[s, 18] = log_f  # prior_log_f (weight 0 unless caller sets)

    pt_in = np.zeros((P, 4), np.float32)
    # quantized uint16 obs wire format (see bundle_adjust_flat): halves the
    # dominant upload of every solve on thin links. Keypoints are in-image
    # and non-negative; fall back to f32 for >4095 px frames (8K stills)
    quantize = (len(obs_uv) == 0 or float(obs_uv.max(initial=0.0)) < 4095.0)
    obs_dtype = np.uint16 if quantize else np.float32
    if point_ids:
        xyz = np.stack([rec.points3D[pid].xyz for pid in point_ids])
        pt_in[: len(point_ids), 0:3] = xyz
        pt_in[: len(point_ids), 3] = 1.0
        # scatter observations via sort-by-point (vectorized; the per-track
        # Python loop here dominated mapping host time at scale).
        # point_ids is sorted (np.unique) -> searchsorted maps pid -> slot
        o_pt = np.searchsorted(np.asarray(point_ids, np.int64), obs_pid)
        order = np.argsort(o_pt, kind="stable")
        o_pt_s = o_pt[order]
        counts = np.bincount(o_pt_s, minlength=P)
        offsets = np.concatenate([[0], np.cumsum(counts)])
        pos = np.arange(len(o_pt_s)) - offsets[o_pt_s]
        # clamp the track dim to the ACTUAL deepest track (bucketed): the
        # obs tensor is the dominant upload, and local windows rarely need
        # more than window-size slots — but merged tracks can observe one
        # image at two keypoints, so the bound is measured, never assumed
        max_track = min(max_track,
                        next_pow2(max(int(counts.max(initial=1)), 1), 4))
        # memory-driven slot cap: the CG trial's resident working set is
        # P*T*96 bytes (the stacked Wc) — bound the obs cells so merged-
        # collection solves stay near 1 GB on-chip (the uncapped 10k
        # solve crashed the worker). Truncation drops the least-recent
        # observations of the deepest tracks only.
        cell_cap = 8 << 20
        if P * max_track > cell_cap:
            max_track = max(8, cell_cap // P)
        obs_in = np.zeros((P, max_track, 4), obs_dtype)
        keep = pos < max_track
        rows, cols = o_pt_s[keep], pos[keep]
        obs_in[rows, cols, 0] = obs_slot[order][keep]
        if quantize:
            obs_in[rows, cols, 1:3] = np.clip(
                np.round(obs_uv[order][keep] * 16.0), 0, 65535
            ).astype(np.uint16)
        else:
            obs_in[rows, cols, 1:3] = obs_uv[order][keep]
        obs_in[rows, cols, 3] = 1
    else:
        obs_in = np.zeros((P, min(max_track, 4), 4), obs_dtype)

    meta = {"image_ids": list(image_ids), "point_ids": list(point_ids),
            "tied": tied}
    return cam_in, pt_in, obs_in, meta


def unpack_bundle(rec: Reconstruction, params: ba.BundleParams, meta: Dict,
                  update_intrinsics: bool = False):
    """Write optimized poses/points (and optionally intrinsics) back."""
    qvec = np.asarray(params.qvec)
    tvec = np.asarray(params.tvec)
    log_f = np.asarray(params.log_f)
    k1 = np.asarray(params.k1)
    xyz = np.asarray(params.xyz)
    # shared-camera slots are tied EXACTLY inside the solve (ba.cam_group) —
    # the mean below is an identity there; it remains only as a safety net
    # for callers that packed shared cameras without the tie column
    cam_slots: Dict[int, list] = {}
    for s, iid in enumerate(meta["image_ids"]):
        cam_slots.setdefault(rec.images[iid].camera_id, []).append(s)
    log_f_eff = log_f.copy()
    k1_eff = k1.copy()
    for slots in cam_slots.values():
        log_f_eff[slots] = np.mean(log_f[slots])
        k1_eff[slots] = np.mean(k1[slots])
    log_f, k1 = log_f_eff, k1_eff

    for s, iid in enumerate(meta["image_ids"]):
        im = rec.images[iid]
        im.qvec = qvec[s].copy()
        im.tvec = tvec[s].copy()
        if update_intrinsics:
            cam = rec.cameras[im.camera_id]
            f = float(np.exp(log_f[s]))
            if cam.model_id == camlib.SIMPLE_RADIAL:
                cam.params[0] = f
                cam.params[3] = float(k1[s])
            elif cam.model_id == camlib.SIMPLE_PINHOLE:
                cam.params[0] = f
            elif cam.model_id == camlib.PINHOLE:
                cam.params[0] = cam.params[1] = f
            else:
                cam.params[0] = f
                cam.params[3] = float(k1[s])
    for ps, pid in enumerate(meta["point_ids"]):
        if pid in rec.points3D:
            rec.points3D[pid].xyz = xyz[ps].copy()
