"""Incremental Structure-from-Motion engine.

Rebuilds the behavior of COLMAP's ``IncrementalMapper`` control loop as
replicated by the reference's mapping kernel
(/root/reference/integration/op_cpp/incremental_mapping.cc:268-373):
initial-pair selection and registration, next-image ranking, PnP
registration, triangulation, iterative local refinement, growth-triggered
global refinement (retriangulate + global BA + complete/merge tracks +
filtering), and a final global pass.

Architecture split (SURVEY §7.4.2): the success-dependent outer loop is
host Python over numpy control state; every numerical kernel — PnP RANSAC,
batched multi-view triangulation, the Schur-complement LM bundle — is a
jitted static-shape device call with bucketed padding.
"""

from __future__ import annotations

import logging
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from scanner_colmap_tpu.engine.bundle_io import (next_pow2, pack_bundle_flat,
                                                 unpack_bundle)
from scanner_colmap_tpu.engine.correspondence import CorrespondenceGraph
from scanner_colmap_tpu.models import cameras as camlib
from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.models.reconstruction import (Camera, Image,
                                                      Reconstruction,
                                                      np_reproj_errors)
from scanner_colmap_tpu.ops import ba, pnp, triangulate
from scanner_colmap_tpu.utils.config import MapperConfig

log = logging.getLogger(__name__)


class IncrementalMapper:
    """One cluster's incremental reconstruction.

    Inputs (all host numpy):
      keypoints: {image_id: (K_i, 2) pixel coords}
      cameras:   {image_id: (model_id, params, width, height, prior_focal)}
      graph:     CorrespondenceGraph of verified matches
      two_view:  {(id1, id2): dict(qvec, tvec, tri_angle, num_inliers)}
                 with id1 < id2, pose maps cam(id1) -> cam(id2)
    """

    def __init__(self, keypoints, cameras, graph: CorrespondenceGraph,
                 two_view, config: Optional[MapperConfig] = None, seed: int = 0):
        # keypoints may carry (x, y) or full (x, y, scale, ori) rows — the
        # engine only consumes positions
        self.kp = {i: np.asarray(k, np.float64)[:, :2]
                   for i, k in keypoints.items()}
        self.cam_info = cameras
        self.graph = graph
        self.two_view = two_view
        self.cfg = config or MapperConfig()
        self.rec = Reconstruction()
        # raw uint32 key data on the host: jax.random.PRNGKey/split would
        # dispatch a device program per registration attempt
        self._key_seed = np.uint32(seed)
        self._key_ctr = 0
        self.num_reg_trials: Dict[int, int] = {}
        self._kp_norm_cache: Dict[int, np.ndarray] = {}
        if getattr(graph, "has_fast_scans", False):
            # mirror point assignments into the native graph's index
            self.rec.observer = graph.set_point
        self._num_total_reg_images = 0
        # growth trackers for global-BA triggers (ref :339-350)
        self._ba_prev_num_reg = 0
        self._ba_prev_num_points = 0

        self._init_log_f: Dict[int, float] = {}
        # shared camera: when enabled and all images agree on model/dims,
        # every image references ONE camera (id -1) and BA ties intrinsics
        infos = list(self.cam_info.values())
        share = (self.cfg.single_camera and len(infos) > 0 and all(
            (i[0], i[2], i[3]) == (infos[0][0], infos[0][2], infos[0][3])
            for i in infos))
        if share:
            model_id, params, w, h, prior = infos[0]
            self.rec.add_camera(Camera(-1, model_id, w, h,
                                       np.array(params, np.float64), prior))
        for iid, kps in self.kp.items():
            model_id, params, w, h, prior = self.cam_info[iid]
            cam_id = -1 if share else iid
            if not share:
                self.rec.add_camera(Camera(iid, model_id, w, h,
                                           np.array(params, np.float64), prior))
            self._init_log_f[iid] = float(np.log(max(params[0], 1e-6)))
            self.rec.add_image(Image(
                image_id=iid, camera_id=cam_id, name=f"image_{iid}",
                xys=kps.copy(),
                point3D_ids=np.full(len(kps), -1, np.int64)))

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _next_key(self):
        self._key_ctr += 1
        return np.array([self._key_seed, np.uint32(self._key_ctr)], np.uint32)

    def _cam_arrays(self, image_id):
        cam = self.rec.cameras[self.rec.images[image_id].camera_id]
        return np.int32(cam.model_id), cam.params_padded

    def _normalize(self, image_id, uv: np.ndarray) -> np.ndarray:
        # host numpy: tiny per-image math where a device round-trip dominates
        mid, p = self._cam_arrays(image_id)
        return camlib.np_image_to_cam(int(mid), p, uv)

    def _kp_norm(self, image_id) -> np.ndarray:
        """Normalized coords of ALL keypoints, cached (one device call per
        image — the engine reads single rows from this in its inner loops)."""
        cached = self._kp_norm_cache.get(image_id)
        if cached is None:
            cached = self._normalize(image_id, self.kp[image_id])
            self._kp_norm_cache[image_id] = cached
        return cached

    def _focal(self, image_id) -> float:
        cam = self.rec.cameras[self.rec.images[image_id].camera_id]
        return float(cam.params[0])

    def point3D_of(self, image_id, kp_idx) -> int:
        return int(self.rec.images[image_id].point3D_ids[kp_idx])

    def _set_registered(self, image_id: int, registered: bool):
        self.rec.images[image_id].registered = registered
        self.graph.set_registered(image_id, registered)

    # ------------------------------------------------------------------
    # initial pair (ref :305-313)
    # ------------------------------------------------------------------
    def find_initial_pair(self) -> Optional[Tuple[int, int]]:
        min_ang = math.radians(self.cfg.init_min_tri_angle_deg)
        cands = []
        for (i, j) in self.graph.pairs:
            tv = self.two_view.get((i, j))
            if tv is None:
                continue
            if tv["num_inliers"] < self.cfg.init_min_num_inliers:
                continue
            if tv["tri_angle"] < min_ang:
                continue
            # COLMAP FindInitialImagePair: watermark/degenerate pairs carry
            # no usable baseline (config enum in ops/two_view.py). Planar
            # pairs stay eligible — their pose now comes from the H
            # decomposition; pure-panoramic pairs are excluded by the
            # tri_angle gate above (tri_angle == 0).
            cfg_v = tv.get("config", 2)
            if cfg_v in (0, 1, 7):  # UNDEFINED, DEGENERATE, WATERMARK
                continue
            cands.append((tv["num_inliers"], i, j))
        if not cands:
            return None
        cands.sort(reverse=True)
        return cands[0][1], cands[0][2]

    def register_initial_pair(self, image_id1: int, image_id2: int) -> bool:
        tv = self.two_view[(min(image_id1, image_id2), max(image_id1, image_id2))]
        if image_id1 > image_id2:
            qrel, trel = geom.np_pose_inverse(tv["qvec"], tv["tvec"])
        else:
            qrel, trel = np.asarray(tv["qvec"]), np.asarray(tv["tvec"])

        im1, im2 = self.rec.images[image_id1], self.rec.images[image_id2]
        im1.qvec = np.array([1.0, 0, 0, 0])
        im1.tvec = np.zeros(3)
        im2.qvec = qrel.copy()
        im2.tvec = trel.copy()
        self._set_registered(image_id1, True)
        self._set_registered(image_id2, True)
        self._num_total_reg_images = 2
        n = self.triangulate_image(image_id1)
        log.info("initial pair (%d, %d): %d points", image_id1, image_id2, n)
        return n >= self.cfg.init_min_num_inliers // 2

    # ------------------------------------------------------------------
    # next images (ref :322-328)
    # ------------------------------------------------------------------
    def find_next_images(self) -> List[int]:
        scores = []
        for iid, im in self.rec.images.items():
            if im.registered:
                continue
            if self.num_reg_trials.get(iid, 0) >= self.cfg.max_reg_trials:
                continue
            n = self.graph.num_visible_points3D(iid, self.point3D_of)
            if n >= 3:
                scores.append((n, iid))
        scores.sort(reverse=True)
        return [iid for _, iid in scores]

    # ------------------------------------------------------------------
    # registration (ref :329, COLMAP RegisterNextImage)
    # ------------------------------------------------------------------
    def register_next_image(self, image_id: int) -> bool:
        self.num_reg_trials[image_id] = self.num_reg_trials.get(image_id, 0) + 1
        if self.graph.has_fast_scans:
            kps_f, pids_f = self.graph.corrs_2d3d(image_id)
            corr2d3d = [(int(k), int(p)) for k, p in zip(kps_f, pids_f)
                        if int(p) in self.rec.points3D]
        else:
            corr2d3d = []  # (kp_idx, pid)
            seen_kp = set()
            for kp_idx in range(len(self.kp[image_id])):
                for (j, kj) in self.graph.correspondences(image_id, kp_idx):
                    if not self.rec.images[j].registered:
                        continue
                    pid = self.point3D_of(j, kj)
                    if pid >= 0 and kp_idx not in seen_kp:
                        corr2d3d.append((kp_idx, pid))
                        seen_kp.add(kp_idx)
                        break
        if len(corr2d3d) < max(6, self.cfg.abs_pose_min_num_inliers // 2):
            return False

        kp_idx = np.array([c[0] for c in corr2d3d])
        pids = [c[1] for c in corr2d3d]
        xn = self._kp_norm(image_id)[kp_idx]
        x3d = np.stack([self.rec.points3D[p].xyz for p in pids])

        N = next_pow2(len(corr2d3d), 256)
        xn_p = np.zeros((N, 2))
        x3d_p = np.zeros((N, 3))
        valid = np.zeros(N, bool)
        xn_p[: len(xn)] = xn
        x3d_p[: len(x3d)] = x3d
        valid[: len(xn)] = True

        thr = self.cfg.abs_pose_max_error / self._focal(image_id)
        # packed upload [x3d, xn, valid] + packed download: one transfer each
        packed_in = np.concatenate(
            [x3d_p, xn_p, valid[:, None].astype(np.float64)], axis=1)
        out = np.asarray(pnp.pnp_ransac_packed_cols(
            self._next_key(), packed_in, np.float64(thr),
            min_num_inliers=min(self.cfg.abs_pose_min_num_inliers,
                                max(6, len(corr2d3d) // 2)),
            min_inlier_ratio=self.cfg.abs_pose_min_inlier_ratio))
        if out[8] < 0.5:  # ok flag
            return False

        im = self.rec.images[image_id]
        im.qvec = out[0:4].astype(np.float64)
        im.tvec = out[4:7].astype(np.float64)
        self._set_registered(image_id, True)
        self._num_total_reg_images += 1

        # attach inlier observations to their tracks
        inl = out[9: 9 + len(corr2d3d)] > 0.5
        for (k, pid), ok in zip(corr2d3d, inl):
            if ok and pid in self.rec.points3D and im.point3D_ids[k] < 0:
                self.rec.points3D[pid].track.append((image_id, int(k)))
                self.rec.set_point3D_id(image_id, int(k), pid)
        return True

    # ------------------------------------------------------------------
    # triangulation (ref :49-57, COLMAP TriangulateImage)
    # ------------------------------------------------------------------
    def triangulate_image(self, image_id: int) -> int:
        """Continue existing tracks + triangulate new points seen from
        image_id. Returns number of new points."""
        if not self.rec.images[image_id].registered:
            return 0
        self._continue_tracks(image_id)
        return self._triangulate_tracks(self._new_track_candidates(image_id))

    def _continue_tracks(self, image_id: int) -> None:
        """Link unassigned keypoints of image_id to existing points reachable
        via correspondences (batched geometric check)."""
        im = self.rec.images[image_id]
        if self.graph.has_fast_scans:
            kps_f, pids_f = self.graph.continuations(image_id)
            if len(kps_f) == 0:
                return
            pts = self.rec.points3D
            xyz = np.zeros((len(pids_f), 3))
            valid = np.zeros(len(pids_f), bool)
            for i, pid in enumerate(pids_f):
                pt = pts.get(int(pid))
                if pt is not None and im.point3D_ids[int(kps_f[i])] < 0:
                    xyz[i] = pt.xyz
                    valid[i] = True
            fits = np.zeros(len(pids_f), bool)
            if valid.any():
                fits[valid] = self._batch_fits(
                    np.full(int(valid.sum()), image_id), kps_f[valid],
                    xyz[valid])
            for i in np.flatnonzero(fits):
                kp_idx, pid = int(kps_f[i]), int(pids_f[i])
                if im.point3D_ids[kp_idx] >= 0:
                    continue
                pts[pid].track.append((image_id, kp_idx))
                self.rec.set_point3D_id(image_id, kp_idx, pid)
        else:
            for kp_idx in range(len(self.kp[image_id])):
                if im.point3D_ids[kp_idx] >= 0:
                    continue
                for (j, kj) in self.graph.correspondences(image_id, kp_idx):
                    if not self.rec.images[j].registered:
                        continue
                    pid = self.point3D_of(j, kj)
                    if pid < 0:
                        continue
                    if self._observation_fits(image_id, kp_idx, pid):
                        self.rec.points3D[pid].track.append((image_id, kp_idx))
                        self.rec.set_point3D_id(image_id, kp_idx, pid)
                    break

    def _new_track_candidates(self, image_id: int):
        """Unassigned kps of image_id with >= 1 registered unassigned corr."""
        if self.graph.has_fast_scans:
            return self.graph.new_track_candidates(image_id)
        im = self.rec.images[image_id]
        tracks = []  # list of [(img, kp), ...]
        for kp_idx in range(len(self.kp[image_id])):
            if im.point3D_ids[kp_idx] >= 0:
                continue
            track = [(image_id, kp_idx)]
            for (j, kj) in self.graph.correspondences(image_id, kp_idx):
                if (self.rec.images[j].registered
                        and self.point3D_of(j, kj) < 0):
                    track.append((j, kj))
            if len(track) >= 2:
                tracks.append(track)
        return tracks

    def _batch_fits(self, iids, kps, xyz, thr_factor: float = 1.0) -> np.ndarray:
        """Vectorized `_observation_fits` over parallel arrays: does point
        xyz[i] reproject within threshold at keypoint kps[i] of image
        iids[i]? One batched rotate/project for all candidates."""
        if len(np.asarray(iids)) == 0:
            return np.zeros(0, bool)
        err, z = np_reproj_errors(self.rec, iids, kps, xyz)
        return (z > 0) & (err < self.cfg.filter_max_reproj_error * thr_factor)

    def _observation_fits(self, image_id, kp_idx, pid,
                          thr_factor: float = 1.0) -> bool:
        im = self.rec.images[image_id]
        pt = self.rec.points3D[pid]
        x_cam = geom.np_pose_transform(im.qvec, im.tvec, pt.xyz)
        if x_cam[2] <= 0:
            return False
        cam = self.rec.cameras[im.camera_id]
        uv = camlib.np_cam_to_image(cam.model_id, cam.params, x_cam)
        err = np.linalg.norm(uv - self.kp[image_id][kp_idx])
        return err < self.cfg.filter_max_reproj_error * thr_factor

    def _triangulate_tracks(self, tracks) -> int:
        """Batch-triangulate candidate tracks; add accepted points.

        Large candidate sets (full-graph retriangulation at collection
        scale produces millions) run in fixed-size chunks: the kernel's
        (B, T, T) pair-angle block alone is B*256 bytes, and an unchunked
        2M-track batch puts multi-GB transients on the chip. Full chunks
        share one compiled shape."""
        if not tracks:
            return 0
        CHUNK = 262144
        if len(tracks) > CHUNK:
            n = 0
            for s in range(0, len(tracks), CHUNK):
                n += self._triangulate_tracks(tracks[s: s + CHUNK])
            return n
        T = 8
        # generous bucket floor: each distinct shape costs a ~2 s remote
        # compile on cacheless backends, far more than the padded FLOPs
        B = next_pow2(len(tracks), 512)
        # one packed upload [qvec, tvec, xn, mask] and one packed download
        data = np.zeros((B, T, 10))
        data[..., 0] = 1.0
        focals = []
        for b, track in enumerate(tracks):
            f_sum = 0.0
            for t, (iid, kp) in enumerate(track[:T]):
                im = self.rec.images[iid]
                data[b, t, 0:4] = im.qvec
                data[b, t, 4:7] = im.tvec
                data[b, t, 7:9] = self._kp_norm(iid)[kp]
                data[b, t, 9] = 1.0
                f_sum += self._focal(iid)
            focals.append(f_sum / min(len(track), T))
        thr_n = self.cfg.filter_max_reproj_error / np.asarray(focals)
        thr_pad = np.full(B, 1e-3)
        thr_pad[: len(tracks)] = thr_n

        out = np.asarray(triangulate.triangulate_tracks_packed(
            data, thr_pad, np.float64(math.radians(self.cfg.min_tri_angle_deg))))
        xyz = out[:, 0:3]
        ok = out[:, 3] > 0.5
        view_ok = out[:, 4:] > 0.5

        n_new = 0
        for b, track in enumerate(tracks):
            if not ok[b]:
                continue
            kept = [te for t, te in enumerate(track[:T]) if view_ok[b, t]]
            # guard against double-assignment created earlier in this batch
            kept = [(i, k) for (i, k) in kept
                    if self.rec.images[i].point3D_ids[k] < 0]
            if len(kept) < 2:
                continue
            self.rec.add_point3D(xyz[b], kept)
            n_new += 1
        return n_new

    # ------------------------------------------------------------------
    # track completion + merging (COLMAP CompleteAndMergeTracks, ref :141-178)
    # ------------------------------------------------------------------
    def complete_tracks(self, point_ids=None) -> int:
        """With point_ids, only those points' tracks are extended (COLMAP's
        local refinement completes the BA window's points, not the model)."""
        if self.graph.has_fast_scans:
            # one native scan for all candidates + one batched fit check
            iids, kps, pids = self.graph.complete_candidates()
            if point_ids is not None and len(pids):
                sub = np.isin(pids, np.fromiter(point_ids, np.int64,
                                                len(point_ids)))
                iids, kps, pids = iids[sub], kps[sub], pids[sub]
            if len(iids) == 0:
                return 0
            pts = self.rec.points3D
            xyz = np.zeros((len(pids), 3))
            valid = np.zeros(len(pids), bool)
            for i, pid in enumerate(pids):
                pt = pts.get(int(pid))
                if pt is not None:
                    xyz[i] = pt.xyz
                    valid[i] = True
            fits = np.zeros(len(pids), bool)
            if valid.any():
                fits[valid] = self._batch_fits(iids[valid], kps[valid],
                                               xyz[valid])
            n = 0
            for i in np.flatnonzero(fits):
                iid, kp, pid = int(iids[i]), int(kps[i]), int(pids[i])
                if self.rec.images[iid].point3D_ids[kp] >= 0:
                    continue  # a previous candidate won this keypoint
                pts[pid].track.append((iid, kp))
                self.rec.set_point3D_id(iid, kp, pid)
                n += 1
            return n
        n = 0
        for pid in (list(self.rec.points3D.keys())
                    if point_ids is None else list(point_ids)):
            pt = self.rec.points3D.get(pid)
            if pt is None:
                continue
            for (iid, kp) in list(pt.track):
                for (j, kj) in self.graph.correspondences(iid, kp):
                    im_j = self.rec.images[j]
                    if not im_j.registered or im_j.point3D_ids[kj] >= 0:
                        continue
                    if self._observation_fits(j, kj, pid):
                        pt.track.append((j, int(kj)))
                        self.rec.set_point3D_id(j, int(kj), pid)
                        n += 1
        return n

    def merge_tracks(self, point_ids=None) -> int:
        """Merge pairs of 3D points linked by a correspondence whose merged
        position fits both tracks. With point_ids, only merges touching
        those points are considered."""
        if self.graph.has_fast_scans:
            return self._merge_tracks_fast(point_ids)
        n = 0
        for pid in (list(self.rec.points3D.keys())
                    if point_ids is None else list(point_ids)):
            pt = self.rec.points3D.get(pid)
            if pt is None:
                continue
            partner = None
            for (iid, kp) in pt.track:
                for (j, kj) in self.graph.correspondences(iid, kp):
                    if not self.rec.images[j].registered:
                        continue
                    pid2 = self.point3D_of(j, kj)
                    if pid2 >= 0 and pid2 != pid:
                        partner = pid2
                        break
                if partner:
                    break
            if partner is None or partner not in self.rec.points3D:
                continue
            pt2 = self.rec.points3D[partner]
            w1, w2 = len(pt.track), len(pt2.track)
            merged_xyz = (pt.xyz * w1 + pt2.xyz * w2) / (w1 + w2)
            # verify merged point fits all observations
            old_xyz1, old_xyz2 = pt.xyz.copy(), pt2.xyz.copy()
            pt.xyz = merged_xyz
            fits = all(
                self._observation_fits(i, k, pid)
                for (i, k) in pt.track + pt2.track
                if self.rec.images[i].registered)
            pt.xyz = old_xyz1
            if not fits:
                continue
            # move pt2's observations into pt
            for (i, k) in pt2.track:
                self.rec.set_point3D_id(i, int(k), pid)
            pt.track = pt.track + pt2.track
            pt.xyz = merged_xyz
            del self.rec.points3D[partner]
            n += 1
        return n

    def _merge_tracks_fast(self, point_ids=None) -> int:
        """Native candidate scan + ONE batched fit check for all candidate
        merges, then sequential conflict-free application."""
        pa, pb = self.graph.merge_candidates()
        if point_ids is not None and len(pa):
            ids = np.fromiter(point_ids, np.int64, len(point_ids))
            sub = np.isin(pa, ids) | np.isin(pb, ids)
            pa, pb = pa[sub], pb[sub]
        if len(pa) == 0:
            return 0
        pts = self.rec.points3D
        # gather candidate merged positions + all observations to check
        cand = []           # (pid_keep, pid_gone, merged_xyz)
        f_iids, f_kps, f_xyz, f_cand = [], [], [], []
        for a, b in zip(pa, pb):
            a, b = int(a), int(b)
            pt1, pt2 = pts.get(a), pts.get(b)
            if pt1 is None or pt2 is None:
                continue
            w1, w2 = len(pt1.track), len(pt2.track)
            merged = (pt1.xyz * w1 + pt2.xyz * w2) / (w1 + w2)
            ci = len(cand)
            cand.append((a, b, merged))
            for (i, k) in pt1.track + pt2.track:
                if self.rec.images[i].registered:
                    f_iids.append(i)
                    f_kps.append(k)
                    f_xyz.append(merged)
                    f_cand.append(ci)
        if not cand:
            return 0
        fits = self._batch_fits(f_iids, f_kps, np.asarray(f_xyz))
        f_cand = np.asarray(f_cand)
        ok_per_cand = np.ones(len(cand), bool)
        np.logical_and.at(ok_per_cand, f_cand, fits)

        n = 0
        touched = set()
        for ci in np.flatnonzero(ok_per_cand):
            a, b, merged = cand[ci]
            # the fit check used a PRE-ROUND snapshot of both tracks; once
            # either endpoint has merged this round, the snapshot is stale
            # and applying would attach observations never validated against
            # the relocated point — defer such candidates to the next round
            if a in touched or b in touched:
                continue
            pt1, pt2 = pts.get(a), pts.get(b)
            if pt1 is None or pt2 is None:
                continue  # consumed by an earlier merge this round
            for (i, k) in pt2.track:
                self.rec.set_point3D_id(i, int(k), a)
            pt1.track = pt1.track + pt2.track
            pt1.xyz = merged
            del pts[b]
            touched.add(a)
            touched.add(b)
            n += 1
        return n

    # ------------------------------------------------------------------
    # filtering (COLMAP FilterPoints/FilterImages, ref :141-178)
    # ------------------------------------------------------------------
    def filter_points(self, point_ids=None) -> int:
        """Reprojection-error + max-triangulation-angle filtering, fully
        vectorized over the flattened observation arrays (the per-point loop
        dominated mapping wall-clock before). With point_ids, only those
        points are checked (COLMAP filters modified points in local passes)."""
        if not self.rec.points3D:
            return 0
        self.rec.compute_reprojection_errors(point_ids)
        min_ang = math.radians(self.cfg.min_tri_angle_deg)

        pids, xyz, obs_pt, obs_img, _, img_list = self.rec.flat_observations(
            point_ids)
        Np = len(pids)
        if Np == 0:
            return 0
        err = np.fromiter((self.rec.points3D[p].error for p in pids),
                          np.float64, Np)
        bad = (err > self.cfg.filter_max_reproj_error) | (err < 0)

        # registered observing-camera centers per point (padded ragged)
        reg = np.asarray([self.rec.images[i].registered for i in img_list])
        if len(obs_pt):
            keep = reg[obs_img]
            op, oi = obs_pt[keep], obs_img[keep]
        else:
            op = oi = np.zeros(0, np.int64)
        counts = np.bincount(op, minlength=Np)
        bad |= counts < 2

        if len(op) and counts.max() >= 2:
            q = np.stack([self.rec.images[i].qvec for i in img_list])
            t = np.stack([self.rec.images[i].tvec for i in img_list])
            centers = geom.np_projection_center(q, t)
            order = np.argsort(op, kind="stable")
            op_s, oi_s = op[order], oi[order]
            offsets = np.concatenate([[0], np.cumsum(counts)])
            pos = np.arange(len(op_s)) - offsets[op_s]
            T = int(counts.max())
            # cap the pairwise-angle check at S spread observations per
            # point: the full (Np, T, T) f64 einsum moved GBs at merged-
            # model scale (T~40, measured 33 s of a 36 s filter pass).
            # Evenly-spaced-in-image-order samples keep the extreme
            # baselines (images are trajectory-ordered), and an
            # UNDER-estimated max angle only filters more aggressively —
            # never keeps a point COLMAP's exact rule would drop. Each
            # track's FIRST and LAST registered observation are always in
            # the sample (first lands first-in-slot; last is taken as the
            # slot-(S-1) representative) so the widest trajectory baseline
            # — e.g. the two legs of a loop-closure track — bounds the
            # under-estimate (ADVICE r3).
            S = 8
            if T > S:
                cnt = counts[op_s]
                slot = (pos * S + S - 1) // np.maximum(cnt, 1)
                first = np.ones(len(pos), bool)
                first[1:] = (op_s[1:] != op_s[:-1]) | (slot[1:] != slot[:-1])
                lastg = np.ones(len(pos), bool)   # last element of its track
                lastg[:-1] = op_s[1:] != op_s[:-1]
                # a track's last obs has pos=cnt-1 -> slot S-1 exactly, so
                # (first-in-slot for slots < S-1) + (track-last for S-1)
                # keeps one element per (point, slot) with no collisions
                keep = (first & (slot != S - 1)) | lastg
                op_s, oi_s = op_s[keep], oi_s[keep]
                pos = slot[keep]
                T = S
            rays = np.zeros((Np, T, 3), np.float32)
            mask = np.zeros((Np, T), bool)
            rays[op_s, pos] = (centers[oi_s] - xyz[op_s]).astype(np.float32)
            mask[op_s, pos] = True
            rn = rays / np.maximum(
                np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
            cosang = np.einsum("pti,psi->pts", rn, rn)
            pair = mask[:, :, None] & mask[:, None, :]
            # compare in cosine space (arccos of the full (Np,T,T) block
            # was another multi-second pass); angle >= min_ang  <=>
            # cos <= cos(min_ang)
            min_cos = np.min(np.where(pair, cosang, 1.0), axis=(1, 2))
            bad |= min_cos > np.cos(min_ang)

        removed = 0
        for i in np.flatnonzero(bad):
            self.rec.remove_point3D(int(pids[i]))
            removed += 1
        return removed

    def filter_images(self) -> int:
        removed = 0
        for iid in self.rec.registered_image_ids:
            im = self.rec.images[iid]
            n = im.num_points3D
            if self._num_total_reg_images > 2 and n < 3:
                self.rec.deregister_image(iid)
                self.graph.set_registered(iid, False)
                removed += 1
        return removed

    # ------------------------------------------------------------------
    # bundle adjustment (ref :59-139)
    # ------------------------------------------------------------------
    def _run_ba(self, image_ids, max_iterations, refine_intrinsics=True,
                fix_all_poses_outside=None):
        cam_in, pt_in, obs_in, meta = pack_bundle_flat(self.rec, image_ids)
        if not meta["point_ids"] or len(meta["image_ids"]) < 2:
            return None
        # gauge: fully fix slot 0, fix one translation comp of slot 1
        cam_in[0, 12:18] = 0.0
        cam_in[1, 15] = 0.0
        if fix_all_poses_outside is not None:
            inside = set(fix_all_poses_outside)
            for s, iid in enumerate(meta["image_ids"]):
                if iid not in inside:
                    cam_in[s, 12:18] = 0.0
        # per-slot prior weight = weight of the PHYSICAL camera divided by
        # its group size (shared-camera slots sum to one camera's prior)
        group_size = {}
        for iid in meta["image_ids"]:
            cid = self.rec.images[iid].camera_id
            group_size[cid] = group_size.get(cid, 0) + 1
        for s, iid in enumerate(meta["image_ids"]):
            cam_in[s, 18] = self._init_log_f[iid]
            g = group_size[self.rec.images[iid].camera_id]
            cam_in[s, 20] = self.cfg.intr_prior_weight_f / g
            cam_in[s, 21] = self.cfg.intr_prior_weight_k / g
        # COLMAP's BA default refines focal even with an EXIF prior
        # (ba_refine_focal_length=true — the prior is the INIT, and the
        # quadratic prior term above keeps the solve in its basin; from a
        # prior-less 1.2*max(w,h) default init the reconstruction is
        # self-consistent at the wrong focal and BA cannot escape anyway)
        scal_in = np.asarray([
            float(bool(refine_intrinsics)),
            float(bool(refine_intrinsics)),
            float(self.cfg.filter_max_reproj_error)], np.float32)

        # segmented solve: 16-trip device programs, host-continued while
        # unconverged (most solves stop after one segment). Past the dense
        # Schur bound (merged-model refinement spans every image) the solve
        # switches to the matrix-free CG path.
        P = pt_in.shape[0]
        solver = ("dense" if cam_in.shape[0]
                  <= getattr(self.cfg, "ba_dense_max_images", 256) else "cg")
        out = ba.bundle_adjust_flat_segmented(
            cam_in, pt_in, obs_in, scal_in,
            max_iterations=max_iterations, chunk=min(1024, P), solver=solver,
            cg_iters=getattr(self.cfg, "ba_cg_iters", 32))
        M = cam_in.shape[0]
        cam = out[: M * 9].reshape(M, 9).astype(np.float64)
        xyz = out[M * 9: M * 9 + P * 3].reshape(P, 3).astype(np.float64)
        stats = out[M * 9 + P * 3:]
        p_out = ba.BundleParams(qvec=cam[:, 0:4], tvec=cam[:, 4:7],
                                log_f=cam[:, 7], k1=cam[:, 8], xyz=xyz)
        info = {"initial_cost": stats[0], "final_cost": stats[1],
                "iterations": stats[2], "mean_reproj_px": stats[3],
                "num_obs": stats[4], "point_ids": meta["point_ids"]}
        unpack_bundle(self.rec, p_out, meta, update_intrinsics=refine_intrinsics)
        if refine_intrinsics:
            # normalized-keypoint cache depends on intrinsics
            for iid in meta["image_ids"]:
                self._kp_norm_cache.pop(iid, None)
        return info

    def local_bundle_adjustment(self, image_ids):
        """Iterative local refinement (ref :86-114): BA over the images most
        connected to image_ids, repeated until the changed-observation ratio
        drops below ba_local_max_refinement_change.

        Accepts one image id or a batch (register_batch_size registrations
        share one refinement round — the union of their neighbor windows is
        solved jointly, amortizing the solve's link round trip)."""
        if isinstance(image_ids, (int, np.integer)):
            image_ids = [int(image_ids)]
        batch = [i for i in image_ids if self.rec.images[i].registered]
        if not batch:
            return
        # local window: images sharing the most points with the batch
        share = {}
        bset = set(batch)
        for image_id in batch:
            im = self.rec.images[image_id]
            for pid in im.point3D_ids:
                if pid < 0:
                    continue
                for (j, _) in self.rec.points3D[int(pid)].track:
                    if j not in bset and self.rec.images[j].registered:
                        share[j] = share.get(j, 0) + 1
        n_neighbors = min(7 * len(batch), 16 - len(batch))
        neighbors = sorted(share, key=share.get, reverse=True)[:n_neighbors]
        # gauge: _run_ba freezes slots 0/1 — those must be the most
        # ESTABLISHED images, not the just-PnP-registered ones (freezing the
        # noisiest pose dragged every settled neighbor toward PnP error).
        # Stability proxy: number of 3D points observed.
        anchors = sorted(neighbors,
                         key=lambda j: self.rec.images[j].num_points3D,
                         reverse=True)[:2]
        rest = [j for j in neighbors if j not in anchors]
        window = anchors + rest + batch
        if len(window) < 2:
            return
        prev_points = None
        for it in range(self.cfg.ba_local_max_refinements):
            info = self._run_ba(window, self.cfg.ba_local_max_num_iterations,
                                refine_intrinsics=True)
            if info is None:
                return
            # COLMAP's local refinement completes/merges/filters the BA
            # window's points only — whole-model passes here made mapping
            # O(model^2) over the run
            touched = info["point_ids"]
            self.complete_tracks(touched)
            self.merge_tracks(touched)
            self.filter_points(touched)
            # converged solve -> further refinement rounds are no-ops;
            # skipping them halves the local-BA device round trips
            rel_drop = (info["initial_cost"] - info["final_cost"]) / max(
                float(info["initial_cost"]), 1e-12)
            if rel_drop < 10 * self.cfg.ba_local_max_refinement_change:
                break
            num_points = len(self.rec.points3D)
            if prev_points is not None:
                change = abs(num_points - prev_points) / max(prev_points, 1)
                if change < self.cfg.ba_local_max_refinement_change:
                    break
            prev_points = num_points

    def global_bundle_adjustment(self):
        """Iterative global refinement (ref :116-139): retriangulate, BA over
        all registered images, complete/merge tracks, filter."""
        reg = self.rec.registered_image_ids
        if len(reg) < 2:
            return
        import time as _time
        for it in range(self.cfg.ba_global_max_refinements):
            t0 = _time.time()
            self.retriangulate()
            t_retri = _time.time() - t0
            prev_obs = sum(p.track_length for p in self.rec.points3D.values())
            # stricter solve for tiny models, like ref :66-73
            iters = self.cfg.ba_global_max_num_iterations
            if len(reg) < 10:
                iters *= 2
            t0 = _time.time()
            info = self._run_ba(reg, iters, refine_intrinsics=True)
            t_ba = _time.time() - t0
            if info is None:
                return
            t0 = _time.time()
            self.complete_tracks()
            self.merge_tracks()
            self.filter_points()
            self.filter_images()
            t_tracks = _time.time() - t0
            log.info("global refine round %d: retriangulate %.1fs, "
                     "BA %.1fs (cost %.0f -> %.0f), track ops %.1fs",
                     it + 1, t_retri, t_ba, float(info["initial_cost"]),
                     float(info["final_cost"]), t_tracks)
            reg = self.rec.registered_image_ids
            num_obs = sum(p.track_length for p in self.rec.points3D.values())
            change = abs(num_obs - prev_obs) / max(prev_obs, 1)
            rel_drop = (info["initial_cost"] - info["final_cost"]) / max(
                float(info["initial_cost"]), 1e-12)
            if (change < self.cfg.ba_global_max_refinement_change
                    or rel_drop < self.cfg.ba_global_max_refinement_change):
                break

    def retriangulate(self):
        """Re-create tracks for under-reconstructed pairs (cheap version of
        COLMAP's Retriangulate): continue + new tracks from every registered
        image, with ONE batched triangulation device call for all of them
        (duplicate candidates anchored at both endpoints lose their second
        copy to the double-assignment guard in _triangulate_tracks)."""
        tracks = []
        for iid in self.rec.registered_image_ids:
            self._continue_tracks(iid)
            tracks.extend(self._new_track_candidates(iid))
        self._triangulate_tracks(tracks)

    def _check_global_ba_trigger(self) -> bool:
        """Growth-ratio/frequency triggers (ref :339-350)."""
        n_reg = self._num_total_reg_images
        n_pts = len(self.rec.points3D)
        if self._ba_prev_num_reg == 0:
            return True
        if n_reg >= self.cfg.ba_global_images_ratio * self._ba_prev_num_reg:
            return True
        if n_reg >= self._ba_prev_num_reg + self.cfg.ba_global_images_freq:
            return True
        if self._ba_prev_num_points and (
                n_pts >= self.cfg.ba_global_points_ratio * self._ba_prev_num_points
                or n_pts >= self._ba_prev_num_points + self.cfg.ba_global_points_freq):
            return True
        return False

    # ------------------------------------------------------------------
    # main loop (ref :305-361)
    # ------------------------------------------------------------------
    def reconstruct(self, init_pair: Optional[Tuple[int, int]] = None) -> Reconstruction:
        if init_pair is None:
            init_pair = self.find_initial_pair()
        if init_pair is None:
            log.warning("no valid initial pair")
            return self.rec
        if not self.register_initial_pair(*init_pair):
            log.warning("initial pair registration weak")
        self.global_bundle_adjustment()
        self._ba_prev_num_reg = self._num_total_reg_images
        self._ba_prev_num_points = len(self.rec.points3D)

        reg_next_success = True
        while reg_next_success:
            reg_next_success = False
            # register up to register_batch_size images before one joint
            # local refinement (K=1 reproduces COLMAP's schedule exactly;
            # PnP + triangulation run host-side, so the device round trips
            # scale with refinement ROUNDS, not registrations). Candidates
            # re-rank after every success, like COLMAP's outer loop.
            batch: List[int] = []
            while len(batch) < max(1, self.cfg.register_batch_size):
                registered = False
                for image_id in self.find_next_images():
                    if self.register_next_image(image_id):
                        self.triangulate_image(image_id)
                        batch.append(image_id)
                        registered = True
                        break
                if not registered:
                    break
            if batch:
                reg_next_success = True
                self.local_bundle_adjustment(batch)
                if self._check_global_ba_trigger():
                    self.global_bundle_adjustment()
                    self._ba_prev_num_reg = self._num_total_reg_images
                    self._ba_prev_num_points = len(self.rec.points3D)

        self.global_bundle_adjustment()
        self.rec.compute_reprojection_errors()
        log.info("reconstruction: %d images, %d points, mean err %.3f px",
                 self.rec.num_registered, len(self.rec.points3D),
                 self.rec.mean_reprojection_error())
        return self.rec
