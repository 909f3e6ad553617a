"""Profile merged-model HOST ops in isolation on a synthetic model —
no pipeline, no device. Times the pieces that made up the untimed
~290 s transplant/warm-start/bookkeeping and the 172 s fold of the 10k
run (PERFORMANCE.md lever 37) so each can be optimized and re-measured
in seconds instead of a 48-minute pipeline rerun.

    JAX_PLATFORMS=cpu python tools/prof_host_ops.py          # defaults
    HOST_N=2000 HOST_P=110000 ...                            # scale knobs
"""

import logging
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
logging.basicConfig(level=logging.WARNING, stream=sys.stderr)

import numpy as np


def build_scene(n_img, n_pts, track_w=4, kmax=1024, seed=0):
    """Synthetic consistent merged model + graph inputs.

    Returns (model, keypoints, cameras, graph, two_view)."""
    from scanner_colmap_tpu.engine.correspondence import make_graph
    from scanner_colmap_tpu.models.reconstruction import (Camera, Image,
                                                          Reconstruction)

    rng = np.random.default_rng(seed)
    W, H, f = 480, 360, 500.0
    spacing = 0.2
    # camera i at (i*spacing, 0, 0), looking +z
    cam_x = np.arange(n_img) * spacing

    # each point anchored near a random image, visible from a window
    anchor = rng.integers(0, n_img, n_pts)
    depth = rng.uniform(4.0, 12.0, n_pts)
    px = cam_x[anchor] + rng.uniform(-1.5, 1.5, n_pts)
    py = rng.uniform(-2.0, 2.0, n_pts)
    xyz = np.stack([px, py, depth], 1)

    start = np.maximum(anchor - track_w // 2, 0)
    start = np.minimum(start, n_img - track_w)

    # project point p into images start[p]..start[p]+track_w-1
    obs_pt = np.repeat(np.arange(n_pts), track_w)
    obs_img = (start[:, None] + np.arange(track_w)[None, :]).reshape(-1)
    xc = xyz[obs_pt] - np.stack([cam_x[obs_img], np.zeros(len(obs_img)),
                                 np.zeros(len(obs_img))], 1)
    u = f * xc[:, 0] / xc[:, 2] + W / 2
    v = f * xc[:, 1] / xc[:, 2] + H / 2
    ok = (u >= 0) & (u < W) & (v >= 0) & (v < H)
    obs_pt, obs_img, u, v = obs_pt[ok], obs_img[ok], u[ok], v[ok]

    # assign keypoint slots per image in observation order; drop overflow
    order = np.argsort(obs_img, kind="stable")
    obs_pt, obs_img, u, v = obs_pt[order], obs_img[order], u[order], v[order]
    counts = np.bincount(obs_img, minlength=n_img)
    offsets = np.concatenate([[0], np.cumsum(counts)])
    slot = np.arange(len(obs_img)) - offsets[obs_img]
    keep = slot < kmax
    obs_pt, obs_img, u, v, slot = (obs_pt[keep], obs_img[keep], u[keep],
                                   v[keep], slot[keep])

    # drop points with < 2 surviving obs
    tl = np.bincount(obs_pt, minlength=n_pts)
    keep = tl[obs_pt] >= 2
    obs_pt, obs_img, u, v, slot = (obs_pt[keep], obs_img[keep], u[keep],
                                   v[keep], slot[keep])

    kcount = np.bincount(obs_img, minlength=n_img)
    kp_arrays = {}
    for i in range(n_img):
        k = max(int(kcount[i]), 8)
        a = rng.uniform([0, 0], [W, H], (k, 2))
        kp_arrays[i] = a
    kp_arrays_by_img = kp_arrays
    for i in np.unique(obs_img):
        m = obs_img == i
        kp_arrays_by_img[i][slot[m].astype(int)] = np.stack(
            [u[m], v[m]], 1)

    cameras = {i: (2, np.array([f, W / 2, H / 2, 0.0]), W, H, False)
               for i in range(n_img)}

    model = Reconstruction()
    model.add_camera(Camera(-1, 2, W, H, np.array([f, W / 2, H / 2, 0.0])))
    for i in range(n_img):
        model.add_image(Image(
            image_id=i, camera_id=-1, name=f"im{i}",
            qvec=np.array([1.0, 0, 0, 0]),
            tvec=np.array([-cam_x[i], 0.0, 0.0]),
            xys=kp_arrays[i].copy(),
            point3D_ids=np.full(len(kp_arrays[i]), -1, np.int64),
            registered=True))
    # tracks: drop ~20% of observations from the MODEL (they stay in the
    # graph -> complete_tracks candidates) and split ~10% of tracks into
    # two points (the graph edge across the split -> merge_tracks
    # candidates)
    t0 = time.time()
    drop = rng.random(len(obs_pt)) < 0.2
    split = rng.random(n_pts) < 0.10
    so_ = np.argsort(obs_pt[~drop], kind="stable")
    kp_i = obs_img[~drop][so_]
    kp_s = slot[~drop][so_].astype(int)
    kp_p = obs_pt[~drop][so_]
    bounds_ = np.flatnonzero(np.concatenate(
        [[True], kp_p[1:] != kp_p[:-1], [True]]))
    for bi in range(len(bounds_) - 1):
        s_, e_ = int(bounds_[bi]), int(bounds_[bi + 1])
        p = int(kp_p[s_])
        track = list(zip(kp_i[s_:e_].tolist(), kp_s[s_:e_].tolist()))
        if len(track) < 2:
            continue
        if split[p] and len(track) >= 4:
            h = len(track) // 2
            model.add_point3D(xyz[p], track[:h])
            model.add_point3D(xyz[p] + rng.normal(0, 1e-3, 3), track[h:])
        else:
            model.add_point3D(xyz[p], track)
    t_build = time.time() - t0

    # graph: consecutive-pair matches along each track
    graph = make_graph()
    for i in range(n_img):
        graph.add_image(i, len(kp_arrays[i]))
    # group (img_a, img_b) -> [(ka, kb)] from per-point consecutive obs
    so = np.argsort(obs_pt, kind="stable")
    sp, si, ss = obs_pt[so], obs_img[so], slot[so]
    same = sp[1:] == sp[:-1]
    a_img, b_img = si[:-1][same], si[1:][same]
    a_kp, b_kp = ss[:-1][same], ss[1:][same]
    pair_key = a_img * n_img + b_img
    po = np.argsort(pair_key, kind="stable")
    pair_key, a_img, b_img, a_kp, b_kp = (pair_key[po], a_img[po], b_img[po],
                                          a_kp[po], b_kp[po])
    bounds = np.flatnonzero(np.concatenate(
        [[True], pair_key[1:] != pair_key[:-1], [True]]))
    two_view = {}
    for bi in range(len(bounds) - 1):
        s, e = bounds[bi], bounds[bi + 1]
        ia, ib = int(a_img[s]), int(b_img[s])
        graph.add_matches(ia, ib, np.stack([a_kp[s:e], b_kp[s:e]], 1))
        two_view[(min(ia, ib), max(ia, ib))] = {"num_inliers": int(e - s)}
    print(f"scene: {n_img} img, {len(model.points3D)} pts, "
          f"{len(obs_pt)} obs, {len(two_view)} pairs, "
          f"model build {t_build:.1f}s, graph {type(graph).__name__}",
          file=sys.stderr, flush=True)
    return model, kp_arrays_by_img, cameras, graph, two_view


def split_submodels(model, n_img, cluster=12, overlap=4, seed=1):
    """Cut the merged model into overlapping cluster submodels (the mapping
    stage's output shape) with small per-submodel Sim(3) perturbations, so
    merge_all has real alignment + fold work to do."""
    from scanner_colmap_tpu.models.reconstruction import (Camera, Image,
                                                          Reconstruction)

    rng = np.random.default_rng(seed)
    stride = cluster - overlap
    subs = []
    for s in range(0, max(n_img - overlap, 1), stride):
        lo, hi = s, min(s + cluster, n_img)
        sub = Reconstruction()
        for cid, cam in model.cameras.items():
            sub.add_camera(Camera(cid, cam.model_id, cam.width, cam.height,
                                  cam.params.copy()))
        for i in range(lo, hi):
            im = model.images[i]
            sub.add_image(Image(
                image_id=i, camera_id=im.camera_id, name=im.name,
                qvec=im.qvec.copy(), tvec=im.tvec.copy(),
                xys=im.xys.copy(),
                point3D_ids=np.full(len(im.point3D_ids), -1, np.int64),
                registered=True))
        for pid, pt in model.points3D.items():
            tr = [(i, k) for (i, k) in pt.track if lo <= i < hi]
            if len(tr) >= 2:
                sub.add_point3D(pt.xyz, tr)
        # small rigid perturbation (what inter-cluster drift looks like)
        ang = rng.normal(0, 1e-3, 3)
        q = np.array([1.0, ang[0] / 2, ang[1] / 2, ang[2] / 2])
        q /= np.linalg.norm(q)
        sub.transform(1.0 + rng.normal(0, 1e-3), q, rng.normal(0, 1e-2, 3))
        subs.append(sub)
        if hi >= n_img:
            break
    return subs


def main():
    from scanner_colmap_tpu.engine.incremental import IncrementalMapper
    from scanner_colmap_tpu.engine import merge as merge_mod
    from scanner_colmap_tpu.utils import colmap_io
    from scanner_colmap_tpu.utils.config import MapperConfig

    n_img = int(os.environ.get("HOST_N", "2000"))
    n_pts = int(os.environ.get("HOST_P", "120000"))
    model, kp, cameras, graph, two_view = build_scene(n_img, n_pts)

    res = {}
    cfg = MapperConfig(single_camera=True)

    if os.environ.get("HOST_FOLD", "1") != "0":
        t0 = time.time()
        subs = split_submodels(model, n_img)
        res["split_build"] = time.time() - t0
        res["n_submodels"] = len(subs)
        t0 = time.time()
        folded = merge_mod.merge_all(subs)
        res["fold"] = time.time() - t0
        res["fold_reg"] = folded.num_registered
        res["fold_pts"] = len(folded.points3D)
        if os.environ.get("HOST_PROFILE_FOLD"):
            import cProfile, pstats
            subs = split_submodels(model, n_img)
            prof = cProfile.Profile()
            prof.enable()
            merge_mod.merge_all(subs)
            prof.disable()
            pstats.Stats(prof, stream=sys.stderr).sort_stats(
                "cumulative").print_stats(25)

    t0 = time.time()
    mapper = IncrementalMapper(kp, cameras, graph, two_view, cfg)
    res["mapper_ctor"] = time.time() - t0

    # ---- transplant + warm start (merge.py:336-362 block) ----
    t0 = time.time()
    n_trans = merge_mod.transplant_model(model, mapper)
    res["transplant"] = time.time() - t0
    res["transplant_pts"] = len(mapper.rec.points3D)

    # ---- track ops, one round each ----
    t0 = time.time()
    nc = mapper.complete_tracks()
    res["complete_tracks"] = time.time() - t0
    t0 = time.time()
    nm = mapper.merge_tracks()
    res["merge_tracks"] = time.time() - t0
    t0 = time.time()
    nf = mapper.filter_points()
    res["filter_points"] = time.time() - t0
    t0 = time.time()
    mapper.filter_images()
    res["filter_images"] = time.time() - t0
    res["ops_counts"] = (int(nc), int(nm), int(nf))

    # ---- full-model reprojection refresh ----
    t0 = time.time()
    mapper.rec.compute_reprojection_errors()
    res["reproj_full"] = time.time() - t0

    # ---- serialization ----
    t0 = time.time()
    cb, ib, pb = colmap_io.model_to_bytes(mapper.rec)
    res["to_bytes"] = time.time() - t0
    t0 = time.time()
    colmap_io.model_from_bytes(cb, ib, pb)
    res["from_bytes"] = time.time() - t0

    for k, v in res.items():
        if isinstance(v, float):
            v = round(v, 2)
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
