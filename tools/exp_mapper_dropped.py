"""Root-cause the device-mapper registration loss (VERDICT r4 #8: the
n=48 / seed=1 / visible_points run registered 47/48 with no
investigation).

Reproduces the config, finds the dropped image, then re-runs its cluster
through the raw device program and reports WHERE it was lost:
  - "pnp": the in-graph PnP RANSAC never accepted it (registered mask
    False straight out of the kernel), or
  - "support_filter": the kernel registered it but _unpack's
    min-3-points support filter deregistered it, with its actual point
    count, or
  - "host_registers": whether the host mapper registers the same image
    from the same subgraph (isolates device numerics vs data).

    python tools/exp_mapper_dropped.py
    ATE_N=48 ATE_SEED=1 ...                     # config overrides
"""

import json
import logging
import os
import sys
import tempfile

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
logging.basicConfig(level=logging.WARNING, stream=sys.stderr)

import numpy as np


def main():
    from scanner_colmap_tpu.engine import device_cluster as dc
    from scanner_colmap_tpu.engine.cluster import make_clusters, subgraph
    from scanner_colmap_tpu.engine.incremental import IncrementalMapper
    from scanner_colmap_tpu.ops import device_mapper
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    n = int(os.environ.get("ATE_N", "48"))
    seed = int(os.environ.get("ATE_SEED", "1"))
    workdir = tempfile.mkdtemp(prefix=f"sct_drop_{n}_{seed}_")
    image_dir = os.path.join(workdir, "images")
    synth.generate_dataset(image_dir, num_images=n, width=480, height=360,
                           num_blobs=500, seed=seed)
    cfg = PipelineConfig(image_path=image_dir,
                         store_path=os.path.join(workdir, "store"))
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.mapper.single_camera = True
    cfg.mapper.mode = "device"
    cfg.mapper.device_schedule = "visible_points"
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    stages.run_extraction(cfg, store)
    stages.run_matching(cfg, store)
    stages.run_mapping(cfg, store)
    model = stages.run_merge(cfg, store)
    reg = set(model.registered_image_ids)
    missing = sorted(set(range(n)) - reg)
    print(f"registered {model.num_registered}/{n}; missing: {missing}",
          flush=True)
    report = {"n": n, "seed": seed, "registered": model.num_registered,
              "missing": missing, "cases": []}
    image_ids, kp, desc, cameras = stages._load_extraction(store)
    graph, two_view = stages._build_graph(store, kp)
    clusters = make_clusters(sorted(kp.keys()), cfg.mapper.cluster_size,
                             cfg.mapper.cluster_overlap)
    for miss in missing:
        for ci, members in enumerate(clusters):
            if miss not in members:
                continue
            g, tv = subgraph(graph, two_view, members)
            kp_c = {i: kp[i] for i in members}
            cam_c = {i: cameras[i] for i in members}
            prep = dc._prepare_cluster(kp_c, cam_c, g, tv, cfg.mapper, ci)
            case = {"image": miss, "cluster": ci, "members": members}
            if prep is None:
                case["cause"] = "cluster_never_seeded"
            else:
                out = np.asarray(device_mapper.map_cluster(
                    prep["key"], prep["cam_in"], prep["order"],
                    prep["forced"], prep["reg_init"], prep["obs_cam"],
                    prep["obs_uv"], prep["obs_xn"], prep["obs_present"],
                    prep["pnp_thr_n"], prep["tri_thr_n"], prep["scal"],
                    pnp_trials=cfg.mapper.device_pnp_trials,
                    ba_iters=cfg.mapper.device_ba_iters_per_step,
                    final_iters=cfg.mapper.device_final_ba_iters,
                    chunk=min(1024, prep["P"])))
                M, P, T = prep["M"], prep["P"], prep["T"]
                li = prep["members"].index(miss)
                off = M * 9 + P * 3
                pt_valid = out[off: off + P] > 0.5
                obs_ok = out[off + P: off + P + P * T].reshape(P, T) > 0.5
                reg_mask = out[off + P + P * T: off + P + P * T + M] > 0.5
                case["kernel_registered"] = bool(reg_mask[li])
                if reg_mask[li]:
                    # count fitting observations credited to this slot
                    tr_img = prep["tr_img"]
                    sup = int(np.sum(obs_ok[: len(tr_img)]
                                     & (tr_img == li)
                                     & pt_valid[: len(tr_img), None]))
                    case["support_points"] = sup
                    case["cause"] = ("support_filter" if sup < 3
                                     else "unclear")
                else:
                    case["cause"] = "pnp"
                # schedule coverage: how many slots of the order target it
                case["schedule_slots"] = int(np.sum(
                    prep["order"] == li))
                # does the host engine register it from the same data?
                host_rec = IncrementalMapper(kp_c, cam_c, g, tv, cfg.mapper,
                                             seed=ci).reconstruct()
                case["host_registers"] = bool(
                    miss in host_rec.registered_image_ids
                    and host_rec.images[miss].registered)
                # PnP evidence: correspondences available to the solve
                has = (prep["obs_cam"] == li) & (prep["obs_present"] > 0.5)
                case["tracks_observing"] = int(np.sum(np.any(has, axis=1)))
            print(json.dumps(case), flush=True)
            report["cases"].append(case)
    print(json.dumps(report))


if __name__ == "__main__":
    main()
