"""Warm mapping/merge rerun on an existing scale store (VERDICT r4 work).

Measures, on a store already populated by bench_scale.py:
  1. mapping (async per-cluster device programs)  [default]
  2. mapping (bucketed chunked vmap batch)        [EXP_BATCH=1 adds it]
  3. merge (fold + full-graph refinement), warm executables

Usage: EXP_STORE=/tmp/sct_scale_X python tools/exp_map_merge_2k.py
"""
import json
import logging
import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
logging.basicConfig(level=logging.INFO, stream=sys.stderr)


def main():
    wd = os.environ["EXP_STORE"]
    from scanner_colmap_tpu.engine import cluster as cluster_mod
    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    cfg = PipelineConfig(image_path=os.path.join(wd, "images"),
                         store_path=os.path.join(wd, "store"))
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.matching.overlap = 6
    cfg.matching.min_num_inliers = 12
    cfg.mapper.cluster_size = 12
    cfg.mapper.cluster_overlap = 4
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    cfg.mapper.single_camera = True
    store = ArtifactStore(cfg.store_path)

    out = {}
    t0 = time.time()
    stages.run_mapping(cfg, store)
    out["mapping_async_s"] = round(time.time() - t0, 1)
    out["mapping_async_stats"] = dict(cluster_mod.LAST_MAPPING_STATS)

    if os.environ.get("EXP_BATCH"):
        cfg.mapper.device_batch_clusters = True
        t0 = time.time()
        stages.run_mapping(cfg, store)
        out["mapping_batch_s"] = round(time.time() - t0, 1)
        out["mapping_batch_stats"] = dict(cluster_mod.LAST_MAPPING_STATS)
        cfg.mapper.device_batch_clusters = False
        # restore the async mapping table for the merge timing
        t0 = time.time()
        stages.run_mapping(cfg, store)
        out["mapping_async2_s"] = round(time.time() - t0, 1)

    t0 = time.time()
    model = stages.run_merge(cfg, store)
    out["merge_s"] = round(time.time() - t0, 1)
    out["merge_split_s"] = store.read_manifest("models")["meta"].get(
        "time_split_s", {})
    out["registered"] = int(model.num_registered)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
