"""Loop closure at 1,000 images (VERDICT r3 #7: the closure measurement
stopped at 96 frames; the auto-on rule needs a >=1k validation).

Renders a 1k-frame out-and-back trajectory (genuine revisits), runs
extraction ONCE, then measures the full mapping+merge chain twice on the
same store: loop_closure=False vs the default "auto" (the BoW prepass
must flip it on). Reports ATE (absolute + % of span), stage timings, the
revisit fraction, and the matching-cost overhead of the candidate pass.

    python tools/exp_loop_1k.py
    LOOP_N=400 ...                       # smaller sweep
"""

import json
import logging
import os
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
logging.basicConfig(level=logging.INFO, stream=sys.stderr)

import numpy as np


def main():
    from scanner_colmap_tpu.models import geometry as geom
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    n = int(os.environ.get("LOOP_N", "1000"))
    workdir = os.environ.get("LOOP_WORKDIR") or tempfile.mkdtemp(
        prefix="sct_loop1k_")
    image_dir = os.path.join(workdir, "images")
    t0 = time.time()
    gt = synth.generate_dataset(image_dir, num_images=n, width=480,
                                height=360, num_blobs=500, seed=11,
                                track="out_and_back")
    print(f"rendered {n} out-and-back frames in {time.time()-t0:.0f}s",
          file=sys.stderr, flush=True)
    cfg = PipelineConfig(image_path=image_dir,
                         store_path=os.path.join(workdir, "store"))
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 6
    cfg.matching.min_num_inliers = 12
    cfg.mapper.cluster_size = 12
    cfg.mapper.cluster_overlap = 4
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    cfg.mapper.single_camera = True
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    t0 = time.time()
    stages.run_extraction(cfg, store)
    t_ext = time.time() - t0

    centers = np.stack([np.asarray(geom.np_projection_center(
        gt["qvecs"][i], gt["tvecs"][i])) for i in range(n)])
    span = float(np.linalg.norm(centers.max(0) - centers.min(0)))

    out = {"n": n, "extraction_s": round(t_ext, 1), "span": round(span, 1)}
    for label, lc in (("off", False), ("auto", "auto")):
        cfg.matching.loop_closure = lc
        t0 = time.time()
        stages.run_matching(cfg, store)
        t_match = time.time() - t0
        lm = store.read_manifest("matching")["meta"]["loop_closure"]
        t0 = time.time()
        stages.run_mapping(cfg, store)
        t_map = time.time() - t0
        t0 = time.time()
        model = stages.run_merge(cfg, store)
        t_merge = time.time() - t0
        ate = float(synth.evaluate_ate(model, gt))
        out[label] = {
            "matching_s": round(t_match, 1), "mapping_s": round(t_map, 1),
            "merge_s": round(t_merge, 1),
            "registered": int(model.num_registered),
            "ate": round(ate, 3), "ate_rel_span": round(ate / span, 5),
            "loop_meta": lm,
        }
        print(json.dumps({label: out[label]}), file=sys.stderr, flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
