"""ATE band at 1k images: seeds x {closure auto, off} (VERDICT r4 #5).

The framework's headline-scale accuracy has been a one-trial number per
round; this harness bounds the band: SEEDS out-and-back 1k-frame
trajectories (the closure-relevant case), each run e2e twice — closure
off vs the default auto (which must self-enable) — reporting ATE
absolute / % of span, registration, and the per-config median + spread.

    python tools/exp_ate_band.py
Env: BAND_N (default 1000), BAND_SEEDS (default "11,12,13"),
BAND_OUT (JSON path, default stdout only).
"""

import json
import logging
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
logging.basicConfig(level=logging.INFO, stream=sys.stderr)

import numpy as np


def log(msg):
    print(f"[band] {msg}", file=sys.stderr, flush=True)


def main():
    from scanner_colmap_tpu.models import geometry as geom
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    n = int(os.environ.get("BAND_N", "1000"))
    seeds = [int(s) for s in os.environ.get("BAND_SEEDS", "11,12,13").split(",")]
    results = {"n": n, "seeds": seeds, "runs": []}
    for seed in seeds:
        workdir = tempfile.mkdtemp(prefix=f"sct_band_{seed}_")
        image_dir = os.path.join(workdir, "images")
        t0 = time.time()
        gt = synth.generate_dataset(image_dir, num_images=n, width=480,
                                    height=360, num_blobs=500, seed=seed,
                                    track="out_and_back")
        log(f"seed {seed}: rendered {n} frames in {time.time()-t0:.0f}s")
        centers = np.stack([np.asarray(geom.np_projection_center(
            gt["qvecs"][i], gt["tvecs"][i])) for i in range(n)])
        span = float(np.linalg.norm(centers.max(0) - centers.min(0)))

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
        stages.run_extraction(cfg, store)

        for label, lc in (("off", False), ("auto", "auto")):
            cfg.matching.loop_closure = lc
            t0 = time.time()
            stages.run_matching(cfg, store)
            lm = store.read_manifest("matching")["meta"]["loop_closure"]
            stages.run_mapping(cfg, store)
            model = stages.run_merge(cfg, store)
            total = time.time() - t0
            ate = float(synth.evaluate_ate(model, gt))
            rec = {"seed": seed, "closure": label,
                   "registered": int(model.num_registered),
                   "ate": round(ate, 3),
                   "ate_rel_span": round(ate / span, 5),
                   "span": round(span, 1),
                   "match_to_merge_s": round(total, 1),
                   "closure_enabled": bool(lm.get("enabled")),
                   "prepass_s": lm.get("prepass_s")}
            results["runs"].append(rec)
            log(json.dumps(rec))
        # free the per-seed render (~GBs of PNGs) as we go
        import shutil

        shutil.rmtree(workdir, ignore_errors=True)

    for label in ("off", "auto"):
        ates = [r["ate_rel_span"] for r in results["runs"]
                if r["closure"] == label]
        if ates:
            results[f"{label}_ate_rel_span"] = {
                "median": round(statistics.median(ates), 5),
                "min": round(min(ates), 5), "max": round(max(ates), 5),
                "n": len(ates)}
    out_path = os.environ.get("BAND_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    print(json.dumps(results))


if __name__ == "__main__":
    main()
