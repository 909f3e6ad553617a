"""Accelerator-numerics parity probe.

The test suite pins JAX_PLATFORMS=cpu + x64, so the accelerator's own
arithmetic (bf16 matching, the backend's f32 matmul precision) shows only
on the card. This probe runs the 16-image synthetic pipeline on the
default device in three modes and records registration/ATE/reprojection
deltas:

  default      — bf16 matching matmuls, device mapper (the shipped path)
  f32_match    — matching.precision="f32" (exact-accumulation matcher)
  host_mapper  — device matcher default + host mapping loop

    python tools/exp_numerics.py
Env: NUM_IMAGES (default 16), NUM_OUT (JSON path).
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


def log(msg):
    print(f"[numerics] {msg}", file=sys.stderr, flush=True)


def main():
    import jax

    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    n = int(os.environ.get("NUM_IMAGES", "16"))
    dev = jax.devices()[0]
    log(f"device: {dev} ({dev.platform})")
    work = tempfile.mkdtemp(prefix="sct_num_")
    img = os.path.join(work, "images")
    gt = synth.generate_dataset(img, num_images=n, width=480, height=360,
                                num_blobs=500, seed=3)

    modes = {
        "default": {},
        "f32_match": {"matching.precision": "f32"},
        "host_mapper": {"mapper.mode": "host"},
    }
    out = {"device": str(dev), "platform": dev.platform, "n": n, "runs": []}
    for label, overrides in modes.items():
        cfg = PipelineConfig(image_path=img,
                             store_path=os.path.join(work, f"store_{label}"))
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
        cfg.apply_overrides(overrides)
        store = ArtifactStore(cfg.store_path)
        stages.prepare_images(cfg, store)
        t0 = time.time()
        stages.run_extraction(cfg, store)
        n_pairs = stages.run_matching(cfg, store)
        stages.run_mapping(cfg, store)
        model = stages.run_merge(cfg, store)
        rec = {
            "mode": label, "overrides": overrides,
            "verified_pairs": int(n_pairs),
            "registered": int(model.num_registered),
            "ate": round(float(synth.evaluate_ate(model, gt)), 5),
            "mean_reproj_px": round(model.mean_reprojection_error(), 4),
            "wall_s": round(time.time() - t0, 1),
        }
        out["runs"].append(rec)
        log(json.dumps(rec))

    base = out["runs"][0]
    for rec in out["runs"][1:]:
        rec["ate_delta_vs_default"] = round(rec["ate"] - base["ate"], 5)
        rec["pairs_delta_vs_default"] = (rec["verified_pairs"]
                                         - base["verified_pairs"])
    out_path = os.environ.get("NUM_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
