"""Reference-capacity fidelity run (VERDICT r4 #6).

The reference operates COLMAP at stock capacities: 8192 SIFT features and
max_num_matches 32768 (/root/reference/integration/op_cpp/colmap.proto:17),
on full-resolution bitmaps. The repo's defaults (2048 features, 1024
matches, 1024 px) have been the only benched operating point; this
harness runs the hardened real-texture scene at BOTH operating points on
the real chip and reports throughput, registration, ATE, reprojection,
and focal recovery side by side.

    python tools/exp_capacity.py
Env: CAP_IMAGES (default 10), CAP_OUT (JSON path).
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


def log(msg):
    print(f"[cap] {msg}", file=sys.stderr, flush=True)


def run_config(label, image_dir, gt, store_root, sift_size, n_feats,
               n_matches, render_w):
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    cfg = PipelineConfig(image_path=image_dir,
                         store_path=os.path.join(store_root, label))
    cfg.sift.max_image_size = sift_size
    cfg.sift.max_num_features = n_feats
    cfg.sift.num_octaves = 4
    cfg.matching.overlap = 5
    cfg.matching.max_num_matches = n_matches
    cfg.mapper.single_camera = True
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)

    def sparse():
        t0 = time.time()
        stages.run_extraction(cfg, store)
        t_e = time.time() - t0
        t0 = time.time()
        stages.run_matching(cfg, store)
        t_m = time.time() - t0
        t0 = time.time()
        stages.run_mapping(cfg, store)
        model = stages.run_merge(cfg, store)
        t_map = time.time() - t0
        return model, t_e, t_m, t_map

    sparse()                                   # warmup (compiles)
    model, t_e, t_m, t_map = sparse()          # steady state
    n_img = len(gt["tvecs"])
    cam = model.cameras[model.images[model.registered_image_ids[0]].camera_id]
    scale = stages.cam_scales(store)[model.registered_image_ids[0]]
    focal_err = abs(cam.params[0] / scale - gt["focal"]) / gt["focal"]
    feats = store.read_table("extraction", columns=["image_id", "keypoints"])
    mean_feats = float(np.mean([len(k) for k in feats["keypoints"]]))
    total = t_e + t_m + t_map
    from scanner_colmap_tpu.pipeline import synth as synth_mod

    return {
        "label": label,
        "sift_max_image_size": sift_size, "max_num_features": n_feats,
        "max_num_matches": n_matches, "render_px": render_w,
        "mean_features": round(mean_feats, 0),
        "registered": int(model.num_registered), "num_images": n_img,
        "ate": round(float(synth_mod.evaluate_ate(model, gt)), 4),
        "mean_reproj_px": round(model.mean_reprojection_error(), 3),
        "focal_rel_err": round(float(focal_err), 4),
        "extraction_s": round(t_e, 1), "matching_s": round(t_m, 1),
        "mapping_s": round(t_map, 1),
        "images_per_s": round(model.num_registered / max(total, 1e-9), 3),
    }


def main():
    import jax

    from scanner_colmap_tpu.pipeline import synth

    n = int(os.environ.get("CAP_IMAGES", "10"))
    log(f"devices: {jax.devices()}")
    work = tempfile.mkdtemp(prefix="sct_cap_")
    # one high-resolution render serves both configs (the pipeline
    # downscales to sift.max_image_size per config, like the reference's
    # resizeBitmap, extraction_op.cc:28-39)
    img_hi = os.path.join(work, "img2048")
    t0 = time.time()
    gt = synth.generate_real_texture_dataset(
        img_hi, num_images=n, width=2048, height=1536, seed=1,
        focal=1920.0,     # the 480px default focal scaled to 2048px
        num_bumps=2, exposure_jitter=0.2, noise_std=2.0)
    log(f"rendered {n} frames at 2048px in {time.time()-t0:.0f}s")

    out = {"runs": []}
    for label, size, feats, matches in (
            ("repo_default", 1024, 2048, 1024),
            ("reference_capacity", 2048, 8192, 32768)):
        log(f"config {label}")
        rec = run_config(label, img_hi, gt, work, size, feats, matches, 2048)
        out["runs"].append(rec)
        log(json.dumps(rec))
    out_path = os.environ.get("CAP_OUT")
    if out_path:
        with open(out_path, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
