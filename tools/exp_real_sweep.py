"""Real-texture robustness sweep: ATE sensitivity vs real-camera effects.

VERDICT round-2 #8: harden the real-texture harness toward real-camera
statistics — non-planar composite geometry, per-image exposure variation,
Gaussian+JPEG noise, motion blur. Each config renders 10 real-photograph-
textured views and runs the sparse pipeline; the table goes to
PERFORMANCE.md.

    JAX_PLATFORMS=cpu python tools/exp_real_sweep.py
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
logging.basicConfig(level=logging.WARNING, stream=sys.stderr)

from scanner_colmap_tpu.pipeline import stages, synth
from scanner_colmap_tpu.utils.config import PipelineConfig
from scanner_colmap_tpu.utils.store import ArtifactStore

CONFIGS = [
    ("baseline", {}),
    ("composite_3bumps", {"num_bumps": 3}),
    ("exposure_20", {"exposure_jitter": 0.20}),
    ("exposure_35", {"exposure_jitter": 0.35}),
    ("noise_2", {"noise_std": 2.0}),
    ("noise_5", {"noise_std": 5.0}),
    ("jpeg_q60", {"jpeg_quality": 60}),
    ("blur_5px", {"motion_blur_px": 5}),
    ("hard_combo", {"num_bumps": 3, "exposure_jitter": 0.25,
                    "noise_std": 3.0, "jpeg_quality": 75}),
]


def run_cfg(label, kw, seed=1):
    wd = tempfile.mkdtemp(prefix=f"sct_real_{label}_")
    img = os.path.join(wd, "images")
    gt = synth.generate_real_texture_dataset(img, num_images=10, width=480,
                                             height=400, seed=seed, **kw)
    cfg = PipelineConfig(image_path=img, store_path=os.path.join(wd, "store"))
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 5
    cfg.mapper.single_camera = True
    store = ArtifactStore(cfg.store_path)
    t0 = time.time()
    stages.prepare_images(cfg, store)
    stages.run_extraction(cfg, store)
    stages.run_matching(cfg, store)
    stages.run_mapping(cfg, store)
    model = stages.run_merge(cfg, store)
    t = time.time() - t0
    ate = float(synth.evaluate_ate(model, gt))
    cam = model.cameras[model.images[0].camera_id]
    scale = stages.cam_scales(store)[0]
    focal_err = abs(cam.params[0] / scale - gt["focal"]) / gt["focal"]
    out = {"label": label, "ate": round(ate, 4),
           "reg": model.num_registered,
           "reproj_px": round(model.mean_reprojection_error(), 3),
           "focal_rel_err": round(float(focal_err), 4), "t_s": round(t, 1)}
    print(json.dumps(out), flush=True)
    return out


def main():
    rows = [run_cfg(label, kw) for label, kw in CONFIGS]
    print("\n| config | registered | ATE | reproj px | focal err |")
    print("|---|---|---|---|---|")
    for r in rows:
        print(f"| {r['label']} | {r['reg']}/10 | {r['ate']} | "
              f"{r['reproj_px']} | {r['focal_rel_err']} |")


if __name__ == "__main__":
    main()
