"""ATE sweep: host vs device mapper (connectivity vs visible_points
schedule) at several collection sizes x seeds.

VERDICT round-2 weak #5: device-mode ATE 0.0105 vs host 0.0064 at 16
images, suspected cause the static greedy registration schedule. This
measures both device schedules against the host path. Extraction/matching
run once per (n, seed); mapping+merge re-run per mode.

    python tools/exp_mapper_ate.py
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

import numpy as np

from scanner_colmap_tpu.pipeline import stages, synth
from scanner_colmap_tpu.utils.config import PipelineConfig
from scanner_colmap_tpu.utils.store import ArtifactStore


def run_once(n, seed, modes):
    workdir = tempfile.mkdtemp(prefix=f"sct_ate_{n}_{seed}_")
    image_dir = os.path.join(workdir, "images")
    gt = synth.generate_dataset(image_dir, num_images=n, width=480,
                                height=360, num_blobs=500, seed=seed)
    cfg = PipelineConfig(image_path=image_dir,
                         store_path=os.path.join(workdir, "store"))
    cfg.sift.max_image_size = 480
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.mapper.single_camera = True
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    stages.run_extraction(cfg, store)
    stages.run_matching(cfg, store)
    out = {}
    for label, (mode, sched) in modes.items():
        cfg.mapper.mode = mode
        cfg.mapper.device_schedule = sched
        t0 = time.time()
        stages.run_mapping(cfg, store)
        model = stages.run_merge(cfg, store)
        t = time.time() - t0
        ate = float(synth.evaluate_ate(model, gt))
        out[label] = {"ate": round(ate, 4), "reg": model.num_registered,
                      "t": round(t, 1)}
        print(f"  n={n} seed={seed} {label}: ate={ate:.4f} "
              f"reg={model.num_registered}/{n} t={t:.1f}s", flush=True)
    return out


def main():
    all_modes = {
        "host": ("host", "visible_points"),
        "dev_conn": ("device", "connectivity"),
        "dev_vis": ("device", "visible_points"),
    }
    sel = os.environ.get("ATE_MODES", "host,dev_conn,dev_vis").split(",")
    modes = {k: v for k, v in all_modes.items() if k in sel}
    sizes = [int(x) for x in os.environ.get("ATE_SIZES", "16,48,96").split(",")]
    seeds = [int(x) for x in os.environ.get("ATE_SEEDS", "0,1,2,3").split(",")]
    results = {}
    for n in sizes:
        for seed in seeds:
            results[f"{n}_{seed}"] = run_once(n, seed, modes)
    print(json.dumps(results))
    # summary bands
    for label in modes:
        for n in sizes:
            ates = [results[f"{n}_{s}"][label]["ate"] for s in seeds]
            regs = [results[f"{n}_{s}"][label]["reg"] for s in seeds]
            print(f"summary {label} n={n}: ate [{min(ates):.4f}, "
                  f"{max(ates):.4f}] med {np.median(ates):.4f} "
                  f"reg {min(regs)}-{max(regs)}", flush=True)


if __name__ == "__main__":
    main()
