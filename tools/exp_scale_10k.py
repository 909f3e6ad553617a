"""10k-image extraction + banked matching on ONE chip (BASELINE.json
config 5 scale; VERDICT r3 #5: prove the O(bank) memory claim at 10k with
measured wall clock and memory high-water, not extrapolation).

    python tools/exp_scale_10k.py
Env: SCALE10K_IMAGES (default 10000), SCALE10K_SIZE (default 480).
"""

import json
import logging
import os
import resource
import sys
import tempfile
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
logging.basicConfig(level=logging.INFO, stream=sys.stderr)


def rss_gb():
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6


def dev_mem_gb():
    import jax

    try:
        stats = jax.devices()[0].memory_stats()
        return (stats or {}).get("peak_bytes_in_use", 0) / 1e9
    except Exception:
        return None


def main():
    import jax

    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    n_img = int(os.environ.get("SCALE10K_IMAGES", "10000"))
    size = int(os.environ.get("SCALE10K_SIZE", "480"))
    workdir = tempfile.mkdtemp(prefix="sct_10k_")
    image_dir = os.path.join(workdir, "images")
    print(f"[10k] devices: {jax.devices()}", file=sys.stderr, flush=True)
    t0 = time.time()
    synth.generate_dataset(image_dir, num_images=n_img, width=size,
                           height=size * 3 // 4, num_blobs=500, seed=11)
    t_render = time.time() - t0
    print(f"[10k] rendered {n_img} frames in {t_render:.0f}s",
          file=sys.stderr, flush=True)

    cfg = PipelineConfig(image_path=image_dir,
                         store_path=os.path.join(workdir, "store"))
    cfg.sift.max_image_size = size
    cfg.sift.max_num_features = 1024
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 6
    cfg.matching.min_num_inliers = 12

    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    times = {}
    for name, fn in [("extraction", stages.run_extraction),
                     ("matching", stages.run_matching)]:
        print(f"[10k] {name}", file=sys.stderr, flush=True)
        t0 = time.time()
        fn(cfg, store)
        times[name] = round(time.time() - t0, 1)
        print(f"[10k] {name}: {times[name]}s  host_rss={rss_gb():.1f}GB  "
              f"dev_peak={dev_mem_gb()}GB", file=sys.stderr, flush=True)

    mm = store.read_manifest("matching")["meta"]
    result = {
        "metric": "scale_10k_extraction_matching",
        "num_images": n_img,
        "stage_s": times,
        "images_per_s_extraction": round(n_img / times["extraction"], 2),
        "pairs_scheduled": int(mm.get("scheduled_pairs", -1)),
        "pairs_per_s": round(mm.get("scheduled_pairs", 0)
                             / max(times["matching"], 1e-9), 1),
        "host_rss_peak_gb": round(rss_gb(), 2),
        "device_peak_gb": dev_mem_gb(),
        "workdir": workdir,
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
