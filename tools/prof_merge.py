"""Profile the merge + full-graph iterative refinement stage at scale.

Runs prepare/extract/match/map once into a temp store (timed), then
cProfiles stages.run_merge. Usage (clean CPU env recommended for host-op
profiling):

  JAX_PLATFORMS=cpu PROF_IMAGES=300 python tools/prof_merge.py
"""

import cProfile
import logging
import os
import pstats
import sys
import tempfile
import time

logging.basicConfig(level=logging.INFO, stream=sys.stderr)


def main():
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    enable_compile_cache()
    n_img = int(os.environ.get("PROF_IMAGES", "300"))
    workdir = tempfile.mkdtemp(prefix="sct_profmerge_")
    image_dir = os.path.join(workdir, "images")
    t0 = time.time()
    synth.generate_dataset(image_dir, num_images=n_img, width=480,
                           height=360, num_blobs=500, seed=7)
    print(f"rendered {n_img} in {time.time()-t0:.0f}s", file=sys.stderr)

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
    for name, fn in [("extraction", stages.run_extraction),
                     ("matching", stages.run_matching),
                     ("mapping", stages.run_mapping)]:
        t0 = time.time()
        fn(cfg, store)
        print(f"{name}: {time.time()-t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    prof = cProfile.Profile()
    prof.enable()
    stages.run_merge(cfg, store)
    prof.disable()
    print(f"merge: {time.time()-t0:.1f}s", file=sys.stderr)
    st = pstats.Stats(prof, stream=sys.stderr)
    st.sort_stats("cumulative").print_stats(40)


if __name__ == "__main__":
    main()
