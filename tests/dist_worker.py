"""Worker entrypoint for the REAL multi-process distributed test.

Each OS process runs this script with its own process_id; they rendezvous
through jax.distributed's coordination service  and the shared
artifact store, then execute the distributed extraction + matching stages
end-to-end (parallel/dist.py). Launched by
tests/test_dist_multiprocess.py — not a test module itself.
"""

import sys


def main():
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]
    image_dir = sys.argv[4]
    store_path = sys.argv[5]

    from scanner_colmap_tpu.parallel import dist

    ok = dist.maybe_init_distributed(f"localhost:{port}", nproc, pid)
    assert ok, "coordinator init failed"
    import jax

    assert jax.process_count() == nproc, jax.process_count()
    assert jax.process_index() == pid

    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    cfg = PipelineConfig(image_path=image_dir, store_path=store_path)
    cfg.sift.max_image_size = 256
    cfg.sift.max_num_features = 384
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 3
    cfg.matching.min_num_inliers = 12

    # host mapper with per-cluster seeds: deterministic, so the 2-process
    # result can be asserted equal to a single-process reference run
    cfg.mapper.mode = "host"
    cfg.mapper.cluster_size = 4
    cfg.mapper.cluster_overlap = 2
    # tiny dense config (the e2e-test shapes): the dense stages must also
    # cross a REAL process boundary (VERDICT r4 #8b)
    cfg.patch_match.max_image_size = 96
    cfg.patch_match.overlap = 3
    cfg.patch_match.num_iterations = 6
    cfg.patch_match.window_radius = 3

    store = ArtifactStore(store_path)
    if pid == 0:
        stages.prepare_images(cfg, store)
    dist.barrier_via_store(store, "frames_ready", timeout_s=300)

    dist.run_extraction_distributed(cfg, store)
    dist.run_matching_distributed(cfg, store)
    dist.run_mapping_distributed(cfg, store)
    model = dist.run_merge_distributed(cfg, store)

    # dense stages across the same real process boundary: prepare on host
    # 0, PatchMatch block-sharded per host, fusion on host 0 over the
    # merged depth-map table
    if pid == 0:
        stages.run_prepare_patch_match(cfg, store)
    dist.barrier_via_store(store, "ppm_ready", timeout_s=300)
    dist.run_patch_match_distributed(cfg, store)
    if pid == 0:
        n_fused = stages.run_fusion(cfg, store)
        print(f"FUSED={n_fused}", flush=True)
    dist.barrier_via_store(store, "fusion_done", timeout_s=300)

    if pid == 0:
        n = store.num_rows("matching")
        print(f"MATCHING_ROWS={n}", flush=True)
        print(f"MERGED_IMAGES={model.num_registered}", flush=True)
    print(f"WORKER_{pid}_DONE", flush=True)


if __name__ == "__main__":
    main()
