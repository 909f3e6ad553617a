"""Multi-host scaffolding: partitioning, store barrier, sharded mapping
(single-process degenerate + simulated 2-host flow through the store)."""

import numpy as np
import pytest

from scanner_colmap_tpu.parallel import dist
from scanner_colmap_tpu.utils.store import ArtifactStore


def test_partition_round_robin_explicit():
    items = list(range(10))
    p0 = dist.partition_round_robin(items, process_id=0, num_processes=3)
    p1 = dist.partition_round_robin(items, process_id=1, num_processes=3)
    p2 = dist.partition_round_robin(items, process_id=2, num_processes=3)
    assert p0 == [0, 3, 6, 9] and p1 == [1, 4, 7] and p2 == [2, 5, 8]
    assert sorted(p0 + p1 + p2) == items


def test_partition_single_process_default():
    items = list(range(5))
    assert dist.partition_round_robin(items) == items


def test_store_barrier_single(tmp_path):
    store = ArtifactStore(str(tmp_path))
    dist.barrier_via_store(store, "phase1", timeout_s=5)
    assert store.has_table("phase1_ready_0")


def test_store_barrier_times_out_waiting_for_peer(tmp_path, monkeypatch):
    store = ArtifactStore(str(tmp_path))
    monkeypatch.setattr(dist, "process_info", lambda: (0, 2))
    with pytest.raises(TimeoutError):
        dist.barrier_via_store(store, "p", timeout_s=0.5, poll_s=0.1)


def test_run_mapping_distributed_single_process(tmp_path, rng):
    """Degenerate 1-host run equals the regular mapping stage contract."""
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig

    d = str(tmp_path / "imgs")
    synth.generate_dataset(d, num_images=6, width=256, height=192,
                           num_blobs=250, seed=2)
    cfg = PipelineConfig()
    cfg.image_path = d
    cfg.store_path = str(tmp_path / "store")
    cfg.sift.max_image_size = 256
    cfg.sift.max_num_features = 384
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 3
    cfg.matching.min_num_inliers = 12
    cfg.mapper.cluster_size = 6
    cfg.mapper.cluster_overlap = 2
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    stages.run_extraction(cfg, store)
    stages.run_matching(cfg, store)

    n = dist.run_mapping_distributed(cfg, store)
    assert n >= 1
    assert store.has_table("mapping")
    assert store.has_table("mapping_shard_0")
    model = stages.run_merge(cfg, store)
    assert model.num_registered >= 4


def test_run_matching_distributed_single_process(tmp_path, rng):
    """Single-process degenerate case: shard 0 of 1 == full matching table."""
    from scanner_colmap_tpu.parallel.dist import run_matching_distributed
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    image_dir = str(tmp_path / "imgs")
    synth.generate_dataset(image_dir, num_images=6, width=320, height=240,
                           num_blobs=300, seed=4)
    cfg = PipelineConfig()
    cfg.image_path = image_dir
    cfg.store_path = str(tmp_path / "store")
    cfg.sift.max_image_size = 320
    cfg.sift.max_num_features = 512
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 3
    cfg.matching.min_num_inliers = 12
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    stages.run_extraction(cfg, store)
    n = run_matching_distributed(cfg, store)
    assert n is not None and n >= 5
    # identical to the single-host stage output (row order is canonical)
    stages.run_matching(cfg, store, out_table="matching_ref")
    a = store.read_table("matching")
    b = store.read_table("matching_ref")
    import numpy as np
    pa = np.asarray(a["pair_image_ids"]).reshape(-1, 2)
    pb = np.asarray(b["pair_image_ids"]).reshape(-1, 2)
    assert sorted(map(tuple, pa)) == sorted(map(tuple, pb))


def _tiny_pipeline(tmp_path, with_dense=False):
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig

    d = str(tmp_path / "imgs")
    synth.generate_dataset(d, num_images=6, width=256, height=192,
                           num_blobs=250, seed=2)
    cfg = PipelineConfig()
    cfg.image_path = d
    cfg.store_path = str(tmp_path / "store")
    cfg.sift.max_image_size = 256
    cfg.sift.max_num_features = 384
    cfg.sift.num_octaves = 3
    cfg.matching.overlap = 3
    cfg.matching.min_num_inliers = 12
    cfg.mapper.cluster_size = 6
    cfg.mapper.cluster_overlap = 2
    cfg.mapper.init_min_num_inliers = 20
    cfg.mapper.abs_pose_min_num_inliers = 12
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    return cfg, store


def test_extraction_shards_cover_and_match_full(tmp_path, rng):
    """2-way frame shards partition the frame set and reproduce the
    unsharded stage's keypoints exactly."""
    from scanner_colmap_tpu.pipeline import stages

    cfg, store = _tiny_pipeline(tmp_path)
    stages.run_extraction(cfg, store)  # full reference
    stages.run_extraction(cfg, store, frame_slice=(0, 2), out_table="ex_s0")
    stages.run_extraction(cfg, store, frame_slice=(1, 2), out_table="ex_s1")
    full = store.read_table("extraction")
    s0 = store.read_table("ex_s0")
    s1 = store.read_table("ex_s1")
    ids_full = [int(i) for i in full["image_id"]]
    ids_sh = [int(i) for i in s0["image_id"]] + [int(i) for i in s1["image_id"]]
    assert sorted(ids_sh) == sorted(ids_full)
    # per-image keypoints identical between full and sharded extraction
    by_id = {int(i): np.asarray(full["keypoints"][k])
             for k, i in enumerate(full["image_id"])}
    for t in (s0, s1):
        for k, i in enumerate(t["image_id"]):
            assert np.array_equal(np.asarray(t["keypoints"][k]), by_id[int(i)])


def test_patch_match_shards_match_full(tmp_path, rng):
    """2-way contiguous ref blocks with window halo reproduce the unsharded
    depth maps bitwise (per-ref fold_in keys make sharding invisible)."""
    from scanner_colmap_tpu.pipeline import stages

    cfg, store = _tiny_pipeline(tmp_path)
    stages.run_extraction(cfg, store)
    stages.run_matching(cfg, store)
    stages.run_mapping(cfg, store)
    stages.run_merge(cfg, store)
    cfg.patch_match.max_image_size = 128
    cfg.patch_match.overlap = 2
    cfg.patch_match.num_iterations = 2
    stages.run_prepare_patch_match(cfg, store)
    n_full = stages.run_patch_match(cfg, store)
    assert n_full >= 2
    stages.run_patch_match(cfg, store, ref_slice=(0, 2), out_table="pm_s0")
    stages.run_patch_match(cfg, store, ref_slice=(1, 2), out_table="pm_s1")
    full = store.read_table("patch_match")
    by_id = {int(i): np.asarray(full["depth_map"][k])
             for k, i in enumerate(full["image_id"])}
    ids_sh = []
    for name in ("pm_s0", "pm_s1"):
        t = store.read_table(name)
        for k, i in enumerate(t["image_id"]):
            ids_sh.append(int(i))
            assert np.array_equal(np.asarray(t["depth_map"][k]), by_id[int(i)])
    assert sorted(ids_sh) == sorted(by_id.keys())


def test_maybe_init_distributed_passes_local_device_ids(monkeypatch):
    """Each process of a one-host multi-GPU run owns its own card."""
    import jax

    seen = {}

    def fake_initialize(coordinator, num_processes, process_id, **kw):
        seen.update(coordinator=coordinator, num_processes=num_processes,
                    process_id=process_id, **kw)

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    ok = dist.maybe_init_distributed("localhost:1234", 4, 2,
                                     local_device_ids=[2])
    assert ok
    assert seen == {"coordinator": "localhost:1234", "num_processes": 4,
                    "process_id": 2, "local_device_ids": [2]}
