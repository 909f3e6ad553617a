"""CPU rehearsal of chip_smoke.py: its pipeline phase at a tiny size (with
Pillow unavailable, so the main path is shown to need only numpy and zlib),
the PatchMatch fault policy on that phase's store, the numerics and mesh
checks at small sizes, and the refusal to run without a GPU."""

import json
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from scanner_colmap_tpu.pipeline import stages
from scanner_colmap_tpu.utils.config import PipelineConfig
from scanner_colmap_tpu.utils.store import ArtifactStore

TINY = {
    "sift.max_image_size": 256, "sift.max_num_features": 512,
    "sift.num_octaves": 3, "matching.overlap": 4,
    "mapper.cluster_size": 8, "mapper.cluster_overlap": 3,
    "patch_match.max_image_size": 96, "patch_match.overlap": 3,
    "patch_match.num_iterations": 6, "patch_match.window_radius": 3,
    "meshing.resolution": 48,
}


@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "PIL", None)   # `import PIL` now fails
    try:
        res = chip_smoke.phase_pipeline(
            str(tmp_path_factory.mktemp("smoke")), num_images=8, width=256,
            height=192, focal=225.0, num_blobs=1200, overrides=TINY)
    finally:
        mp.undo()
    return res


def test_pipeline_phase_tiny(tiny_run):
    assert chip_smoke.pipeline_failures(tiny_run) == []
    assert tiny_run["registered"] == 8
    assert set(tiny_run["stage_seconds"]) == {
        "prepare_images", "extraction", "matching", "mapping", "merge",
        "prepare_patch_match", "patch_match", "fusion", "meshing"}


def test_pipeline_failures_names_each_bar(tiny_run):
    bad = dict(tiny_run, registered=5, ate_rel_span=0.01, mean_reproj_px=2.0,
               host_retries=1, missing_depth_maps=[3], fused_points=0,
               surface_median_rel=0.2, mesh_faces=0)
    assert len(chip_smoke.pipeline_failures(bad)) == 8


@pytest.mark.parametrize("error, propagates", [
    (jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: out of memory"), True),
    (ValueError("degenerate source window"), False),
])
def test_patch_match_fault_policy(tiny_run, monkeypatch, error, propagates):
    """Device errors propagate; a data fault drops only that image."""
    def fail(*args, **kwargs):
        raise error

    monkeypatch.setattr(stages.pm_ops, "patch_match_tiled", fail)
    with open(f"{tiny_run['store']}/pipeline_config.json") as f:
        cfg = PipelineConfig.from_json(f.read())
    store = ArtifactStore(tiny_run["store"])
    if propagates:
        with pytest.raises(type(error)):
            stages.run_patch_match(cfg, store, out_table="pm_fault")
    else:
        assert stages.run_patch_match(cfg, store, out_table="pm_fault") == 0


def test_matching_agreement_on_cpu(tiny_run):
    rows = chip_smoke.matching_agreement(tiny_run["store"], num_pairs=4)
    assert len(rows) == 4
    for i, j, share, n_c, n_f in rows:
        assert j == i + 1 and n_c > 20 and n_f > 20
        assert share >= chip_smoke.MIN_MATCH_AGREEMENT


def test_mesh_check_small_on_cpu_mesh():
    rows = chip_smoke.mesh_check(
        num_cards=4, step_images=16, step_keypoints=32, dense_images=8,
        points=256, track=4, cg_images=16, iterations=4, chunk=64)
    assert [r[0] for r in rows] == ["step", "dense BA", "CG BA"]
    for name, multi, one, rel in rows:
        assert np.isfinite(multi) and rel <= chip_smoke.MESH_REL_TOL, name


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert "no GPU" in out.err
    for line in out.out.splitlines():
        with pytest.raises(json.JSONDecodeError):
            json.loads(line)
