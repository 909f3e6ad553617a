"""Checks that need an NVIDIA GPU: the numerics comparisons that
chip_smoke.py runs in its phase 3, through the same functions. Each test
decides in the `gpu` fixture whether a card is present and skips
otherwise. Run them on a card with

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/
"""

import os

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs an NVIDIA GPU; JAX's default device is "
                    f"{dev.platform} (run with JAX_PLATFORMS=cuda,cpu)")
    return dev


def test_ba_gpu_matches_cpu(gpu):
    dev, cpu, _, _ = chip_smoke.ba_device_vs_cpu()
    assert abs(dev - cpu) / abs(cpu) <= chip_smoke.BA_REL_TOL, (dev, cpu)


def test_matching_precision_agreement(gpu, tmp_path):
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.store import ArtifactStore

    image_dir, store_dir = str(tmp_path / "images"), str(tmp_path / "store")
    synth.generate_dataset(image_dir, num_images=6, width=512, height=384,
                           focal=450.0, num_blobs=chip_smoke.NUM_BLOBS)
    cfg = chip_smoke.pipeline_config(image_dir, store_dir)
    store = ArtifactStore(store_dir)
    with open(os.path.join(store_dir, "pipeline_config.json"), "w") as f:
        f.write(cfg.to_json())
    stages.prepare_images(cfg, store)
    stages.run_extraction(cfg, store)
    for i, j, share, n_c, n_f in chip_smoke.matching_agreement(store_dir, 5):
        assert share >= chip_smoke.MIN_MATCH_AGREEMENT, (i, j, share)
