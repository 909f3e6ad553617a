"""Video-input ingestion (reference: Scanner's built-in video sampling,
README.md:3; Stride/Range lazy sampling — SURVEY §2.2). Uses an animated
GIF as the container so the test needs no ffmpeg backend (imageio decodes
GIF via its Pillow plugin)."""

import os

import numpy as np
import pytest

from scanner_colmap_tpu.pipeline import stages, synth
from scanner_colmap_tpu.utils.config import PipelineConfig
from scanner_colmap_tpu.utils.store import ArtifactStore


@pytest.fixture
def gif_video(tmp_path):
    from PIL import Image

    frames_dir = tmp_path / "frames"
    synth.generate_dataset(str(frames_dir), num_images=8, width=120,
                           height=90, seed=0)
    imgs = [Image.open(frames_dir / f"image_{i:04d}.png").convert("P")
            for i in range(8)]
    path = tmp_path / "video.gif"
    imgs[0].save(path, save_all=True, append_images=imgs[1:], duration=100)
    return str(path)


def test_video_stride_sampling(gif_video, tmp_path):
    cfg = PipelineConfig(image_path=gif_video,
                         store_path=str(tmp_path / "store"))
    store = ArtifactStore(cfg.store_path)
    n = stages.prepare_images(cfg, store, stride=2)
    assert n == 4
    t = store.read_table("frames")
    names = [os.path.basename(p.decode()) for p in t["path"]]
    assert names == [f"frame_{i:06d}.png" for i in (0, 2, 4, 6)]
    # ids are index-based over the sampled frames
    assert list(t["image_id"]) == [0, 1, 2, 3]


def test_video_frame_range(gif_video, tmp_path):
    cfg = PipelineConfig(image_path=gif_video,
                         store_path=str(tmp_path / "store"))
    store = ArtifactStore(cfg.store_path)
    n = stages.prepare_images(cfg, store, frame_range=(2, 6))
    assert n == 4
    t = store.read_table("frames")
    names = [os.path.basename(p.decode()) for p in t["path"]]
    assert names == [f"frame_{i:06d}.png" for i in (2, 3, 4, 5)]


def test_video_frames_feed_extraction(gif_video, tmp_path):
    """Decoded video frames flow into the extraction stage unchanged."""
    cfg = PipelineConfig(image_path=gif_video,
                         store_path=str(tmp_path / "store"))
    cfg.sift.max_image_size = 128
    cfg.sift.max_num_features = 256
    cfg.sift.num_octaves = 2
    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store, stride=4)
    feats = stages.run_extraction(cfg, store, batch_size=2)
    assert len(feats) == 2
    assert all(f > 0 for f in feats)
