"""The numpy/zlib image codec (utils/imgcodec.py) and the host resize
(ops/image.resize_max), each against Pillow as the reference."""

import numpy as np
import pytest
from PIL import Image

from scanner_colmap_tpu.ops import image as image_ops
from scanner_colmap_tpu.pipeline import synth
from scanner_colmap_tpu.utils import imgcodec


def _texture(rng, shape):
    """Smooth ramps plus noise: PIL's adaptive encoder then uses every
    filter type somewhere in the image."""
    a = rng.integers(0, 256, shape).astype(np.uint8)
    a[: shape[0] // 3] = 77
    return np.cumsum(a, axis=1).astype(np.uint8)


@pytest.mark.parametrize("shape", [(37, 53), (41, 29, 3)])
def test_png_round_trip(tmp_path, rng, shape):
    img = _texture(rng, shape)
    p = str(tmp_path / "x.png")
    imgcodec.write_png(p, img)
    back, exif = imgcodec.read_png(p)
    assert exif is None and back.dtype == np.uint8
    assert np.array_equal(back, img)
    assert imgcodec.image_size(p) == (shape[1], shape[0])
    assert np.array_equal(np.asarray(Image.open(p)), img)   # a valid PNG


@pytest.mark.parametrize("mode, shape", [
    ("L", (33, 47)), ("RGB", (25, 31, 3)), ("RGBA", (19, 23, 4))])
def test_png_decode_equals_pil(tmp_path, rng, mode, shape):
    img = _texture(rng, shape)
    p = str(tmp_path / "pil.png")
    Image.fromarray(img, mode).save(p)
    back, _ = imgcodec.read_png(p)
    assert np.array_equal(back, img)
    rgb = image_ops.decode_image(p)
    assert np.array_equal(rgb, np.asarray(Image.open(p).convert("RGB")))


def test_png_exif_focal_round_trip(tmp_path):
    p = str(tmp_path / "cam.png")
    imgcodec.write_png(p, np.zeros((240, 320), np.uint8),
                       exif=synth._camera_exif(300.0, 320))
    assert image_ops.exif_focal_px(p, 320) == pytest.approx(300.0, rel=1e-4)
    # Pillow reads the same tags from the eXIf chunk
    tags = Image.open(p).getexif().get_ifd(imgcodec.TAG_EXIF_IFD)
    assert float(tags[imgcodec.TAG_FOCAL_LENGTH]) == pytest.approx(33.75)
    # no eXIf chunk: no EXIF focal, not an error
    imgcodec.write_png(p, np.zeros((8, 8), np.uint8))
    assert image_ops.exif_focal_px(p, 8) is None


def test_pnm_read_and_size(tmp_path, rng):
    img = _texture(rng, (12, 17, 3))
    p = str(tmp_path / "x.ppm")
    with open(p, "wb") as f:
        f.write(b"P6\n# comment\n17 12\n255\n" + img.tobytes())
    assert np.array_equal(imgcodec.read_pnm(p), img)
    assert np.array_equal(image_ops.decode_image(p), img)
    assert image_ops.image_size(p) == (17, 12)
    assert image_ops.exif_focal_px(p, 17) is None


def test_corrupt_png_raises(tmp_path, monkeypatch):
    p = str(tmp_path / "bad.png")
    imgcodec.write_png(p, np.zeros((8, 8), np.uint8))
    data = open(p, "rb").read()
    open(p, "wb").write(data[:40])
    monkeypatch.setattr(image_ops, "_pil_module", lambda: None)  # no Pillow
    with pytest.raises(ValueError, match="bad.png"):
        image_ops.decode_image(p)


def test_corrupt_png_raises_through_pillow(tmp_path):
    p = str(tmp_path / "bad.png")
    imgcodec.write_png(p, np.zeros((8, 8), np.uint8))
    data = open(p, "rb").read()
    open(p, "wb").write(data[:40])
    with pytest.raises((OSError, SyntaxError)):
        image_ops.decode_image(p)


@pytest.mark.parametrize("mode, shape", [("L", (64, 96)), ("RGB", (48, 80, 3))])
def test_decode_image_same_with_and_without_pillow(tmp_path, rng, monkeypatch,
                                                   mode, shape):
    """decode_image reads PNG through Pillow when it imports, else through
    imgcodec: the pixels must not depend on which."""
    img = _texture(rng, shape)
    p = str(tmp_path / "x.png")
    Image.fromarray(img, mode).save(p)       # adaptive row filters
    with_pil = image_ops.decode_image(p)
    monkeypatch.setattr(image_ops, "_pil_module", lambda: None)
    assert np.array_equal(image_ops.decode_image(p), with_pil)


@pytest.mark.parametrize("dtype, shape", [
    (np.float32, (768, 1024)), (np.uint8, (300, 400, 3))])
@pytest.mark.parametrize("max_size", [512, 333, 64])
def test_resize_max_matches_pil_bilinear(rng, dtype, shape, max_size):
    if dtype == np.float32:
        img = rng.random(shape).astype(np.float32)
        mode, tol = "F", 1.0 / 255.0
    else:
        img = _texture(rng, shape)
        mode, tol = "RGB", 1.0   # one 8-bit level = 1/255 of full scale
    out, scale = image_ops.resize_max(img, max_size)
    h, w = shape[:2]
    nh, nw = int(round(h * scale)), int(round(w * scale))
    ref = np.asarray(Image.fromarray(img, mode).resize((nw, nh),
                                                       Image.BILINEAR))
    assert out.dtype == img.dtype and out.shape == ref.shape
    assert np.abs(out.astype(np.float64) - ref).max() <= tol
