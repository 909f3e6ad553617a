"""Image ingest: host-side decode + EXIF, device-side resize/gray/pad.

Rebuilds the reference's stage-1/2 image handling: Scanner's builtin
ImageDecoder + PrepareImage id assignment
(integration/prepare_images.py:33-40) and the extraction kernel's FreeImage
grey-convert + downscale (integration/op_cpp/extraction_op.cc:28-39, 86-100)
and EXIF focal-length camera init (extraction_op.cc:43-64). PNG, PGM and
PPM decode without Pillow (utils/imgcodec); other formats need it.

Ids are derived from sorted path order (index-based), fixing the reference's
per-worker stateful counter hazard (prepare_image.cc:12-24, SURVEY §8.5).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from scanner_colmap_tpu.utils import imgcodec

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".ppm", ".pgm"}


def list_images(image_dir: str) -> List[str]:
    """Sorted image paths (order defines image ids, like the reference's
    sorted listing in prepare_images.py:13)."""
    out = []
    for name in sorted(os.listdir(image_dir)):
        if os.path.splitext(name)[1].lower() in IMAGE_EXTS:
            out.append(os.path.join(image_dir, name))
    return out


def _pil_module():
    """PIL's Image module, or None when Pillow is not installed."""
    try:
        from PIL import Image as PILImage
    except ImportError:
        return None
    return PILImage


def _pil(path: str):
    """PIL's Image module for the formats the built-in codec does not read."""
    pil = _pil_module()
    if pil is None:
        raise RuntimeError(
            f"{path}: reading this format needs Pillow, which is not "
            "installed; PNG, PGM and PPM read without it")
    return pil


def decode_image(path: str) -> np.ndarray:
    """Decode to RGB uint8 (H, W, 3).

    PNG decodes through Pillow when it is installed (its C decoder is far
    faster on the Average and Paeth row filters that real encoders use) and
    through utils/imgcodec otherwise; both are lossless, so the pixels are
    the same. PGM/PPM always use imgcodec."""
    if imgcodec.is_pnm(path):
        px = imgcodec.read_pnm(path)
    elif imgcodec.is_png(path) and _pil_module() is None:
        px, _ = imgcodec.read_png(path)
    else:
        with _pil(path).open(path) as im:
            return np.asarray(im.convert("RGB"))
    if px.ndim == 2:
        return np.repeat(px[..., None], 3, axis=-1)
    if px.shape[-1] == 2:   # gray + alpha
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def image_size(path: str) -> Tuple[int, int]:
    """(width, height) without decoding the pixels."""
    wh = imgcodec.image_size(path)
    if wh is not None:
        return wh
    with _pil(path).open(path) as im:
        return im.size


def _exif_tags(path: str) -> dict:
    """Numeric EXIF tags by id; empty when the file carries no EXIF.

    Raises when the file cannot be read or its EXIF block is malformed."""
    if imgcodec.is_png(path):
        raw = imgcodec.read_png_exif(path)
        return imgcodec.parse_exif(raw) if raw else {}
    if imgcodec.is_pnm(path):
        return {}
    with _pil(path).open(path) as im:
        exif = im.getexif()
        vals = dict(exif.items())
        vals.update(exif.get_ifd(imgcodec.TAG_EXIF_IFD).items())
    out = {}
    for k, v in vals.items():
        try:
            out[k] = float(v)
        except (TypeError, ValueError, ZeroDivisionError):
            continue  # non-numeric tags (strings, arrays) are not used here
    return out


def exif_focal_px(path: str, width: int) -> Optional[float]:
    """Focal length in pixels from EXIF (COLMAP-style priority):

    1. FocalLength (mm, rational — precise) + FocalPlaneXResolution /
       FocalPlaneResolutionUnit, which give the sensor width directly
       (COLMAP's ExtractExifFocalLength does the same before its sensor
       database): focal_px = f_mm / sensor_w_mm * width.
    2. FocalLengthIn35mmFilm fallback: focal_35 / 36.0 * width. The tag is
       INTEGER by spec, so this path carries up to ~2% rounding — real EXIF
       behavior; a downstream intrinsic prior must expect it.

    Returns None when the file has neither (no sensor-database guessing,
    matching the reference's fallback-to-default rule,
    extraction_op.cc:49-55). A file that cannot be read raises."""
    vals = _exif_tags(path)
    f_mm = vals.get(imgcodec.TAG_FOCAL_LENGTH)
    xres = vals.get(imgcodec.TAG_FOCAL_PLANE_X_RES)
    unit = vals.get(imgcodec.TAG_FOCAL_PLANE_RES_UNIT, 2)
    exif_w = vals.get(imgcodec.TAG_EXIF_IMAGE_WIDTH) or width
    if f_mm and xres:
        unit_mm = {2: 25.4, 3: 10.0, 4: 1.0, 5: 0.001}.get(int(unit))
        if unit_mm and xres > 0:
            sensor_w_mm = exif_w / xres * unit_mm
            if sensor_w_mm > 0:
                return f_mm / sensor_w_mm * width
    f35 = vals.get(imgcodec.TAG_FOCAL_35MM)
    if f35:
        return f35 / 36.0 * width
    return None


def to_grayscale(rgb: np.ndarray) -> np.ndarray:
    """ITU-R BT.601 luma, float32 in [0, 1]."""
    w = np.array([0.299, 0.587, 0.114], np.float32)
    return (rgb.astype(np.float32) @ w) / 255.0


def _bilinear_taps(in_size: int, out_size: int):
    """PIL's BILINEAR filter as banded taps: a triangle of support 1,
    widened by the scale factor when downscaling (an antialiasing box),
    each output's weights normalized to 1. Returns (idx, w), both
    (out_size, taps): input index and float32 weight of every tap (taps
    past the input edge have weight 0)."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    center = (np.arange(out_size) + 0.5) * scale
    lo = np.maximum(np.trunc(center - fs + 0.5), 0).astype(np.int64)
    hi = np.minimum(np.trunc(center + fs + 0.5), in_size).astype(np.int64)
    x = lo[:, None] + np.arange(int((hi - lo).max()))
    k = np.maximum(1.0 - np.abs((x - center[:, None] + 0.5) / fs), 0.0)
    k = np.where(x < hi[:, None], k, 0.0)
    total = k.sum(axis=1, keepdims=True)
    k = np.divide(k, total, out=np.zeros_like(k), where=total > 0)
    return np.minimum(x, in_size - 1), k.astype(np.float32)


def _resample_axis(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """Resample float32 `x` along `axis` to `out_size` with PIL's BILINEAR
    taps: one gather and multiply-add per tap (about 2 x scale + 1 taps
    per output), never a dense (out, in) matrix."""
    idx, w = _bilinear_taps(x.shape[axis], out_size)
    shape = [1] * x.ndim
    shape[axis] = out_size
    out = np.zeros(x.shape[:axis] + (out_size,) + x.shape[axis + 1:],
                   np.float32)
    for t in range(idx.shape[1]):
        out += w[:, t].reshape(shape) * np.take(x, idx[:, t], axis=axis)
    return out


def resize_max(img: np.ndarray, max_size: int) -> Tuple[np.ndarray, float]:
    """Downscale so max(H, W) <= max_size (like extraction_op.cc:28-39).

    Returns (resized, scale) with scale = new / old (<= 1). Separable
    bilinear resampling with PIL's BILINEAR weights, in float32 on the host
    (ingest path; device-side resize uses jax.image in MVS). Float input
    stays float32; uint8 input is rounded back to uint8."""
    h, w = img.shape[:2]
    m = max(h, w)
    if m <= max_size:
        return img, 1.0
    scale = max_size / m
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = _resample_axis(img.astype(np.float32), nh, axis=0)
    out = _resample_axis(out, nw, axis=1)
    if img.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8), scale
    return out, scale


def pad_to_canvas(img: np.ndarray, canvas_hw: Tuple[int, int]) -> np.ndarray:
    """Zero-pad bottom/right to a fixed canvas (static shapes for jit)."""
    H, W = canvas_hw
    h, w = img.shape[:2]
    if h > H or w > W:
        raise ValueError(f"image {img.shape} exceeds canvas {canvas_hw}")
    pad = [(0, H - h), (0, W - w)] + [(0, 0)] * (img.ndim - 2)
    return np.pad(img, pad)


def load_for_extraction(path: str, max_image_size: int,
                        canvas: Tuple[int, int]):
    """Full ingest for one image: decode -> gray -> downscale -> pad.

    Returns dict with canvas image (uint8 (H,W) — the reference's own
    8-bit grayscale working format, FreeImage ConvertToGreyscale in
    extraction_op.cc:86-92; consumers cast on device, and the upload
    moves 4x fewer bytes than f32),
    valid (h, w), the downscale factor (to map keypoints back to
    original pixels), original (width, height), and EXIF focal in
    ORIGINAL pixels (or None).
    """
    rgb = decode_image(path)
    oh, ow = rgb.shape[:2]
    gray = to_grayscale(rgb)
    gray, scale = resize_max(gray, max_image_size)
    h, w = gray.shape
    out = pad_to_canvas(gray, canvas)
    # gray is [0, 1] luma: quantize to 8-bit levels for the transfer
    out = np.clip(np.round(out * 255.0), 0, 255).astype(np.uint8)
    return {
        "image": out,
        "valid_hw": np.array([h, w], np.int32),
        "scale": scale,
        "orig_wh": (ow, oh),
        "exif_focal_px": exif_focal_px(path, ow),
        "name": os.path.basename(path),
    }
