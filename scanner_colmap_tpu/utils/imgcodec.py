"""Image codec on numpy and zlib alone: PNG, PGM/PPM and the EXIF focal tags.

The main path (synthetic capture, ingest, undistortion) reads and writes
images through this module, so it needs no imaging library. Scope:

- PNG read: 8-bit gray, gray+alpha, RGB and RGBA, non-interlaced, all five
  row filters. PNG write: 8-bit gray or RGB with filter 0.
- An ``eXIf`` chunk that carries the camera tags ``ops.image.exif_focal_px``
  reads: FocalLength, FocalPlaneXResolution, FocalPlaneResolutionUnit,
  ExifImageWidth and FocalLengthIn35mmFilm.
- Binary PGM (P5) and PPM (P6) read, maxval <= 255.
- Header-only image size for both.

Other formats (JPEG, TIFF, BMP) go through PIL in ``ops.image``.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, Optional, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # PNG color type -> samples per pixel

# EXIF tag ids (TIFF/EXIF 2.3)
TAG_EXIF_IFD = 0x8769
TAG_FOCAL_LENGTH = 0x920A               # RATIONAL, mm
TAG_EXIF_IMAGE_WIDTH = 0xA002           # SHORT or LONG, px
TAG_FOCAL_PLANE_X_RES = 0xA20E          # RATIONAL, px per unit
TAG_FOCAL_PLANE_RES_UNIT = 0xA210       # SHORT: 2 inch, 3 cm, 4 mm, 5 um
TAG_FOCAL_35MM = 0xA405                 # SHORT, mm
_RATIONAL_TAGS = (TAG_FOCAL_LENGTH, TAG_FOCAL_PLANE_X_RES)
_SHORT_TAGS = (TAG_EXIF_IMAGE_WIDTH, TAG_FOCAL_PLANE_RES_UNIT, TAG_FOCAL_35MM)
_TYPE_SIZE = {3: 2, 4: 4, 5: 8}   # SHORT, LONG, RATIONAL: the types read


def is_png(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(8) == PNG_SIGNATURE


def is_pnm(path: str) -> bool:
    with open(path, "rb") as f:
        return f.read(2) in (b"P5", b"P6")


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _chunks(data: bytes, path: str):
    if data[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {ctype!r} chunk")
        yield ctype, body
        pos += 12 + length
        if ctype == b"IEND":
            return
    raise ValueError(f"{path}: PNG ends without IEND")


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(raw: bytes, height: int, stride: int, bpp: int,
              path: str) -> np.ndarray:
    """Undo the per-row PNG filters; returns (height, stride) uint8."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{path}: image data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line.copy()
        elif ftype == 1:    # Sub: running sum per channel, modulo 256
            cur = np.cumsum(line.reshape(-1, bpp).astype(np.int64),
                            axis=0).astype(np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prior
        elif ftype in (3, 4):   # Average / Paeth: sequential along the row
            buf = bytearray(line.tobytes())
            up = prior.tobytes()
            for x in range(stride):
                a = buf[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, up[x - bpp] if x >= bpp else 0)
                buf[x] = (buf[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"{path}: unknown PNG filter type {ftype}")
        out[y] = cur
        prior = cur
    return out


def read_png(path: str) -> Tuple[np.ndarray, Optional[bytes]]:
    """Decode a PNG: (pixels, raw EXIF bytes or None).

    pixels are uint8 (H, W) for gray, else (H, W, C) with C in {2, 3, 4}."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat, exif = None, [], None
    for ctype, body in _chunks(data, path):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"eXIf":
            exif = bytes(body)
    if header is None:
        raise ValueError(f"{path}: PNG has no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError(
            f"{path}: PNG with bit depth {depth} and color type {ctype} is "
            "not supported (8-bit gray, gray+alpha, RGB or RGBA only)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    ch = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"{path}: corrupt PNG image data: {e}") from e
    px = _unfilter(raw, height, width * ch, ch, path)
    px = px.reshape(height, width, ch)
    return (px[..., 0] if ch == 1 else px), exif


def read_png_exif(path: str) -> Optional[bytes]:
    """The raw ``eXIf`` chunk of a PNG, without decoding its pixels."""
    with open(path, "rb") as f:
        data = f.read()
    for ctype, body in _chunks(data, path):
        if ctype == b"eXIf":
            return bytes(body)
        if ctype == b"IDAT":    # eXIf must precede the image data
            return None
    return None


def _chunk(ctype: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray,
              exif: Optional[bytes] = None) -> None:
    """Write uint8 (H, W) gray or (H, W, 3) RGB as PNG, filter 0, with an
    optional ``eXIf`` chunk (raw TIFF-structured EXIF, see `make_exif`)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png expects uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"write_png expects (H, W) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = img.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    parts = [PNG_SIGNATURE,
             _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))]
    if exif:
        parts.append(_chunk(b"eXIf", exif))
    parts.append(_chunk(b"IDAT", zlib.compress(raw.tobytes())))
    parts.append(_chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(b"".join(parts))


# ---------------------------------------------------------------------------
# PGM / PPM
# ---------------------------------------------------------------------------

def _pnm_header(data: bytes, path: str):
    """(magic, width, height, maxval, offset of the pixel data)."""
    tokens, pos = [], 0
    while len(tokens) < 4:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos:pos + 1] not in (b"\n", b"\r"):
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        if start == pos:
            raise ValueError(f"{path}: truncated PNM header")
        tokens.append(data[start:pos])
    magic = tokens[0]
    if magic not in (b"P5", b"P6"):
        raise ValueError(f"{path}: only binary PGM (P5) / PPM (P6) are supported")
    try:
        w, h, maxval = (int(t) for t in tokens[1:])
    except ValueError as e:
        raise ValueError(f"{path}: malformed PNM header") from e
    return magic, w, h, maxval, pos + 1   # one whitespace ends the header


def read_pnm(path: str) -> np.ndarray:
    """Decode binary PGM/PPM to uint8 (H, W) or (H, W, 3)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, w, h, maxval, off = _pnm_header(data, path)
    if not 0 < maxval <= 255:
        raise ValueError(f"{path}: PNM maxval {maxval} is not supported (<= 255)")
    ch = 1 if magic == b"P5" else 3
    n = w * h * ch
    if len(data) - off < n:
        raise ValueError(f"{path}: PNM pixel data is truncated")
    px = np.frombuffer(data, np.uint8, n, off)
    if maxval != 255:
        px = np.round(px.astype(np.float64) * (255.0 / maxval)).astype(np.uint8)
    return px.reshape(h, w) if ch == 1 else px.reshape(h, w, 3)


# ---------------------------------------------------------------------------
# header-only size
# ---------------------------------------------------------------------------

def image_size(path: str) -> Optional[Tuple[int, int]]:
    """(width, height) from a PNG or PNM header, None for other formats."""
    with open(path, "rb") as f:
        head = f.read(256)
    if head[:8] == PNG_SIGNATURE:
        if head[12:16] != b"IHDR":
            raise ValueError(f"{path}: PNG does not start with IHDR")
        return struct.unpack(">II", head[16:24])
    if head[:2] in (b"P5", b"P6"):
        _, w, h, _, _ = _pnm_header(head, path)
        return w, h
    return None


# ---------------------------------------------------------------------------
# EXIF (TIFF structure) for the focal-length tags
# ---------------------------------------------------------------------------

def make_exif(tags: Dict[int, float]) -> bytes:
    """Little-endian TIFF/EXIF block: IFD0 points at an EXIF IFD holding
    `tags` (rational tags as value/10000, the rest as SHORT)."""
    entries = sorted(tags.items())
    n = len(entries)
    exif_ifd_off = 8 + 2 + 12 + 4          # after header + IFD0 (1 entry)
    data_off = exif_ifd_off + 2 + 12 * n + 4
    ifd, extra = [], b""
    for tag, val in entries:
        if tag in _RATIONAL_TAGS:
            ifd.append(struct.pack("<HHII", tag, 5, 1, data_off + len(extra)))
            extra += struct.pack("<II", int(round(float(val) * 10000)), 10000)
        elif tag in _SHORT_TAGS:
            ifd.append(struct.pack("<HHIHH", tag, 3, 1, int(val), 0))
        else:
            raise ValueError(f"make_exif: unsupported tag 0x{tag:04X}")
    out = b"II*\x00" + struct.pack("<I", 8)
    out += struct.pack("<H", 1) + struct.pack("<HHII", TAG_EXIF_IFD, 4, 1,
                                              exif_ifd_off) + b"\0\0\0\0"
    out += struct.pack("<H", n) + b"".join(ifd) + b"\0\0\0\0" + extra
    return out


def parse_exif(data: bytes) -> Dict[int, float]:
    """Numeric tags of IFD0 and the EXIF sub-IFD of a TIFF-structured EXIF
    block. Raises ValueError on a block that is not TIFF-structured."""
    if data[:6] == b"Exif\x00\x00":
        data = data[6:]
    if data[:4] == b"II*\x00":
        e = "<"
    elif data[:4] == b"MM\x00*":
        e = ">"
    else:
        raise ValueError("EXIF block has no TIFF header")
    out: Dict[int, float] = {}

    def read_ifd(off: int, follow: bool):
        if off + 2 > len(data):
            raise ValueError("EXIF IFD offset out of range")
        (n,) = struct.unpack(e + "H", data[off:off + 2])
        for i in range(n):
            p = off + 2 + 12 * i
            if p + 12 > len(data):
                raise ValueError("EXIF IFD is truncated")
            tag, typ, count = struct.unpack(e + "HHI", data[p:p + 8])
            if count != 1 or typ not in _TYPE_SIZE:
                continue
            size = _TYPE_SIZE[typ]
            voff = p + 8 if size <= 4 else struct.unpack(
                e + "I", data[p + 8:p + 12])[0]
            if voff + size > len(data):
                raise ValueError("EXIF value offset out of range")
            if typ == 3:
                (val,) = struct.unpack(e + "H", data[voff:voff + 2])
            elif typ == 4:
                (val,) = struct.unpack(e + "I", data[voff:voff + 4])
            else:
                num, den = struct.unpack(e + "II", data[voff:voff + 8])
                if den == 0:
                    continue
                val = num / den
            if tag == TAG_EXIF_IFD and follow:
                read_ifd(int(val), follow=False)
            else:
                out[tag] = float(val)

    read_ifd(struct.unpack(e + "I", data[4:8])[0], follow=True)
    return out
