import numpy as np
import jax.numpy as jnp

from scanner_colmap_tpu.ops import matching, sift


def render_blobs(H, W, blobs):
    """Image with Gaussian blobs at (x, y, sigma, amplitude)."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    img = np.zeros((H, W))
    for x, y, s, a in blobs:
        img += a * np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * s * s))
    return img.astype(np.float32)


def test_sift_detects_blobs():
    H = W = 128
    blobs = [(32.0, 32.0, 3.0, 1.0), (96.0, 40.0, 4.0, 1.0),
             (48.0, 96.0, 5.0, 1.0), (100.0, 100.0, 3.5, 1.0)]
    img = render_blobs(H, W, blobs)
    feats = sift.extract(jnp.asarray(img), jnp.array([H, W]),
                         max_features=64, num_octaves=3)
    xy = np.asarray(feats.xy)[np.asarray(feats.valid)]
    assert len(xy) >= len(blobs)
    # every blob center found within 1.5 px by some keypoint
    for x, y, s, a in blobs:
        d = np.min(np.linalg.norm(xy - np.array([x, y]), axis=-1))
        assert d < 1.5, (x, y, d)


def test_sift_scale_estimates_blob_size():
    H = W = 128
    img = render_blobs(H, W, [(64.0, 64.0, 4.0, 1.0)])
    feats = sift.extract(jnp.asarray(img), jnp.array([H, W]),
                         max_features=16, num_octaves=3)
    v = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)[v]
    sc = np.asarray(feats.scale)[v]
    i = np.argmin(np.linalg.norm(xy - 64.0, axis=-1))
    # DoG response peaks at sigma ~ blob sigma (tolerate half-octave)
    assert 2.0 < sc[i] < 8.0, sc[i]


def test_sift_empty_image():
    img = np.zeros((64, 64), np.float32)
    feats = sift.extract(jnp.asarray(img), jnp.array([64, 64]),
                         max_features=32, num_octaves=2)
    assert not np.any(np.asarray(feats.valid))


def test_sift_descriptor_invariance_translation():
    """Same pattern at two positions -> nearly identical descriptors."""
    H = W = 160
    # an asymmetric corner-like pattern, twice
    def pattern(cx, cy):
        return [(cx, cy, 3.0, 1.0), (cx + 7, cy, 2.0, -0.6),
                (cx, cy + 9, 2.5, -0.4)]

    img = render_blobs(H, W, pattern(40, 40) + pattern(104, 96))
    feats = sift.extract(jnp.asarray(img), jnp.array([H, W]),
                         max_features=64, num_octaves=3)
    v = np.asarray(feats.valid)
    xy = np.asarray(feats.xy)[v]
    desc = np.asarray(feats.desc)[v]
    i = np.argmin(np.linalg.norm(xy - np.array([40, 40]), axis=-1))
    j = np.argmin(np.linalg.norm(xy - np.array([104, 96]), axis=-1))
    assert np.linalg.norm(xy[i] - [40, 40]) < 2.0
    assert np.linalg.norm(xy[j] - [104, 96]) < 2.0
    sim = float(desc[i] @ desc[j])
    assert sim > 0.9, sim


def test_sift_match_shifted_image():
    """End-to-end: extract on an image and a shifted copy, match, verify
    displacement consistency."""
    H = W = 128
    rng = np.random.default_rng(3)
    blobs = [(float(x), float(y), float(s), float(a))
             for x, y, s, a in zip(rng.uniform(20, 90, 12), rng.uniform(20, 90, 12),
                                   rng.uniform(2.5, 5, 12), rng.uniform(0.5, 1, 12))]
    img1 = render_blobs(H, W, blobs)
    dxy = (16, 9)
    blobs2 = [(x + dxy[0], y + dxy[1], s, a) for x, y, s, a in blobs]
    img2 = render_blobs(H, W, blobs2)

    f1 = sift.extract(jnp.asarray(img1), jnp.array([H, W]), max_features=64,
                      num_octaves=3)
    f2 = sift.extract(jnp.asarray(img2), jnp.array([H, W]), max_features=64,
                      num_octaves=3)
    idx, ok = matching.match_descriptors(f1.desc, f2.desc, f1.valid, f2.valid)
    idx, ok = np.asarray(idx), np.asarray(ok)
    assert ok.sum() >= 6
    xy1 = np.asarray(f1.xy)[ok]
    xy2 = np.asarray(f2.xy)[idx[ok]]
    disp = xy2 - xy1
    med = np.median(disp, axis=0)
    assert np.allclose(med, dxy, atol=1.0), med
    # most matches agree with the displacement
    frac = np.mean(np.linalg.norm(disp - med, axis=-1) < 2.0)
    assert frac > 0.7


def test_descriptors_to_uint8_roundtrip():
    d = jnp.ones((4, 128)) / np.sqrt(128.0)
    u8 = np.asarray(sift.descriptors_to_uint8(d))
    assert u8.dtype == np.uint8
    assert np.all(u8 == np.round(512 / np.sqrt(128)))


def test_extract_patches_matches_direct_slicing():
    """Patch block extraction (the contiguous-block gather) equals direct numpy
    slicing, including corner clamping at image borders."""
    rng = np.random.default_rng(0)
    maps = rng.normal(size=(3, 64, 80)).astype(np.float32)
    yx = np.array([[32.2, 40.6],    # interior
                   [0.9, 1.2],      # top-left corner (clamps)
                   [63.0, 79.0]])   # bottom-right corner (clamps)
    si = np.array([0, 1, 2], np.int32)
    P = 32
    patches, rel = sift.extract_patches(
        jnp.asarray(maps), jnp.asarray(si), jnp.asarray(yx), P)
    patches, rel = np.asarray(patches), np.asarray(rel)
    for k in range(3):
        cy = int(np.clip(round(yx[k, 0]) - P // 2, 0, 64 - P))
        cx = int(np.clip(round(yx[k, 1]) - P // 2, 0, 80 - P))
        assert np.array_equal(patches[k], maps[si[k], cy:cy + P, cx:cx + P])
        assert np.allclose(rel[k], yx[k] - [cy, cx])
