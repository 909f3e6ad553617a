"""SIFT descriptor matching: batched ratio-test + cross-check matching.

Rebuilds the capability of COLMAP's ``MatchSiftFeaturesCPU`` as called by the
reference's sequential matching kernel
(integration/op_cpp/sequential_matching.cc:154-155) with one dense product:
the N×M descriptor similarity is one matmul; best/second-best selection,
the angular ratio test, and the cross check are fused elementwise work. A
whole overlap window of pairs is matched as one batched einsum (the
reference loops pairs serially per stencil row).

Conventions (matching COLMAP semantics):
- descriptors are L2-normalized rows; similarity = dot product in [0, 1]
- distance = arccos(similarity); ``max_distance`` and the ratio test are
  applied in this angular space
- invalid (padded) keypoints are masked out of both sides
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

NEG = -1e9


def normalize_descriptors(desc: jax.Array) -> jax.Array:
    """L2-normalize descriptor rows (uint8 COLMAP-style 512-scaled or float)."""
    d = desc.astype(jnp.float32)
    return d / jnp.maximum(jnp.linalg.norm(d, axis=-1, keepdims=True), 1e-8)


def _sim_matmul(d1: jax.Array, d2: jax.Array, precision: str):
    """Descriptor similarity matmul. precision="bf16" multiplies bf16
    operands with f32 accumulation (the tensor cores' bf16 rate). bf16's
    8-bit mantissa on normalized descriptors is the same quantization class
    as COLMAP's raw uint8 descriptors, so match decisions only move on ties
    the ratio test rejects anyway; "f32" keeps the f32 path, whose
    precision follows jax.default_matmul_precision."""
    if precision == "bf16":
        d1 = d1.astype(jnp.bfloat16)
        d2 = d2.astype(jnp.bfloat16)
    return jnp.dot(d1, d2.T, preferred_element_type=jnp.float32)


def _top2(sim: jax.Array):
    """Row-wise best and second-best similarity + best index. sim: (N, M)."""
    best_idx = jnp.argmax(sim, axis=-1)
    best = jnp.take_along_axis(sim, best_idx[:, None], axis=-1)[:, 0]
    masked = jnp.where(
        jax.nn.one_hot(best_idx, sim.shape[-1], dtype=jnp.bool_), NEG, sim
    )
    second = jnp.max(masked, axis=-1)
    return best, second, best_idx


# bf16 bias for the packed reductions: sim in [-1, 1] shifts to [1, 3], all
# positive, where the bf16 bit pattern is monotone — so (value bits << 16 |
# complemented index) reduces value AND first-index argmax in ONE max pass
NEG_BF16 = -2.0


def _pack_bf16(sim_bf16: jax.Array, idx: jax.Array):
    bits = jax.lax.bitcast_convert_type(
        sim_bf16 + jnp.bfloat16(2.0), jnp.uint16).astype(jnp.uint32)
    return (bits << 16) | (0xFFFF - idx.astype(jnp.uint32))


def _unpack_bf16(packed: jax.Array):
    val = jax.lax.bitcast_convert_type(
        (packed >> 16).astype(jnp.uint16), jnp.bfloat16) - jnp.bfloat16(2.0)
    return val.astype(jnp.float32), (0xFFFF - (packed & 0xFFFF)).astype(jnp.int32)


def _match_from_sim_bf16(sim: jax.Array, valid1, valid2, max_ratio,
                         max_distance, cross_check):
    """Ratio-test + cross-check decisions from a raw bf16 similarity.

    The packed single-pass max+argmax formulation: one reduction pass
    over the similarity yields value and first index together, in place of
    the argmax/take_along/one_hot chain. Quantization: best/second are bf16
    roundings of the f32-accumulated similarity — the same precision class
    as the bf16 matmul itself (see _sim_matmul's note); tie-breaks remain
    first-index, matching the f32 path."""
    K1, K2 = sim.shape
    simm = jnp.where(valid2[None, :], sim, jnp.bfloat16(NEG_BF16))
    cols = jax.lax.broadcasted_iota(jnp.uint32, sim.shape, 1)
    pmax = jnp.max(_pack_bf16(simm, cols), axis=-1)
    best, best_idx = _unpack_bf16(pmax)
    second = jnp.max(
        jnp.where(cols == best_idx.astype(jnp.uint32)[:, None],
                  jnp.bfloat16(NEG_BF16), simm), axis=-1).astype(jnp.float32)
    dist = jnp.arccos(jnp.clip(best, -1.0, 1.0))
    dist2 = jnp.arccos(jnp.clip(second, -1.0, 1.0))
    ok = valid1 & (best > -1.0) & (dist < max_distance)
    ok &= dist < max_ratio * dist2
    if cross_check:
        rows = jax.lax.broadcasted_iota(jnp.uint32, sim.shape, 0)
        bits = jax.lax.bitcast_convert_type(
            simm + jnp.bfloat16(2.0), jnp.uint16).astype(jnp.uint32) << 16
        packed_r = jnp.where(valid1[:, None], bits, 0) | (0xFFFF - rows)
        rev = (0xFFFF - (jnp.max(packed_r, axis=0) & 0xFFFF)).astype(jnp.int32)
        ok &= rev[best_idx] == jnp.arange(K1)
    return jnp.where(ok, best_idx, -1).astype(jnp.int32), ok


@functools.partial(jax.jit, static_argnames=("cross_check", "precision"))
def match_descriptors(
    desc1: jax.Array,
    desc2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    precision: str = "bf16",
):
    """Match desc1 (N,128) against desc2 (M,128) with masks.

    Returns (match_idx (N,) int32 into desc2 or -1, valid (N,) bool).
    Semantics follow COLMAP FindBestMatches: angular distance threshold,
    Lowe ratio test in angular space, optional mutual-best cross check.

    precision="bf16" (default) runs the packed single-pass reductions on a
    raw bf16 similarity (_match_from_sim_bf16); "f32" keeps the
    f32-accumulated path.
    """
    d1 = normalize_descriptors(desc1)
    d2 = normalize_descriptors(desc2)
    if precision == "bf16":
        sim = jnp.dot(d1.astype(jnp.bfloat16), d2.astype(jnp.bfloat16).T)
        return _match_from_sim_bf16(sim, valid1, valid2, max_ratio,
                                    max_distance, cross_check)
    sim = _sim_matmul(d1, d2, precision)  # (N, M)
    sim = jnp.where(valid2[None, :], sim, NEG)

    best, second, best_idx = _top2(sim)
    dist = jnp.arccos(jnp.clip(best, -1.0, 1.0))
    dist2 = jnp.arccos(jnp.clip(second, -1.0, 1.0))

    ok = valid1
    ok &= best > -1.0  # at least one valid target
    ok &= dist < max_distance
    ok &= dist < max_ratio * dist2

    if cross_check:
        sim_r = jnp.where(valid1[:, None], sim, NEG)
        rev_best = jnp.argmax(sim_r, axis=0)  # (M,) best row for each col
        ok &= rev_best[best_idx] == jnp.arange(desc1.shape[0])

    return jnp.where(ok, best_idx, -1).astype(jnp.int32), ok


# ---------------------------------------------------------------------------
# Device-resident descriptor pool (collection-scale path)
# ---------------------------------------------------------------------------

@jax.jit
def normalize_pool(desc_pool: jax.Array) -> jax.Array:
    """(N_img, K, 128) raw (uint8) descriptor pool -> L2-normalized bf16.

    The pool uploads ONCE as uint8 (4x fewer bytes than f32, and no
    per-bank re-upload) and normalizes on device. Padded rows are zero and
    stay zero."""
    f = desc_pool.astype(jnp.float32)
    n = jnp.maximum(jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-8)
    return (f / n).astype(jnp.bfloat16)


@functools.lru_cache(maxsize=8)
def _match_pairs_pool_fn(max_ratio, max_distance, cross_check, precision):
    """Jitted pool matcher per matching configuration. Collection sizes
    are bucketed by the caller (stages.upload_pool rounds N up), so a new
    collection size within a bucket reuses the compiled program."""
    def run(pool, valid, ai, bi):
        return _match_pairs_pool_impl(pool, valid, ai, bi, max_ratio,
                                      max_distance, cross_check, precision)
    return jax.jit(run)


def match_pairs_pool(pool, valid, ai, bi, max_ratio: float = 0.8,
                     max_distance: float = 0.7, cross_check: bool = True,
                     precision: str = "bf16"):
    return _match_pairs_pool_fn(float(max_ratio), float(max_distance),
                                bool(cross_check), precision)(
        pool, valid, ai, bi)


def _match_pairs_pool_impl(pool, valid, ai, bi, max_ratio: float = 0.8,
                           max_distance: float = 0.7,
                           cross_check: bool = True,
                           precision: str = "bf16"):
    """Match scheduled pairs (ai[i], bi[i]) from a resident pool.

    pool: (N_img, K, 128) bf16 normalized (normalize_pool); valid:
    (N_img, K) bool; ai/bi: (NP,) int32. Returns (NP, K) int32 match
    indices (-1 = none). Decision-for-decision identical to
    match_descriptors at the same precision — same similarity operands,
    same reduction formulation — so banked and resident schedules of the
    same collection produce the same matching table."""
    def per_pair(args):
        a, b = args
        d1, d2 = pool[a], pool[b]
        v1, v2 = valid[a], valid[b]
        if precision == "bf16":
            sim = jnp.dot(d1, d2.T)
            idx, ok = _match_from_sim_bf16(sim, v1, v2, max_ratio,
                                           max_distance, cross_check)
        else:
            idx, ok = match_descriptors(d1, d2, v1, v2, max_ratio=max_ratio,
                                        max_distance=max_distance,
                                        cross_check=cross_check,
                                        precision=precision)
        return jnp.where(ok, idx, -1).astype(jnp.int32)

    # vmap width scaled to the capacity: XLA materializes the batched
    # (C, K, K) similarity at large K (measured: 512 lanes at K=8192
    # asked for a 64 GB buffer), so cap the parallel chunk at ~16 K=2048
    # pairs' worth and run chunks sequentially under lax.map
    NP = ai.shape[0]
    K = pool.shape[1]
    inner = max(1, min(16, (16 * 2048 * 2048) // max(K * K, 1), NP))
    while NP % inner:           # lax.map needs an exact chunking
        inner -= 1
    xs = (ai.reshape(NP // inner, inner), bi.reshape(NP // inner, inner))
    ys = jax.lax.map(lambda c: jax.vmap(lambda a, b: per_pair((a, b)))(*c),
                     xs)
    return ys.reshape(NP, -1)


@functools.partial(jax.jit, static_argnames=("cross_check", "precision"))
def match_window(
    desc: jax.Array,
    valid: jax.Array,
    max_ratio: float = 0.8,
    max_distance: float = 0.7,
    cross_check: bool = True,
    precision: str = "bf16",
):
    """Sequential-overlap matching for one window of images.

    desc: (W, K, 128) — image 0 is the pivot, images 1..W-1 its window
    (the reference's stencil: feature_matching.py:43, each row sees the next
    ``overlap`` rows). Returns (match_idx (W-1, K), valid (W-1, K)) matching
    pivot keypoints into each window image.

    The W-1 pair similarities run as ONE batched einsum.
    """
    d = normalize_descriptors(desc)
    if precision == "bf16":
        d = d.astype(jnp.bfloat16)
    d0 = d[0]  # (K, 128)
    dw = d[1:]  # (W-1, K, 128)
    sim = jnp.einsum("kd,wmd->wkm", d0, dw, preferred_element_type=jnp.float32)
    sim = jnp.where(valid[1:, None, :], sim, NEG)

    def per_pair(s, v2):
        best_idx = jnp.argmax(s, axis=-1)
        best = jnp.take_along_axis(s, best_idx[:, None], axis=-1)[:, 0]
        masked = jnp.where(jax.nn.one_hot(best_idx, s.shape[-1], dtype=jnp.bool_), NEG, s)
        second = jnp.max(masked, axis=-1)
        dist = jnp.arccos(jnp.clip(best, -1.0, 1.0))
        dist2 = jnp.arccos(jnp.clip(second, -1.0, 1.0))
        ok = valid[0]
        ok &= best > -1.0
        ok &= dist < max_distance
        ok &= dist < max_ratio * dist2
        if cross_check:
            s_r = jnp.where(valid[0][:, None], s, NEG)
            rev_best = jnp.argmax(s_r, axis=0)
            ok &= rev_best[best_idx] == jnp.arange(s.shape[0])
        return jnp.where(ok, best_idx, -1).astype(jnp.int32), ok

    return jax.vmap(per_pair)(sim, valid[1:])


@functools.partial(jax.jit, static_argnames=("cross_check", "precision"))
def match_descriptors_guided(
    desc1: jax.Array,
    desc2: jax.Array,
    valid1: jax.Array,
    valid2: jax.Array,
    uv1: jax.Array,      # (N, 2) pixel coords
    uv2: jax.Array,      # (M, 2)
    F: jax.Array,        # (3, 3) fundamental matrix of the pair
    max_epipolar_error: float = 4.0,
    max_ratio: float = 0.9,
    max_distance: float = 0.7,
    cross_check: bool = True,
    precision: str = "bf16",
):
    """Guided matching (capability of COLMAP's guided_matching flag,
    colmap.proto:41, which the reference exposes but never enables):
    candidate matches are restricted to epipolar-consistent pairs BEFORE
    the nearest-neighbor search, recovering matches the unconstrained
    ratio test rejects in repetitive texture.

    The epipolar gate is an (N, M) Sampson-distance mask fused with the
    similarity matmul — still one matmul plus elementwise work.
    """
    d1 = normalize_descriptors(desc1)
    d2 = normalize_descriptors(desc2)
    sim = _sim_matmul(d1, d2, precision)

    ones1 = jnp.ones_like(uv1[:, :1])
    ones2 = jnp.ones_like(uv2[:, :1])
    p1 = jnp.concatenate([uv1, ones1], axis=-1)       # (N, 3)
    p2 = jnp.concatenate([uv2, ones2], axis=-1)       # (M, 3)
    Fx1 = p1 @ F.T                                    # (N, 3) lines in img2
    Ftx2 = p2 @ F                                     # (M, 3) lines in img1
    x2Fx1 = Fx1 @ p2.T                                # (N, M)
    denom = (Fx1[:, 0] ** 2 + Fx1[:, 1] ** 2)[:, None] + \
        (Ftx2[:, 0] ** 2 + Ftx2[:, 1] ** 2)[None, :]
    sampson2 = x2Fx1**2 / jnp.maximum(denom, 1e-12)
    epi_ok = sampson2 < max_epipolar_error**2

    sim = jnp.where(valid2[None, :] & epi_ok, sim, NEG)
    best, second, best_idx = _top2(sim)
    dist = jnp.arccos(jnp.clip(best, -1.0, 1.0))
    dist2 = jnp.arccos(jnp.clip(second, -1.0, 1.0))
    ok = valid1 & (best > -1.0) & (dist < max_distance)
    ok &= dist < max_ratio * dist2
    if cross_check:
        sim_r = jnp.where(valid1[:, None], sim, NEG)
        rev_best = jnp.argmax(sim_r, axis=0)
        ok &= rev_best[best_idx] == jnp.arange(desc1.shape[0])
    return jnp.where(ok, best_idx, -1).astype(jnp.int32), ok


def matches_to_pairs(match_idx, match_valid, max_num_matches: int):
    """Compact (K,) match indices into fixed-capacity (max_num_matches, 2)
    index pairs + mask, jit-safe (stable argsort on validity)."""
    K = match_idx.shape[0]
    order = jnp.argsort(~match_valid, stable=True)  # valid first
    idx1 = order[:max_num_matches]
    idx2 = match_idx[idx1]
    m = match_valid[idx1]
    count_ok = jnp.arange(max_num_matches) < jnp.sum(match_valid)
    m &= count_ok
    pairs = jnp.stack([idx1.astype(jnp.int32), idx2.astype(jnp.int32)], axis=-1)
    return jnp.where(m[:, None], pairs, -1), m
