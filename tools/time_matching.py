"""Time the resident-pool matcher (ops/matching.match_pairs_pool) on the
default device at K=2048 and K=8192 keypoints per image, 128 pairs per
call, and report ms per pair and the share of the card's bf16 peak that
its (K, K, 128) similarity products reach.

    python tools/time_matching.py

Warm timings: one call compiles, then REPS calls are timed back to back
and synchronized once. Random uint8 descriptors; the work does not depend
on the values.
"""

import os
import subprocess
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from scanner_colmap_tpu.ops import matching  # noqa: E402
from scanner_colmap_tpu.utils import flops  # noqa: E402

PAIRS, POOL_IMAGES, REPS = 128, 48, 8


def time_pool(K: int) -> float:
    """Seconds per call of match_pairs_pool over PAIRS pairs, warm."""
    rng = np.random.default_rng(5)
    pool = matching.normalize_pool(jnp.asarray(
        rng.integers(0, 255, (POOL_IMAGES, K, 128), np.uint8)))
    valid = jnp.ones((POOL_IMAGES, K), bool)
    ai = jnp.asarray(rng.integers(0, POOL_IMAGES, PAIRS), jnp.int32)
    bi = jnp.asarray(rng.integers(0, POOL_IMAGES, PAIRS), jnp.int32)
    jax.block_until_ready(matching.match_pairs_pool(pool, valid, ai, bi))
    t0 = time.perf_counter()
    for _ in range(REPS):
        out = matching.match_pairs_pool(pool, valid, ai, bi)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / REPS


def main():
    dev = jax.devices()[0]
    card = dev.device_kind
    if dev.platform == "gpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.splitlines()[0].strip()
    peak = flops.device_peak_tflops(dev)
    for K in (2048, 8192):
        s = time_pool(K)
        tflops = flops.matching_flops(PAIRS, K) / s / 1e12
        share = f"{100 * tflops / peak:.2f}% of bf16 peak" if peak else "no peak"
        print(f"match_pairs_pool K={K} pairs={PAIRS}: {1e3 * s / PAIRS:.4f} "
              f"ms/pair, {tflops:.2f} TFLOP/s ({share})  [{card}]",
              flush=True)


if __name__ == "__main__":
    main()
