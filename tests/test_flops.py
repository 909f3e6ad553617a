"""Sanity checks for the analytic work estimates and the peak table behind
the bench's utilization report (utils/flops.py)."""

import numpy as np
import pytest

from scanner_colmap_tpu.utils import flops


def test_matching_flops_matches_matmul_count():
    # one (K, 128) @ (128, K) matmul per pair: 2*K*K*128 FLOPs
    assert flops.matching_flops(1, 1024) == 2 * 1024 * 1024 * 128
    assert flops.matching_flops(10, 512) == 10 * 2 * 512 * 512 * 128


def test_ba_flops_dominated_by_schur_accumulation():
    """At bench shapes the S += BV B^T term (2*3*MC^2 per point) dominates;
    the estimate must sit between that floor and ~3x it."""
    M, P, T = 16, 1024, 16
    MC = 8 * M
    schur = P * 2 * 3 * MC * MC
    est = flops.ba_flops_per_iter(M, P, T)
    assert est > schur
    assert est < 4 * schur, (est, schur)
    # monotonic in every dimension
    assert flops.ba_flops_per_iter(32, P, T) > est
    assert flops.ba_flops_per_iter(M, 2 * P, T) > est
    assert flops.ba_flops_per_iter(M, P, 2 * T) > est


def test_patch_match_taps_formula():
    # window radius 5 -> 11x11 offsets; 10 candidates/iter + initial pass
    t = flops.patch_match_taps(100, 200, 4, 5, 7)
    assert t == 100 * 200 * 4 * 121 * (1 + 70)
    assert flops.patch_match_taps(100, 200, 4, 5, 7, window_step=2) < t


@pytest.mark.parametrize("platform, kind, expect", [
    ("gpu", "NVIDIA H100 80GB HBM3", 989.0),
    ("gpu", "NVIDIA Unknown Card", KeyError),
    ("cpu", "cpu", None),
])
def test_device_peak_lookup(platform, kind, expect):
    class Dev:
        pass
    dev = Dev()
    dev.platform, dev.device_kind = platform, kind
    if expect is KeyError:
        with pytest.raises(KeyError, match="no published peaks"):
            flops.device_peak_tflops(dev)
    else:
        assert flops.device_peak_tflops(dev) == expect
