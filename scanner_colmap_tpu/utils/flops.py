"""Analytic FLOP / gather-tap accounting for utilization reporting.

Wall-clock throughput alone cannot show how close a stage runs to the
hardware's ceiling. This module provides closed-form work estimates for the
three device-dominated stages — descriptor matching (matmuls), bundle
adjustment (einsums), and PatchMatch (elementwise work + gather taps) — so
the benchmarks can put an achieved/peak fraction next to a throughput.
Estimates count the dominant terms of the actual programs in
ops/matching.py, ops/ba.py, ops/patch_match.py (documented per term) and
are accurate to ~±20%, which is enough to distinguish "3% of peak" from
"40% of peak".
"""

from __future__ import annotations

# Published peaks of one card, keyed by jax Device.device_kind: dense rates
# (no sparsity) at the card's full power limit (700 W for the H100 SXM).
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM column. A card set
# below its full power limit cannot hold these clocks under load, so a
# fraction of peak is reported with the card's power limit beside it.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tflops": 989.0,   # tensor cores, bf16/fp16 inputs
        "tf32_tflops": 495.0,   # tensor cores, TF32
        "fp32_tflops": 67.0,    # CUDA cores, float32
        "hbm_tbps": 3.35,       # HBM3 bandwidth, TB/s
    },
}


def device_peaks(device) -> dict | None:
    """Peak rates of a jax device: None for the CPU, which has no entry by
    design; an accelerator missing from PEAKS raises, since a rate divided
    by an assumed peak is a made-up number."""
    if device.platform == "cpu":
        return None
    try:
        return PEAKS[device.device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device kind "
                       f"{device.device_kind!r}; add them to PEAKS") from None


def device_peak_tflops(device) -> float | None:
    """bf16 dense-matmul peak (TFLOP/s) of a jax device; None for the CPU."""
    peaks = device_peaks(device)
    return None if peaks is None else peaks["bf16_tflops"]


def matching_flops(num_pairs: int, k_max: int, dim: int = 128) -> float:
    """FLOPs of the banked matching phase: one (K, dim) @ (dim, K) distance
    matrix per scheduled pair (ops/matching.py match_descriptors; the
    cross-check direction reuses the transposed matrix, and the ratio-test
    top-2 reduction is O(K^2) — negligible next to the matmul)."""
    return 2.0 * num_pairs * k_max * k_max * dim


def ba_flops_per_iter(M: int, P: int, T: int) -> float:
    """FLOPs of ONE LM iteration of ops/ba.py (trial + 2 cost evals).

    Dominant terms of _build_normal_eqs / _lm_trial, MC = 8*M:
      - residual + closed-form Jacobian chains:       ~250 flops / obs cell
      - V_j / g_p point-block einsums:                 ~40 flops / obs cell
      - U, g_c one-hot camera scatters:            2*(64+8)*M flops / cell
      - B coupling-block scatter:                      2*24*M flops / cell
      - B V^-1 product:                                2*9*MC flops / point
      - Schur accumulation  S += BV B^T:              2*3*MC^2 flops / point
      - dense solve of the MC x MC reduced system:        ~2/3 * MC^3
      - two robust_cost evaluations:                  ~120 flops / obs cell
    """
    MC = 8.0 * M
    cells = float(P) * T
    per_cell = 250.0 + 40.0 + 2.0 * (64.0 + 8.0) * M + 2.0 * 24.0 * M + 120.0
    per_point = 2.0 * 9.0 * MC + 2.0 * 3.0 * MC * MC
    return cells * per_cell + P * per_point + (2.0 / 3.0) * MC**3


def ba_cg_flops_per_iter(M: int, P: int, T: int, cg_iters: int) -> float:
    """FLOPs of ONE LM iteration of the matrix-free CG-Schur path
    (ops/ba._lm_trial_cg). Dominant terms:

      build (once per trial):
        Jacobian chains ~250, V/g_p ~40, Wc ~96, U-segsum ~256+64,
        g_c ~32, rhs_sub ~48, Schur-Jacobi diag ~200 flops / obs cell,
        plus ~90 flops / point (3x3 inverse, y0)
      per CG iteration:
        matvec Wc products ~105 / cell, ~20 / point, 2*64*M for Ud x
      two robust_cost evaluations: ~240 / cell

    Unlike the dense path there is NO M-scaled per-cell term and no MC^2
    accumulation — the work is segment-sum/gather dominated, so the bound
    is HBM bandwidth, not the matmul peak."""
    cells = float(P) * T
    build = cells * (250.0 + 40.0 + 96.0 + 320.0 + 32.0 + 48.0 + 200.0
                     + 240.0) + P * 90.0
    per_cg = cells * 105.0 + P * 20.0 + 128.0 * M
    return build + cg_iters * per_cg


def device_mapper_flops(M: int, P: int, T: int, n_images: int,
                        ba_iters: int, final_iters: int,
                        pnp_trials: int = 256) -> float:
    """SCHEDULED FLOPs of one device-mapper cluster program
    (ops/device_mapper._map_cluster_impl): ~(n-1) active registration steps
    (the retry pass and padded schedule slots cond-skip on the non-vmapped
    path), each running PnP RANSAC + triangulate_all + ba_iters LM
    iterations, plus two final grow_and_refine rounds of final_iters.

    UPPER BOUND on executed work: converged LM trips skip device-side
    (lax.cond), so achieved-TFLOP/s computed from this is an upper
    estimate — good for order-of-magnitude MFU accounting, not ±20%."""
    steps = max(n_images - 1, 1)
    ba_it = ba_flops_per_iter(M, P, T)
    pnp_fl = float(pnp_trials) * P * 120.0    # per-trial residual checks
    tri = float(P) * T * 600.0                # _triangulate_all einsums
    return (steps * (ba_iters * ba_it + pnp_fl + tri)
            + 2.0 * (final_iters * ba_it + tri))


def patch_match_taps(H: int, W: int, S: int, window_radius: int,
                     num_iterations: int, window_step: int = 1,
                     n_candidates: int = 10) -> float:
    """Gather taps of one PatchMatch solve (ops/patch_match.py, "field"
    sampling): one packed [value, gx, gy] gather per source view per window
    offset per candidate per pixel; 10 candidates per iteration (8 Jacobi
    propagations + perturbation + random) plus the initial cost pass.
    The stage is bound by these gathers, not by its FLOPs."""
    n_off = (2 * window_radius // window_step + 1) ** 2
    return float(H) * W * S * n_off * (1.0 + n_candidates * num_iterations)
