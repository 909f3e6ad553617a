"""Measure large-scale BA on the accelerator: the dense Schur path at a
card-filling size (M=256 cameras, P=50k points) and the matrix-free
CG-Schur path at M=1024/P=50k.

    python tools/exp_ba_scale.py
"""

import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax
import numpy as np

from __graft_entry__ import _synthetic_bundle
from scanner_colmap_tpu.ops import ba
from scanner_colmap_tpu.utils import flops as fl


def run(tag, M, Pn, T, iters, solver, chunk, cg_iters=32):
    params, obs, cfg, _, _ = _synthetic_bundle(M=M, Pn=Pn, T=T, K=8)
    kw = dict(max_iterations=iters, chunk=chunk, solver=solver,
              cg_iters=cg_iters, function_tolerance=0.0)
    t0 = time.time()
    p, info = ba.bundle_adjust(params, obs, cfg, **kw)
    cost = float(info["final_cost"])  # sync
    t_cold = time.time() - t0
    t0 = time.time()
    p, info = ba.bundle_adjust(params, obs, cfg, **kw)
    n = float(info["iterations"])
    cost = float(info["final_cost"])
    t = time.time() - t0
    per_iter = t / max(n, 1)
    if solver == "dense":
        fpi = fl.ba_flops_per_iter(M, Pn, T)
    else:
        fpi = fl.ba_cg_flops_per_iter(M, Pn, T, cg_iters)
    tflops = fpi * n / t / 1e12
    peak = fl.device_peak_tflops(jax.devices()[0])
    print(f"{tag}: M={M} P={Pn} T={T} solver={solver} "
          f"cold={t_cold:.1f}s warm={t:.2f}s n_iter={n:.0f} "
          f"({per_iter*1e3:.1f} ms/iter) cost={cost:.1f} "
          f"achieved={tflops:.2f} TFLOP/s "
          + (f"({100 * tflops / peak:.1f}% of bf16 peak)" if peak
             else "(no peak on the CPU)"),
          flush=True)
    return {"t": t, "n": n, "tflops": tflops}


if __name__ == "__main__":
    print("devices:", jax.devices(), flush=True)
    # first device dispatch (backend start-up) outside the timings
    jax.block_until_ready(jax.numpy.zeros(8) + 1)
    run("dense-small", 64, 8192, 4, 10, "dense", 1024)
    run("dense-big", 256, 49152, 4, 10, "dense", 1024)
    run("cg-1k", 1024, 49152, 4, 10, "cg", 4096, cg_iters=32)
