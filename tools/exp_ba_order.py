"""How far a CG bundle-adjustment result moves when only the order of its
sums changes: the same problem solved on one device twice, once with the
points permuted (the point-block reductions then add in another order).

    python tools/exp_ba_order.py [line] [ring]

`line` is `__graft_entry__._synthetic_bundle` and `ring` is
`__graft_entry__.ring_bundle`, both at M=1024 cameras, P=49,152 points,
T=4 observations per point, solved as `chip_smoke.mesh_check` solves them
(one-device mesh, CG with 64 inner iterations, at most 100 LM trips). A
gap here bounds what a multi-device comparison of the same problem can
show, since psum order is also only a change of summation order.
"""

import os
import sys
import time

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import numpy as np  # noqa: E402

from __graft_entry__ import _synthetic_bundle, ring_bundle  # noqa: E402
from scanner_colmap_tpu.parallel.dist_ba import distributed_bundle_adjust  # noqa: E402
from scanner_colmap_tpu.parallel.mesh import make_mesh  # noqa: E402

M, P, T = 1024, 49152, 4


def permute_points(params, obs, cfg, perm):
    return (params._replace(xyz=params.xyz[perm]),
            obs._replace(cam_idx=obs.cam_idx[perm], uv=obs.uv[perm],
                         valid=obs.valid[perm]),
            cfg._replace(pt_valid=cfg.pt_valid[perm]))


def solve(params, obs, cfg):
    t0 = time.time()
    _, info = jax.block_until_ready(distributed_bundle_adjust(
        make_mesh(num_devices=1), params, obs, cfg, max_iterations=100,
        chunk=1024, solver="cg", cg_iters=64))
    return (float(info["final_cost"]), int(info["iterations"]),
            time.time() - t0)


def main(names):
    dev = jax.devices()[0]
    for name in names:
        if name == "line":
            params, obs, cfg, _, _ = _synthetic_bundle(M=M, Pn=P, T=T, K=8)
        elif name == "ring":
            params, obs, cfg = ring_bundle(M, P, T)
        else:
            raise ValueError(f"unknown problem {name!r}")
        perm = np.random.default_rng(1).permutation(P)
        base = solve(params, obs, cfg)
        permuted = solve(*permute_points(params, obs, cfg, perm))
        for tag, (cost, trips, secs) in (("as built", base),
                                         ("points permuted", permuted)):
            print(f"{name} M={M} P={P} T={T} on {dev.device_kind}, {tag}: "
                  f"final cost {cost:.6f}, {trips} LM trips, {secs:.3f} s "
                  "(compile included)", flush=True)
        print(f"{name}: rel diff {abs(permuted[0] - base[0]) / base[0]:.2e}",
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:] or ["line", "ring"])
