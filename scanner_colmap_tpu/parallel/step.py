"""The fused multi-device SfM step: sharded windowed matching + distributed BA.

This is the framework's "training step" analog — the recurring heavy
iteration of a large-scale reconstruction: match new imagery against its
neighborhood and re-solve the bundle. Sharding layout (SURVEY §2.2):

- ordered-image axis shards over the `data` mesh axis (row/data parallelism);
  the match window crosses shard boundaries via a ring halo ppermute
  between devices (stencil/sequence parallelism)
- BA landmarks shard over the same axis; the reduced camera system
  psum-reduces across devices (the model-parallel analog for the map)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from scanner_colmap_tpu.ops import ba, matching
from scanner_colmap_tpu.parallel.halo import ring_halo_append
from scanner_colmap_tpu.parallel.mesh import DATA_AXIS


def make_distributed_step(mesh: Mesh, overlap: int, ba_iterations: int = 3,
                          chunk: int = 64, axis_name: str = DATA_AXIS):
    """Build the jitted multi-chip step.

    Returned fn signature:
      fn(desc (N, K, 128), kp_valid (N, K),
         params: BundleParams (points sharded), obs: BundleObs, cfg)
      -> (match_idx (N, overlap, K), match_ok (N, overlap, K),
          params', info)
    with N = images (sharded), K = padded keypoints per image.
    """

    def local_matching(desc, valid):
        # desc: (n_local, K, 128). Append halo so windows cross the boundary.
        d = ring_halo_append(desc, overlap, axis_name)
        v = ring_halo_append(valid, overlap, axis_name)
        n_local = desc.shape[0]

        def match_pivot(i):
            win_d = jax.lax.dynamic_slice_in_dim(d, i, overlap + 1, 0)
            win_v = jax.lax.dynamic_slice_in_dim(v, i, overlap + 1, 0)
            return matching.match_window(win_d, win_v)

        idx, ok = jax.lax.map(match_pivot, jnp.arange(n_local))
        return idx, ok

    params_spec = ba.BundleParams(
        qvec=P(), tvec=P(), log_f=P(), k1=P(), xyz=P(axis_name))
    obs_spec = ba.BundleObs(cam_idx=P(axis_name), uv=P(axis_name),
                            valid=P(axis_name))
    info_spec = {"initial_cost": P(), "final_cost": P(), "iterations": P(),
                 "mean_reproj_px": P(), "num_obs": P(), "final_lambda": P()}

    def step(desc, kp_valid, params, obs, cfg):
        idx, ok = local_matching(desc, kp_valid)
        p_out, info = ba.bundle_adjust(
            params, obs, cfg, max_iterations=ba_iterations, chunk=chunk,
            axis_name=axis_name)
        return idx, ok, p_out, info

    # The BundleConfig spec must mirror the config pytree exactly: a tied
    # (shared-camera) config carries cam_group as a replicated leaf, an
    # untied one carries None — build and cache one jitted step per shape.
    fns: dict[bool, object] = {}

    def _get(tied: bool):
        if tied not in fns:
            cfg_spec = ba.BundleConfig(
                cc=P(), cam_valid=P(), pose_free=P(), pt_valid=P(axis_name),
                refine_focal=P(), refine_distortion=P(), loss_scale=P(),
                prior_log_f=P(), prior_k1=P(), prior_weight_f=P(),
                prior_weight_k=P(),
                cam_group=(P() if tied else None))
            fns[tied] = jax.jit(shard_map(
                step, mesh=mesh,
                in_specs=(P(axis_name), P(axis_name), params_spec, obs_spec,
                          cfg_spec),
                out_specs=(P(axis_name), P(axis_name), params_spec, info_spec),
                check_vma=False,
            ))
        return fns[tied]

    def dispatch(desc, kp_valid, params, obs, cfg):
        return _get(cfg.cam_group is not None)(desc, kp_valid, params, obs, cfg)

    return dispatch
