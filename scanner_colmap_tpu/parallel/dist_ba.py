"""Distributed Schur-complement bundle adjustment over a device mesh.

The north-star kernel: LANDMARKS (points + their
observations) shard across devices; CAMERA parameters are small and
replicated. Each LM iteration:

  1. every shard evaluates residuals/Jacobians for ITS points (dense
     batched elementwise and matmul work — ops/ba.py)
  2. the reduced camera system (U, g_c, S_pt, rhs_pt) psum-reduces across
     the devices — a few MB regardless of point count
  3. every shard solves the identical few-hundred-square dense system
     (replicated compute beats broadcasting the factorization)
  4. point back-substitution is embarrassingly local per shard

This matches the reference's delegation of BA to Ceres/ParallelBA
(incremental_mapping.cc:76-83) in capability, scaled across devices instead
of CPU threads.
"""

from __future__ import annotations

import functools

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from scanner_colmap_tpu.ops import ba
from scanner_colmap_tpu.parallel.mesh import DATA_AXIS


def distributed_bundle_adjust(
    mesh: Mesh,
    params: ba.BundleParams,
    obs: ba.BundleObs,
    cfg: ba.BundleConfig,
    max_iterations: int = 25,
    chunk: int = 1024,
    axis_name: str = DATA_AXIS,
    **kw,
):
    """bundle_adjust with points sharded over mesh[axis_name].

    params.xyz, obs.*, cfg.pt_valid shard on axis 0; everything else is
    replicated. P must divide by the mesh axis size (pad invalid points).
    """
    n_shards = mesh.shape[axis_name]
    P_total = params.xyz.shape[0]
    if P_total % (n_shards * chunk) != 0:
        raise ValueError(
            f"points {P_total} must divide by shards*chunk = {n_shards * chunk}")

    params_spec = ba.BundleParams(
        qvec=P(), tvec=P(), log_f=P(), k1=P(), xyz=P(axis_name))
    obs_spec = ba.BundleObs(cam_idx=P(axis_name), uv=P(axis_name),
                            valid=P(axis_name))
    cfg_spec = ba.BundleConfig(
        cc=P(), cam_valid=P(), pose_free=P(), pt_valid=P(axis_name),
        refine_focal=P(), refine_distortion=P(), loss_scale=P(),
        prior_log_f=P(), prior_k1=P(), prior_weight_f=P(), prior_weight_k=P(),
        # replicated shared-camera tie vector; None must stay None so the
        # spec pytree matches an untied config's structure
        cam_group=(P() if cfg.cam_group is not None else None))
    info_spec = {"initial_cost": P(), "final_cost": P(), "iterations": P(),
                 "mean_reproj_px": P(), "num_obs": P(), "final_lambda": P()}

    def body(p, o, c):
        return ba.bundle_adjust(
            p, o, c, max_iterations=max_iterations, chunk=chunk,
            axis_name=axis_name, **kw)

    fn = shard_map(
        body, mesh=mesh,
        in_specs=(params_spec, obs_spec, cfg_spec),
        out_specs=(params_spec, info_spec),
        check_vma=False,
    )
    return jax.jit(fn)(params, obs, cfg)
