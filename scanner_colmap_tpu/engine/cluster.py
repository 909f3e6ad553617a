"""Cluster scheduling for scalable mapping: overlapping key-image clusters,
independent per-cluster reconstruction, then Sim(3) merge.

Rebuilds the reference's clustered mapping semantics
(/root/reference/integration/incremental_mapping.py:57-87 +
incremental_mapping.cc:268-373): images are ordered; each cluster covers
``cluster_size`` consecutive images and shares ``cluster_overlap`` images
with its neighbor (step = cluster_size − cluster_overlap) so that submodels
can be aligned for merging (README.md:49). The reference realizes this with
Scanner stencils + stride-sampled lazy rows; here it is an explicit index
schedule, and clusters are independent work units that shard across hosts /
run sequentially on one (SURVEY §2.2 parallelism #3).
"""

from __future__ import annotations

import logging
from typing import Dict, List, Optional, Sequence

import numpy as np

from scanner_colmap_tpu.engine.correspondence import CorrespondenceGraph, make_graph
from scanner_colmap_tpu.engine.incremental import IncrementalMapper
from scanner_colmap_tpu.engine.merge import merge_all
from scanner_colmap_tpu.models.reconstruction import Reconstruction
from scanner_colmap_tpu.utils.config import MapperConfig, MergeConfig

log = logging.getLogger(__name__)

# timing/FLOP accounting of the most recent device-mode run (filled by
# run_clustered_mapping; read by the mapping stage for its manifest meta)
LAST_MAPPING_STATS: dict = {}


def make_clusters(image_ids: Sequence[int], cluster_size: int,
                  cluster_overlap: int) -> List[List[int]]:
    """Overlapping windows over the ordered image list."""
    if cluster_overlap >= cluster_size:
        raise ValueError("cluster_overlap must be < cluster_size")
    ids = list(image_ids)
    step = cluster_size - cluster_overlap
    if len(ids) <= cluster_size:
        return [ids]
    clusters = []
    start = 0
    while start < len(ids):
        c = ids[start:start + cluster_size]
        if len(c) >= 2:
            clusters.append(c)
        elif clusters:
            # a 1-image tail cannot seed a reconstruction; fold it into the
            # final cluster (one over target size) instead of dropping it —
            # with cluster_overlap=0 the tail was silently never mapped
            clusters[-1] = clusters[-1] + c
        if start + cluster_size >= len(ids):
            break
        start += step
    return clusters


def subgraph(graph: CorrespondenceGraph, two_view: Dict, members: Sequence[int]):
    """Restrict the correspondence graph + TVGs to a cluster's images."""
    mset = set(members)
    g = make_graph()
    for i in members:
        g.add_image(i, graph.num_keypoints(i))
    pm = getattr(graph, "pair_matches", None)
    sub_pm = {}
    for (i, j) in graph.pairs:
        if i in mset and j in mset:
            if pm is not None and (i, j) in pm:
                # per-pair match lists retained by the stage's graph build
                pairs = pm[(i, j)]
            else:
                # fallback: re-derive pairs from per-keypoint adjacency
                pairs = [(k1, k2)
                         for k1 in range(graph.num_keypoints(i))
                         for (jj, k2) in graph.correspondences(i, k1)
                         if jj == j]
            if len(pairs):
                pairs = np.asarray(pairs)
                g.add_matches(i, j, pairs)
                sub_pm[(i, j)] = pairs
    # carry the per-pair lists so downstream track building reads them
    # directly instead of re-deriving from per-keypoint adjacency (the
    # device mapper's build_tracks_packed was 150k native-graph calls
    # per cluster without this)
    g.pair_matches = sub_pm
    tv = {k: v for k, v in two_view.items() if k[0] in mset and k[1] in mset}
    return g, tv


def run_clustered_mapping(
    keypoints: Dict[int, np.ndarray],
    cameras: Dict,
    graph: CorrespondenceGraph,
    two_view: Dict,
    config: Optional[MapperConfig] = None,
    merge_config: Optional[MergeConfig] = None,
    merge: bool = True,
):
    """Cluster → reconstruct → (optionally) merge.

    Returns (final model or None, list of per-cluster submodels). Empty
    submodels are dropped (the role of the reference's
    remove_empty_reconstruction.py stage).
    """
    import time as _time

    cfg = config or MapperConfig()
    ids = sorted(keypoints.keys())
    clusters = make_clusters(ids, cfg.cluster_size, cfg.cluster_overlap)

    if cfg.mode == "device":
        from scanner_colmap_tpu.engine import device_cluster as dc
        from scanner_colmap_tpu.engine.device_cluster import (
            map_cluster_device, map_clusters_device_batch)

        dc.SHAPE_LOG.clear()
        t_start = _time.time()
        if cfg.device_batch_clusters and len(clusters) > 1:
            # clusters grouped by shape bucket, chunked, each chunk one
            # vmapped device program (engine/device_cluster.py)
            args = []
            for ci, members in enumerate(clusters):
                g, tv = subgraph(graph, two_view, members)
                args.append(({i: keypoints[i] for i in members},
                             {i: cameras[i] for i in members}, g, tv, ci))
            t_prep = _time.time() - t_start
            t0 = _time.time()
            recs = map_clusters_device_batch(args, cfg)
            t_await = _time.time() - t0
        else:
            # single-program-per-cluster mapper: dispatch every cluster's
            # device call first (async), then await — the clusters pipeline
            # on device with zero host round trips (ops/device_mapper.py)
            pending = []
            for ci, members in enumerate(clusters):
                g, tv = subgraph(graph, two_view, members)
                pending.append(map_cluster_device(
                    {i: keypoints[i] for i in members},
                    {i: cameras[i] for i in members}, g, tv, cfg, seed=ci,
                    block=False))
            t_prep = _time.time() - t_start
            t0 = _time.time()
            recs = [finish() for finish in pending]
            t_await = _time.time() - t0
        # utilization accounting: scheduled device FLOPs (upper bound —
        # converged LM trips cond-skip) over the stage's device window
        from scanner_colmap_tpu.utils import flops as _fl

        sched_fl = sum(_fl.device_mapper_flops(
            M, P, T, n, cfg.device_ba_iters_per_step,
            cfg.device_final_ba_iters, cfg.device_pnp_trials)
            for (M, P, T, n) in dc.SHAPE_LOG)
        global LAST_MAPPING_STATS
        LAST_MAPPING_STATS = {
            "prep_s": round(t_prep, 2), "await_s": round(t_await, 2),
            "n_clusters": len(clusters),
            "scheduled_tflop": round(sched_fl / 1e12, 3),
            "batched": bool(cfg.device_batch_clusters),
        }
        for ci, rec in enumerate(recs):
            log.info("cluster %d/%d (device): %d/%d images, %d points",
                     ci + 1, len(clusters), rec.num_registered,
                     len(clusters[ci]), len(rec.points3D))
        # failure tolerance (the per-unit tolerance the reference applies
        # per-image in PatchMatch, patch_match.cc:108-114, applied per
        # CLUSTER here): a cluster the single-program mapper under-registers
        # (its static registration schedule can miss an image the host
        # mapper's adaptive one finds) retries on the host mapper's exact
        # COLMAP schedule before the submodel is shipped. The retry count
        # lands in LAST_MAPPING_STATS["host_retries"].
        min_frac = getattr(cfg, "device_fallback_min_frac", 0.6)
        LAST_MAPPING_STATS["host_retries"] = 0
        for ci, rec in enumerate(recs):
            members = clusters[ci]
            if (len(members) >= 3
                    and rec.num_registered < min_frac * len(members)):
                LAST_MAPPING_STATS["host_retries"] += 1
                g, tv = subgraph(graph, two_view, members)
                host_rec = IncrementalMapper(
                    {i: keypoints[i] for i in members},
                    {i: cameras[i] for i in members}, g, tv, cfg,
                    seed=ci).reconstruct()
                if host_rec.num_registered > rec.num_registered:
                    log.warning(
                        "cluster %d/%d: device mapper registered %d/%d — "
                        "host retry registered %d, using it",
                        ci + 1, len(clusters), rec.num_registered,
                        len(members), host_rec.num_registered)
                    recs[ci] = host_rec
    else:
        def run_one(ci: int) -> Reconstruction:
            members = clusters[ci]
            g, tv = subgraph(graph, two_view, members)
            mapper = IncrementalMapper(
                {i: keypoints[i] for i in members},
                {i: cameras[i] for i in members}, g, tv, cfg, seed=ci)
            rec = mapper.reconstruct()
            log.info("cluster %d/%d: %d/%d images registered, %d points",
                     ci + 1, len(clusters), rec.num_registered, len(members),
                     len(rec.points3D))
            return rec

        # Clusters are independent work units (the reference ships them to
        # Scanner workers). Their control planes are host-side Python that
        # blocks on one small device solve at a time, so running several
        # threads overlaps round-trip latency; device compute serializes in
        # the runtime. Deterministic: results keyed by cluster index.
        workers = min(cfg.cluster_workers, len(clusters)) or 1
        if workers > 1 and len(clusters) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as pool:
                recs = list(pool.map(run_one, range(len(clusters))))
        else:
            recs = [run_one(ci) for ci in range(len(clusters))]
    submodels: List[Reconstruction] = [r for r in recs if r.num_registered >= 2]
    if not merge:
        return None, submodels
    model = merge_all(submodels, merge_config) if submodels else Reconstruction()
    return model, submodels
