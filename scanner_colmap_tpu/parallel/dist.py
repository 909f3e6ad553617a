"""Multi-process execution: process-group init + host-level work
partitioning for the cluster-parallel mapping stage.

Replaces the Scanner master/worker pool (gRPC, external — SURVEY §2.2
job scheduler) with the jax.distributed model: every host runs the same
program; cluster work units (key-image clusters, SURVEY §2.2 parallelism #3)
are assigned by host index; results rendezvous through the shared artifact
store (each host writes its own rows; host 0 merges), so no bespoke RPC
layer exists — the same crash-safe stage-table contract carries the
cross-host traffic.

Single-process fallback: with no coordinator configured this degrades to
one host owning all clusters, so the same code path serves laptop runs,
one multi-GPU host (one process per card), and a cluster of hosts.
"""

from __future__ import annotations

import logging
import os
import time
from typing import List, Optional, Sequence, TypeVar

log = logging.getLogger(__name__)

T = TypeVar("T")


def maybe_init_distributed(coordinator: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           local_device_ids: Optional[Sequence[int]] = None
                           ) -> bool:
    """Initialize jax.distributed when a coordinator is configured.

    Reads JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID when
    args are None. Returns True if multi-process mode is active.

    local_device_ids are the cards of this host that this process owns.
    With several processes on one multi-GPU host, give each its own card
    (e.g. [process_id]): left unset, every process sees every card and
    computes on the first one. A launcher outside Python can pin each
    process with CUDA_VISIBLE_DEVICES instead.
    """
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None else int(
        os.environ.get("JAX_PROCESS_ID", "0"))
    jax.distributed.initialize(coordinator, num_processes, process_id,
                               local_device_ids=local_device_ids)
    log.info("jax.distributed: process %d/%d via %s, local devices %s",
             process_id, num_processes, coordinator, local_device_ids)
    return True


def process_info():
    """(process_id, num_processes) — (0, 1) when not distributed."""
    import jax

    try:
        return jax.process_index(), jax.process_count()
    except RuntimeError:   # no backend could initialize
        return 0, 1


def partition_round_robin(items: Sequence[T], process_id: Optional[int] = None,
                          num_processes: Optional[int] = None) -> List[T]:
    """This host's share of a work list (deterministic round-robin, so
    adjacent clusters land on different hosts and merge trees stay local)."""
    pid, n = process_info()
    if process_id is not None:
        pid = process_id
    if num_processes is not None:
        n = num_processes
    return [x for i, x in enumerate(items) if i % n == pid]


def barrier_via_store(store, name: str, timeout_s: float = 3600.0,
                      poll_s: float = 2.0):
    """Cross-host rendezvous through the artifact store: every host writes a
    ready marker table row; all hosts wait until every marker exists.

    Environments without jax.distributed (shared filesystem only) still
    synchronize correctly; with jax.distributed active the same rendezvous
    works on any shared store path.
    """
    import numpy as np

    pid, n = process_info()
    store.write_table(f"{name}_ready_{pid}", {"pid": np.asarray([pid])},
                      meta={"barrier": name})
    t0 = time.time()
    while True:
        done = all(store.has_table(f"{name}_ready_{i}") for i in range(n))
        if done:
            return
        if time.time() - t0 > timeout_s:
            raise TimeoutError(f"barrier {name}: waited {timeout_s}s")
        time.sleep(poll_s)


def merge_shard_tables(store, shard_prefix: str, out_table: str,
                       sort_col: str, ragged_cols: Sequence[str] = (),
                       stacked_cols: Sequence[str] = (), meta=None):
    """Host-0 concatenation of per-host shard tables into the canonical
    stage table, ordered by an integer key column (the shared tail of every
    *_distributed stage). ragged_cols stay lists of per-row arrays;
    stacked_cols become one (N, ...) array (empty-safe)."""
    import numpy as np

    _, n = process_info()
    keys = []
    cols = {c: [] for c in list(ragged_cols) + list(stacked_cols)}
    for i in range(n):
        t = store.read_table(f"{shard_prefix}_{i}")
        keys.extend(int(x) for x in t[sort_col])
        for c in cols:
            cols[c].extend(t[c])  # keep store-native row types (arrays/bytes)
    order = np.argsort(keys)
    out = {sort_col: np.asarray(keys, np.int64)[order]}
    for c in ragged_cols:
        out[c] = [cols[c][i] for i in order]
    for c in stacked_cols:
        out[c] = (np.stack([cols[c][i] for i in order]) if len(order)
                  else np.zeros((0,)))
    store.write_table(out_table, out, meta=dict(meta or {}, num_hosts=n))


def run_matching_distributed(cfg, store=None):
    """Multi-host variant of the matching stage: each host matches its
    round-robin slice of the PAIR SCHEDULE (the 10k-image partitioned
    matching configuration, BASELINE.md) and writes `matching_shard_<pid>`;
    host 0 concatenates shards into the canonical `matching` table."""
    import numpy as np

    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils.store import ArtifactStore

    store = store or ArtifactStore(cfg.store_path)
    pid, n = process_info()
    stages.run_matching(cfg, store, schedule_slice=(pid, n),
                        out_table=f"matching_shard_{pid}")
    barrier_via_store(store, "matching_done")
    if pid == 0:
        merged = {"pair_image_ids": [], "two_view_geometry": [], "matches": []}
        for i in range(n):
            t = store.read_table(f"matching_shard_{i}")
            pids_ = np.asarray(t["pair_image_ids"]).reshape(-1, 2)
            for r in range(len(pids_)):
                merged["pair_image_ids"].append(pids_[r])
                merged["two_view_geometry"].append(
                    np.asarray(t["two_view_geometry"][r]))
                merged["matches"].append(np.asarray(t["matches"][r]))
        # deterministic order: sort rows by (id1, id2)
        order = sorted(range(len(merged["pair_image_ids"])),
                       key=lambda r: tuple(merged["pair_image_ids"][r]))
        store.write_table("matching", {
            "pair_image_ids": (np.stack([merged["pair_image_ids"][r]
                                         for r in order])
                               if order else np.zeros((0, 2), np.int64)),
            "two_view_geometry": (np.stack([merged["two_view_geometry"][r]
                                            for r in order])
                                  if order else np.zeros((0, 37))),
            "matches": [merged["matches"][r] for r in order],
        }, meta={"stage": "matching", "num_hosts": n})
    barrier_via_store(store, "matching_merged")
    return store.num_rows("matching") if pid == 0 else None


def run_mapping_distributed(cfg, store=None):
    """Multi-host variant of the mapping stage: each host reconstructs its
    round-robin share of clusters and writes `mapping_shard_<pid>`; host 0
    concatenates shards into the canonical `mapping` table after a barrier.
    """
    import numpy as np

    from scanner_colmap_tpu.engine.cluster import make_clusters, subgraph
    from scanner_colmap_tpu.engine.incremental import IncrementalMapper
    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils import colmap_io
    from scanner_colmap_tpu.utils.store import ArtifactStore

    store = store or ArtifactStore(cfg.store_path)
    pid, n = process_info()
    image_ids, kp, desc, cameras = stages._load_extraction(store)
    graph, two_view = stages._build_graph(store, kp)
    clusters = make_clusters(sorted(kp.keys()), cfg.mapper.cluster_size,
                             cfg.mapper.cluster_overlap)
    mine = partition_round_robin(list(enumerate(clusters)))

    rows = {"cluster_id": [], "cameras": [], "images": [], "points3d": []}
    for ci, members in mine:
        g, tv = subgraph(graph, two_view, members)
        mapper = IncrementalMapper({i: kp[i] for i in members},
                                   {i: cameras[i] for i in members},
                                   g, tv, cfg.mapper, seed=ci)
        rec = mapper.reconstruct()
        if rec.num_registered >= 2:
            cb, ib, pb = colmap_io.model_to_bytes(rec)
            rows["cluster_id"].append(ci)
            rows["cameras"].append(cb)
            rows["images"].append(ib)
            rows["points3d"].append(pb)
        log.info("host %d/%d: cluster %d -> %d images", pid, n, ci,
                 rec.num_registered)
    store.write_table(f"mapping_shard_{pid}", {
        "cluster_id": np.asarray(rows["cluster_id"], np.int64),
        "cameras": rows["cameras"],
        "images": rows["images"],
        "points3d": rows["points3d"],
    }, meta={"stage": "mapping", "host": pid})

    barrier_via_store(store, "mapping_done")
    if pid == 0:
        merge_shard_tables(store, "mapping_shard", "mapping", "cluster_id",
                           ragged_cols=("cameras", "images", "points3d"),
                           meta={"stage": "mapping"})
    barrier_via_store(store, "mapping_merged")
    return len(mine)


def run_extraction_distributed(cfg, store=None):
    """Multi-host variant of the extraction stage: each host extracts its
    round-robin share of frames into `extraction_shard_<pid>`; host 0
    concatenates shards (ordered by image_id) into `extraction`."""
    import numpy as np

    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils.store import ArtifactStore

    store = store or ArtifactStore(cfg.store_path)
    pid, n = process_info()
    stages.run_extraction(cfg, store, frame_slice=(pid, n),
                          out_table=f"extraction_shard_{pid}")
    barrier_via_store(store, "extraction_done")
    if pid == 0:
        merge_shard_tables(store, "extraction_shard", "extraction",
                           "image_id",
                           ragged_cols=("keypoints", "descriptors"),
                           stacked_cols=("camera",),
                           meta={"stage": "extraction"})
    barrier_via_store(store, "extraction_merged")
    return store.num_rows("extraction") if pid == 0 else None


def run_patch_match_distributed(cfg, store=None):
    """Multi-host variant of the PatchMatch stage: each host computes a
    CONTIGUOUS block of reference images (the block is halo-extended by the
    source-view window so the geometric-consistency pass finds its
    neighbors' pass-1 depth maps locally — recompute beats a cross-host
    depth-bank exchange at window sizes) and writes
    `patch_match_shard_<pid>`; host 0 concatenates shards."""
    import numpy as np

    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils.store import ArtifactStore

    store = store or ArtifactStore(cfg.store_path)
    pid, n = process_info()
    stages.run_patch_match(cfg, store, ref_slice=(pid, n),
                           out_table=f"patch_match_shard_{pid}")
    barrier_via_store(store, "patch_match_done")
    if pid == 0:
        merge_shard_tables(store, "patch_match_shard", "patch_match",
                           "image_id",
                           ragged_cols=("depth_map", "normal_map",
                                        "cost_map"),
                           meta={"stage": "patch_match"})
    barrier_via_store(store, "patch_match_merged")
    return store.num_rows("patch_match") if pid == 0 else None


def run_merge_distributed(cfg, store=None):
    """Multi-host merge: the tree-merge + full-graph refinement run on
    host 0 over the concatenated `mapping` table (the reference's merge is
    likewise a single batched kernel over all submodel rows,
    merge_mapping.cc:96 `.batch()`); other hosts wait on the store barrier
    so every process leaves the stage with `models` readable."""
    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils.store import ArtifactStore

    store = store or ArtifactStore(cfg.store_path)
    pid, n = process_info()
    model = None
    if pid == 0:
        model = stages.run_merge(cfg, store)
    barrier_via_store(store, "merge_done")
    if model is None:
        model = stages.load_model(store)
    return model
