"""Halo exchange over the ordered-image axis.

The reference's neighborhood computation is Scanner stencils: row i reads
rows [i, i+overlap) (feature_matching.py:43, incremental_mapping.py:61,
patch_match.py:92). When the ordered axis is sharded across devices, a
window near a shard's end needs the first `halo` rows of the NEXT shard —
a ring ppermute between devices (SURVEY §5 long-context entry).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map


def ring_halo_append(x: jax.Array, halo: int, axis_name: str) -> jax.Array:
    """INSIDE shard_map: append the next shard's first `halo` rows.

    x: (n_local, ...) this shard's rows of the globally-ordered axis.
    Returns (n_local + halo, ...). The last shard receives the first
    shard's rows (ring); callers mask them out via global indices.
    """
    if halo > x.shape[0]:
        raise ValueError(
            f"halo {halo} exceeds local shard rows {x.shape[0]}; use fewer "
            f"shards or a smaller window")
    n = jax.lax.psum(1, axis_name)
    perm = [(i, (i - 1) % n) for i in range(n)]  # send my head to my LEFT neighbor
    head = x[:halo]
    recv = jax.lax.ppermute(head, axis_name, perm)
    return jnp.concatenate([x, recv], axis=0)


def windowed_gather(mesh: Mesh, x, halo: int, axis_name: str = "data"):
    """OUTSIDE jit: shard x (N, ...) rows over the mesh and return a
    per-shard array with the halo appended: (num_shards, n_local+halo, ...).

    Convenience wrapper used by the distributed matching stage; the real
    pipelines call ring_halo_append inside their own shard_map bodies so
    the exchange fuses with compute.
    """
    f = shard_map(
        lambda s: ring_halo_append(s, halo, axis_name)[None],
        mesh=mesh,
        in_specs=P(axis_name),
        out_specs=P(axis_name),
    )
    return f(x)
