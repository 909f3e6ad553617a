"""Scale-out layer: device meshes, halo exchange over the ordered-image
axis, distributed Schur-complement BA, multi-host helpers.

Replaces the Scanner runtime's roles (gRPC worker pool, packetized work
distribution, stencil materialization — SURVEY §2.2) with jax.sharding +
shard_map collectives across the devices of a host and jax.distributed
across hosts.
"""
