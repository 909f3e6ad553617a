"""scanner_colmap_tpu — a JAX Structure-from-Motion / Multi-View-Stereo framework.

A from-scratch re-design of the capabilities of ``garyjyzhang/scanner-colmap``
(an 8-stage COLMAP-on-Scanner dataflow pipeline) for accelerators, run on
NVIDIA GPUs:

- compute path: JAX / XLA, jitted with static shapes, batched into dense
  matmuls and elementwise work
- scale-out: ``jax.sharding`` meshes + shard_map collectives across the
  cards of a host, and one process per card across hosts (not a
  Scanner-style gRPC worker pool)
- storage: a typed columnar artifact store (stage tables, like Scanner's table
  store) plus COLMAP-binary interchange for evaluation

Pipeline stages (mirroring the reference's 8 scripts, see README):
  1. prepare_images   — ingest + decode + id assignment
  2. extraction       — SIFT keypoints/descriptors + EXIF camera init
  3. feature_matching — overlap-window descriptor matching + two-view geometry
  4. incremental_mapping — clustered incremental SfM with bundle adjustment
  5. merge_mapping    — Sim(3) submodel merge (tree reduction)
  6. prepare_patch_match — per-registered-image MVS geometry
  7. patch_match      — PatchMatch depth/normal estimation
  8. stereo_fusion    — multi-view consistent depth fusion -> colored point cloud
"""

__version__ = "0.1.0"
