"""Device compute ops: SIFT, matching, two-view geometry, triangulation,
PnP, bundle adjustment, PatchMatch stereo, fusion, undistortion.

All ops are jittable with static shapes (padding + masks for variable-length
data) and batch via vmap/shard_map. Hot paths are shaped as batched dense
matmuls and elementwise work that XLA compiles for the card; there are no
hand-written kernels.
"""
