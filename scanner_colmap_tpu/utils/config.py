"""Layered configuration: one dataclass tree, CLI-overridable, JSON-serializable.

Replaces the reference's three config tiers (argparse flags per driver,
protobuf op-args, hardcoded COLMAP defaults — SURVEY §5) with a single
pipeline → stage → kernel dataclass hierarchy. Defaults mirror the reference's
effective values, cited per field.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional


def _field(**kw):
    return dataclasses.field(default_factory=lambda: kw)


@dataclasses.dataclass
class SiftConfig:
    """SIFT extraction (reference defaults: extraction_op.cc:95-100 uses stock
    colmap SiftExtractionOptions; max_image_size via proto/CLI)."""
    max_image_size: int = 1024          # reference README step 2 suggests downscale
    max_num_features: int = 2048        # padded keypoint capacity per image
    num_octaves: int = 4
    scales_per_octave: int = 3
    first_octave: int = 0               # COLMAP uses -1 (upsample); 0 is cheaper
    peak_threshold: float = 0.0067      # 0.02/3 like COLMAP
    edge_threshold: float = 10.0
    init_sigma: float = 1.6
    upright: bool = False


@dataclasses.dataclass
class MatchingConfig:
    """Descriptor matching + two-view geometry (colmap.proto:6-65 defaults)."""
    overlap: int = 10                   # SequentialMatchingArgs.overlap=10 (colmap.proto:59)
    quadratic_overlap: bool = False     # colmap.proto:61-65 (unused flag in ref)
    max_ratio: float = 0.8              # colmap.proto:8
    max_distance: float = 0.7           # colmap.proto:11
    cross_check: bool = True            # colmap.proto:14
    max_num_matches: int = 1024         # capacity (ref: 32768, colmap.proto:17)
    max_error: float = 4.0              # RANSAC inlier threshold px (colmap.proto:20)
    confidence: float = 0.999           # colmap.proto:23
    min_num_trials: int = 30            # colmap.proto:26
    max_num_trials: int = 1000          # static RANSAC batch (ref 10000, colmap.proto:29)
    min_inlier_ratio: float = 0.25      # colmap.proto:32
    min_num_inliers: int = 15           # colmap.proto:35
    multiple_models: bool = False       # colmap.proto:38
    guided_matching: bool = False       # colmap.proto:41
    detect_watermark: bool = True       # COLMAP TwoViewGeometry::Options
                                        # .detect_watermark (config enum 7)
    # similarity-matmul precision: "bf16" = bf16 operands with f32
    # accumulation (the tensor cores' bf16 rate; quantization comparable to
    # COLMAP's raw uint8 descriptors); "f32" = f32 operands
    precision: str = "bf16"
    # descriptor-bank residency (the packetized-stencil analog of the
    # reference's io/work_packet_size, feature_matching.py:70-74): only a
    # window of [bank_images + overlap] images' descriptors is device-
    # resident at a time, so matching memory is O(bank) not O(collection).
    # 0 = auto-size the bank to ~256 MB of descriptors.
    bank_images: int = 0
    # Execution plan: "auto" keeps the whole collection's descriptors
    # device-resident — uploaded ONCE as uint8 and normalized to a bf16
    # pool on device — whenever pool + normalized copy fit
    # resident_pool_mb; else it streams banks (10k images: ~11 GB of f32
    # per-bank re-upload vs a 2.6 GB one-time u8 pool).
    # Both plans produce the identical matching table (same similarity
    # operands and reduction formulation).
    execution: str = "auto"             # auto | resident | banked
    resident_pool_mb: int = 6144
    # pairs per device dispatch in the resident plan
    resident_pair_chunk: int = 512
    # geometric-verification batch: pairs per device dispatch (bounds the
    # padded keypoint buffers at large pair counts)
    verify_batch_pairs: int = 1024
    # ---- loop closure (EXCEEDS the reference: loop detection is marked
    # unsupported there, colmap.proto:56-57). Candidates come from
    # pooled-SIFT global-descriptor similarity (top-k non-window pairs per
    # image); they are verified by the SAME RANSAC gate as window pairs,
    # so false candidates cost only a verification slot. Loop edges enter
    # the correspondence graph and the post-merge full-graph refinement,
    # which is where they remove the drift the windowed pipeline cannot
    # observe (PERFORMANCE.md Known bounds).
    # True/"on" = always, False/"off" = never, "auto" (default) = a cheap
    # BoW self-similarity prepass decides: an image counts as a REVISIT
    # when its best non-window similarity reaches loop_auto_ratio x its
    # best window similarity (a straight pass scores far pairs well below
    # near pairs; a loop scores them comparably), and closure turns on
    # when >= loop_auto_min_frac of images are revisits. The prepass
    # reuses the candidate-retrieval embedding, so auto costs one blocked
    # (N, N) similarity sweep and nothing else when it stays off.
    loop_closure: object = "auto"
    loop_top_k: int = 3                 # candidate partners per image
    loop_min_separation: int = 0        # 0 = auto (2 * overlap)
    loop_min_similarity: float = 0.0    # 0 = rank-only candidate gate
    loop_auto_ratio: float = 0.85       # revisit: s_far >= ratio * s_near
    # Auto-prepass budgeting (round-5, VERDICT r4 #2): the auto decision
    # first runs the revisit signal on an evenly spaced
    # <= loop_probe_images subset, on a host thread OVERLAPPED with the
    # device-bound window matching — near-zero wall cost. A clear
    # "no revisit" probe verdict skips the full prepass entirely; when
    # the collection is no larger than the probe, the probe IS the full
    # signal and its embedding is reused for candidate retrieval.
    # Explicit loop_closure=True always runs the full prepass.
    loop_probe_images: int = 64
    loop_auto_min_frac: float = 0.08    # auto-on when revisit fraction >=
    loop_auto_min_coherence: float = 0.4  # and the top-partner map must be
                                        # locally smooth over ratio-passing
                                        # rows (|b(a+1)-b(a)| <= 4): true
                                        # revisits track the mirror leg
                                        # (measured 0.96); appearance
                                        # aliasing at collection scale
                                        # scatters (0.02 on a straight 10k
                                        # repetitive-texture pass)


@dataclasses.dataclass
class MapperConfig:
    """Incremental mapping (reference: stock IncrementalMapperOptions,
    incremental_mapping.cc:283, + cluster semantics from
    incremental_mapping.py:57-87)."""
    cluster_size: int = 20
    cluster_overlap: int = 5
    single_camera: bool = False         # share ONE camera across all images
                                        # (COLMAP single_camera; conditions
                                        # intrinsics far better when the
                                        # collection is one physical camera)
    init_min_num_inliers: int = 50     # min TVG inliers for the initial pair
    init_min_tri_angle_deg: float = 4.0
    abs_pose_max_error: float = 12.0    # COLMAP abs_pose_max_error (px)
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    min_tri_angle_deg: float = 1.5      # triangulation filter
    filter_max_reproj_error: float = 4.0
    max_reg_trials: int = 3
    cluster_workers: int = 8            # concurrent cluster control planes
                                        # (threads overlap per-solve
                                        # latency; numpy releases the GIL)
                                        # (device compute still serializes;
                                        # this overlaps host<->device latency)
    # intrinsic-prior strength in BA (pulls focal to its init and k1 to 0;
    # breaks the per-image focal/depth near-degeneracy on weak-parallax data)
    intr_prior_weight_f: float = 300.0
    intr_prior_weight_k: float = 30000.0  # strong zero-prior on k1: free
                                          # distortion refinement on flat /
                                          # low-parallax scenes excites the
                                          # DOMING mode (model bends, k1
                                          # compensates; reproj + ATE stay
                                          # good while 3D points leave the
                                          # true surface — measured 2.8x
                                          # worse dense surface error)
    # Registrations folded into ONE local-BA round. COLMAP refines after
    # every single registration; where each BA solve costs a host round
    # trip, batching K registrations (PnP + triangulation are robust
    # to the short refinement delay) before one joint local BA over the
    # union window cuts the mapper's dominant latency ~K-fold. 1 = exact
    # COLMAP schedule.
    register_batch_size: int = 4
    # per-cluster failure tolerance in device mode: a cluster the
    # single-program mapper registers below this fraction of its members
    # retries on the host mapper's exact COLMAP schedule
    device_fallback_min_frac: float = 0.6
    # BA schedule (incremental_mapping.cc:86-139, 339-350)
    ba_local_max_num_iterations: int = 25
    ba_local_max_refinements: int = 2
    ba_local_max_refinement_change: float = 0.001
    ba_global_max_num_iterations: int = 50
    # dense-Schur camera-count bound: global solves over more images than
    # this run the matrix-free CG path (ops/ba._lm_trial_cg) instead of
    # factorizing the (M*8)^2 reduced system
    ba_dense_max_images: int = 256
    # CG iteration cap per LM trial on the matrix-free path. At the
    # merged-2k shape (M=2048/P=131k/T=12) caps of 32 and 16 ended the
    # 25-iter solve within 0.9%/1.9% of the 64-cap final cost — the classic
    # inexact-Newton tradeoff; LM re-solves every iteration, so looser
    # steps cost accuracy ~nothing. CG also early-exits at tol 1e-4, so
    # this only bites on hard systems. Per-iteration times on the GPU are
    # not measured yet.
    ba_cg_iters: int = 32
    ba_global_max_refinements: int = 5
    ba_global_max_refinement_change: float = 0.0005
    ba_global_images_ratio: float = 1.1
    ba_global_points_ratio: float = 1.1
    ba_global_images_freq: int = 500
    ba_global_points_freq: int = 250000
    # capacities (padding) for the jitted solves
    max_images: int = 64
    max_points: int = 32768
    max_obs_per_image: int = 2048
    # mapper execution mode:
    #   "host"   — COLMAP-faithful host control loop, one device solve per
    #              refinement round (engine/incremental.py)
    #   "device" — whole-cluster single-program mapper: precomputed track
    #              structure + registration schedule, lax control flow,
    #              exactly ONE round trip per cluster (ops/device_mapper.py)
    # DEFAULT = device: it was the faster mode on the previous accelerator,
    # with ATE inside the host mapper's seed band; its speed on the GPU is
    # not measured yet. Set "host" for the exact COLMAP refinement
    # schedule.
    mode: str = "device"
    device_ba_iters_per_step: int = 8   # LM trips after each registration
    device_final_ba_iters: int = 60     # LM trips per final global round
    device_max_track: int = 16          # CAP on obs slots per track; the
                                        # effective T is min(cluster size,
                                        # cap) — truncating tracks below the
                                        # cluster span measurably hurts both
                                        # registration and ATE
    device_max_points: int = 8192       # track capacity per cluster
    device_schedule: str = "visible_points"  # static registration order:
                                        # "visible_points" unrolls COLMAP's
                                        # visible-triangulated-points ranking
                                        # against the track structure;
                                        # "connectivity" = raw pair-inlier
                                        # greedy (the round-2 schedule)
    device_pnp_trials: int = 256
    device_batch_size: int = 8          # clusters per vmapped batch chunk
                                        # (map_clusters_device_batch): the
                                        # vmapped solver's per-lane working
                                        # set multiplies (32 lanes at
                                        # P=2048 ran a device out of
                                        # memory); 8 bounds it
    device_batch_clusters: bool = False  # solve ALL clusters as ONE vmapped
                                        # program. Slower at 16 and 10k
                                        # images on the previous
                                        # accelerator (not measured on the
                                        # GPU yet): vmap lowers every
                                        # lax.cond to select, so the
                                        # skip-converged-BA and
                                        # skip-inactive-step branches all
                                        # execute for every lane. Async
                                        # per-cluster dispatch already
                                        # pipelines clusters on device; keep
                                        # this for sharding lanes across
                                        # devices, not for one-device speed.


@dataclasses.dataclass
class MergeConfig:
    """Submodel merging (merge_mapping.cc:17,61: kMaxReprojError=64)."""
    max_reproj_error: float = 64.0
    min_common_images: int = 2
    final_ba: bool = True               # global BA on the merged model
                                        # (the reference ships the raw
                                        # concatenation; drift accumulates
                                        # over many submodels without this)
    final_ba_iterations: int = 50
    # full COLMAP IterativeGlobalRefinement on the merged model using the
    # complete correspondence graph: retriangulation creates CROSS-CLUSTER
    # tracks (constraints the per-cluster solves never saw), then
    # BA + complete/merge tracks + filter iterate. Falls back to the single
    # global BA when the matching table is unavailable.
    iterative_refine: bool = True
    # dense-Schur bound for the merged-model solve: beyond this many
    # registered images the reduced camera system (O(M^2) memory, O(P*M^2)
    # accumulation FLOPs) outgrows a dense factorization, and the final BA
    # switches to the matrix-free preconditioned-CG Schur path
    # (ops/ba._lm_trial_cg) — large merged models are refined, not skipped
    final_ba_max_images: int = 256
    # when the graph carries loop edges (far outside the matching window),
    # run ONE refinement round with reprojection gates/robust loss loosened
    # by this factor first, so drifted cross-loop tracks survive long
    # enough for the BA to pull the loop together (engine/merge.py)
    loop_refine_gate_factor: float = 3.0


@dataclasses.dataclass
class PatchMatchConfig:
    """PatchMatch stereo (reference options patch_match.cc:74-102)."""
    overlap: int = 5                    # ref CLI default 10 source views
    window_radius: int = 5
    num_iterations: int = 7             # Jacobi propagation moves 1-3 px per
                                        # sweep; 7 sweeps of the nearest-tap
                                        # field sampler beat 5 bilinear ones
                                        # on both density and wall time
    sampling: str = "field"             # "field": gradient-corrected field
                                        # warp, 1 gather/candidate; "exact": COLMAP's
                                        # per-offset slanted-window gathers
    num_samples: int = 15
    sigma_spatial: float = 5.0
    sigma_color: float = 0.2
    depth_min_factor: float = 0.75      # widen sparse depth range like COLMAP
    depth_max_factor: float = 1.25
    max_image_size: int = 400
    geom_consistency: bool = False      # ref disables (patch_match.cc:84);
                                        # ON = COLMAP's second pass with
                                        # forward-backward depth consistency
    geom_weight: float = 0.3            # COLMAP geom_consistency_regularizer
    max_geom_error: float = 3.0         # COLMAP geom_consistency_max_cost (px)
    filter_min_ncc: float = 0.1
    # coarse-to-fine: solve at half resolution first (full iteration
    # budget — propagation reach doubles per sweep at half res), then
    # refine at full resolution from the upsampled field with
    # fine_iterations sweeps. On the previous accelerator this gave +77%
    # fused points at equal surface error (480px/8src) and was faster;
    # its speed on the GPU is not measured yet. Default ON.
    coarse_to_fine: bool = True
    fine_iterations: int = 3
    # reference-resolution memory plan: ref-image ROW BANDS with an
    # overlap halo (ops/patch_match.patch_match_tiled) — the per-pixel
    # working set scales with the band while source images stay whole.
    # 0 = auto: tile only when the canvas exceeds tile_auto_px pixels
    # (bands of tile_auto_rows); negative = never tile
    tile_rows: int = 0
    tile_halo: int = 48                 # >= propagation reach (3 px/sweep)
    tile_auto_px: int = 1_200_000       # ~1280x960; below this, untiled
    tile_auto_rows: int = 384


@dataclasses.dataclass
class FusionConfig:
    """Stereo fusion (semantics from COLMAP StereoFusion, which the reference's
    broken stereo_fusion.cc:40 cites as its source)."""
    min_num_consistent: int = 2         # COLMAP check_num_images default 50 is for BFS; voting needs >=2
    max_reproj_error: float = 2.0
    max_depth_error: float = 0.01       # relative
    max_normal_error_deg: float = 10.0
    # voting window along the ordered view axis (COLMAP bounds fusion work
    # the same way via overlap sets + max_traversal_depth,
    # stereo_fusion.cc:210-240). Memory is O(N*H*W*window) instead of
    # O(N*H*W*N). 0 = auto (2x the PatchMatch source window); -1 = all-pairs.
    window: int = 0


@dataclasses.dataclass
class MeshingConfig:
    """Surface meshing (the reference's step 8, never shipped: "coming
    soon" README.md:69, poisson_recon linked but unused CMakeLists.txt:91).
    TSDF fusion + marching tetrahedra — ops/meshing.py."""
    resolution: int = 128               # cells along the longest grid axis
    trunc_voxels: float = 3.0           # truncation band, in voxels
    min_weight: float = 1.0             # min supporting views per grid point
    margin_voxels: int = 4              # grid padding around the point bounds
    bounds_percentile: float = 1.0      # robust point-cloud bounds (1/99)


@dataclasses.dataclass
class ParallelConfig:
    """Device mesh + packetization (replaces io/work_packet_size)."""
    batch_size: int = 8                 # images per device step (≈ work_packet_size)
    mesh_axes: tuple = ("data",)
    num_devices: int = 0                # 0 = all available
    # bounded dispatch-ahead window for pipelined stages (extraction,
    # PatchMatch): enough to overlap host prep / device compute / downloads,
    # without queueing hundreds of in-flight executions (unbounded dispatch
    # wedged 250-batch runs)
    inflight_batches: int = 8


@dataclasses.dataclass
class PipelineConfig:
    image_path: str = ""
    store_path: str = "artifacts"
    sift: SiftConfig = dataclasses.field(default_factory=SiftConfig)
    matching: MatchingConfig = dataclasses.field(default_factory=MatchingConfig)
    mapper: MapperConfig = dataclasses.field(default_factory=MapperConfig)
    merge: MergeConfig = dataclasses.field(default_factory=MergeConfig)
    patch_match: PatchMatchConfig = dataclasses.field(default_factory=PatchMatchConfig)
    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    meshing: MeshingConfig = dataclasses.field(default_factory=MeshingConfig)
    parallel: ParallelConfig = dataclasses.field(default_factory=ParallelConfig)

    # ---- (de)serialization ------------------------------------------------
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "PipelineConfig":
        cfg = cls()
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            cur = getattr(cfg, f.name)
            if dataclasses.is_dataclass(cur) and isinstance(v, dict):
                for k, vv in v.items():
                    if hasattr(cur, k):
                        setattr(cur, k, tuple(vv) if isinstance(getattr(cur, k), tuple) else vv)
            else:
                setattr(cfg, f.name, v)
        return cfg

    @classmethod
    def from_json(cls, s: str) -> "PipelineConfig":
        return cls.from_dict(json.loads(s))

    def apply_overrides(self, overrides: dict) -> "PipelineConfig":
        """Apply dotted-key overrides, e.g. {"matching.overlap": 5}."""
        for key, val in overrides.items():
            obj = self
            parts = key.split(".")
            for p in parts[:-1]:
                obj = getattr(obj, p)
            cur = getattr(obj, parts[-1])
            if cur is not None and not isinstance(cur, (dict, tuple, list)):
                val = type(cur)(val)
            setattr(obj, parts[-1], val)
        return self
