"""Break BA calls down by call site + dissect one call's latency."""
import os, sys, time, tempfile, collections, traceback
import numpy as np
import jax
from scanner_colmap_tpu.pipeline import stages, synth
from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache
from scanner_colmap_tpu.utils.config import PipelineConfig
from scanner_colmap_tpu.utils.store import ArtifactStore

enable_compile_cache()
num_images = 16
workdir = tempfile.mkdtemp(prefix="sct_prof_")
image_dir = os.path.join(workdir, "images")
gt = synth.generate_dataset(image_dir, num_images=num_images,
                            width=480, height=360, num_blobs=500, seed=3)
cfg = PipelineConfig()
cfg.image_path = image_dir
cfg.store_path = os.path.join(workdir, "store")
cfg.sift.max_image_size = 480
cfg.sift.max_num_features = 1024
cfg.sift.num_octaves = 3
cfg.matching.overlap = 6
cfg.matching.min_num_inliers = 12
cfg.mapper.cluster_size = 12
cfg.mapper.cluster_overlap = 4
cfg.mapper.init_min_num_inliers = 20
cfg.mapper.abs_pose_min_num_inliers = 12
cfg.mapper.single_camera = True

store = ArtifactStore(cfg.store_path)
stages.prepare_images(cfg, store)
stages.run_extraction(cfg, store)
stages.run_matching(cfg, store)

stats = collections.defaultdict(lambda: [0, 0.0])
shapes = collections.Counter()
from scanner_colmap_tpu.ops import ba
orig = ba.bundle_adjust_flat_segmented
def wrapped(cam_in, pt_in, obs_in, scal_in, **k):
    caller = traceback.extract_stack(limit=4)
    names = [f.name for f in caller[:-1]]
    tag = "other"
    for n in ("local_bundle_adjustment", "global_bundle_adjustment",
              "register_initial_pair", "global_refine", "reconstruct"):
        if n in names:
            tag = n
            break
    t0 = time.monotonic()
    r = orig(cam_in, pt_in, obs_in, scal_in, **k)
    dt = time.monotonic() - t0
    s = stats[tag]; s[0] += 1; s[1] += dt
    shapes[(cam_in.shape, pt_in.shape, obs_in.shape,
            k.get("max_iterations"))] += 1
    return r
ba.bundle_adjust_flat_segmented = wrapped

t0 = time.time(); stages.run_mapping(cfg, store); warm = time.time() - t0
stats.clear(); shapes.clear()
t0 = time.time(); stages.run_mapping(cfg, store); t_map = time.time() - t0
t0 = time.time(); model = stages.run_merge(cfg, store); t_merge = time.time() - t0
print(f"mapping={t_map:.2f}s merge={t_merge:.2f}s")
for k2, (n, t) in sorted(stats.items(), key=lambda kv: -kv[1][1]):
    print(f"  {k2:28s} n={n:4d} total={t:7.2f}s mean={1000*t/max(n,1):7.1f}ms")
print("shapes:")
for s, n in shapes.most_common():
    print(f"  n={n:3d}  cam={s[0]} pt={s[1]} obs={s[2]} iters={s[3]}")
