"""Benchmark driver: prints ONE JSON line with the headline metric.

Primary metric: sparse pipeline throughput (images registered per second)
on a synthetic collection, including SIFT + matching + two-view geometry +
clustered incremental mapping with BA. Secondary metrics (BA iter/s,
matching pairs/s, ATE, dense and scale sections) are included in the JSON
for the record. Every result names the device it ran on.

vs_baseline divides by a same-code CPU-host rate of 0.57 img/s at the
identical 16-image config, measured before the move to GPUs
(PERFORMANCE.md@0af5287, lever 32); vs_nominal_colmap_cpu divides by a
nominal COLMAP-CPU 0.5 img/s (the reference publishes no numbers,
SURVEY §6). Both are placeholders until the benchmark measures its own
baseline on the card.

Error bars: the headline sparse pass and the BA/dense timed sections each
run BENCH_TRIALS (default 3) times; the JSON reports the median plus
{min, max, n_trials} per metric. Every section runs: a failing section
fails the run with a non-zero exit.

Output contract: the FINAL stdout line is a <= 500-char compact headline;
the full result prints on the line above.
"""

import json
import os
import statistics
import sys
import tempfile
import time


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def main():
    import numpy as np
    import jax

    from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    num_images = int(os.environ.get("BENCH_NUM_IMAGES", "16"))
    t_bench0 = time.time()
    workdir = tempfile.mkdtemp(prefix="sct_bench_")
    image_dir = os.path.join(workdir, "images")
    log(f"devices: {jax.devices()}")
    log(f"rendering {num_images} synthetic images")
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
    cfg.mapper.single_camera = True   # one physical camera rendered the set
    cfg.mapper.mode = os.environ.get("BENCH_MAPPER_MODE", cfg.mapper.mode)

    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)

    # Each stage runs twice: the first pass pays jit compiles / cache
    # loads (one-time per process), the second pass times steady state —
    # the production number, since a deployment amortizes compiles across
    # thousands of images. Cold-pass times are reported in detail.
    n_trials = max(int(os.environ.get("BENCH_TRIALS", "3")), 1)
    cold = {}
    stage_trials = {}      # name -> [t_trial0, t_trial1, ...]
    timed = {}             # name -> median
    n_pairs = 0
    stage_list = [("extraction", stages.run_extraction),
                  ("matching", stages.run_matching),
                  ("mapping", stages.run_mapping),
                  ("merge", stages.run_merge)]
    for name, fn in stage_list:
        log(f"{name} (warmup)")
        t0 = time.time()
        out = fn(cfg, store)
        cold[name] = time.time() - t0
        # N timed passes (median reported): steady state is the
        # production number a deployment sees
        stage_trials[name] = []
        for rep in range(n_trials):
            log(f"{name} (timed {rep + 1}/{n_trials})")
            t0 = time.time()
            out = fn(cfg, store)
            stage_trials[name].append(time.time() - t0)
        timed[name] = statistics.median(stage_trials[name])
        if name == "matching":
            n_pairs = out
    model = out  # run_merge returns the merged model
    log(f"mapped {model.num_registered} images")

    n_reg = model.num_registered
    t_extract, t_match = timed["extraction"], timed["matching"]
    t_map = timed["mapping"] + timed["merge"]
    # per-trial end-to-end throughput (trial r = sum of each stage's r-th
    # timed pass) -> median + spread for the headline
    trial_tp = [n_reg / max(sum(stage_trials[n][r] for n, _ in stage_list),
                            1e-9)
                for r in range(n_trials)]
    images_per_s = statistics.median(trial_tp)
    headline_spread = {"median": round(images_per_s, 3),
                       "min": round(min(trial_tp), 3),
                       "max": round(max(trial_tp), 3),
                       "n_trials": n_trials}
    ate = synth.evaluate_ate(model, gt)

    # ---- utilization: achieved fraction of the card's bf16 matmul peak ----
    from scanner_colmap_tpu.utils import flops as flops_acct

    peak_tflops = flops_acct.device_peak_tflops(jax.devices()[0])
    match_meta = store.read_manifest("matching")["meta"]
    match_fl = flops_acct.matching_flops(match_meta["scheduled_pairs"],
                                         match_meta["k_max"])
    match_tflops = match_fl / max(t_match, 1e-9) / 1e12
    util = {
        "peak_bf16_tflops": peak_tflops,
        "matching_achieved_tflops": round(match_tflops, 3),
        "matching_frac_of_peak": (round(match_tflops / peak_tflops, 4)
                                  if peak_tflops else None),
    }

    # ---- BOTH mapper modes (the device-resident mapper against the host
    # loop; headline uses cfg.mapper.mode) ---------------------------------
    alt_mode = "device" if cfg.mapper.mode == "host" else "host"
    alt = {}
    if os.environ.get("BENCH_ALT_MAPPER", "1") != "0":
        log(f"mapping (mode={alt_mode}, warmup)")
        cfg.mapper.mode = alt_mode
        stages.run_mapping(cfg, store)
        t0 = time.time()
        stages.run_mapping(cfg, store)
        t_alt_map = time.time() - t0
        t0 = time.time()
        model_alt = stages.run_merge(cfg, store)
        t_alt_merge = time.time() - t0
        alt = {
            "mode": alt_mode,
            "mapping_s": round(t_alt_map + t_alt_merge, 2),
            "registered": int(model_alt.num_registered),
            "ate": round(float(synth.evaluate_ate(model_alt, gt)), 4),
        }
        log(f"alt mapper: {alt}")
        # restore headline tables (mapping/models) for the dense phase
        cfg.mapper.mode = "device" if alt_mode == "host" else "host"
        stages.run_mapping(cfg, store)
        model = stages.run_merge(cfg, store)

    # BA iterations/sec microbench on the flagship solve. Shapes chosen to
    # REUSE the jit signature the mapper already compiled (M=16 cameras,
    # P=1024 points, T=16 track slots, 25 iterations, chunk=1024) so this
    # costs no extra compile on a cold cache.
    log("BA microbench")
    from __graft_entry__ import _synthetic_bundle, ring_bundle
    from scanner_colmap_tpu.ops import ba

    params, obs, cfg_ba, _, _ = _synthetic_bundle(M=16, Pn=1024, T=16)
    # warmup pays the compile; the timed passes measure steady-state rate.
    # Sync via a scalar download (float(...)).
    p_out, info = ba.bundle_adjust(params, obs, cfg_ba, max_iterations=25,
                                   chunk=1024, function_tolerance=0.0)
    float(info["final_cost"])
    ba_trials = []
    for _ in range(n_trials):
        t0 = time.time()
        p_out, info = ba.bundle_adjust(params, obs, cfg_ba, max_iterations=25,
                                       chunk=1024, function_tolerance=0.0)
        float(info["final_cost"])
        ba_trials.append(int(info["iterations"]) / max(time.time() - t0, 1e-9))
    ba_iters_per_s = statistics.median(ba_trials)
    log(f"BA: {ba_iters_per_s:.2f} iters/s (trials {ba_trials})")
    # sustained device rate: an easy start converges in a few dozen
    # applied trips, so its rate is dominated by convergence-count drift
    # and per-call latency. A HARD fixed-perturbation start keeps the
    # applied-trip count stable; 4 calls pipelined per trial, one sync.
    import jax.numpy as jnp_
    rng_h = np.random.default_rng(9)
    params_h = params._replace(
        xyz=params.xyz + jnp_.asarray(
            rng_h.normal(size=params.xyz.shape) * 0.3, params.xyz.dtype),
        tvec=params.tvec + jnp_.asarray(
            rng_h.normal(size=params.tvec.shape) * 0.05, params.tvec.dtype))
    p_out, info = ba.bundle_adjust(params_h, obs, cfg_ba, max_iterations=512,
                                   chunk=1024, function_tolerance=0.0)
    float(info["final_cost"])
    n_applied = float(info["iterations"])
    sus_trials = []
    for _ in range(n_trials):
        t0 = time.time()
        infos = []
        for _ in range(4):   # pipelined: one sync for all four programs
            _, i_s = ba.bundle_adjust(params_h, obs, cfg_ba,
                                      max_iterations=512, chunk=1024,
                                      function_tolerance=0.0)
            infos.append(i_s)
        for i_s in infos:
            float(i_s["final_cost"])
        sus_trials.append(4 * n_applied / max(time.time() - t0, 1e-9))
    ba_sustained = statistics.median(sus_trials)
    ba_spread = {"median": round(ba_sustained, 1),
                 "min": round(min(sus_trials), 1),
                 "max": round(max(sus_trials), 1),
                 "n_trials": n_trials,
                 "applied_per_call": int(n_applied)}
    log(f"BA sustained: {ba_sustained:.0f} iters/s (trials "
        f"{[round(x) for x in sus_trials]})")
    ba_tflops = (flops_acct.ba_flops_per_iter(16, 1024, 16) * ba_sustained
                 / 1e12)
    util["ba_achieved_tflops"] = round(ba_tflops, 3)
    util["ba_frac_of_peak"] = (round(ba_tflops / peak_tflops, 4)
                               if peak_tflops else None)

    # Further sections (BA at scale / dense / real-texture / scale).
    # BENCH_BUDGET_S (default 2400) soft-caps total bench wall clock;
    # sections are skipped, and say so, once it is spent. A section that
    # fails fails the run.
    dense, real, scale, ba_scale = {}, {}, {}, {}
    _budget_s = float(os.environ.get("BENCH_BUDGET_S", "2400"))

    def _have_budget(name):
        if time.time() - t_bench0 > _budget_s - 120:
            log(f"skipping {name} section (bench time budget spent)")
            return False
        return True

    # ---- card-filling BA: the dense Schur path at M=256/P=49k is
    # matmul-bound — the Schur accumulation is a (MC, 3c)@(3c, MC) matmul
    # per chunk; the matrix-free CG path at M=1024 (the 1k-camera
    # global-refinement shape) is segment-sum/gather bound, so its ceiling
    # is HBM bandwidth + gather rate, not the matmul peak — both reported.
    if os.environ.get("BENCH_BA_SCALE", "1") != "0" \
            and _have_budget("ba_scale"):
        log("BA at scale (dense M=256/P=49k, CG M=1024/P=49k)")

        # ring_bundle, not _synthetic_bundle: at M=1024 the latter puts the
        # cameras on a 307-unit line past a 4-unit point cube, a problem on
        # which two shardings of one CG solve ended 1e-3 apart (PERF.md)
        def _ba_run(M, Pn, T, solver, chunk, cg_iters=32, iters=10):
            prm, ob, cf = ring_bundle(M, Pn, T)
            kw = dict(max_iterations=iters, chunk=chunk, solver=solver,
                      cg_iters=cg_iters, function_tolerance=0.0)
            p, nfo = ba.bundle_adjust(prm, ob, cf, **kw)
            float(nfo["final_cost"])            # warmup + sync
            t0 = time.time()
            p, nfo = ba.bundle_adjust(prm, ob, cf, **kw)
            n = float(nfo["iterations"])
            float(nfo["final_cost"])
            return max(time.time() - t0, 1e-9), n

        t_d, n_d = _ba_run(256, 49152, 4, "dense", 1024)
        fl_d = flops_acct.ba_flops_per_iter(256, 49152, 4)
        tf_d = fl_d * n_d / t_d / 1e12
        t_c, n_c = _ba_run(1024, 49152, 4, "cg", 49152)
        fl_c = flops_acct.ba_cg_flops_per_iter(1024, 49152, 4, 32)
        tf_c = fl_c * n_c / t_c / 1e12
        # CG roofline: bytes moved per LM iteration — the stacked CG
        # working set (Wc 96B + Vinv 36B + g_p 12B per point-slot)
        # re-read by every CG application plus the build pass
        bytes_ws = 49152 * (4 * 96.0 + 36.0 + 12.0)
        cg_gbs = (32 + 1) * bytes_ws * n_c / t_c / 1e9
        ba_scale = {
            "dense_M256_P49k_iters_per_s": round(n_d / t_d, 2),
            "dense_achieved_tflops": round(tf_d, 2),
            "dense_frac_of_peak": (round(tf_d / peak_tflops, 4)
                                   if peak_tflops else None),
            "cg_M1024_P49k_iters_per_s": round(n_c / t_c, 2),
            "cg_achieved_tflops": round(tf_c, 3),
            "cg_effective_gbs": round(cg_gbs, 1),
        }
        util["ba_dense_big_frac_of_peak"] = ba_scale["dense_frac_of_peak"]
        log(f"BA at scale: {ba_scale}")

    # ---- matching at capacity scale: sustained device-side rate of the
    # resident-pool matcher at the COLMAP-capacity shape (K=2048). The
    # uint8 pool uploads ONCE and amortizes across the collection's whole
    # pair schedule, so the utilization claim is the kernel's
    # sustained rate on resident descriptors; the one-time upload is
    # reported alongside.
    if os.environ.get("BENCH_MATCH_SCALE", "1") != "0" \
            and _have_budget("matching_scale"):
        import jax.numpy as jnp

        from scanner_colmap_tpu.ops import matching as mops

        K_big, n_pool, npc = 2048, 48, 128
        rngm = np.random.default_rng(5)
        d_u8 = rngm.integers(0, 255, (n_pool, K_big, 128), np.uint8)
        t0 = time.time()
        pool = mops.normalize_pool(jnp.asarray(d_u8))
        float(pool[0, 0, 0].astype(jnp.float32))   # sync the upload
        t_up = time.time() - t0
        v_pool = jnp.ones((n_pool, K_big), bool)
        ai = jnp.asarray(rngm.integers(0, n_pool, npc), dtype=jnp.int32)
        bi = jnp.asarray(rngm.integers(0, n_pool, npc), dtype=jnp.int32)
        out = mops.match_pairs_pool(pool, v_pool, ai, bi)
        float(out.astype(jnp.float32).sum())       # warmup + sync
        reps = 8
        t0 = time.time()
        for _ in range(reps - 1):
            mops.match_pairs_pool(pool, v_pool, ai, bi)
        out = mops.match_pairs_pool(pool, v_pool, ai, bi)
        float(out.astype(jnp.float32).sum())
        t_m = max(time.time() - t0, 1e-9)
        tf_m = npc * reps * 2 * K_big * K_big * 128 / t_m / 1e12
        util["matching_at_scale_tflops"] = round(tf_m, 2)
        util["matching_at_scale_frac_of_peak"] = (
            round(tf_m / peak_tflops, 4) if peak_tflops else None)
        util["matching_pool_upload_s_48img"] = round(t_up, 2)
        log(f"matching at scale: {tf_m:.1f} TFLOP/s "
            f"({tf_m / peak_tflops:.1%} of peak), pool upload {t_up:.1f}s")

    # dense phase (north star: fused points/sec per chip). Timed on the
    # steady-state second pass like the sparse stages.
    dense = {}
    if os.environ.get("BENCH_DENSE", "1") != "0" and _have_budget("dense"):
        cfg.patch_match.max_image_size = 192
        cfg.patch_match.overlap = 4
        cfg.patch_match.num_iterations = 7
        log("dense (warmup)")
        stages.run_prepare_patch_match(cfg, store)
        stages.run_patch_match(cfg, store)
        n_fused = stages.run_fusion(cfg, store)
        pm_trials, fuse_trials = [], []
        for rep in range(n_trials):
            log(f"dense (timed {rep + 1}/{n_trials})")
            t0 = time.time()
            n_maps = stages.run_patch_match(cfg, store)
            pm_trials.append(time.time() - t0)
            t0 = time.time()
            n_fused = stages.run_fusion(cfg, store)
            fuse_trials.append(time.time() - t0)
        t_pm = statistics.median(pm_trials)
        t_fuse = statistics.median(fuse_trials)
        # gather-tap rate (the stage's bound; see utils/flops.py)
        pm_h = cfg.patch_match.max_image_size * 3 // 4  # 4:3 bench frames
        taps = flops_acct.patch_match_taps(
            pm_h, cfg.patch_match.max_image_size, cfg.patch_match.overlap,
            cfg.patch_match.window_radius, cfg.patch_match.num_iterations)
        util["patch_match_gtaps_per_s"] = round(
            taps * n_maps / max(t_pm, 1e-9) / 1e9, 2)
        fused_xyz = store.read_table("fused", columns=["xyz"])["xyz"]
        acc = synth.evaluate_dense(model, gt, np.asarray(fused_xyz))
        dense = {
            "depth_maps_per_s": round(n_maps / max(t_pm, 1e-9), 2),
            "fused_points_per_s": round(n_fused / max(t_fuse, 1e-9), 1),
            "fused_points": int(n_fused),
            "patch_match_s": round(t_pm, 2),
            "fusion_s": round(t_fuse, 2),
            "depth_maps_per_s_spread": {
                "median": round(n_maps / max(t_pm, 1e-9), 2),
                "min": round(n_maps / max(max(pm_trials), 1e-9), 2),
                "max": round(n_maps / max(min(pm_trials), 1e-9), 2),
                "n_trials": n_trials},
            "surface_err_median_rel": round(acc["median_rel"], 5),
            "surface_err_p90_rel": round(acc["p90_rel"], 5),
        }
        # stage 9: TSDF + marching-tetrahedra mesh (the reference's
        # never-shipped step); accuracy = mesh-vertex distance to the
        # analytic surface, same metric as the fused cloud. Warm pass
        # first (TSDF compile), steady state timed like the other stages
        stages.run_meshing(cfg, store)
        t0 = time.time()
        n_faces = stages.run_meshing(cfg, store)
        t_mesh = time.time() - t0
        mesh_verts = np.asarray(store.read_table("mesh")["verts"][0])
        if len(mesh_verts):
            macc = synth.evaluate_dense(model, gt, mesh_verts)
            dense.update({
                "mesh_faces": int(n_faces),
                "meshing_s": round(t_mesh, 2),
                "mesh_err_median_rel": round(macc["median_rel"], 5),
            })
        log(f"dense: {dense}")

    # ---- dense at REFERENCE resolution: the reference's
    # one GPU stage runs CUDA PatchMatch on full-resolution bitmaps with
    # the full source window (patch_match.cc:47-114); measure >= 480 px
    # with 8 source views next to the 192 px numbers ---------------------
    if os.environ.get("BENCH_DENSE_HIRES", "1") != "0" \
            and _have_budget("dense_hires"):
        cfg.patch_match.max_image_size = 480
        cfg.patch_match.overlap = 8
        cfg.patch_match.num_iterations = 7
        log("dense 480px/8src (warmup)")
        stages.run_prepare_patch_match(cfg, store)
        stages.run_patch_match(cfg, store)
        stages.run_fusion(cfg, store)
        log("dense 480px/8src (timed)")
        t0 = time.time()
        n_maps_h = stages.run_patch_match(cfg, store)
        t_pm_h = time.time() - t0
        t0 = time.time()
        n_fused_h = stages.run_fusion(cfg, store)
        t_fuse_h = time.time() - t0
        fused_xyz_h = store.read_table("fused", columns=["xyz"])["xyz"]
        acc_h = synth.evaluate_dense(model, gt, np.asarray(fused_xyz_h))
        taps_h = flops_acct.patch_match_taps(
            360, 480, cfg.patch_match.overlap,
            cfg.patch_match.window_radius, cfg.patch_match.num_iterations)
        dense["hires_480px_8src"] = {
            "depth_maps_per_s": round(n_maps_h / max(t_pm_h, 1e-9), 2),
            "fused_points_per_s": round(n_fused_h / max(t_fuse_h, 1e-9), 1),
            "fused_points": int(n_fused_h),
            "patch_match_s": round(t_pm_h, 2),
            "fusion_s": round(t_fuse_h, 2),
            "surface_err_median_rel": round(acc_h["median_rel"], 5),
            "surface_err_p90_rel": round(acc_h["p90_rel"], 5),
            "gtaps_per_s": round(
                taps_h * n_maps_h / max(t_pm_h, 1e-9) / 1e9, 2),
        }
        log(f"dense hires: {dense['hires_480px_8src']}")

    # ---- dense at REFERENCE resolution, 960 px:
    # separate 960x720 renders (the dense stage reloads ORIGINAL files
    # at patch_match.max_image_size, so the sources must carry the
    # pixels); sparse runs at the standard 480 px; PatchMatch runs the
    # full 960 px canvas through the row-band tiling/memory plan
    # (ops/patch_match.patch_match_tiled) with coarse-to-fine ---------
    if os.environ.get("BENCH_DENSE_960", "1") != "0" \
            and _have_budget("dense_960"):
        log("dense 960px (render + sparse)")
        dir960 = os.path.join(workdir, "images960")
        gt9 = synth.generate_dataset(dir960, num_images=8, width=960,
                                     height=720, num_blobs=500, seed=3)
        cfg9 = PipelineConfig()
        cfg9.image_path = dir960
        cfg9.store_path = os.path.join(workdir, "store960")
        cfg9.sift.max_image_size = 480
        cfg9.sift.max_num_features = 1024
        cfg9.sift.num_octaves = 3
        cfg9.matching.overlap = 5
        cfg9.mapper.single_camera = True
        cfg9.mapper.mode = cfg.mapper.mode
        cfg9.patch_match.max_image_size = 960
        cfg9.patch_match.overlap = 8 - 1   # 8-image set: 7 sources
        cfg9.patch_match.num_iterations = 7
        store9 = ArtifactStore(cfg9.store_path)
        stages.prepare_images(cfg9, store9)
        stages.run_extraction(cfg9, store9)
        stages.run_matching(cfg9, store9)
        stages.run_mapping(cfg9, store9)
        model9 = stages.run_merge(cfg9, store9)
        stages.run_prepare_patch_match(cfg9, store9)
        log("dense 960px (warmup)")
        stages.run_patch_match(cfg9, store9)
        stages.run_fusion(cfg9, store9)
        log("dense 960px (timed)")
        t0 = time.time()
        n_maps_9 = stages.run_patch_match(cfg9, store9)
        t_pm_9 = time.time() - t0
        t0 = time.time()
        n_fused_9 = stages.run_fusion(cfg9, store9)
        t_fuse_9 = time.time() - t0
        fused_9 = store9.read_table("fused", columns=["xyz"])["xyz"]
        acc_9 = synth.evaluate_dense(model9, gt9, np.asarray(fused_9))
        taps_9 = flops_acct.patch_match_taps(
            720, 960, cfg9.patch_match.overlap,
            cfg9.patch_match.window_radius,
            cfg9.patch_match.num_iterations)
        dense["hires_960px"] = {
            "depth_maps_per_s": round(n_maps_9 / max(t_pm_9, 1e-9), 3),
            "fused_points_per_s": round(
                n_fused_9 / max(t_fuse_9, 1e-9), 1),
            "fused_points": int(n_fused_9),
            "patch_match_s": round(t_pm_9, 2),
            "fusion_s": round(t_fuse_9, 2),
            "surface_err_median_rel": round(acc_9["median_rel"], 5),
            "surface_err_p90_rel": round(acc_9["p90_rel"], 5),
            "gtaps_per_s": round(
                taps_9 * n_maps_9 / max(t_pm_9, 1e-9) / 1e9, 2),
            "registered_sparse": int(model9.num_registered),
        }
        log(f"dense 960px: {dense['hires_960px']}")

    # ---- REAL-PHOTOGRAPH texture eval: the pipeline
    # on JPEG-compressed views of a real photo mapped onto a known 3D
    # surface — natural-image SIFT/matching statistics + EXIF priors, ATE
    # against exact ground truth -----------------------------------------
    real = {}
    if os.environ.get("BENCH_REAL", "1") != "0" and _have_budget("real"):
        log("real-texture eval")
        real_dir = os.path.join(workdir, "real_images")
        # hardening knobs ON: composite non-planar geometry +
        # exposure variation + sensor noise (the full sweep lives in
        # tools/exp_real_sweep.py; this keeps one hardened config in
        # every BENCH record)
        gt_r = synth.generate_real_texture_dataset(real_dir, num_images=10,
                                                   width=480, height=400,
                                                   seed=1, num_bumps=2,
                                                   exposure_jitter=0.2,
                                                   noise_std=2.0)
        cfg_r = PipelineConfig()
        cfg_r.image_path = real_dir
        cfg_r.store_path = os.path.join(workdir, "real_store")
        cfg_r.sift.max_image_size = 480
        cfg_r.sift.max_num_features = 1024
        cfg_r.sift.num_octaves = 3
        cfg_r.matching.overlap = 5
        cfg_r.mapper.single_camera = True
        cfg_r.mapper.mode = cfg.mapper.mode
        store_r = ArtifactStore(cfg_r.store_path)
        stages.prepare_images(cfg_r, store_r)

        def real_sparse():
            t0 = time.time()
            stages.run_extraction(cfg_r, store_r)
            stages.run_matching(cfg_r, store_r)
            stages.run_mapping(cfg_r, store_r)
            m = stages.run_merge(cfg_r, store_r)
            return m, time.time() - t0

        real_sparse()                    # warmup (pays any residual compiles)
        model_r, t_real = real_sparse()  # steady state
        cam_r = model_r.cameras[model_r.images[0].camera_id]
        scale_r = stages.cam_scales(store_r)[0]
        focal_err = abs(cam_r.params[0] / scale_r - gt_r["focal"]) / gt_r["focal"]
        real = {
            "registered": int(model_r.num_registered),
            "num_images": 10,
            "ate": round(float(synth.evaluate_ate(model_r, gt_r)), 4),
            "mean_reproj_px": round(model_r.mean_reprojection_error(), 3),
            "focal_rel_err": round(float(focal_err), 4),
            "images_per_s": round(model_r.num_registered / max(t_real, 1e-9), 3),
        }
        log(f"real-texture: {real}")

    # ---- SCALE section: a 200-image sparse run (bench_scale.py runs the
    # 1k/10k configs — this keeps a scale proof in this script's JSON line
    # at bounded wall clock). Executables are
    # already warm from the headline section (same sift/matching configs).
    scale = {}
    n_scale = int(os.environ.get("BENCH_SCALE", "200"))
    if n_scale > 0 and _have_budget("scale"):
        log(f"scale section ({n_scale} images)")
        scale_dir = os.path.join(workdir, "scale_images")
        gt_s = synth.generate_dataset(scale_dir, num_images=n_scale,
                                      width=480, height=360, num_blobs=500,
                                      seed=7)
        cfg_s = PipelineConfig()
        cfg_s.image_path = scale_dir
        cfg_s.store_path = os.path.join(workdir, "scale_store")
        # deep-copy the sub-configs: sharing by reference would let any
        # later mutation of the headline cfg leak into the scale run
        import copy as _copy
        for attr in ("sift", "matching", "mapper"):
            setattr(cfg_s, attr, _copy.deepcopy(getattr(cfg, attr)))
        times_s = {}
        cold_s = {}
        store_s = ArtifactStore(cfg_s.store_path)
        stages.prepare_images(cfg_s, store_s)
        # warmup + steady-state like every other section:
        # the single-pass timing mixed one-time costs (executable
        # loads, per-signature compiles) into the per-collection
        # number — a deployment amortizes those across collections
        for name, fn in [("extraction", stages.run_extraction),
                         ("matching", stages.run_matching),
                         ("mapping", stages.run_mapping),
                         ("merge", stages.run_merge)]:
            t0 = time.time()
            fn(cfg_s, store_s)
            cold_s[name] = round(time.time() - t0, 1)
            t0 = time.time()
            out_s = fn(cfg_s, store_s)
            times_s[name] = round(time.time() - t0, 1)
        from scanner_colmap_tpu.models import geometry as geom_b
        centers = np.stack([np.asarray(geom_b.np_projection_center(
            gt_s["qvecs"][i], gt_s["tvecs"][i]))
            for i in range(len(gt_s["tvecs"]))])
        span = float(np.linalg.norm(centers.max(0) - centers.min(0)))
        ate_s = float(synth.evaluate_ate(out_s, gt_s))
        total_s = sum(times_s.values())
        scale = {
            "num_images": n_scale,
            "registered": int(out_s.num_registered),
            "images_per_s": round(out_s.num_registered / max(total_s, 1e-9), 3),
            "ate": round(ate_s, 4),
            "ate_rel_span": round(ate_s / max(span, 1e-9), 5),
            "mean_reproj_px": round(out_s.mean_reprojection_error(), 3),
            "stage_s": times_s,
            "cold_stage_s": cold_s,
        }
        log(f"scale: {scale}")

    # ---- REFERENCE-CAPACITY fidelity: the reference
    # operates COLMAP at stock capacities — 8192 features,
    # max_num_matches 32768 (colmap.proto:17), full-resolution
    # bitmaps. One hardened real-texture run at those capacities so
    # quality at reference fidelity is a recorded number, not an
    # extrapolation (full default-vs-capacity table:
    # tools/exp_capacity.py).
    if os.environ.get("BENCH_REAL_CAPACITY", "1") != "0" \
            and _have_budget("real_capacity"):
        log("reference-capacity real-texture run (2048px/8192 feats)")
        cap_dir = os.path.join(workdir, "cap_images")
        gt_c = synth.generate_real_texture_dataset(
            cap_dir, num_images=10, width=2048, height=1536,
            focal=1920.0, seed=1, num_bumps=2, exposure_jitter=0.2,
            noise_std=2.0)
        log("reference capacity: rendered; warmup pass (2048px "
            "compiles — the supervisor watches output, so narrate "
            "around the long silent stretches)")
        cfg_c = PipelineConfig()
        cfg_c.image_path = cap_dir
        cfg_c.store_path = os.path.join(workdir, "cap_store")
        cfg_c.sift.max_image_size = 2048
        cfg_c.sift.max_num_features = 8192
        cfg_c.sift.num_octaves = 4
        cfg_c.matching.overlap = 5
        cfg_c.matching.max_num_matches = 32768
        cfg_c.mapper.single_camera = True
        cfg_c.mapper.mode = cfg.mapper.mode
        store_c = ArtifactStore(cfg_c.store_path)
        stages.prepare_images(cfg_c, store_c)

        def cap_sparse():
            t0 = time.time()
            stages.run_extraction(cfg_c, store_c)
            stages.run_matching(cfg_c, store_c)
            stages.run_mapping(cfg_c, store_c)
            mm = stages.run_merge(cfg_c, store_c)
            return mm, time.time() - t0

        cap_sparse()                       # warmup (2048px compiles)
        log("reference capacity: warm; timed pass")
        model_c, t_cap = cap_sparse()      # steady state
        real["reference_capacity"] = {
            "registered": int(model_c.num_registered),
            "num_images": 10,
            "ate": round(float(synth.evaluate_ate(model_c, gt_c)), 4),
            "mean_reproj_px": round(
                model_c.mean_reprojection_error(), 3),
            "images_per_s": round(
                model_c.num_registered / max(t_cap, 1e-9), 3),
            "wall_s": round(t_cap, 1),
        }
        log(f"reference capacity: {real['reference_capacity']}")

    measured_cpu_baseline = 0.57  # same-code 2-vCPU host (see docstring)
    nominal_colmap_cpu = 0.5      # nominal COLMAP-CPU constant (secondary)
    result = {
        "metric": "sparse_pipeline_images_registered_per_sec",
        "value": round(images_per_s, 3),
        "unit": "images/s",
        "vs_baseline": round(images_per_s / measured_cpu_baseline, 2),
        "detail": {
            "num_images": num_images,
            "vs_baseline_note": ("measured same-code 2-vCPU host baseline "
                                 "0.57 img/s (PERFORMANCE.md@0af5287 "
                                 "lever 32)"),
            "vs_nominal_colmap_cpu": round(
                images_per_s / nominal_colmap_cpu, 2),
            "value_spread": headline_spread,
            "ba_iters_per_sec_sustained_spread": ba_spread,
            "registered": int(n_reg),
            "ate": round(float(ate), 4),
            "mean_reproj_px": round(model.mean_reprojection_error(), 3),
            "extraction_s": round(t_extract, 2),
            "matching_s": round(t_match, 2),
            "mapping_s": round(t_map, 2),
            "cold_s": {k: round(v, 2) for k, v in cold.items()},
            "verified_pairs": int(n_pairs),
            "ba_iters_per_sec": round(ba_iters_per_s, 2),
            "ba_iters_per_sec_sustained": round(ba_sustained, 1),
            "dense": dense,
            "mapper_mode": cfg.mapper.mode,
            "alt_mapper": alt,
            "utilization": util,
            "ba_scale": ba_scale,
            "real_texture": real,
            "scale": scale,
            "platform": jax.devices()[0].platform,
            "device_kind": getattr(jax.devices()[0], "device_kind", ""),
        },
    }
    # the full blob first, then a compact <= 500-char headline as the final
    # line, which a tail-capturing reader can never truncate
    print(json.dumps(result))
    compact = {
        "metric": result["metric"],
        "value": result["value"],
        "unit": result["unit"],
        "vs_baseline": result["vs_baseline"],
        "registered": int(n_reg),
        "ate": round(float(ate), 4),
        "ba_sustained": round(ba_sustained, 1),
        "dense_maps_per_s": (dense or {}).get("depth_maps_per_s"),
        "scale_images_per_s": (scale or {}).get("images_per_s"),
        "scale_matching_s": (scale or {}).get("stage_s", {}).get("matching"),
        "real_images_per_s": (real or {}).get("images_per_s"),
        "device_kind": result["detail"]["device_kind"],
    }
    line = json.dumps(compact)
    if len(line) > 500:  # hard ceiling: drop the optional keys first
        for k in ("real_images_per_s", "scale_matching_s"):
            compact.pop(k, None)
            line = json.dumps(compact)
            if len(line) <= 500:
                break
    print(line)


def _supervise():
    """Run main() in a monitored child, retrying on output stalls.

    A hung device call cannot be cancelled in-process, so this parent —
    which never imports JAX, so the child is the one process that holds
    the card — watches the child's output and kills + retries it when
    nothing has been emitted for BENCH_STALL_S seconds. The child's stdout
    (the JSON result lines) is forwarded verbatim.
    """
    import subprocess
    import threading

    attempts = int(os.environ.get("BENCH_ATTEMPTS", "2"))
    stall_s = float(os.environ.get("BENCH_STALL_S", "480"))
    for a in range(attempts):
        env = dict(os.environ, BENCH_SUPERVISED="1")
        proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=env,
            cwd=os.path.dirname(os.path.abspath(__file__)) or None)
        last = [time.time()]
        out_buf = []

        def pump(stream, sink, keep=None):
            for line in iter(stream.readline, b""):
                last[0] = time.time()
                if keep is not None:
                    keep.append(line)
                sink.buffer.write(line)
                sink.flush()

        t_out = threading.Thread(target=pump,
                                 args=(proc.stdout, sys.stdout, out_buf))
        t_err = threading.Thread(target=pump, args=(proc.stderr, sys.stderr))
        t_out.daemon = t_err.daemon = True
        t_out.start()
        t_err.start()
        while proc.poll() is None:
            time.sleep(5)
            if time.time() - last[0] > stall_s:
                log(f"supervisor: no output for {stall_s:.0f}s "
                    f"(attempt {a + 1}/{attempts}) — killing child")
                proc.kill()
                break
        proc.wait()
        t_out.join(timeout=10)
        t_err.join(timeout=10)
        if proc.returncode == 0 and any(b'"metric"' in l for l in out_buf):
            return 0
        log(f"supervisor: attempt {a + 1} failed (rc={proc.returncode})")
    return 1


if __name__ == "__main__":
    if os.environ.get("BENCH_SUPERVISED") == "1":
        main()
    else:
        sys.exit(_supervise())
