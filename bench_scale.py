"""Scale benchmark: 1k-10k-image sparse reconstruction on ONE card.

The 1k and 10k collection sizes are the scale configurations of the
original plan (BASELINE.md@0af5287). This harness carries ALL sparse
stages through
at SCALE_IMAGES and reports per-stage splits, merge sub-splits
(load/fold/graph/refine), utilization accounting (achieved TFLOP/s and
fraction of bf16 peak for matching / mapping / merge BA), and the host
RSS high-water. Prints ONE JSON line like bench.py. Not part of the
driver's default bench — run manually: `python bench_scale.py`
(env: SCALE_IMAGES to change N).
"""

import json
import logging
import os
import sys
import tempfile
import time

logging.basicConfig(level=logging.INFO, stream=sys.stderr)


def log(msg):
    print(f"[scale] {msg}", file=sys.stderr, flush=True)


def _vm_hwm_gb() -> float:
    """Host RSS high-water (VmHWM) of this process, GB."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmHWM:"):
                    return round(int(line.split()[1]) / 1e6, 2)
    except OSError:
        pass
    return -1.0


def _ba_perf(peak_tflops):
    """Aggregate + clear ops.ba.PERF_LOG -> achieved TFLOP/s over the BA
    calls' wall window (the segmented host driver's own timing)."""
    from scanner_colmap_tpu.ops import ba
    from scanner_colmap_tpu.utils import flops as fl

    total_fl, total_s, n = 0.0, 0.0, 0
    for solver, M, P, T, iters, cg_iters, secs in ba.PERF_LOG:
        per = (fl.ba_cg_flops_per_iter(M, P, T, cg_iters)
               if solver == "cg" else fl.ba_flops_per_iter(M, P, T))
        total_fl += per * max(iters, 1)
        total_s += secs
        n += 1
    ba.PERF_LOG.clear()
    if n == 0 or total_s <= 0:
        return {}
    tf = total_fl / total_s / 1e12
    return {"ba_calls": n, "ba_wall_s": round(total_s, 1),
            "achieved_tflops": round(tf, 3),
            "frac_of_peak": (round(tf / peak_tflops, 5)
                             if peak_tflops else None)}


def main():
    import jax

    from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from scanner_colmap_tpu.ops import ba
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils import flops as fl
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    n_img = int(os.environ.get("SCALE_IMAGES", "1000"))
    workdir = os.environ.get("SCALE_WORKDIR") or tempfile.mkdtemp(
        prefix="sct_scale_")
    image_dir = os.path.join(workdir, "images")
    resume = bool(os.environ.get("SCALE_RESUME"))
    log(f"devices: {jax.devices()}")
    peak = fl.device_peak_tflops(jax.devices()[0])
    t0 = time.time()
    if resume and os.path.exists(os.path.join(image_dir,
                                              "ground_truth.json")):
        gt = synth.load_ground_truth(image_dir)
        log(f"resume: reusing {len(gt['tvecs'])} rendered frames")
    else:
        gt = synth.generate_dataset(image_dir, num_images=n_img, width=480,
                                    height=360, num_blobs=500, seed=7)
        log(f"rendered {n_img} frames in {time.time() - t0:.0f}s")

    cfg = PipelineConfig(image_path=image_dir,
                         store_path=os.path.join(workdir, "store"))
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
    if os.environ.get("SCALE_BATCH_CLUSTERS"):
        cfg.mapper.device_batch_clusters = True

    store = ArtifactStore(cfg.store_path)
    stages.prepare_images(cfg, store)
    times = {}
    util = {"peak_bf16_tflops": peak}
    out_table = {"extraction": "extraction", "matching": "matching",
                 "mapping": "mapping", "merge": "models"}
    for name, fn in [("extraction", stages.run_extraction),
                     ("matching", stages.run_matching),
                     ("mapping", stages.run_mapping),
                     ("merge", stages.run_merge)]:
        if resume and store.has_table(out_table[name]):
            log(f"{name}: resume — table present, skipping (stage time "
                f"not re-measured)")
            times[name] = -1.0
            if name == "merge":
                out = stages.load_model(store)
            continue
        log(name)
        ba.PERF_LOG.clear()
        t0 = time.time()
        out = fn(cfg, store)
        times[name] = time.time() - t0
        log(f"{name}: {times[name]:.1f}s (host hwm {_vm_hwm_gb()} GB)")
        if name in ("mapping", "merge"):
            perf = _ba_perf(peak)
            if perf:
                util[f"{name}_host_ba"] = perf
    model = out
    # resume-skipped stages carry -1: the total (and img/s) then covers
    # only the re-measured stages — merge complete numbers by hand
    total = sum(v for v in times.values() if v > 0)
    ate = synth.evaluate_ate(model, gt)
    # trajectory extent: ATE on a 600-unit track reads very differently
    # from the same number on an 8-unit arc
    import numpy as np

    from scanner_colmap_tpu.models import geometry as geom
    centers = np.stack([
        np.asarray(geom.np_projection_center(gt["qvecs"][i], gt["tvecs"][i]))
        for i in range(len(gt["tvecs"]))])
    span = float(np.linalg.norm(centers.max(0) - centers.min(0)))
    mm = store.read_manifest("matching")["meta"]
    map_meta = store.read_manifest("mapping")["meta"]
    merge_meta = store.read_manifest("models")["meta"]

    # matching utilization (matmul fraction of peak); skipped on resume runs
    # where the stage time was not re-measured
    if times["matching"] > 0:
        m_fl = fl.matching_flops(mm["scheduled_pairs"], mm["k_max"])
        m_tf = m_fl / times["matching"] / 1e12
        util["matching"] = {
            "achieved_tflops": round(m_tf, 3),
            "frac_of_peak": round(m_tf / peak, 5) if peak else None}
    # device-mapper utilization: scheduled FLOPs (upper bound; converged LM
    # trips cond-skip on device) over the whole mapping stage wall clock
    dstats = map_meta.get("device_stats") or {}
    if dstats.get("scheduled_tflop") and times["mapping"] > 0:
        mp_tf = dstats["scheduled_tflop"] / times["mapping"]
        util["mapping_device"] = {
            "scheduled_tflops": round(mp_tf, 3),
            "frac_of_peak": round(mp_tf / peak, 5) if peak else None,
            "prep_s": dstats.get("prep_s"), "await_s": dstats.get("await_s"),
            "n_clusters": dstats.get("n_clusters"),
            "batched": dstats.get("batched")}

    result = {
        "metric": f"scale_{n_img}_images_registered_per_sec",
        "value": round(model.num_registered / max(total, 1e-9), 3),
        "unit": "images/s",
        "vs_baseline": round(model.num_registered / max(total, 1e-9) / 0.57,
                             2),
        "detail": {
            "num_images": n_img,
            "registered": int(model.num_registered),
            "ate": round(float(ate), 4),
            "ate_rel_span": round(float(ate) / max(span, 1e-9), 5),
            "trajectory_span": round(span, 1),
            "mean_reproj_px": round(model.mean_reprojection_error(), 3),
            "stage_s": {k: round(v, 1) for k, v in times.items()},
            "merge_split_s": merge_meta.get("time_split_s", {}),
            "host_rss_hwm_gb": _vm_hwm_gb(),
            "utilization": util,
            "matching_banks": mm["num_banks"],
            "bank_images": mm["bank_images"],
            "scheduled_pairs": mm["scheduled_pairs"],
            "platform": jax.devices()[0].platform,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
