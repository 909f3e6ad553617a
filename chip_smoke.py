#!/usr/bin/env python3
"""Smoke test of the whole reconstruction pipeline on NVIDIA GPUs.

    python chip_smoke.py              # one card: device, pipeline, numerics
    python chip_smoke.py --cards 4    # four cards: the in-process mesh and
                                      # process-per-card paths, each against
                                      # a one-card run

One card, all phases in this process:

1. device    refuse anything but a GPU; print the card (nvidia-smi name and
             power limit), the JAX version, device kind and count.
2. pipeline  render a seeded synthetic sequential capture (100 images at
             1024x768 by default) and run ``cli all`` on it in-process
             through every stage; check registration, trajectory error,
             reprojection error, host-mapper retries, depth-map coverage,
             dense surface error and the mesh.
3. numerics  matching decisions of the configured bf16 path against f32 at
             the highest precision, and one BA solve on the GPU against the
             same solve on the CPU backend.

Four cards (``--cards 4``): this parent never initializes JAX; each
sub-phase runs in its own child, one at a time.

1. mesh      make_distributed_step, dense and CG distributed BA on a 4-card
             mesh against the same calls on a 1-card mesh (card 0).
2. procs     one process per card (parallel/dist.py) over a 24-image
             capture against a one-card run of the same stages.

Every time is printed beside the card's name and power limit. On success
the last line of standard output is one JSON object,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``;
on any failure the script exits non-zero without printing it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# phase 2 collection: the Gerrard Hall image count of COLMAP's docs, at
# SiftConfig's default max_image_size
NUM_IMAGES = 100
WIDTH, HEIGHT = 1024, 768
FOCAL = 900.0            # ~59 degree horizontal field of view
NUM_BLOBS = 600          # texture density of the synthetic wall (default 400)
SEED = 0

# accuracy bars of the pipeline phase
MIN_REGISTERED_FRAC = 0.98
MAX_ATE_REL_SPAN = 0.005
MAX_REPROJ_PX = 1.0
MAX_SURFACE_REL = 0.05
# numerics phase
MATCH_PAIRS = 20
MIN_MATCH_AGREEMENT = 0.97
BA_REL_TOL = 1e-3
# four-card phase
MESH_REL_TOL = 1e-4
PROCS_IMAGES = 24       # two mapping clusters (cluster_size 20, overlap 5)
PROCS_ATE_TOL = 0.10

_card = ""   # "name, power limit" of the card(s), set by card_line()


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """nvidia-smi's name and power limit of every card, one per line."""
    global _card
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi listed no card")
    _card = out.splitlines()[0].strip()
    return out


def report_time(name: str, seconds: float) -> None:
    log(f"time {name}: {seconds:.3f} s  [{_card}]")


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------

def phase_device(min_count: int = 1) -> dict:
    """The accelerator as JAX reports it; raises unless it is a GPU."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default backend is {devs[0].platform!r}")
    if len(devs) < min_count:
        raise RuntimeError(f"{min_count} GPUs needed, JAX found {len(devs)}")
    log(f"card: {card_line()}")
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    log(f"jax {jax.__version__}: {info['count']} x {info['kind']}")
    return info


# ---------------------------------------------------------------------------
# phase 2: pipeline
# ---------------------------------------------------------------------------

def pipeline_config(image_dir: str, store_dir: str, overrides=None):
    """Default PipelineConfig; one camera rendered the set."""
    from scanner_colmap_tpu.utils.config import PipelineConfig

    cfg = PipelineConfig(image_path=image_dir, store_path=store_dir)
    cfg.apply_overrides({"mapper.single_camera": True, **(overrides or {})})
    return cfg


def trajectory_span(gt) -> float:
    import numpy as np

    from scanner_colmap_tpu.models import geometry as geom

    centers = np.stack([np.asarray(geom.np_projection_center(q, t))
                        for q, t in zip(gt["qvecs"], gt["tvecs"])])
    return float(np.linalg.norm(centers.max(0) - centers.min(0)))


def phase_pipeline(work_dir: str, num_images: int = NUM_IMAGES,
                   width: int = WIDTH, height: int = HEIGHT,
                   focal: float = FOCAL, num_blobs: int = NUM_BLOBS,
                   seed: int = SEED, overrides=None) -> dict:
    """Render a capture, run ``cli all`` on it, and measure the result."""
    import numpy as np

    from scanner_colmap_tpu.pipeline import cli, stages, synth
    from scanner_colmap_tpu.utils.store import ArtifactStore

    image_dir = os.path.join(work_dir, "images")
    store_dir = os.path.join(work_dir, "store")
    t0 = time.time()
    synth.generate_dataset(image_dir, num_images=num_images, width=width,
                           height=height, focal=focal, num_blobs=num_blobs,
                           seed=seed)
    gt = synth.load_ground_truth(image_dir)
    log(f"rendered {num_images} images at {width}x{height} in "
        f"{time.time() - t0:.1f} s")
    cfg_path = os.path.join(work_dir, "pipeline_config.json")
    with open(cfg_path, "w") as f:
        f.write(pipeline_config(image_dir, store_dir, overrides).to_json())
    os.makedirs(store_dir, exist_ok=True)
    t0 = time.time()
    rc = cli.main(["all", "--config", cfg_path, "--image_path", image_dir,
                   "--store_path", store_dir])
    wall = time.time() - t0
    if rc != 0:
        raise RuntimeError(f"cli all exited with {rc}")

    store = ArtifactStore(store_dir)
    times = store.read_table("stage_times")
    stage_s = {s.decode(): float(v)
               for s, v in zip(times["stage"], times["seconds"])}
    model = stages.load_model(store)
    reg = sorted(model.registered_image_ids)
    ate = synth.evaluate_ate(model, gt)
    span = trajectory_span(gt)
    retries = store.read_manifest("mapping")["meta"]["device_stats"].get(
        "host_retries", 0)
    depth_ids = {int(i) for i in store.read_table(
        "patch_match", columns=["image_id"])["image_id"]}
    xyz = np.asarray(store.read_table("fused", columns=["xyz"])["xyz"])
    dense = synth.evaluate_dense(model, gt, xyz)
    faces = store.read_table("mesh", columns=["faces"])["faces"][0]
    return {
        "num_images": num_images, "registered": len(reg),
        "ate": ate, "trajectory_span": span, "ate_rel_span": ate / span,
        "mean_reproj_px": float(model.mean_reprojection_error()),
        "host_retries": int(retries),
        "missing_depth_maps": sorted(set(reg) - depth_ids),
        "fused_points": int(len(xyz)), "surface_median_rel": dense["median_rel"],
        "mesh_faces": int(len(faces)), "stage_seconds": stage_s,
        "wall_seconds": wall, "store": store_dir,
    }


def pipeline_failures(res: dict) -> list:
    """The accuracy bars of the pipeline phase that `res` misses."""
    bad = []
    need = int(-(-MIN_REGISTERED_FRAC * res["num_images"] // 1))
    if res["registered"] < need:
        bad.append(f"registered {res['registered']} < {need}")
    if not res["ate_rel_span"] <= MAX_ATE_REL_SPAN:
        bad.append(f"ATE/span {res['ate_rel_span']:.5f} > {MAX_ATE_REL_SPAN}")
    if not res["mean_reproj_px"] <= MAX_REPROJ_PX:
        bad.append(f"mean reprojection {res['mean_reproj_px']:.3f} px > "
                   f"{MAX_REPROJ_PX}")
    if res["host_retries"]:
        bad.append(f"{res['host_retries']} clusters took the host retry")
    if res["missing_depth_maps"]:
        bad.append(f"no depth map for {res['missing_depth_maps']}")
    if res["fused_points"] <= 0:
        bad.append("no fused points")
    if not res["surface_median_rel"] <= MAX_SURFACE_REL:
        bad.append(f"surface median rel {res['surface_median_rel']:.4f} > "
                   f"{MAX_SURFACE_REL}")
    if res["mesh_faces"] <= 0:
        bad.append("mesh has no faces")
    return bad


def print_pipeline(res: dict) -> None:
    for name, s in res["stage_seconds"].items():
        report_time(f"stage {name} (cold)", s)
    report_time("cli all (cold)", res["wall_seconds"])
    log(f"registered {res['registered']}/{res['num_images']}; "
        f"ATE {res['ate']:.5f} over span {res['trajectory_span']:.3f} "
        f"= {100 * res['ate_rel_span']:.4f}%; mean reprojection "
        f"{res['mean_reproj_px']:.4f} px; host retries {res['host_retries']}")
    log(f"depth maps missing for {len(res['missing_depth_maps'])} registered "
        f"images; fused points {res['fused_points']}; surface median rel "
        f"{res['surface_median_rel']:.5f}; mesh faces {res['mesh_faces']}")


# ---------------------------------------------------------------------------
# phase 3: numerics
# ---------------------------------------------------------------------------

def matching_agreement(store_dir: str, num_pairs: int = MATCH_PAIRS) -> list:
    """Per adjacent pair (i, i+1) of the store's descriptors: the share of
    valid keypoints whose match decision (index or none) is the same on
    the configured ``matching.precision`` path and on the f32 path under
    the highest matmul precision. Returns [(i, j, share, n_bf16, n_f32)]."""
    import jax
    import numpy as np

    from scanner_colmap_tpu.ops import matching
    from scanner_colmap_tpu.utils.config import PipelineConfig
    from scanner_colmap_tpu.utils.store import ArtifactStore

    store = ArtifactStore(store_dir)
    with open(os.path.join(store_dir, "pipeline_config.json")) as f:
        mcfg = PipelineConfig.from_json(f.read()).matching
    tab = store.read_table("extraction", columns=["image_id", "descriptors"])
    descs = tab["descriptors"]
    K = max(len(d) for d in descs)
    out = []
    for i in range(min(num_pairs, len(descs) - 1)):
        ds, vs = [], []
        for d in (descs[i], descs[i + 1]):
            pad = np.zeros((K, d.shape[1]), np.float32)
            pad[:len(d)] = d
            ds.append(pad)
            vs.append(np.arange(K) < len(d))
        kw = dict(max_ratio=mcfg.max_ratio, max_distance=mcfg.max_distance,
                  cross_check=mcfg.cross_check)
        idx_c, _ = matching.match_descriptors(*ds, *vs,
                                              precision=mcfg.precision, **kw)
        with jax.default_matmul_precision("highest"):
            idx_f, _ = matching.match_descriptors(*ds, *vs, precision="f32",
                                                  **kw)
        idx_c, idx_f = np.asarray(idx_c)[vs[0]], np.asarray(idx_f)[vs[0]]
        out.append((int(tab["image_id"][i]), int(tab["image_id"][i + 1]),
                    float(np.mean(idx_c == idx_f)), int(np.sum(idx_c >= 0)),
                    int(np.sum(idx_f >= 0))))
    return out


def ba_device_vs_cpu(M: int = 16, P: int = 1024, T: int = 16,
                     iterations: int = 25) -> tuple:
    """Final cost of one float32 BA solve on the default device and on the
    CPU backend: (device_cost, cpu_cost, device_initial, cpu_initial)."""
    import jax

    from __graft_entry__ import _synthetic_bundle
    from scanner_colmap_tpu.ops import ba

    params, obs, cfg, _, _ = _synthetic_bundle(M=M, Pn=P, T=T)

    def solve(dev):
        args = jax.device_put((params, obs, cfg), dev)
        _, info = ba.bundle_adjust(*args, max_iterations=iterations,
                                   chunk=min(P, 1024))
        return float(info["final_cost"]), float(info["initial_cost"])

    dev_cost, dev_init = solve(jax.devices()[0])
    cpu_cost, cpu_init = solve(jax.devices("cpu")[0])
    return dev_cost, cpu_cost, dev_init, cpu_init


def phase_numerics(store_dir: str) -> list:
    """Run the numerics comparisons; returns the list of failures."""
    bad = []
    t0 = time.time()
    for i, j, share, n_c, n_f in matching_agreement(store_dir):
        log(f"matching ({i},{j}): {100 * share:.2f}% identical decisions; "
            f"matches bf16 {n_c} / f32-highest {n_f}")
        if share < MIN_MATCH_AGREEMENT:
            bad.append(f"pair ({i},{j}) agrees on {share:.4f} < "
                       f"{MIN_MATCH_AGREEMENT}")
    dev, cpu, dev0, cpu0 = ba_device_vs_cpu()
    rel = abs(dev - cpu) / max(abs(cpu), 1e-12)
    log(f"BA M=16 P=1024 T=16, 25 iterations: cost {dev0:.6f} -> {dev:.6f} "
        f"on the GPU, {cpu0:.6f} -> {cpu:.6f} on the CPU; rel diff {rel:.2e}")
    if not rel <= BA_REL_TOL:
        bad.append(f"BA final cost GPU {dev} vs CPU {cpu}: rel {rel:.2e} > "
                   f"{BA_REL_TOL}")
    report_time("numerics phase", time.time() - t0)
    return bad


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-12)


def mesh_check(num_cards: int = 4, step_images: int = 256,
               step_keypoints: int = 2048, dense_images: int = 256,
               points: int = 49152, track: int = 4, cg_images: int = 1024,
               iterations: int = 100, chunk: int = 1024) -> list:
    """The in-process mesh path on `num_cards` devices against the same
    calls on a one-device mesh (device 0). Returns a list of
    (name, multi-card cost, one-card cost, relative difference).

    Each BA runs to LM convergence (function tolerance 1e-6, at most
    `iterations` trips) on a well-posed problem (`ring_bundle`): costs
    compared mid-descent measure how far two trajectories drifted apart,
    not the psum order the comparison is about, and on
    `_synthetic_bundle` at M=1024 (cameras on a line past the points) the
    CG solves of two shardings ended 1e-3 apart (PERF.md)."""
    import jax
    import numpy as np

    from __graft_entry__ import _synthetic_bundle, ring_bundle
    from scanner_colmap_tpu.parallel.dist_ba import distributed_bundle_adjust
    from scanner_colmap_tpu.parallel.mesh import make_mesh
    from scanner_colmap_tpu.parallel.step import make_distributed_step

    meshes = {n: make_mesh(num_devices=n) for n in (num_cards, 1)}
    out = []

    params, obs, cfg, desc, kp_valid = _synthetic_bundle(
        M=step_images, Pn=points, T=track, K=step_keypoints)
    res = {}
    for n, mesh in meshes.items():
        step = make_distributed_step(mesh, overlap=4, ba_iterations=iterations,
                                     chunk=chunk)
        t0 = time.time()
        idx, ok, _, info = jax.block_until_ready(
            step(desc, kp_valid, params, obs, cfg))
        report_time(f"mesh step {n} card(s) (cold)", time.time() - t0)
        res[n] = (np.asarray(idx), float(info["final_cost"]))
        log(f"mesh step {n} card(s): {int(info['iterations'])} LM trips")
    same = float(np.mean(res[num_cards][0] == res[1][0]))
    log(f"mesh step: {100 * same:.3f}% identical match indices")
    out.append(("step", res[num_cards][1], res[1][1],
                _rel(res[num_cards][1], res[1][1])))
    if same < 1.0:
        out.append(("step match indices", same, 1.0, 1.0 - same))

    for name, M, kw in (("dense BA", dense_images, {}),
                        ("CG BA", cg_images, {"solver": "cg",
                                              "cg_iters": 64})):
        params, obs, cfg = ring_bundle(M, points, track)
        costs = {}
        for n, mesh in meshes.items():
            t0 = time.time()
            _, info = jax.block_until_ready(distributed_bundle_adjust(
                mesh, params, obs, cfg, max_iterations=iterations,
                chunk=chunk, **kw))
            report_time(f"mesh {name} M={M} P={points} {n} card(s) (cold)",
                        time.time() - t0)
            costs[n] = float(info["final_cost"])
            log(f"mesh {name} {n} card(s): {int(info['iterations'])} LM trips")
        out.append((name, costs[num_cards], costs[1],
                    _rel(costs[num_cards], costs[1])))
    return out


def procs_config(image_dir: str, store_dir: str, overrides=None):
    """The process-per-card comparison runs the host mapper, which is what
    parallel/dist.py's mapping stage runs."""
    return pipeline_config(image_dir, store_dir,
                           {"mapper.mode": "host", **(overrides or {})})


def _timed_stages(tag: str, steps) -> None:
    """Run (name, fn) steps in order, printing each one's time and the sum."""
    t_all = time.time()
    for name, fn in steps:
        t0 = time.time()
        fn()
        report_time(f"{tag} {name} (cold)", time.time() - t0)
    report_time(f"{tag} sparse stages (cold)", time.time() - t_all)


def procs_reference(spec: dict) -> None:
    """Render the capture, then run the sparse stages on one card."""
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.store import ArtifactStore

    synth.generate_dataset(spec["image_dir"], num_images=spec["num_images"],
                           width=spec["width"], height=spec["height"],
                           focal=spec["focal"], num_blobs=spec["num_blobs"],
                           seed=spec["seed"])
    cfg = procs_config(spec["image_dir"], spec["ref_store"],
                       spec.get("overrides"))
    store = ArtifactStore(cfg.store_path)
    _timed_stages("procs one-card", [
        (name, lambda f=f: f(cfg, store)) for name, f in (
            ("prepare_images", stages.prepare_images),
            ("extraction", stages.run_extraction),
            ("matching", stages.run_matching),
            ("mapping", stages.run_mapping),
            ("merge", stages.run_merge))])


def procs_worker(spec: dict, pid: int) -> None:
    """One process of the process-per-card run (as tests/dist_worker.py)."""
    from scanner_colmap_tpu.parallel import dist

    if not dist.maybe_init_distributed(
            f"localhost:{spec['port']}", spec["num_cards"], pid,
            local_device_ids=[pid]):
        raise RuntimeError("jax.distributed did not initialize")
    import jax

    from scanner_colmap_tpu.pipeline import stages
    from scanner_colmap_tpu.utils.store import ArtifactStore

    log(f"worker {pid}: devices {jax.local_devices()}")
    cfg = procs_config(spec["image_dir"], spec["dist_store"],
                       spec.get("overrides"))
    store = ArtifactStore(cfg.store_path)

    def prepare():
        if pid == 0:
            stages.prepare_images(cfg, store)
        dist.barrier_via_store(store, "frames_ready", timeout_s=600)

    _timed_stages(f"procs worker {pid}/{spec['num_cards']}", [
        ("prepare_images", prepare)] + [
        (name, lambda f=f: f(cfg, store)) for name, f in (
            ("extraction", dist.run_extraction_distributed),
            ("matching", dist.run_matching_distributed),
            ("mapping", dist.run_mapping_distributed),
            ("merge", dist.run_merge_distributed))])


def procs_compare(spec: dict) -> list:
    """Verified pairs, registered sets and per-image trajectory error of
    the process-per-card run against the one-card run; returns failures."""
    import numpy as np

    from scanner_colmap_tpu.models import geometry as geom
    from scanner_colmap_tpu.pipeline import stages, synth
    from scanner_colmap_tpu.utils.store import ArtifactStore

    gt = synth.load_ground_truth(spec["image_dir"])
    stores = {k: ArtifactStore(spec[k]) for k in ("dist_store", "ref_store")}
    pairs = {k: {tuple(int(x) for x in p) for p in np.asarray(
        s.read_table("matching", columns=["pair_image_ids"])[
            "pair_image_ids"]).reshape(-1, 2)} for k, s in stores.items()}
    models = {k: stages.load_model(s) for k, s in stores.items()}
    regs = {k: sorted(m.registered_image_ids) for k, m in models.items()}

    def per_image_error(model):
        ids = sorted(model.registered_image_ids)
        est = np.stack([model.images[i].projection_center() for i in ids])
        ref = np.stack([np.asarray(geom.np_projection_center(
            gt["qvecs"][i], gt["tvecs"][i])) for i in ids])
        s, q, t = geom.np_umeyama_alignment(est, ref)
        err = np.linalg.norm(s * geom.np_quat_rotate(q, est) + t - ref,
                             axis=-1)
        return dict(zip(ids, err))

    errs = {k: per_image_error(m) for k, m in models.items()}
    ate = {k: float(np.sqrt(np.mean(np.square(list(e.values())))))
           for k, e in errs.items()}
    log(f"procs: verified pairs {len(pairs['dist_store'])} (processes) / "
        f"{len(pairs['ref_store'])} (one card); registered "
        f"{len(regs['dist_store'])} / {len(regs['ref_store'])}; ATE "
        f"{ate['dist_store']:.5f} / {ate['ref_store']:.5f}")
    bad = []
    if pairs["dist_store"] != pairs["ref_store"]:
        bad.append(f"verified pairs differ: "
                   f"{sorted(pairs['dist_store'] ^ pairs['ref_store'])}")
    if regs["dist_store"] != regs["ref_store"]:
        bad.append(f"registered sets differ: "
                   f"{sorted(set(regs['dist_store']) ^ set(regs['ref_store']))}")
    # per-image error within 10% of the one-card value, floored at the
    # one-card ATE so near-zero errors are not compared digit by digit
    worst = 0.0
    for i, e_ref in errs["ref_store"].items():
        if i in errs["dist_store"]:
            worst = max(worst, abs(errs["dist_store"][i] - e_ref)
                        / max(e_ref, ate["ref_store"]))
    log(f"procs: largest per-image trajectory error difference "
        f"{100 * worst:.3f}% (bar {100 * PROCS_ATE_TOL:.0f}%)")
    if worst > PROCS_ATE_TOL:
        bad.append(f"per-image trajectory error differs by {worst:.3f}")
    return bad


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_child(name: str, spec: dict, pid=None):
    args = [sys.executable, os.path.abspath(__file__), "--child", name,
            "--spec", json.dumps(spec)]
    if pid is not None:
        args += ["--pid", str(pid)]
    return subprocess.Popen(args, cwd=HERE)


def _wait(procs, timeout: float) -> None:
    deadline = time.time() + timeout
    try:
        for p in procs:
            rc = p.wait(timeout=max(deadline - time.time(), 1.0))
            if rc != 0:
                raise RuntimeError(f"child {p.args[3]} exited with {rc}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def four_cards(work_dir: str, num_cards: int = 4, mesh_sizes=None,
               num_images: int = PROCS_IMAGES, width: int = WIDTH,
               height: int = HEIGHT, focal: float = FOCAL,
               num_blobs: int = NUM_BLOBS, overrides=None,
               platform: str = "gpu", timeout: float = 1500.0) -> dict:
    """Run the two multi-card sub-phases, one child at a time; raises on a
    failed comparison. `mesh_sizes` are mesh_check keyword arguments.
    Returns the devices as the mesh child's JAX reported them."""
    spec = {"num_cards": num_cards, "platform": platform, "work_dir": work_dir,
            "mesh_sizes": mesh_sizes or {},
            "num_images": num_images, "width": width, "height": height,
            "focal": focal, "num_blobs": num_blobs, "seed": SEED,
            "overrides": overrides or {},
            "image_dir": os.path.join(work_dir, "images"),
            "ref_store": os.path.join(work_dir, "store_one_card"),
            "dist_store": os.path.join(work_dir, "store_processes")}
    t0 = time.time()
    _wait([_run_child("mesh", spec)], timeout)
    _wait([_run_child("procs_reference", spec)], timeout)
    spec["port"] = _free_port()
    _wait([_run_child("procs_worker", spec, p) for p in range(num_cards)],
          timeout)
    _wait([_run_child("procs_compare", spec)], timeout)
    report_time(f"{num_cards}-card phases", time.time() - t0)
    with open(os.path.join(work_dir, "device.json")) as f:
        return json.load(f)


def _child(name: str, spec: dict, pid) -> int:
    from scanner_colmap_tpu.utils.compile_cache import enable_compile_cache

    logging.basicConfig(
        level=logging.INFO,
        format=f"%(asctime)s {name}{'' if pid is None else pid} %(name)s "
               "%(levelname)s %(message)s")

    enable_compile_cache()
    import jax

    if spec["platform"] == "gpu":
        card_line()
    if name != "procs_worker":   # a worker must not touch JAX before init
        devs = jax.devices()
        if devs[0].platform != spec["platform"]:
            raise RuntimeError(f"child {name}: platform {devs[0].platform}")
    if name == "mesh":
        with open(os.path.join(spec["work_dir"], "device.json"), "w") as f:
            json.dump({"platform": devs[0].platform,
                       "kind": devs[0].device_kind, "count": len(devs)}, f)
        bad = []
        for what, multi, one, rel in mesh_check(spec["num_cards"],
                                                **spec["mesh_sizes"]):
            log(f"mesh {what}: {spec['num_cards']} cards {multi:.6f}, "
                f"one card {one:.6f}, rel diff {rel:.2e}")
            if not rel <= MESH_REL_TOL:
                bad.append(what)
        if bad:
            raise RuntimeError(f"mesh comparisons failed: {bad}")
    elif name == "procs_reference":
        procs_reference(spec)
    elif name == "procs_worker":
        procs_worker(spec, pid)
    elif name == "procs_compare":
        bad = procs_compare(spec)
        if bad:
            raise RuntimeError(f"process-per-card comparisons failed: {bad}")
    else:
        raise ValueError(f"unknown child {name!r}")
    return 0


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card paths")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--spec", help=argparse.SUPPRESS)
    ap.add_argument("--pid", type=int, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return _child(args.child, json.loads(args.spec), args.pid)

    t_start = time.time()
    try:
        if args.cards == 4:
            # a SIGTERM (a time limit) unwinds through _wait, which kills
            # the children it started
            signal.signal(signal.SIGTERM,
                          lambda signum, frame: sys.exit(128 + signum))
            # the parent stays off JAX: each child owns the cards it uses
            cards = card_line()
            log(f"cards:\n{cards}")
            if len(cards.splitlines()) < 4:
                raise RuntimeError(f"4 cards needed, nvidia-smi lists:\n{cards}")
            with tempfile.TemporaryDirectory() as work:
                device = four_cards(work)
        else:
            device = phase_device()
            from scanner_colmap_tpu.utils.compile_cache import (
                enable_compile_cache)

            log(f"compile cache: {enable_compile_cache()}")
            with tempfile.TemporaryDirectory() as work:
                res = phase_pipeline(work)
                print_pipeline(res)
                bad = pipeline_failures(res)
                bad += phase_numerics(res["store"])
            if bad:
                raise RuntimeError("; ".join(bad))
    except Exception as e:  # the script's boundary: report and fail
        import traceback

        traceback.print_exc()
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    report_time("chip_smoke total", time.time() - t_start)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
