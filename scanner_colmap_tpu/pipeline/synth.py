"""Synthetic dataset generator: renders an image collection with known
geometry for end-to-end tests, benchmarks, and ATE evaluation without
external data (the reference points at COLMAP's Gerrard Hall downloads,
README.md:70-71 — not available in a zero-egress environment).

Scene: a textured wall of Gaussian blobs + depth variation, viewed from a
translating/rotating camera track. Writes PNG images + ground-truth poses.
"""

from __future__ import annotations

import json
import os

import numpy as np

from scanner_colmap_tpu.models import geometry as geom
from scanner_colmap_tpu.utils import imgcodec


def generate_dataset(out_dir: str, num_images: int = 12, width: int = 320,
                     height: int = 240, focal: float = 300.0,
                     num_blobs: int = 400, seed: int = 0,
                     depth0: float = 8.0, depth_spread: float = 2.5,
                     track: str = "arc"):
    """Render images of a 3D blob field. Returns ground-truth dict.

    track="arc" (default): one left-to-right pass.
    track="out_and_back": the camera traverses the wall and RETURNS along
    the same path (slightly jittered) — late frames revisit early frames'
    views, so the collection contains genuine loop-closure pairs outside
    any matching window while keeping the well-conditioned forward-facing
    geometry (unlike the rotation-dominant cylinder of
    generate_loop_dataset)."""
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    # 3D feature field. Plain symmetric blobs are all alike — every
    # descriptor matches every other and the ratio test kills everything —
    # so each feature is a small 3D CONSTELLATION of 2-4 sub-blobs with
    # random offsets/sizes/signed amplitudes: locally unique appearance
    # that moves rigidly and consistently under viewpoint change.
    # Features sit on a SMOOTH SURFACE (undulating wall), not a random 3D
    # cloud: with independent random depths, neighboring features slide past
    # each other by many pixels per view and descriptor windows (which span
    # several features) never repeat — no descriptor could match that. Real
    # scenes are locally surface-like, which is what SIFT assumes.
    # constant PER-FRAME baseline: a fixed total track length made pair
    # baselines shrink with num_images until every two-view geometry
    # degenerated to PLANAR_OR_PANORAMIC (~1.4 deg triangulation angles at
    # 96 frames) and no cluster could find an initial pair. The wall grows
    # with the track, and blob count scales with wall area so feature
    # density per view stays constant.
    step = 0.055 * depth0
    # out_and_back covers the wall twice, so its spatial extent is half
    n_span = max(num_images - 1, 1)
    if track == "out_and_back":
        n_span = max((num_images - 1) / 2.0, 1.0)
    track_half = 0.5 * step * n_span
    span = track_half + 0.9 * depth0
    num_blobs = int(num_blobs * span / (0.9 * depth0))
    cx_ = rng.uniform(-span, span, num_blobs)
    cy_ = rng.uniform(-depth0 * 0.675, depth0 * 0.675, num_blobs)

    def surface_z(x, y):
        return depth0 + depth_spread * (
            0.5 * np.sin(0.45 * x) * np.cos(0.35 * y) + 0.25 * np.sin(0.9 * y))

    centers = np.stack([cx_, cy_, surface_z(cx_, cy_)], axis=1)
    sub_pts, sub_sizes, sub_amps = [], [], []
    for c in centers:
        k = rng.integers(2, 5)
        offs = np.zeros((k, 3))
        # in-surface offsets only (z follows the surface): stable appearance
        offs[1:, :2] = rng.uniform(-0.12, 0.12, size=(k - 1, 2)) * depth0 / 8.0
        amp0 = rng.uniform(0.5, 1.0)
        for m in range(k):
            p = c + offs[m]
            p[2] = surface_z(p[0], p[1])
            sub_pts.append(p)
            sub_sizes.append(rng.uniform(3.0, 7.0) if m == 0
                             else rng.uniform(1.8, 4.0))
            sub_amps.append(amp0 if m == 0
                            else rng.uniform(0.3, 0.9) * rng.choice([-1.0, 1.0]))
    pts = np.asarray(sub_pts)
    sizes = np.asarray(sub_sizes)
    amps = np.abs(np.asarray(sub_amps))
    signs = np.sign(np.asarray(sub_amps))
    # ground-truth 3D points = the feature centers
    gt_points = centers

    qs, ts = [], []
    for i in range(num_images):
        # arc track looking inward; out_and_back folds the parameter so the
        # return leg revisits the same wall positions (with a different
        # bob/yaw phase, so revisit poses are close but not identical)
        u = i / max(num_images - 1, 1)
        if track == "out_and_back":
            u2 = 2.0 * u
            frac = (u2 if u2 <= 1.0 else 2.0 - u2) - 0.5
            yaw = -frac * 0.5 + 0.03 * np.sin(u2 * 2.3)
            bob = 0.15 * np.sin(u2 * 3.7)
        else:
            frac = u - 0.5
            yaw = -frac * 0.5
            bob = 0.15 * np.sin(frac * 6)
        aa = np.array([0.0, yaw, 0.0])
        q = geom.np_angle_axis_to_quat(aa)
        C = np.array([frac * 2 * track_half, bob, 0.0])
        t = -np.asarray(geom.np_quat_rotate(q, C))
        qs.append(q)
        ts.append(t)

    _render_blob_frames(out_dir, pts, sizes, amps, signs, qs, ts,
                        width, height, focal)

    gt = {
        "focal": focal, "width": width, "height": height,
        "qvecs": [q.tolist() for q in qs],
        "tvecs": [t.tolist() for t in ts],
        "points": gt_points.tolist(),
        # the analytic surface (dense-phase accuracy evaluation)
        "surface": {"depth0": depth0, "depth_spread": depth_spread},
    }
    with open(os.path.join(out_dir, "ground_truth.json"), "w") as f:
        json.dump(gt, f)
    return gt


def _render_blob_frames(out_dir, pts, sizes, amps, signs, qs, ts,
                        width, height, focal):
    """Splat the blob field into gray PNG frames for the given poses.

    Each PNG carries an eXIf chunk with the camera's focal tags, like real
    photos: exercises the extraction stage's EXIF camera-prior path
    (reference extraction_op.cc:49-55 reads EXIF focal length)."""
    exif = _camera_exif(focal, width)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    cx, cy = width / 2.0, height / 2.0
    for i in range(len(qs)):
        x_cam = np.asarray(geom.np_pose_transform(qs[i], ts[i], pts))
        vis = x_cam[:, 2] > 1.0
        u = focal * x_cam[:, 0] / np.where(vis, x_cam[:, 2], 1.0) + cx
        v = focal * x_cam[:, 1] / np.where(vis, x_cam[:, 2], 1.0) + cy
        # perspective blob size
        s_px = sizes * focal / np.where(vis, x_cam[:, 2], 1.0) / 40.0
        img = np.full((height, width), 0.15)
        # vectorized candidate cull: at 1k-frame scale the wall holds ~50k
        # blobs and a python loop over all of them per frame dominates
        cand = vis & (u >= -20) & (u <= width + 20) & (v >= -20) & (v <= height + 20)
        for b in np.nonzero(cand)[0]:
            s = max(s_px[b], 1.2)
            r = int(4 * s) + 1
            y0, y1 = max(int(v[b]) - r, 0), min(int(v[b]) + r + 1, height)
            x0, x1 = max(int(u[b]) - r, 0), min(int(u[b]) + r + 1, width)
            if y1 <= y0 or x1 <= x0:
                continue
            patch = np.exp(-((xx[y0:y1, x0:x1] - u[b]) ** 2
                             + (yy[y0:y1, x0:x1] - v[b]) ** 2) / (2 * s * s))
            img[y0:y1, x0:x1] += signs[b] * amps[b] * patch
        img = np.clip(img, 0, 1)
        imgcodec.write_png(os.path.join(out_dir, f"image_{i:04d}.png"),
                           (img * 255).astype(np.uint8), exif=exif)


def generate_loop_dataset(out_dir: str, num_images: int = 48,
                          width: int = 480, height: int = 360,
                          focal: float = 300.0, num_blobs: int = 1200,
                          seed: int = 0, radius: float = 8.0,
                          cam_radius: float = 2.0,
                          depth_spread: float = 1.2):
    """Closed-circuit camera track: cameras on a circle of radius
    ``cam_radius`` looking OUTWARD at a textured cylinder wall of radius
    ``radius``. Frame 0 and frame N-1 observe the same wall sector, so the
    collection contains a genuine loop — the constraint windowed matching
    cannot represent (reference marks loop detection unsupported,
    colmap.proto:56-57) and the one that bounds long-trajectory drift
    (PERFORMANCE.md Known bounds). Returns the generate_dataset gt schema.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(out_dir, exist_ok=True)

    depth = radius - cam_radius
    y_half = depth * (0.5 * height / focal) * 1.4 + 0.2
    theta = rng.uniform(0.0, 2 * np.pi, num_blobs)
    ys = rng.uniform(-y_half, y_half, num_blobs)

    def wall_r(th, y):
        return radius + depth_spread * (
            0.5 * np.sin(3.0 * th) * np.cos(0.35 * y) + 0.25 * np.sin(0.9 * y))

    def wall_pt(th, y):
        r = wall_r(th, y)
        return np.stack([r * np.sin(th), y, r * np.cos(th)], axis=-1)

    centers = wall_pt(theta, ys)
    sub_pts, sub_sizes, sub_amps = [], [], []
    dth_scale = 0.12 / 8.0 * radius / max(radius, 1e-6)  # ~constellation span
    for b in range(num_blobs):
        k = rng.integers(2, 5)
        amp0 = rng.uniform(0.5, 1.0)
        for mth in range(k):
            if mth == 0:
                th2, y2 = theta[b], ys[b]
            else:
                th2 = theta[b] + rng.uniform(-dth_scale, dth_scale)
                y2 = ys[b] + rng.uniform(-0.12, 0.12)
            sub_pts.append(wall_pt(np.asarray(th2), np.asarray(y2)))
            sub_sizes.append(rng.uniform(3.0, 7.0) if mth == 0
                             else rng.uniform(1.8, 4.0))
            sub_amps.append(amp0 if mth == 0
                            else rng.uniform(0.3, 0.9) * rng.choice([-1.0, 1.0]))
    pts = np.asarray(sub_pts)
    sizes = np.asarray(sub_sizes)
    amps = np.abs(np.asarray(sub_amps))
    signs = np.sign(np.asarray(sub_amps))

    qs, ts = [], []
    for i in range(num_images):
        phi = 2 * np.pi * i / num_images
        q = geom.np_angle_axis_to_quat(np.array([0.0, -phi, 0.0]))
        C = np.array([cam_radius * np.sin(phi),
                      0.1 * np.sin(3 * phi),
                      cam_radius * np.cos(phi)])
        t = -np.asarray(geom.np_quat_rotate(q, C))
        qs.append(np.asarray(q))
        ts.append(t)

    _render_blob_frames(out_dir, pts, sizes, amps, signs, qs, ts,
                        width, height, focal)
    gt = {
        "focal": focal, "width": width, "height": height,
        "qvecs": [q.tolist() for q in qs],
        "tvecs": [t.tolist() for t in ts],
        "points": centers.tolist(),
        "loop": True,
    }
    with open(os.path.join(out_dir, "ground_truth.json"), "w") as f:
        json.dump(gt, f)
    return gt


def _camera_exif(focal: float, width: int) -> bytes:
    """EXIF block a real camera would write: precise FocalLength (mm,
    rational) + FocalPlane resolution tags (virtual 36 mm sensor), plus the
    integer FocalLengthIn35mmFilm fallback (its ~2% rounding is real EXIF
    behavior; the precise tags take priority in ops/image.exif_focal_px).
    TIFF-structured bytes: a PNG eXIf chunk as is, a JPEG APP1 segment
    after the "Exif" marker."""
    return imgcodec.make_exif({
        imgcodec.TAG_FOCAL_LENGTH: round(focal * 36.0 / width, 4),
        imgcodec.TAG_FOCAL_PLANE_X_RES: round(width / 3.6, 4),
        imgcodec.TAG_FOCAL_PLANE_RES_UNIT: 3,            # cm
        imgcodec.TAG_EXIF_IMAGE_WIDTH: width,
        imgcodec.TAG_FOCAL_35MM: int(round(focal * 36.0 / width)),
    })


DEFAULT_TEXTURE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "tests", "data",
    "grace_hopper.jpg")


def _composite_bumps(rng, num_bumps: int, half_x: float, half_y: float,
                     depth0: float):
    """Random smooth plateaus protruding from the wall (toward the camera):
    [cx, cy, radius, height, edge_width] per bump. Real scenes are not
    single smooth reliefs; these create genuine depth discontinuity-like
    structure (steep tanh edges) and occlusion boundaries."""
    bumps = []
    for _ in range(num_bumps):
        r = rng.uniform(0.10, 0.22) * depth0
        bumps.append([rng.uniform(-0.7 * half_x, 0.7 * half_x),
                      rng.uniform(-0.6 * half_y, 0.6 * half_y),
                      r, rng.uniform(0.08, 0.18) * depth0, 0.25 * r])
    return bumps


def _surface_with_bumps(x, y, depth0, depth_spread, bumps):
    z = depth0 + depth_spread * (
        0.5 * np.sin(0.45 * x) * np.cos(0.35 * y) + 0.25 * np.sin(0.9 * y))
    for (bx, by, r, h, w) in bumps or []:
        d = np.sqrt((x - bx) ** 2 + (y - by) ** 2)
        # plateau toward the camera (smaller z); tanh edge of width w
        z = z - 0.5 * h * (1.0 - np.tanh((d - r) / w))
    return z


def _march_rays(C, d, surface_z, z_lo, z_hi, coarse: int = 64,
                bisect: int = 24):
    """Robust per-pixel ray/heightfield intersection: coarse sampling for
    the FIRST sign change of z_ray - surface(x, y) along each ray, then
    bisection. Unlike fixed-point iteration this converges for steep
    composite surfaces (|grad| >~ 1) and picks the NEAREST hit, giving
    correct occlusion at bump silhouettes."""
    dz = d[..., 2]
    s_lo = (z_lo - C[2]) / dz
    s_hi = (z_hi - C[2]) / dz

    def g(s):
        px = C[0] + s * d[..., 0]
        py = C[1] + s * d[..., 1]
        pz = C[2] + s * dz
        return pz - surface_z(px, py)

    # coarse scan: first index where g >= 0 (ray passed the surface)
    a = s_lo.copy()
    b = s_hi.copy()
    found = np.zeros(a.shape, bool)
    prev = a.copy()
    for k in range(coarse + 1):
        s = s_lo + (s_hi - s_lo) * (k / coarse)
        hit = (g(s) >= 0) & ~found
        a = np.where(hit, prev, a)
        b = np.where(hit, s, b)
        found |= hit
        prev = s
    for _ in range(bisect):
        mid = 0.5 * (a + b)
        gm = g(mid)
        a = np.where(gm < 0, mid, a)
        b = np.where(gm < 0, b, mid)
    return 0.5 * (a + b)


def generate_real_texture_dataset(out_dir: str, num_images: int = 10,
                                  width: int = 480, height: int = 400,
                                  focal: float = 450.0, seed: int = 0,
                                  depth0: float = 6.0,
                                  depth_spread: float = 0.9,
                                  texture_path: str | None = None,
                                  jpeg_quality: int = 92,
                                  num_bumps: int = 0,
                                  exposure_jitter: float = 0.0,
                                  noise_std: float = 0.0,
                                  motion_blur_px: int = 0):
    """Render views of a 3D relief surface textured with a REAL PHOTOGRAPH.

    The reference's only demonstrated capability is a reconstruction of
    real photographs (Gerrard Hall, /root/reference/README.md:5-6); with
    zero egress the closest attainable validation is real natural-image
    pixels under exactly known geometry: the committed public-domain
    photograph tests/data/grace_hopper.jpg (1984 US Navy portrait — rich
    face/fabric/book texture) is mapped onto an undulating surface and
    rendered through real pinhole cameras with per-pixel ray marching, then
    saved as EXIF-tagged JPEGs. This exercises JPEG decode, the EXIF focal
    prior, SIFT on natural texture, and full-pipeline ATE against exact
    ground truth — everything the blob renderer cannot.

    Returns the ground-truth dict (same schema as generate_dataset; the
    surface matches gt_surface_z so evaluate_dense works unchanged).

    Real-camera statistics knobs (round-3 hardening):
      num_bumps       composite non-planar geometry — smooth plateaus
                      protruding toward the camera, with occlusion edges
      exposure_jitter per-image gain in [1-j, 1+j] + gamma in [1-j/2, 1+j/2]
                      (auto-exposure / lighting variation between shots)
      noise_std       Gaussian sensor noise, DN (0-255 scale), before JPEG
      motion_blur_px  1D box blur length along the track direction
    """
    from PIL import Image as PILImage

    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    tex_path = texture_path or DEFAULT_TEXTURE
    with PILImage.open(tex_path) as tim:
        tex = np.asarray(tim.convert("RGB")).astype(np.float64)
    th, tw = tex.shape[:2]

    # camera track: translate along x with slight inward yaw (same pattern
    # as generate_dataset so pair baselines are healthy at any num_images)
    step = 0.055 * depth0
    track_half = 0.5 * step * max(num_images - 1, 1)
    qs, ts = [], []
    for i in range(num_images):
        frac = i / max(num_images - 1, 1) - 0.5
        aa = np.array([0.0, -frac * 0.35, 0.0])
        q = geom.np_angle_axis_to_quat(aa)
        C = np.array([frac * 2 * track_half, 0.1 * np.sin(frac * 5), 0.0])
        t = -np.asarray(geom.np_quat_rotate(q, C))
        qs.append(q)
        ts.append(t)

    # wall extent: everything any camera can see (plus margin) maps INSIDE
    # the photo — no tiling, no repeated texture to confuse the ratio test
    half_x = track_half + depth0 * (0.5 * width / focal) * 1.35
    half_y = depth0 * (0.5 * height / focal) * 1.3 + 0.2

    bumps = _composite_bumps(rng, num_bumps, half_x, half_y, depth0)

    def surface_z(x, y):
        return _surface_with_bumps(x, y, depth0, depth_spread, bumps)

    def sample_texture(x, y):
        # world (x, y) -> texture pixel, bilinear
        u = (x + half_x) / (2 * half_x) * (tw - 1)
        v = (y + half_y) / (2 * half_y) * (th - 1)
        u = np.clip(u, 0.0, tw - 1.001)
        v = np.clip(v, 0.0, th - 1.001)
        u0 = np.floor(u).astype(np.int64)
        v0 = np.floor(v).astype(np.int64)
        fu = (u - u0)[..., None]
        fv = (v - v0)[..., None]
        c = (tex[v0, u0] * (1 - fu) * (1 - fv)
             + tex[v0, u0 + 1] * fu * (1 - fv)
             + tex[v0 + 1, u0] * (1 - fu) * fv
             + tex[v0 + 1, u0 + 1] * fu * fv)
        return c

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    cx, cy = width / 2.0, height / 2.0
    for i in range(num_images):
        R = np.asarray(geom.np_quat_to_rotmat(qs[i]))
        C = -R.T @ ts[i]
        # world-frame ray directions for every pixel
        dc = np.stack([(xx - cx) / focal, (yy - cy) / focal,
                       np.ones_like(xx)], axis=-1)
        d = dc @ R  # R^T applied row-wise
        # coarse-scan + bisection ray marching: converges on the composite
        # (bumped) surface and resolves occlusion at bump silhouettes,
        # where fixed-point iteration diverges
        # overlapping bumps stack — bound the near plane by the SUM of
        # heights, not the max
        h_max = sum(b[3] for b in bumps)
        s = _march_rays(C, d, surface_z,
                        depth0 - depth_spread - h_max - 0.2,
                        depth0 + depth_spread + 0.2)
        px = C[0] + s * d[..., 0]
        py = C[1] + s * d[..., 1]
        img = np.clip(sample_texture(px, py), 0, 255)
        if exposure_jitter > 0:
            gain = rng.uniform(1 - exposure_jitter, 1 + exposure_jitter)
            gamma = rng.uniform(1 - 0.5 * exposure_jitter,
                                1 + 0.5 * exposure_jitter)
            img = 255.0 * np.clip(gain * (img / 255.0) ** gamma, 0, 1)
        if motion_blur_px > 1:
            k = int(motion_blur_px)
            acc = np.zeros_like(img)
            for o in range(k):  # 1D box blur along the (x) track direction
                acc += np.roll(img, o - k // 2, axis=1)
            img = acc / k
        if noise_std > 0:
            img = img + rng.normal(0.0, noise_std, img.shape)
        img = np.clip(img, 0, 255).astype(np.uint8)
        pil = PILImage.fromarray(img, "RGB")
        pil.save(os.path.join(out_dir, f"image_{i:04d}.jpg"),
                 quality=jpeg_quality,
                 exif=b"Exif\x00\x00" + _camera_exif(focal, width))

    gt = {
        "focal": focal, "width": width, "height": height,
        "qvecs": [q.tolist() for q in qs],
        "tvecs": [t.tolist() for t in ts],
        "points": [],
        "surface": {"depth0": depth0, "depth_spread": depth_spread,
                    "bumps": bumps},
        "texture": os.path.basename(tex_path),
    }
    with open(os.path.join(out_dir, "ground_truth.json"), "w") as f:
        json.dump(gt, f)
    return gt


def load_ground_truth(image_dir: str):
    with open(os.path.join(image_dir, "ground_truth.json")) as f:
        gt = json.load(f)
    gt["qvecs"] = np.asarray(gt["qvecs"])
    gt["tvecs"] = np.asarray(gt["tvecs"])
    gt["points"] = np.asarray(gt["points"])
    return gt


def evaluate_ate(rec, gt, id_order=None):
    """RMS absolute trajectory error after Sim(3) alignment (the eval the
    driver's north star asks for: ATE vs reference trajectories)."""
    est, ref = [], []
    for iid in rec.registered_image_ids:
        est.append(rec.images[iid].projection_center())
        ref.append(np.asarray(geom.np_projection_center(
            gt["qvecs"][iid], gt["tvecs"][iid])))
    if len(est) < 3:
        return float("inf")
    est, ref = np.stack(est), np.stack(ref)
    # host numpy: evaluation-only, and the image count varies per call
    s, q, t = geom.np_umeyama_alignment(est, ref)
    aligned = s * geom.np_quat_rotate(q, est) + t
    return float(np.sqrt(np.mean(np.sum((aligned - ref) ** 2, axis=-1))))


def gt_surface_z(gt, x, y):
    """Analytic scene surface z(x, y) (matches the generators, including
    composite bumps when present)."""
    d0 = gt["surface"]["depth0"]
    ds = gt["surface"]["depth_spread"]
    return _surface_with_bumps(x, y, d0, ds, gt["surface"].get("bumps"))


def evaluate_dense(rec, gt, fused_xyz):
    """Median/p90 distance of fused points to the known scene surface,
    after aligning the model to GT by its trajectory Sim(3) (the dense
    counterpart of evaluate_ate; measures depth-map + fusion accuracy,
    normalized by scene depth)."""
    est, ref = [], []
    for iid in rec.registered_image_ids:
        est.append(rec.images[iid].projection_center())
        ref.append(np.asarray(geom.np_projection_center(
            gt["qvecs"][iid], gt["tvecs"][iid])))
    if len(est) < 3 or len(fused_xyz) == 0:
        return {"median_rel": float("inf"), "p90_rel": float("inf")}
    s, q, t = geom.np_umeyama_alignment(np.stack(est), np.stack(ref))
    pts = s * geom.np_quat_rotate(q, np.asarray(fused_xyz, np.float64)) + t
    dz = np.abs(pts[:, 2] - gt_surface_z(gt, pts[:, 0], pts[:, 1]))
    d0 = gt["surface"]["depth0"]
    return {"median_rel": float(np.median(dz) / d0),
            "p90_rel": float(np.percentile(dz, 90) / d0)}


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("out_dir")
    ap.add_argument("--num_images", type=int, default=12)
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    generate_dataset(a.out_dir, a.num_images, a.width, a.height, seed=a.seed)
    print(f"wrote {a.num_images} images to {a.out_dir}")
