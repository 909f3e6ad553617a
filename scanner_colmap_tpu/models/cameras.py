"""Camera models — jittable, batched, COLMAP-compatible.

Reference behavior being matched: the reference synthesizes a per-image
camera from EXIF focal length or a default focal factor
(/root/reference/integration/op_cpp/extraction_op.cc:43-64) and serializes
COLMAP camera structs (io.cc:307-370). COLMAP model ids supported here:

  0 SIMPLE_PINHOLE (f, cx, cy)
  1 PINHOLE        (fx, fy, cx, cy)
  2 SIMPLE_RADIAL  (f, cx, cy, k)
  3 RADIAL         (f, cx, cy, k1, k2)
  4 OPENCV         (fx, fy, cx, cy, k1, k2, p1, p2)

For jit-friendliness every camera is carried as a fixed-size params row of
MAX_CAM_PARAMS floats plus an int model id; all models are normalized into a
canonical (fx, fy, cx, cy, k1, k2, p1, p2) tuple with arithmetic selection
(no data-dependent Python control flow), so one projection code path serves
every model and vmaps cleanly over mixed-model camera sets.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

MAX_CAM_PARAMS = 8

SIMPLE_PINHOLE = 0
PINHOLE = 1
SIMPLE_RADIAL = 2
RADIAL = 3
OPENCV = 4

MODEL_NUM_PARAMS = {
    SIMPLE_PINHOLE: 3,
    PINHOLE: 4,
    SIMPLE_RADIAL: 4,
    RADIAL: 5,
    OPENCV: 8,
}
MODEL_NAMES = {
    SIMPLE_PINHOLE: "SIMPLE_PINHOLE",
    PINHOLE: "PINHOLE",
    SIMPLE_RADIAL: "SIMPLE_RADIAL",
    RADIAL: "RADIAL",
    OPENCV: "OPENCV",
}
MODEL_IDS = {v: k for k, v in MODEL_NAMES.items()}


def pad_params(params, model_id: int):
    """Pad a python list of params to a MAX_CAM_PARAMS row."""
    import numpy as np

    p = np.zeros(MAX_CAM_PARAMS, dtype=np.float64)
    p[: len(params)] = params
    return p


def canonical_intrinsics(model_id: jax.Array, params: jax.Array):
    """Normalize any supported model to (fx, fy, cx, cy, k1, k2, p1, p2).

    model_id: (...,) int32; params: (..., MAX_CAM_PARAMS).
    """
    p = params
    is_sp = model_id == SIMPLE_PINHOLE
    is_ph = model_id == PINHOLE
    is_sr = model_id == SIMPLE_RADIAL
    is_ra = model_id == RADIAL
    is_cv = model_id == OPENCV

    # focal
    single_f = is_sp | is_sr | is_ra
    fx = jnp.where(single_f, p[..., 0], p[..., 0])
    fy = jnp.where(single_f, p[..., 0], p[..., 1])
    cx = jnp.where(single_f, p[..., 1], p[..., 2])
    cy = jnp.where(single_f, p[..., 2], p[..., 3])
    k1 = jnp.where(is_sr | is_ra, p[..., 3], jnp.where(is_cv, p[..., 4], 0.0))
    k2 = jnp.where(is_ra, p[..., 4], jnp.where(is_cv, p[..., 5], 0.0))
    p1 = jnp.where(is_cv, p[..., 6], 0.0)
    p2 = jnp.where(is_cv, p[..., 7], 0.0)
    del is_ph
    return fx, fy, cx, cy, k1, k2, p1, p2


def distort(k1, k2, p1, p2, xy: jax.Array) -> jax.Array:
    """Apply radial+tangential distortion to normalized coords (..., 2)."""
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return jnp.stack([dx, dy], axis=-1)


def undistort(k1, k2, p1, p2, xy: jax.Array, num_iters: int = 10) -> jax.Array:
    """Invert `distort` by fixed-point iteration (jit-safe fixed trip count)."""
    def body(_, est):
        d = distort(k1, k2, p1, p2, est)
        return est + (xy - d)

    return jax.lax.fori_loop(0, num_iters, body, xy)


def cam_to_image(model_id: jax.Array, params: jax.Array, x_cam: jax.Array) -> jax.Array:
    """Project camera-frame 3D points (..., 3) to pixel coords (..., 2).

    Points behind the camera still produce coordinates (z clamped away from 0);
    callers must gate on z > 0 for cheirality.
    """
    fx, fy, cx, cy, k1, k2, p1, p2 = canonical_intrinsics(model_id, params)
    z = x_cam[..., 2]
    zs = jnp.where(jnp.abs(z) < 1e-9, jnp.where(z < 0, -1e-9, 1e-9), z)
    xy = x_cam[..., :2] / zs[..., None]
    d = distort(k1, k2, p1, p2, xy)
    u = fx * d[..., 0] + cx
    v = fy * d[..., 1] + cy
    return jnp.stack([u, v], axis=-1)


def image_to_cam(model_id: jax.Array, params: jax.Array, uv: jax.Array) -> jax.Array:
    """Pixel coords (..., 2) -> normalized camera ray coords (..., 2) (z=1 plane)."""
    fx, fy, cx, cy, k1, k2, p1, p2 = canonical_intrinsics(model_id, params)
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    xy = jnp.stack([x, y], axis=-1)
    return undistort(k1, k2, p1, p2, xy)


def calibration_matrix(model_id: jax.Array, params: jax.Array) -> jax.Array:
    """(..., 3, 3) K matrix (ignores distortion)."""
    fx, fy, cx, cy, *_ = canonical_intrinsics(model_id, params)
    z = jnp.zeros_like(fx)
    o = jnp.ones_like(fx)
    K = jnp.stack([fx, z, cx, z, fy, cy, z, z, o], axis=-1)
    return K.reshape(jnp.shape(fx) + (3, 3))


def mean_focal(model_id: jax.Array, params: jax.Array) -> jax.Array:
    fx, fy, *_ = canonical_intrinsics(model_id, params)
    return 0.5 * (fx + fy)


def np_canonical_intrinsics(model_id, params):
    """Vectorized numpy canonicalization to (fx, fy, cx, cy, k1, k2, p1, p2).

    model_id: (...,) int array; params: (..., MAX_CAM_PARAMS) padded rows.
    Host control-plane mirror of `canonical_intrinsics` (no jax dispatch).
    """
    import numpy as np

    p = np.asarray(params, np.float64)
    m = np.asarray(model_id)
    single_f = (m == SIMPLE_PINHOLE) | (m == SIMPLE_RADIAL) | (m == RADIAL)
    is_sr = m == SIMPLE_RADIAL
    is_ra = m == RADIAL
    is_cv = m == OPENCV
    fx = p[..., 0]
    fy = np.where(single_f, p[..., 0], p[..., 1])
    cx = np.where(single_f, p[..., 1], p[..., 2])
    cy = np.where(single_f, p[..., 2], p[..., 3])
    k1 = np.where(is_sr | is_ra, p[..., 3], np.where(is_cv, p[..., 4], 0.0))
    k2 = np.where(is_ra, p[..., 4], np.where(is_cv, p[..., 5], 0.0))
    p1 = np.where(is_cv, p[..., 6], 0.0)
    p2 = np.where(is_cv, p[..., 7], 0.0)
    return fx, fy, cx, cy, k1, k2, p1, p2


def np_distort(k1, k2, p1, p2, xy):
    """Numpy radial+tangential distortion on normalized coords (..., 2)."""
    import numpy as np

    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([dx, dy], axis=-1)


def np_image_to_cam(model_id, params, uv, num_iters: int = 10):
    """Numpy pixel -> normalized ray coords; fixed-point undistortion.

    Host control-plane mirror of `image_to_cam`: the engine normalizes
    per-image keypoint sets in inner loops where a device round trip per
    call would dominate.
    """
    import numpy as np

    fx, fy, cx, cy, k1, k2, p1, p2 = np_canonical_intrinsics(model_id, params)
    uv = np.asarray(uv, np.float64)
    x = (uv[..., 0] - cx) / fx
    y = (uv[..., 1] - cy) / fy
    xy = np.stack([x, y], axis=-1)
    est = xy
    for _ in range(num_iters):
        est = est + (xy - np_distort(k1, k2, p1, p2, est))
    return est


def np_cam_to_image(model_id: int, params, x_cam):
    """Numpy projection for host control-plane loops (engine filtering):
    same canonical model as cam_to_image, no jax dispatch."""
    import numpy as np

    p = np.asarray(params)
    x_cam = np.asarray(x_cam)
    single_f = model_id in (SIMPLE_PINHOLE, SIMPLE_RADIAL, RADIAL)
    fx = p[0]
    fy = p[0] if single_f else p[1]
    cx = p[1] if single_f else p[2]
    cy = p[2] if single_f else p[3]
    if model_id == SIMPLE_RADIAL:
        k1, k2, p1, p2 = p[3], 0.0, 0.0, 0.0
    elif model_id == RADIAL:
        k1, k2, p1, p2 = p[3], p[4], 0.0, 0.0
    elif model_id == OPENCV:
        k1, k2, p1, p2 = p[4], p[5], p[6], p[7]
    else:
        k1 = k2 = p1 = p2 = 0.0
    z = x_cam[..., 2]
    zs = np.where(np.abs(z) < 1e-9, np.where(z < 0, -1e-9, 1e-9), z)
    x = x_cam[..., 0] / zs
    y = x_cam[..., 1] / zs
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * k2)
    dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return np.stack([fx * dx + cx, fy * dy + cy], axis=-1)


def make_simple_radial(focal, cx, cy, k=0.0):
    """Convenience constructor returning a padded params row (host-side)."""
    import numpy as np

    p = np.zeros(MAX_CAM_PARAMS, dtype=np.float64)
    p[:4] = [focal, cx, cy, k]
    return p


def camera_from_exif(width: int, height: int, exif_focal_px: float | None,
                     default_focal_factor: float = 1.2):
    """EXIF-or-default camera init, matching the reference's rule
    (extraction_op.cc:43-64): focal = EXIF focal in pixels when present, else
    default_focal_factor * max(width, height); principal point at center.

    Returns (model_id, params_row, has_prior_focal).
    """
    import numpy as np

    if exif_focal_px is not None and exif_focal_px > 0:
        focal = float(exif_focal_px)
        prior = True
    else:
        focal = default_focal_factor * max(width, height)
        prior = False
    p = np.zeros(MAX_CAM_PARAMS, dtype=np.float64)
    p[:4] = [focal, width / 2.0, height / 2.0, 0.0]
    return SIMPLE_RADIAL, p, prior
