"""Numpy twins of the camera-model projections for host-side calls.

Port of ``pycolmap_tpu/ops/camera_models_np.py``, the reference's own host
projection of the 11 models (same parameter layout as
:mod:`pycolmap_torch.ops.camera_models`). The scene layer's bookkeeping
(track merging, completion, filtering, reprojection errors) projects through
these in float64. Inverse distortion uses the same fixed-iteration Newton
scheme with central-difference Jacobians (the upstream IterativeUndistortion
approach).
"""

from __future__ import annotations

import numpy as np

from pycolmap_torch.ops.camera_models import CAMERA_MODEL_BY_ID


def _radial(params, uv, ks):
    r2 = np.sum(uv * uv, axis=-1, keepdims=True)
    radial = np.ones_like(r2)
    rpow = r2.copy()
    for k in ks:
        radial = radial + params[k] * rpow
        rpow = rpow * r2
    return uv * radial


def _opencv(params, uv, k_idxs, p_idxs):
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r2 = u * u + v * v
    radial = np.ones_like(r2)
    rpow = r2.copy()
    for k in k_idxs:
        radial = radial + params[k] * rpow
        rpow = rpow * r2
    p1, p2 = params[p_idxs[0]], params[p_idxs[1]]
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return np.concatenate([du, dv], axis=-1)


def _full_opencv(params, uv):
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    k1, k2, p1, p2, k3, k4, k5, k6 = (params[i] for i in range(4, 12))
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return np.concatenate([du, dv], axis=-1)


def _fov(params, uv):
    omega = params[4]
    r = np.sqrt(np.sum(uv * uv, axis=-1, keepdims=True))
    if abs(omega) < 1e-8:
        return uv
    tan_half = np.tan(0.5 * omega)
    with np.errstate(invalid="ignore", divide="ignore"):
        factor = np.where(
            r > 1e-8, np.arctan(2.0 * r * tan_half) / (r * omega),
            2.0 * tan_half / omega,
        )
    return uv * factor


def _fov_inv(params, uv):
    omega = params[4]
    if abs(omega) < 1e-8:
        return uv
    r = np.sqrt(np.sum(uv * uv, axis=-1, keepdims=True))
    tan_half = np.tan(0.5 * omega)
    with np.errstate(invalid="ignore", divide="ignore"):
        factor = np.where(
            r > 1e-8, np.tan(r * omega) / (2.0 * r * tan_half),
            omega / (2.0 * tan_half),
        )
    return uv * factor


def _opencv_fisheye(params, uv):
    r = np.sqrt(np.sum(uv * uv, axis=-1, keepdims=True))
    theta = np.arctan(r)
    t2 = theta * theta
    k1, k2, k3, k4 = (params[i] for i in range(4, 8))
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = np.where(r > 1e-8, theta_d / np.maximum(r, 1e-12), 1.0)
    return uv * scale


def _fisheye_wrap(fn):
    def wrapped(params, uv):
        r = np.sqrt(np.sum(uv * uv, axis=-1, keepdims=True))
        theta = np.arctan(r)
        scale = np.where(r > 1e-8, theta / np.maximum(r, 1e-12), 1.0)
        return fn(params, uv * scale)

    return wrapped


def _fisheye_unwrap(undist):
    def wrapped(params, uv):
        uv_t = undist(params, uv)
        theta = np.sqrt(np.sum(uv_t * uv_t, axis=-1, keepdims=True))
        theta_c = np.clip(theta, 0.0, np.pi / 2 - 1e-6)
        scale = np.where(theta > 1e-8, np.tan(theta_c) / np.maximum(theta, 1e-12), 1.0)
        return uv_t * scale

    return wrapped


def _thin_prism(params, uv):
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    k1, k2, p1, p2, k3, k4, sx1, sy1 = (params[i] for i in range(4, 12))
    radial = 1 + k1 * r2 + k2 * r4 + k3 * r6 + k4 * r4 * r4
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u) + sx1 * r2
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v) + sy1 * r2
    return np.concatenate([du, dv], axis=-1)


def _identity(params, uv):
    return uv


def _newton_inverse(distort):
    def undistort(params, uv):
        x = uv.copy()
        eps = 1e-7
        for _ in range(25):
            f = distort(params, x) - uv
            # central-difference 2x2 Jacobian
            ex = np.zeros_like(x)
            ex[..., 0] = eps
            ey = np.zeros_like(x)
            ey[..., 1] = eps
            j0 = (distort(params, x + ex) - distort(params, x - ex)) / (2 * eps)
            j1 = (distort(params, x + ey) - distort(params, x - ey)) / (2 * eps)
            a, c = j0[..., 0], j0[..., 1]
            b, d = j1[..., 0], j1[..., 1]
            det = a * d - b * c
            det = np.where(np.abs(det) < 1e-12, 1e-12, det)
            dx = (d * f[..., 0] - b * f[..., 1]) / det
            dy = (-c * f[..., 0] + a * f[..., 1]) / det
            x = x - np.stack([dx, dy], axis=-1)
        return x

    return undistort


_sr = lambda p, uv: _radial(p, uv, (3,))
_r = lambda p, uv: _radial(p, uv, (3, 4))
_ocv = lambda p, uv: _opencv(p, uv, (4, 5), (6, 7))

DISTORT_NP = {
    0: _identity, 1: _identity, 2: _sr, 3: _r, 4: _ocv,
    5: _opencv_fisheye, 6: _full_opencv, 7: _fov,
    8: _fisheye_wrap(_sr), 9: _fisheye_wrap(_r), 10: _fisheye_wrap(_thin_prism),
}

UNDISTORT_NP = {
    0: _identity, 1: _identity,
    2: _newton_inverse(_sr), 3: _newton_inverse(_r), 4: _newton_inverse(_ocv),
    5: _newton_inverse(_opencv_fisheye), 6: _newton_inverse(_full_opencv),
    7: _fov_inv,
    8: _fisheye_unwrap(_newton_inverse(_sr)),
    9: _fisheye_unwrap(_newton_inverse(_r)),
    10: _fisheye_unwrap(_newton_inverse(_thin_prism)),
}


def _focal_principal(model_id, params):
    info = CAMERA_MODEL_BY_ID[model_id]
    if len(info.focal_idxs) == 1:
        fx = fy = params[info.focal_idxs[0]]
    else:
        fx = params[info.focal_idxs[0]]
        fy = params[info.focal_idxs[1]]
    return fx, fy, params[info.principal_idxs[0]], params[info.principal_idxs[1]]


def img_from_cam_np(model_id: int, params, uv: np.ndarray) -> np.ndarray:
    """Normalized plane [..., 2] -> pixels [..., 2] (numpy)."""
    uv = np.asarray(uv, dtype=np.float64)
    duv = DISTORT_NP[model_id](params, uv)
    fx, fy, cx, cy = _focal_principal(model_id, params)
    out = np.empty_like(duv)
    out[..., 0] = fx * duv[..., 0] + cx
    out[..., 1] = fy * duv[..., 1] + cy
    return out


def cam_from_img_np(model_id: int, params, xy: np.ndarray) -> np.ndarray:
    """Pixels [..., 2] -> normalized plane [..., 2] (numpy)."""
    xy = np.asarray(xy, dtype=np.float64)
    fx, fy, cx, cy = _focal_principal(model_id, params)
    uv = np.empty_like(xy)
    uv[..., 0] = (xy[..., 0] - cx) / fx
    uv[..., 1] = (xy[..., 1] - cy) / fy
    return UNDISTORT_NP[model_id](params, uv)
