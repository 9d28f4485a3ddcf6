"""The 11 COLMAP camera models as PyTorch functions.

Port of ``pycolmap_tpu/ops/camera_models.py`` (parity target:
colmap/sensor/models.h, enumerated via ``CAMERA_MODEL_CASES``):

- ``img_from_cam(model_id, params, uv)``: normalized camera plane [..., 2]
  (u = x/z, v = y/z) -> pixel coordinates [..., 2];
- ``cam_from_img(model_id, params, xy)``: the inverse, with a fixed-iteration
  Newton solve for models without closed-form undistortion (the counterpart
  of upstream IterativeUndistortion). Its 2x2 Jacobians come from
  ``torch.func.jvp``.

``params`` is padded to ``MAX_PARAMS``. The reference dispatches a traced
model id through ``lax.switch``; eager PyTorch dispatches on the Python int.

A mixed-model bundle passes ``model_id`` as a tuple of ids (the
reference's ``img_from_cam_fixed``): ``params`` then carries one more
column, the per-camera model id, at ``mixed_sel_index(models)``, and every
listed model is evaluated and selected per point with ``torch.where`` (a
NaN of a model evaluated on another model's parameters, FOV at omega 0,
never reaches the output). A point whose selector names no listed model
maps to 0, as in the reference.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

MAX_PARAMS = 12

# Undistortion Newton iterations (upstream uses up to 100 with line search;
# quadratic convergence makes 20 plenty for realistic distortion).
_UNDISTORT_ITERS = 20


class CameraModelInfo(NamedTuple):
    model_id: int
    name: str
    num_params: int
    focal_idxs: tuple
    principal_idxs: tuple
    extra_idxs: tuple
    param_names: str


CAMERA_MODELS = [
    CameraModelInfo(0, "SIMPLE_PINHOLE", 3, (0,), (1, 2), (), "f, cx, cy"),
    CameraModelInfo(1, "PINHOLE", 4, (0, 1), (2, 3), (), "fx, fy, cx, cy"),
    CameraModelInfo(2, "SIMPLE_RADIAL", 4, (0,), (1, 2), (3,), "f, cx, cy, k"),
    CameraModelInfo(3, "RADIAL", 5, (0,), (1, 2), (3, 4), "f, cx, cy, k1, k2"),
    CameraModelInfo(4, "OPENCV", 8, (0, 1), (2, 3), (4, 5, 6, 7),
                    "fx, fy, cx, cy, k1, k2, p1, p2"),
    CameraModelInfo(5, "OPENCV_FISHEYE", 8, (0, 1), (2, 3), (4, 5, 6, 7),
                    "fx, fy, cx, cy, k1, k2, k3, k4"),
    CameraModelInfo(6, "FULL_OPENCV", 12, (0, 1), (2, 3),
                    (4, 5, 6, 7, 8, 9, 10, 11),
                    "fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, k5, k6"),
    CameraModelInfo(7, "FOV", 5, (0, 1), (2, 3), (4,), "fx, fy, cx, cy, omega"),
    CameraModelInfo(8, "SIMPLE_RADIAL_FISHEYE", 4, (0,), (1, 2), (3,),
                    "f, cx, cy, k"),
    CameraModelInfo(9, "RADIAL_FISHEYE", 5, (0,), (1, 2), (3, 4),
                    "f, cx, cy, k1, k2"),
    CameraModelInfo(10, "THIN_PRISM_FISHEYE", 12, (0, 1), (2, 3),
                    (4, 5, 6, 7, 8, 9, 10, 11),
                    "fx, fy, cx, cy, k1, k2, p1, p2, k3, k4, sx1, sy1"),
]

CAMERA_MODEL_BY_NAME = {m.name: m for m in CAMERA_MODELS}
CAMERA_MODEL_BY_ID = {m.model_id: m for m in CAMERA_MODELS}
NUM_CAMERA_MODELS = len(CAMERA_MODELS)


def model_id_from_name(name):
    return CAMERA_MODEL_BY_NAME[name].model_id


def model_name_from_id(model_id):
    return CAMERA_MODEL_BY_ID[int(model_id)].name


def num_params_for_model(model) -> int:
    if isinstance(model, str):
        return CAMERA_MODEL_BY_NAME[model].num_params
    return CAMERA_MODEL_BY_ID[int(model)].num_params


def mixed_sel_index(models: tuple) -> int:
    """Column index of the per-camera model-id selector plane of a
    mixed-model bundle (model_id given as a tuple of ids)."""
    return max(CAMERA_MODEL_BY_ID[m].num_params for m in models)


def solver_num_params(model_id) -> int:
    """Parameter-plane count the BA solver carries for this model id
    (int = one model; tuple = mixed: max model width + selector plane)."""
    if isinstance(model_id, tuple):
        return mixed_sel_index(model_id) + 1
    return CAMERA_MODEL_BY_ID[model_id].num_params


def pad_params(params, dtype=torch.float32):
    """Pad a per-model params vector to MAX_PARAMS (host-side helper)."""
    import numpy as np

    params = np.asarray(params, dtype=np.float64)
    out = np.zeros(MAX_PARAMS)
    out[: params.shape[0]] = params
    return torch.as_tensor(out, dtype=dtype)


# ---------------------------------------------------------------------------
# Distortion in the normalized plane: uv -> duv (distorted normalized coords).
# Each takes the padded params [..., MAX_PARAMS] and uv [..., 2].
# ---------------------------------------------------------------------------


def _p(params, i):
    return params[..., i:i + 1]


def _radial_poly(params, uv, ks):
    """u' = u * (1 + sum_i k_i r^(2(i+1)))."""
    r2 = torch.sum(uv * uv, dim=-1, keepdim=True)
    radial = torch.ones_like(r2)
    rpow = r2
    for k_idx in ks:
        radial = radial + _p(params, k_idx) * rpow
        rpow = rpow * r2
    return uv * radial


def _opencv_distort(params, uv, k_idxs, p_idxs):
    """Radial polynomial + tangential distortion (OPENCV family)."""
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r2 = u * u + v * v
    radial = torch.ones_like(r2)
    rpow = r2
    for k_idx in k_idxs:
        radial = radial + _p(params, k_idx) * rpow
        rpow = rpow * r2
    p1 = _p(params, p_idxs[0])
    p2 = _p(params, p_idxs[1])
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return torch.cat([du, dv], dim=-1)


def _full_opencv_distort(params, uv):
    """Rational radial + tangential (FULL_OPENCV)."""
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    k1, k2, p1, p2, k3, k4, k5, k6 = (_p(params, i) for i in range(4, 12))
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return torch.cat([du, dv], dim=-1)


def _fov_distort(params, uv):
    """FOV model (Devernay & Faugeras)."""
    omega = _p(params, 4)
    r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True))
    tan_half = torch.tan(0.5 * omega)
    # factor = atan(2 r tan(w/2)) / (r w), stable as r->0 or w->0
    num = torch.atan2(2.0 * r * tan_half, torch.ones_like(r))
    safe_rw = r * omega
    small = torch.abs(safe_rw) < 1e-8
    w_small = torch.abs(omega) < 1e-8
    limit = torch.where(
        w_small, torch.ones_like(r),
        2.0 * tan_half / torch.where(w_small, torch.ones_like(omega), omega),
    )
    factor = torch.where(
        small, limit, num / torch.where(small, torch.ones_like(safe_rw), safe_rw)
    )
    return uv * factor


def _fov_undistort(params, uv):
    """FOV has a closed-form inverse."""
    omega = _p(params, 4)
    r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True))
    tan_half = torch.tan(0.5 * omega)
    num = torch.tan(r * omega)
    safe = 2.0 * r * tan_half
    small = torch.abs(safe) < 1e-8
    w_small = torch.abs(omega) < 1e-8
    limit = torch.where(
        w_small, torch.ones_like(r),
        omega / torch.where(w_small, torch.ones_like(tan_half), 2.0 * tan_half),
    )
    factor = torch.where(
        small, limit, num / torch.where(small, torch.ones_like(safe), safe)
    )
    return uv * factor


def _fisheye_wrap(distort_fn):
    """Equidistant fisheye projection wrapper used by *_FISHEYE models:
    pinhole plane -> angle coordinates (theta * unit dir), then the plane
    distortion there (upstream FisheyeFromNormal)."""

    def wrapped(params, uv):
        r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True))
        theta = torch.atan(r)
        scale = torch.where(
            r > 1e-8, theta / torch.clamp(r, min=1e-12), torch.ones_like(r)
        )
        return distort_fn(params, uv * scale)

    return wrapped


def _fisheye_unwrap(undistort_fn):
    """Inverse of :func:`_fisheye_wrap`: angle plane back to pinhole plane."""

    def wrapped(params, uv):
        uv_theta = undistort_fn(params, uv)
        theta = torch.sqrt(torch.sum(uv_theta * uv_theta, dim=-1, keepdim=True))
        # clamp to just under pi/2: beyond that the point is behind the camera
        theta_c = torch.clamp(theta, 0.0, math.pi / 2 - 1e-6)
        scale = torch.where(
            theta > 1e-8, torch.tan(theta_c) / torch.clamp(theta, min=1e-12),
            torch.ones_like(theta),
        )
        return uv_theta * scale

    return wrapped


def _opencv_fisheye_distort(params, uv):
    """OPENCV_FISHEYE: theta polynomial in odd powers (k1..k4)."""
    r = torch.sqrt(torch.sum(uv * uv, dim=-1, keepdim=True))
    theta = torch.atan(r)
    t2 = theta * theta
    k1, k2, k3, k4 = (_p(params, i) for i in range(4, 8))
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = torch.where(
        r > 1e-8, theta_d / torch.clamp(r, min=1e-12), torch.ones_like(r)
    )
    return uv * scale


def _thin_prism_distort_plane(params, uv):
    """Radial + tangential + thin-prism terms applied in the angle plane."""
    u = uv[..., 0:1]
    v = uv[..., 1:2]
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    k1, k2, p1, p2, k3, k4, sx1, sy1 = (_p(params, i) for i in range(4, 12))
    radial = 1 + k1 * r2 + k2 * r4 + k3 * r6 + k4 * r4 * r4
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u) + sx1 * r2
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v) + sy1 * r2
    return torch.cat([du, dv], dim=-1)


def _identity_distort(params, uv):
    return uv


def _newton_undistort(distort_fn):
    """Generic inverse of a plane distortion by Newton iteration (upstream
    IterativeUndistortion): solve distort(x) = y for x with a fixed
    iteration count; the 2x2 Jacobian comes from two jvps."""

    def undistort(params, uv):
        x = uv
        e0 = torch.zeros_like(uv)
        e0[..., 0] = 1.0
        e1 = torch.zeros_like(uv)
        e1[..., 1] = 1.0

        def f(p):
            return distort_fn(params, p)

        for _ in range(_UNDISTORT_ITERS):
            fx_, j0 = torch.func.jvp(f, (x,), (e0,))
            _, j1 = torch.func.jvp(f, (x,), (e1,))
            res = fx_ - uv
            a, c = j0[..., 0], j0[..., 1]
            b, d = j1[..., 0], j1[..., 1]
            det = a * d - b * c
            det = torch.where(
                torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det
            )
            rx, ry = res[..., 0], res[..., 1]
            dx = (d * rx - b * ry) / det
            dy = (-c * rx + a * ry) / det
            x = x - torch.stack([dx, dy], dim=-1)
        return x

    return undistort


_simple_radial = functools.partial(_radial_poly, ks=(3,))
_radial = functools.partial(_radial_poly, ks=(3, 4))
_opencv = functools.partial(_opencv_distort, k_idxs=(4, 5), p_idxs=(6, 7))

_DISTORT_FNS = {
    0: _identity_distort,
    1: _identity_distort,
    2: _simple_radial,
    3: _radial,
    4: _opencv,
    5: _opencv_fisheye_distort,
    6: _full_opencv_distort,
    7: _fov_distort,
    8: _fisheye_wrap(_simple_radial),
    9: _fisheye_wrap(_radial),
    10: _fisheye_wrap(_thin_prism_distort_plane),
}

_UNDISTORT_FNS = {
    0: _identity_distort,
    1: _identity_distort,
    2: _newton_undistort(_simple_radial),
    3: _newton_undistort(_radial),
    4: _newton_undistort(_opencv),
    5: _newton_undistort(_opencv_fisheye_distort),
    6: _newton_undistort(_full_opencv_distort),
    7: _fov_undistort,
    8: _fisheye_unwrap(_newton_undistort(_simple_radial)),
    9: _fisheye_unwrap(_newton_undistort(_radial)),
    10: _fisheye_unwrap(_newton_undistort(_thin_prism_distort_plane)),
}


def _focal_principal(model_id, params):
    info = CAMERA_MODEL_BY_ID[model_id]
    if len(info.focal_idxs) == 1:
        fx = fy = _p(params, info.focal_idxs[0])
    else:
        fx = _p(params, info.focal_idxs[0])
        fy = _p(params, info.focal_idxs[1])
    cx = _p(params, info.principal_idxs[0])
    cy = _p(params, info.principal_idxs[1])
    return fx, fy, cx, cy


def _mixed(models, fn, params, x):
    """fn(m, params, x) of each listed model, selected per point by the
    selector column of params (0 where it names none)."""
    sel_idx = mixed_sel_index(models)
    sel = params[..., sel_idx:sel_idx + 1]
    out = None
    for m in models:
        y = fn(m, params, x)
        if out is None:
            out = torch.zeros_like(y)
        out = torch.where(sel == m, y, out)
    return out


def img_from_cam(model_id, params, uv):
    """Project normalized camera points [..., 2] to pixels for one model id
    (or a tuple of them); params [..., MAX_PARAMS] (one more column, the
    selector, for a tuple)."""
    if isinstance(model_id, tuple):
        return _mixed(model_id, img_from_cam, params, uv)
    model_id = int(model_id)
    duv = _DISTORT_FNS[model_id](params, uv)
    fx, fy, cx, cy = _focal_principal(model_id, params)
    return torch.cat([fx * duv[..., 0:1] + cx, fy * duv[..., 1:2] + cy], dim=-1)


def cam_from_img(model_id, params, xy):
    """Unproject pixels [..., 2] to the normalized camera plane."""
    if isinstance(model_id, tuple):
        return _mixed(model_id, cam_from_img, params, xy)
    model_id = int(model_id)
    fx, fy, cx, cy = _focal_principal(model_id, params)
    u = (xy[..., 0:1] - cx) / fx
    v = (xy[..., 1:2] - cy) / fy
    return _UNDISTORT_FNS[model_id](params, torch.cat([u, v], dim=-1))


def img_from_cam_fixed(model_id_static):
    """``img_from_cam`` as a closure over one model id, or a tuple of ids
    (the mixed form: selected per point by the selector column at
    ``mixed_sel_index(models)`` with ``torch.where``)."""
    if not isinstance(model_id_static, tuple):
        model_id_static = int(model_id_static)

    def fn(params, uv):
        return img_from_cam(model_id_static, params, uv)

    return fn


def cam_from_img_fixed(model_id_static: int):
    """``cam_from_img`` as a closure over one model id."""
    model_id_static = int(model_id_static)

    def fn(params, xy):
        return cam_from_img(model_id_static, params, xy)

    return fn


def calibration_matrix(model_id_static: int, params):
    """3x3 K matrix (valid for the pinhole part of any model)."""
    fx, fy, cx, cy = _focal_principal(int(model_id_static), params)
    zeros = torch.zeros_like(fx[..., 0])
    ones = torch.ones_like(fx[..., 0])
    K = torch.stack(
        [fx[..., 0], zeros, cx[..., 0],
         zeros, fy[..., 0], cy[..., 0],
         zeros, zeros, ones], dim=-1)
    return K.reshape(params.shape[:-1] + (3, 3))
