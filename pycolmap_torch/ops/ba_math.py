"""Component-first math for the bundle-adjustment datapath.

Port of ``pycolmap_tpu/ops/ba_math.py``. Functions take and return tuples
of same-shaped tensors (one per component) and broadcast over arbitrary
shapes. These are the plain PyTorch versions of the arithmetic that the
CUDA kernels in ``sfm/csrc`` evaluate per observation; the distortion
tables here and ``_distort`` in ``sfm/csrc/ba_device.cuh`` must stay in step.
"""

from __future__ import annotations

import torch

from pycolmap_torch.ops.camera_models import CAMERA_MODEL_BY_ID, mixed_sel_index


# -- quaternions (tuples (w, x, y, z)) --------------------------------------


def quat_rotate_cf(q, v):
    """q = (w,x,y,z) tensors; v = (vx,vy,vz). Returns rotated (x,y,z)."""
    w, x, y, z = q
    vx, vy, vz = v
    # t = 2 * cross(u, v)
    tx = 2.0 * (y * vz - z * vy)
    ty = 2.0 * (z * vx - x * vz)
    tz = 2.0 * (x * vy - y * vx)
    # v + w*t + cross(u, t)
    ox = vx + w * tx + (y * tz - z * ty)
    oy = vy + w * ty + (z * tx - x * tz)
    oz = vz + w * tz + (x * ty - y * tx)
    return ox, oy, oz


def quat_mul_cf(q1, q2):
    w1, x1, y1, z1 = q1
    w2, x2, y2, z2 = q2
    return (
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    )


def axis_angle_to_quat_cf(aa):
    """aa = (ax, ay, az). Differentiable at 0 (series near zero)."""
    ax, ay, az = aa
    sq = ax * ax + ay * ay + az * az
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return (w, k * ax, k * ay, k * az)


def quat_boxplus_cf(q0, delta):
    """exp(delta) * q0, renormalized."""
    w, x, y, z = quat_mul_cf(axis_angle_to_quat_cf(delta), q0)
    inv = 1.0 / torch.sqrt(w * w + x * x + y * y + z * z + 1e-20)
    return (w * inv, x * inv, y * inv, z * inv)


# -- camera models (component-first) ----------------------------------------
# params: sequence of tensors indexed by the model's parameter layout.


def _where(cond, a, b):
    """torch.where that accepts a Python number on either side."""
    if not torch.is_tensor(a):
        a = torch.full_like(b, a)
    if not torch.is_tensor(b):
        b = torch.full_like(a, b)
    return torch.where(cond, a, b)


def _radial_cf(params, u, v, ks):
    r2 = u * u + v * v
    radial = torch.ones_like(r2)
    rpow = r2
    for k_idx in ks:
        radial = radial + params[k_idx] * rpow
        rpow = rpow * r2
    return u * radial, v * radial


def _opencv_cf(params, u, v, k_idxs, p_idxs):
    r2 = u * u + v * v
    radial = torch.ones_like(r2)
    rpow = r2
    for k_idx in k_idxs:
        radial = radial + params[k_idx] * rpow
        rpow = rpow * r2
    p1 = params[p_idxs[0]]
    p2 = params[p_idxs[1]]
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return du, dv


def _full_opencv_cf(params, u, v):
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    k1, k2, p1, p2, k3, k4, k5, k6 = (params[i] for i in range(4, 12))
    radial = (1 + k1 * r2 + k2 * r4 + k3 * r6) / (1 + k4 * r2 + k5 * r4 + k6 * r6)
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u)
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v)
    return du, dv


def _fov_cf(params, u, v):
    omega = params[4]
    r = torch.sqrt(u * u + v * v + 1e-20)
    tan_half = torch.tan(0.5 * omega)
    num = torch.atan(2.0 * r * tan_half)
    rw = r * omega
    small = torch.abs(rw) < 1e-8
    w_small = torch.abs(omega) < 1e-8
    limit = _where(
        w_small, torch.ones_like(r),
        2.0 * tan_half / _where(w_small, 1.0, omega),
    )
    factor = _where(small, limit, num / _where(small, 1.0, rw))
    return u * factor, v * factor


def _opencv_fisheye_cf(params, u, v):
    r = torch.sqrt(u * u + v * v + 1e-20)
    theta = torch.atan(r)
    t2 = theta * theta
    k1, k2, k3, k4 = (params[i] for i in range(4, 8))
    theta_d = theta * (1 + t2 * (k1 + t2 * (k2 + t2 * (k3 + t2 * k4))))
    scale = theta_d / r
    return u * scale, v * scale


def _fisheye_wrap_cf(fn):
    def wrapped(params, u, v):
        r = torch.sqrt(u * u + v * v + 1e-20)
        theta = torch.atan(r)
        scale = _where(r > 1e-8, theta / r, 1.0)
        return fn(params, u * scale, v * scale)

    return wrapped


def _thin_prism_cf(params, u, v):
    r2 = u * u + v * v
    r4 = r2 * r2
    r6 = r4 * r2
    k1, k2, p1, p2, k3, k4, sx1, sy1 = (params[i] for i in range(4, 12))
    radial = 1 + k1 * r2 + k2 * r4 + k3 * r6 + k4 * r4 * r4
    du = u * radial + 2 * p1 * u * v + p2 * (r2 + 2 * u * u) + sx1 * r2
    dv = v * radial + 2 * p2 * u * v + p1 * (r2 + 2 * v * v) + sy1 * r2
    return du, dv


def _identity_cf(params, u, v):
    return u, v


_DISTORT_CF = {
    0: _identity_cf,
    1: _identity_cf,
    2: lambda p, u, v: _radial_cf(p, u, v, (3,)),
    3: lambda p, u, v: _radial_cf(p, u, v, (3, 4)),
    4: lambda p, u, v: _opencv_cf(p, u, v, (4, 5), (6, 7)),
    5: _opencv_fisheye_cf,
    6: _full_opencv_cf,
    7: _fov_cf,
    8: _fisheye_wrap_cf(lambda p, u, v: _radial_cf(p, u, v, (3,))),
    9: _fisheye_wrap_cf(lambda p, u, v: _radial_cf(p, u, v, (3, 4))),
    10: _fisheye_wrap_cf(_thin_prism_cf),
}


def img_from_cam_cf(model_id_static, params, u, v):
    """Normalized plane -> pixels, component-first. params: sequence of
    tensors in the model's parameter layout. Returns (x, y).

    model_id_static may be a tuple (a mixed-model bundle): params then
    carries the per-observation model id at ``mixed_sel_index(models)``;
    each model is evaluated and selected with ``torch.where``, so another
    model's NaN (FOV at omega 0) never leaks, and an id naming no listed
    model gives 0.
    """
    if isinstance(model_id_static, tuple):
        sel = params[mixed_sel_index(model_id_static)]
        px = torch.zeros_like(u)
        py = torch.zeros_like(v)
        for m in model_id_static:
            xm, ym = img_from_cam_cf(m, params, u, v)
            c = sel == m
            px = torch.where(c, xm, px)
            py = torch.where(c, ym, py)
        return px, py
    info = CAMERA_MODEL_BY_ID[model_id_static]
    du, dv = _DISTORT_CF[model_id_static](params, u, v)
    if len(info.focal_idxs) == 1:
        fx = fy = params[info.focal_idxs[0]]
    else:
        fx = params[info.focal_idxs[0]]
        fy = params[info.focal_idxs[1]]
    cx = params[info.principal_idxs[0]]
    cy = params[info.principal_idxs[1]]
    return fx * du + cx, fy * dv + cy


def project_cf(model_id_static, intr, quat, trans, X):
    """Full projection: world point -> pixel, component-first.

    intr: sequence of parameter tensors; quat: (w,x,y,z); trans: (tx,ty,tz);
    X: (X0,X1,X2). Returns (px, py, z) with z the camera-frame depth.
    """
    cx, cy, cz = quat_rotate_cf(quat, X)
    cx = cx + trans[0]
    cy = cy + trans[1]
    cz = cz + trans[2]
    z_safe = _where(torch.abs(cz) < 1e-8, 1e-8, cz)
    u = cx / z_safe
    v = cy / z_safe
    px, py = img_from_cam_cf(model_id_static, intr, u, v)
    return px, py, cz
