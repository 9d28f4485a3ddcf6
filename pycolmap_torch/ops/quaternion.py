"""Batched quaternion / SE(3) math in PyTorch.

Port of ``pycolmap_tpu/ops/quaternion.py``. Quaternions are **[w, x, y, z]**
(COLMAP's on-disk and BA convention) and every function broadcasts over
leading axes. Rotation updates live in the tangent space (axis-angle, 3 dof)
and retract through :func:`quat_boxplus`, the analog of Ceres' quaternion
manifold (ref: pipeline/sfm.h:307-319).
"""

from __future__ import annotations

import torch


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """Hamilton product, wxyz convention; broadcasts over leading axes."""
    w1, x1, y1, z1 = torch.unbind(q1, dim=-1)
    w2, x2, y2, z2 = torch.unbind(q2, dim=-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_rotate(q, v):
    """Rotate vectors v [..., 3] by quaternions q [..., 4] (wxyz)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = torch.linalg.cross(u, v)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv))


def matrix_to_quat(R):
    """Rotation matrix [..., 3, 3] -> wxyz quaternion [..., 4].

    Branch-free: the four Shepperd cases are evaluated and selected with
    ``torch.where``, so it batches over arbitrary rotations."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    s0 = safe_sqrt(1.0 + tr)
    q0 = torch.stack(
        [0.5 * s0, 0.5 * (m21 - m12) / s0, 0.5 * (m02 - m20) / s0,
         0.5 * (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22)
    q1 = torch.stack(
        [0.5 * (m21 - m12) / s1, 0.5 * s1, 0.5 * (m01 + m10) / s1,
         0.5 * (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 - m00 + m11 - m22)
    q2 = torch.stack(
        [0.5 * (m02 - m20) / s2, 0.5 * (m01 + m10) / s2, 0.5 * s2,
         0.5 * (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 - m00 - m11 + m22)
    q3 = torch.stack(
        [0.5 * (m10 - m01) / s3, 0.5 * (m02 + m20) / s3,
         0.5 * (m12 + m21) / s3, 0.5 * s3], dim=-1)

    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q_no_tr = torch.where(
        cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)
    )
    q = torch.where((tr > 0)[..., None], q0, q_no_tr)
    return quat_normalize(q)


def axis_angle_to_quat(aa):
    """so(3) tangent [..., 3] -> wxyz quaternion (exponential map).

    Differentiable at aa = 0: the norm is guarded and the sinc factor
    switches to its Taylor series near zero, because BA linearizes exactly
    at the zero tangent."""
    sq = torch.sum(aa * aa, dim=-1, keepdim=True)
    small = sq < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(sq), sq))
    half = 0.5 * angle
    # sin(a/2)/a = 1/2 - a^2/48 + O(a^4);  cos(a/2) = 1 - a^2/8 + O(a^4)
    k = torch.where(small, 0.5 - sq / 48.0, torch.sin(half) / angle)
    w = torch.where(small, 1.0 - sq / 8.0, torch.cos(half))
    return torch.cat([w, k * aa], dim=-1)


def quat_to_axis_angle(q):
    """wxyz quaternion -> so(3) tangent [..., 3] (log map)."""
    q = quat_normalize(q)
    w = q[..., :1]
    q = q * torch.sign(torch.where(w == 0, torch.ones_like(w), w))
    sin_half = torch.linalg.norm(q[..., 1:], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, q[..., :1])
    k = torch.where(
        sin_half > 1e-8, angle / torch.clamp(sin_half, min=1e-12),
        torch.full_like(sin_half, 2.0),
    )
    return k * q[..., 1:]


def quat_boxplus(q, delta):
    """Manifold retraction q' = exp(delta) * q (left-multiplicative)."""
    return quat_normalize(quat_mul(axis_angle_to_quat(delta), q))


def quat_conj(q):
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def quat_to_matrix(q):
    """wxyz quaternion [..., 4] -> rotation matrix [..., 3, 3]."""
    w, x, y, z = torch.unbind(q, dim=-1)
    m = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
            2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
            2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def quat_angle(q):
    """Rotation angle in radians of wxyz quaternion (q and -q agree)."""
    q = quat_normalize(q)
    return 2.0 * torch.atan2(
        torch.linalg.norm(q[..., 1:], dim=-1), torch.abs(q[..., 0])
    )


def rigid_transform(quat, trans, points):
    """Apply cam_from_world (quat wxyz [...,4], t [...,3]) to points [...,3]."""
    return quat_rotate(quat, points) + trans


def rigid_compose(quat_ab, t_ab, quat_bc, t_bc):
    """(a_from_b) * (b_from_c) -> a_from_c."""
    quat_ac = quat_mul(quat_ab, quat_bc)
    t_ac = quat_rotate(quat_ab, t_bc) + t_ab
    return quat_ac, t_ac


def rigid_inverse(quat, trans):
    q_inv = quat_conj(quat)
    return q_inv, -quat_rotate(q_inv, trans)


def cross_matrix(v):
    """[..., 3] -> skew-symmetric [..., 3, 3]."""
    zero = torch.zeros_like(v[..., 0])
    rows = torch.stack(
        [zero, -v[..., 2], v[..., 1],
         v[..., 2], zero, -v[..., 0],
         -v[..., 1], v[..., 0], zero], dim=-1)
    return rows.reshape(v.shape[:-1] + (3, 3))


def essential_from_pose(quat, trans):
    """E = [t]_x R for cam2_from_cam1 (ref: geometry/bindings.h:82)."""
    t = trans / torch.clamp(
        torch.linalg.norm(trans, dim=-1, keepdim=True), min=1e-12
    )
    return cross_matrix(t) @ quat_to_matrix(quat)


def project_center(quat, trans):
    """Camera projection center in world coords: -R^T t."""
    return -quat_rotate(quat_conj(quat), trans)
