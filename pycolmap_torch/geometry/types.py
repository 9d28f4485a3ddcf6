"""SE(3)/Sim(3) host-side geometry types.

API-parity targets (method names/semantics): reference
pycolmap/geometry/bindings.h:21-137 (Rotation3d, Rigid3d, Sim3d).
These are light numpy objects used for scene bookkeeping and I/O; all batched
device math lives in :mod:`pycolmap_torch.ops.quaternion` (PyTorch).
Port of ``pycolmap_tpu/geometry/types.py``, unchanged.

Quaternion storage convention: ``quat`` is **[x, y, z, w]** (Eigen coeffs
order, as exposed by the reference bindings); the identity is [0, 0, 0, 1].
COLMAP's on-disk formats use [w, x, y, z]; the I/O layer converts.
"""

from __future__ import annotations

import numpy as np


def _normalize_quat(q):
    q = np.asarray(q, dtype=np.float64).reshape(4)
    n = np.linalg.norm(q)
    if n == 0:
        return np.array([0.0, 0.0, 0.0, 1.0])
    return q / n


def _quat_to_matrix(q):
    """xyzw quaternion -> 3x3 rotation matrix."""
    x, y, z, w = q
    return np.array(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
        ]
    )


def _matrix_to_quat(R):
    """3x3 rotation matrix -> xyzw quaternion (Shepperd's method)."""
    R = np.asarray(R, dtype=np.float64)
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        w = 0.25 * s
        x = (R[2, 1] - R[1, 2]) / s
        y = (R[0, 2] - R[2, 0]) / s
        z = (R[1, 0] - R[0, 1]) / s
    elif R[0, 0] > R[1, 1] and R[0, 0] > R[2, 2]:
        s = np.sqrt(1.0 + R[0, 0] - R[1, 1] - R[2, 2]) * 2
        w = (R[2, 1] - R[1, 2]) / s
        x = 0.25 * s
        y = (R[0, 1] + R[1, 0]) / s
        z = (R[0, 2] + R[2, 0]) / s
    elif R[1, 1] > R[2, 2]:
        s = np.sqrt(1.0 + R[1, 1] - R[0, 0] - R[2, 2]) * 2
        w = (R[0, 2] - R[2, 0]) / s
        x = (R[0, 1] + R[1, 0]) / s
        y = 0.25 * s
        z = (R[1, 2] + R[2, 1]) / s
    else:
        s = np.sqrt(1.0 + R[2, 2] - R[0, 0] - R[1, 1]) * 2
        w = (R[1, 0] - R[0, 1]) / s
        x = (R[0, 2] + R[2, 0]) / s
        y = (R[1, 2] + R[2, 1]) / s
        z = 0.25 * s
    return _normalize_quat([x, y, z, w])


def _quat_mul(q1, q2):
    """Hamilton product of xyzw quaternions."""
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return np.array(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


class Rotation3d:
    """3D rotation as a unit quaternion (ref: geometry/bindings.h:24-71)."""

    __slots__ = ("quat",)

    def __init__(self, value=None):
        if value is None:
            self.quat = np.array([0.0, 0.0, 0.0, 1.0])
        elif isinstance(value, Rotation3d):
            self.quat = value.quat.copy()
        else:
            arr = np.asarray(value, dtype=np.float64)
            if arr.shape == (4,):
                self.quat = arr.copy()
            elif arr.shape == (3, 3):
                self.quat = _matrix_to_quat(arr)
            elif arr.shape == (3,):
                # axis-angle vector
                angle = np.linalg.norm(arr)
                if angle < 1e-12:
                    self.quat = np.array([0.0, 0.0, 0.0, 1.0])
                else:
                    axis = arr / angle
                    s = np.sin(angle / 2)
                    self.quat = np.array(
                        [axis[0] * s, axis[1] * s, axis[2] * s, np.cos(angle / 2)]
                    )
            else:
                raise ValueError(f"cannot build Rotation3d from shape {arr.shape}")

    def normalize(self) -> None:
        self.quat = _normalize_quat(self.quat)

    def norm(self) -> float:
        return float(np.linalg.norm(self.quat))

    def matrix(self) -> np.ndarray:
        return _quat_to_matrix(_normalize_quat(self.quat))

    def angle(self) -> float:
        q = _normalize_quat(self.quat)
        return float(2.0 * np.arctan2(np.linalg.norm(q[:3]), abs(q[3])))

    def angle_to(self, other: "Rotation3d") -> float:
        return (self.inverse() * other).angle()

    def inverse(self) -> "Rotation3d":
        q = self.quat
        return Rotation3d(np.array([-q[0], -q[1], -q[2], q[3]]))

    def __mul__(self, other):
        if isinstance(other, Rotation3d):
            return Rotation3d(_quat_mul(self.quat, other.quat))
        pts = np.asarray(other, dtype=np.float64)
        R = self.matrix()
        if pts.shape == (3,):
            return R @ pts
        if pts.ndim == 2 and pts.shape[1] == 3:
            return pts @ R.T
        raise TypeError(f"cannot rotate object of shape {pts.shape}")

    def __eq__(self, other):
        return isinstance(other, Rotation3d) and np.allclose(self.quat, other.quat)

    def __repr__(self):
        return f"Rotation3d(quat_xyzw={np.round(self.quat, 6).tolist()})"


class Rigid3d:
    """SE(3) transform b_from_a: x_b = R x_a + t (ref: geometry/bindings.h:74-103)."""

    __slots__ = ("rotation", "translation")

    def __init__(self, rotation=None, translation=None):
        if rotation is None and translation is None:
            self.rotation = Rotation3d()
            self.translation = np.zeros(3)
        elif translation is None:
            mat = np.asarray(rotation, dtype=np.float64)
            if mat.shape == (3, 4):
                self.rotation = Rotation3d(mat[:, :3])
                self.translation = mat[:, 3].copy()
            elif isinstance(rotation, Rigid3d):
                self.rotation = Rotation3d(rotation.rotation)
                self.translation = rotation.translation.copy()
            else:
                raise ValueError("expected 3x4 matrix or Rigid3d")
        else:
            self.rotation = Rotation3d(rotation) if not isinstance(rotation, Rotation3d) else Rotation3d(rotation)
            self.translation = np.asarray(translation, dtype=np.float64).reshape(3).copy()

    def matrix(self) -> np.ndarray:
        return np.hstack([self.rotation.matrix(), self.translation[:, None]])

    def inverse(self) -> "Rigid3d":
        rot_inv = self.rotation.inverse()
        return Rigid3d(rot_inv, -(rot_inv * self.translation))

    def essential_matrix(self) -> np.ndarray:
        """E from the relative pose cam2_from_cam1 (ref: geometry/bindings.h:82)."""
        t = self.translation
        t_norm = np.linalg.norm(t)
        if t_norm > 0:
            t = t / t_norm
        t_cross = np.array(
            [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]
        )
        return t_cross @ self.rotation.matrix()

    def adjoint(self) -> np.ndarray:
        """6x6 adjoint mapping se(3) tangents (rot, trans) between frames."""
        R = self.rotation.matrix()
        t = self.translation
        t_cross = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        out = np.zeros((6, 6))
        out[:3, :3] = R
        out[3:, :3] = t_cross @ R
        out[3:, 3:] = R
        return out

    @staticmethod
    def interpolate(a: "Rigid3d", b: "Rigid3d", t: float) -> "Rigid3d":
        """Slerp rotation + lerp translation (ref: geometry/bindings.h:94)."""
        qa = _normalize_quat(a.rotation.quat)
        qb = _normalize_quat(b.rotation.quat)
        dot = float(np.dot(qa, qb))
        if dot < 0:
            qb, dot = -qb, -dot
        if dot > 0.9995:
            q = _normalize_quat(qa + t * (qb - qa))
        else:
            theta0 = np.arccos(np.clip(dot, -1, 1))
            theta = theta0 * t
            q = _normalize_quat(
                qa * np.cos(theta) + _normalize_quat(qb - qa * dot) * np.sin(theta)
            )
        trans = (1 - t) * a.translation + t * b.translation
        return Rigid3d(Rotation3d(q), trans)

    def __mul__(self, other):
        if isinstance(other, Rigid3d):
            rot = self.rotation * other.rotation
            trans = self.rotation * other.translation + self.translation
            return Rigid3d(rot, trans)
        pts = np.asarray(other, dtype=np.float64)
        if pts.shape == (3,):
            return self.rotation * pts + self.translation
        if pts.ndim == 2 and pts.shape[1] == 3:
            return (self.rotation * pts) + self.translation[None, :]
        raise TypeError(f"cannot transform object of shape {pts.shape}")

    def __eq__(self, other):
        return (
            isinstance(other, Rigid3d)
            and self.rotation == other.rotation
            and np.allclose(self.translation, other.translation)
        )

    def __repr__(self):
        return (
            f"Rigid3d(quat_xyzw={np.round(self.rotation.quat, 6).tolist()}, "
            f"t={np.round(self.translation, 6).tolist()})"
        )


class Sim3d:
    """Sim(3) transform: x_b = s R x_a + t (ref: geometry/bindings.h:106-137)."""

    __slots__ = ("scale", "rotation", "translation")

    def __init__(self, scale=1.0, rotation=None, translation=None):
        if isinstance(scale, np.ndarray) and scale.shape == (3, 4):
            mat = scale
            self.scale = float(np.linalg.norm(mat[:, 0]))
            self.rotation = Rotation3d(mat[:, :3] / self.scale)
            self.translation = mat[:, 3].copy()
        else:
            self.scale = float(scale)
            self.rotation = Rotation3d(rotation) if not isinstance(rotation, Rotation3d) else rotation
            self.translation = (
                np.zeros(3)
                if translation is None
                else np.asarray(translation, dtype=np.float64).reshape(3).copy()
            )

    @staticmethod
    def from_matrix(mat: np.ndarray) -> "Sim3d":
        return Sim3d(np.asarray(mat, dtype=np.float64)[:3, :4])

    def matrix(self) -> np.ndarray:
        return np.hstack(
            [self.scale * self.rotation.matrix(), self.translation[:, None]]
        )

    def inverse(self) -> "Sim3d":
        inv_scale = 1.0 / self.scale
        rot_inv = self.rotation.inverse()
        return Sim3d(inv_scale, rot_inv, -inv_scale * (rot_inv * self.translation))

    def transform_camera_world(self, cam_from_world: Rigid3d) -> Rigid3d:
        """cam_from_new_world for new_world = self * old_world.

        Matches upstream TransformCameraWorld (colmap/geometry/sim3.h): compose
        Rigid(cam_from_world) with self^-1 as Sim3, then rescale translation so
        the result is a Rigid3d in the new world's metric.
        """
        return _transform_camera_world(self, cam_from_world)

    def __mul__(self, other):
        if isinstance(other, Sim3d):
            scale = self.scale * other.scale
            rot = self.rotation * other.rotation
            trans = self.scale * (self.rotation * other.translation) + self.translation
            return Sim3d(scale, rot, trans)
        pts = np.asarray(other, dtype=np.float64)
        if pts.shape == (3,):
            return self.scale * (self.rotation * pts) + self.translation
        if pts.ndim == 2 and pts.shape[1] == 3:
            return self.scale * (self.rotation * pts) + self.translation[None, :]
        raise TypeError(f"cannot transform object of shape {pts.shape}")

    def __eq__(self, other):
        return (
            isinstance(other, Sim3d)
            and np.isclose(self.scale, other.scale)
            and self.rotation == other.rotation
            and np.allclose(self.translation, other.translation)
        )

    def __repr__(self):
        return (
            f"Sim3d(scale={self.scale:.6g}, "
            f"quat_xyzw={np.round(self.rotation.quat, 6).tolist()}, "
            f"t={np.round(self.translation, 6).tolist()})"
        )


def _transform_camera_world(sim: Sim3d, cam_from_world: Rigid3d) -> Rigid3d:
    """cam_from_new_world = Rigid(cam_from_world) * sim^-1, rescaled to Rigid3d.

    The camera keeps its image observations; only the world frame changes by
    ``sim``. The Sim3 composition has scale 1/sim.scale; multiplying the
    translation by sim.scale yields the unit-scale Rigid3d of the new frame.
    """
    inv = sim.inverse()
    rotation = cam_from_world.rotation * inv.rotation
    translation = (
        cam_from_world.rotation * inv.translation + cam_from_world.translation
    ) * sim.scale
    return Rigid3d(rotation, translation)
