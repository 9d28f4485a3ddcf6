"""Host-side Camera object (API parity: pycolmap/scene/camera.h:39-213).

Port of ``pycolmap_tpu/scene/camera.py``. The object is a thin bookkeeping
record; its projections evaluate the numpy twins of the camera models
(:mod:`pycolmap_torch.ops.camera_models_np`) in float64 at any batch size.
The reference's jitted projection for batches above a million points, and
its power-of-two padding, exist only to bound TPU compiles.
"""

from __future__ import annotations

import numpy as np

from pycolmap_torch.ops import camera_models as cm
from pycolmap_torch.ops.camera_models_np import cam_from_img_np, img_from_cam_np


class Camera:
    """A physical camera: model + intrinsics (ref: scene/camera.h)."""

    __slots__ = ("camera_id", "model", "width", "height", "params", "has_prior_focal_length")

    def __init__(
        self,
        camera_id: int = 0xFFFFFFFF,
        model: str = "SIMPLE_PINHOLE",
        width: int = 0,
        height: int = 0,
        params=None,
        has_prior_focal_length: bool = False,
    ):
        if isinstance(model, int):
            model = cm.model_name_from_id(model)
        self.camera_id = camera_id
        self.model = model
        self.width = int(width)
        self.height = int(height)
        if params is None:
            params = np.zeros(cm.num_params_for_model(model))
        self.params = np.asarray(params, dtype=np.float64).copy()
        self.has_prior_focal_length = bool(has_prior_focal_length)

    # -- constructors -------------------------------------------------------
    @staticmethod
    def create(
        camera_id: int, model: str, focal_length: float, width: int, height: int
    ) -> "Camera":
        """Initialize with centered principal point (upstream Camera::CreateFromModelId)."""
        info = cm.CAMERA_MODEL_BY_NAME[model if isinstance(model, str) else cm.model_name_from_id(model)]
        params = np.zeros(info.num_params)
        for idx in info.focal_idxs:
            params[idx] = focal_length
        params[info.principal_idxs[0]] = width / 2.0
        params[info.principal_idxs[1]] = height / 2.0
        if info.name == "FOV":
            params[info.extra_idxs[0]] = 1e-2
        return Camera(camera_id, info.name, width, height, params)

    # -- model metadata -----------------------------------------------------
    @property
    def model_id(self) -> int:
        return cm.model_id_from_name(self.model)

    @property
    def model_name(self) -> str:
        return self.model

    @property
    def params_info(self) -> str:
        return cm.CAMERA_MODEL_BY_NAME[self.model].param_names

    @property
    def focal_length_idxs(self):
        return list(cm.CAMERA_MODEL_BY_NAME[self.model].focal_idxs)

    @property
    def principal_point_idxs(self):
        return list(cm.CAMERA_MODEL_BY_NAME[self.model].principal_idxs)

    @property
    def extra_params_idxs(self):
        return list(cm.CAMERA_MODEL_BY_NAME[self.model].extra_idxs)

    # -- intrinsics accessors ----------------------------------------------
    @property
    def focal_length(self) -> float:
        return float(np.mean([self.params[i] for i in self.focal_length_idxs]))

    @focal_length.setter
    def focal_length(self, f: float):
        for i in self.focal_length_idxs:
            self.params[i] = f

    @property
    def focal_length_x(self) -> float:
        return float(self.params[self.focal_length_idxs[0]])

    @property
    def focal_length_y(self) -> float:
        return float(self.params[self.focal_length_idxs[-1]])

    @property
    def principal_point_x(self) -> float:
        return float(self.params[self.principal_point_idxs[0]])

    @property
    def principal_point_y(self) -> float:
        return float(self.params[self.principal_point_idxs[1]])

    @principal_point_x.setter
    def principal_point_x(self, v: float):
        self.params[self.principal_point_idxs[0]] = v

    @principal_point_y.setter
    def principal_point_y(self, v: float):
        self.params[self.principal_point_idxs[1]] = v

    def mean_focal_length(self) -> float:
        return self.focal_length

    def calibration_matrix(self) -> np.ndarray:
        K = np.eye(3)
        K[0, 0] = self.focal_length_x
        K[1, 1] = self.focal_length_y
        K[0, 2] = self.principal_point_x
        K[1, 2] = self.principal_point_y
        return K

    def params_to_string(self) -> str:
        return ", ".join(f"{p:.6g}" for p in self.params)

    def set_params_from_string(self, s: str) -> bool:
        try:
            vals = [float(x) for x in s.replace(",", " ").split()]
        except ValueError:
            return False
        if len(vals) != cm.num_params_for_model(self.model):
            return False
        self.params = np.array(vals)
        return True

    def verify_params(self) -> bool:
        return len(self.params) == cm.num_params_for_model(self.model)

    def has_bogus_params(
        self,
        min_focal_length_ratio: float,
        max_focal_length_ratio: float,
        max_extra_param: float,
    ) -> bool:
        """Sanity check used by mapper filtering (upstream Camera::HasBogusParams)."""
        max_dim = max(self.width, self.height)
        for i in self.focal_length_idxs:
            ratio = self.params[i] / max_dim
            if ratio < min_focal_length_ratio or ratio > max_focal_length_ratio:
                return True
        for i in self.extra_params_idxs:
            if abs(self.params[i]) > max_extra_param:
                return True
        return False

    # -- projection ---------------------------------------------------------
    def _padded_params(self) -> np.ndarray:
        out = np.zeros(cm.MAX_PARAMS)
        out[: len(self.params)] = self.params
        return out

    def img_from_cam(self, cam_points: np.ndarray) -> np.ndarray:
        """Normalized camera-plane points [N,2] (or [N,3] hom.) -> pixels [N,2]."""
        pts = np.asarray(cam_points, dtype=np.float64)
        if pts.ndim >= 1 and pts.shape[-1] == 3:
            pts = pts[..., :2] / pts[..., 2:3]
        return img_from_cam_np(self.model_id, self._padded_params(), pts)

    def cam_from_img(self, image_points: np.ndarray) -> np.ndarray:
        """Pixels [N,2] -> normalized camera-plane points [N,2]."""
        pts = np.asarray(image_points, dtype=np.float64)
        return cam_from_img_np(self.model_id, self._padded_params(), pts)

    def cam_from_img_threshold(self, threshold: float) -> float:
        """Convert a pixel-space threshold to normalized units (ref: essential_matrix.h:42-47)."""
        return threshold / self.mean_focal_length()

    def rescale(self, new_width, new_height=None):
        """Scale intrinsics to a new resolution (ref: scene/camera.h rescale)."""
        if new_height is None:
            scale = float(new_width)
            new_w = int(round(self.width * scale))
            new_h = int(round(self.height * scale))
            sx = sy = scale
        else:
            new_w, new_h = int(new_width), int(new_height)
            sx = new_w / self.width
            sy = new_h / self.height
        for i in self.focal_length_idxs:
            self.params[i] *= (sx + sy) / 2.0 if len(self.focal_length_idxs) == 1 else (sx if i == self.focal_length_idxs[0] else sy)
        self.params[self.principal_point_idxs[0]] *= sx
        self.params[self.principal_point_idxs[1]] *= sy
        self.width, self.height = new_w, new_h

    def is_undistorted(self) -> bool:
        return all(abs(self.params[i]) < 1e-12 for i in self.extra_params_idxs)

    def __eq__(self, other):
        return (
            isinstance(other, Camera)
            and self.camera_id == other.camera_id
            and self.model == other.model
            and self.width == other.width
            and self.height == other.height
            and np.allclose(self.params, other.params)
        )

    def __repr__(self):
        return (
            f"Camera(camera_id={self.camera_id}, model={self.model}, "
            f"width={self.width}, height={self.height}, params=[{self.params_to_string()}])"
        )

    def summary(self) -> str:
        return repr(self)
