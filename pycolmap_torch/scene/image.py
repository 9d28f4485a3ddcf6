"""Image: a posed view with keypoints and 3D links.

API parity: pycolmap/scene/image.h:54-244. Keypoints are stored SoA
(``xy`` [N,2] float64 + ``point3D_ids`` [N] uint64) so the mapper can hand
them to device kernels without per-object marshalling; the ``points2D`` list
property provides the reference's object view.
"""

from __future__ import annotations

import numpy as np

from pycolmap_torch.geometry.types import Rigid3d
from pycolmap_torch.scene.point2d import INVALID_POINT3D_ID, Point2D

INVALID_IMAGE_ID = 4294967295


class Image:
    __slots__ = (
        "image_id",
        "name",
        "camera_id",
        "cam_from_world",
        "cam_from_world_prior",
        "_xy",
        "_xy_loader",
        "_lazy_count",
        "_p3d_ids",
        "registered",
        "num_points3D",
        "link_epoch",
    )

    def __init__(
        self,
        name: str = "",
        points2D=None,
        cam_from_world: Rigid3d = None,
        camera_id: int = INVALID_IMAGE_ID,
        id: int = INVALID_IMAGE_ID,
        keypoints_xy=None,
    ):
        self.image_id = int(id)
        self.name = name
        self.camera_id = int(camera_id)
        self.cam_from_world = cam_from_world if cam_from_world is not None else Rigid3d()
        self.cam_from_world_prior = None
        self._xy = np.zeros((0, 2), dtype=np.float64)
        self._p3d_ids = np.zeros((0,), dtype=np.uint64)
        self.registered = False
        self.num_points3D = 0
        # bumped on every keypoint->point3D link change; lets the mapper's
        # LinkIndex (sfm/link_index.py) refresh its flat lookup incrementally
        self.link_epoch = 0
        if keypoints_xy is not None:
            self.set_keypoints(keypoints_xy)
        elif points2D is not None:
            self.points2D = points2D

    # -- keypoints (SoA core) ----------------------------------------------
    def set_keypoints(self, xy: np.ndarray):
        xy = np.asarray(xy, dtype=np.float64).reshape(-1, 2)
        self._xy = xy.copy()
        self._p3d_ids = np.full(len(xy), INVALID_POINT3D_ID, dtype=np.uint64)
        self.num_points3D = 0
        self.link_epoch += 1

    def set_lazy_keypoints(self, count: int, loader):
        """Defer the keypoint-coordinate array: `loader()` is called on
        first points2D_xy access (streaming DatabaseCache for large scenes
        — ref analog pipeline/sfm.h:59-93 streaming DB load). The
        point3D-link array is allocated immediately (registration
        bookkeeping needs it before coordinates are ever read)."""
        self._xy = None
        self._xy_loader = loader
        self._lazy_count = int(count)
        self._p3d_ids = np.full(count, INVALID_POINT3D_ID, dtype=np.uint64)
        self.num_points3D = 0
        self.link_epoch += 1

    @property
    def points2D_xy(self) -> np.ndarray:
        if self._xy is None and getattr(self, "_xy_loader", None) is not None:
            xy = np.asarray(self._xy_loader(), dtype=np.float64)
            self._xy = xy.reshape(-1, 2)[: self._lazy_count]
            self._xy_loader = None
        return self._xy

    @property
    def points2D_point3D_ids(self) -> np.ndarray:
        return self._p3d_ids

    @property
    def points2D(self):
        return [Point2D(self._xy[i], int(self._p3d_ids[i])) for i in range(len(self._xy))]

    @points2D.setter
    def points2D(self, pts):
        self._xy = np.array([p.xy for p in pts], dtype=np.float64).reshape(-1, 2)
        self._p3d_ids = np.array(
            [p.point3D_id for p in pts], dtype=np.uint64
        ).reshape(-1)
        self.num_points3D = int(np.sum(self._p3d_ids != INVALID_POINT3D_ID))
        self.link_epoch += 1

    def point2D(self, idx: int) -> Point2D:
        return Point2D(self._xy[idx], int(self._p3d_ids[idx]))

    @property
    def num_points2D(self) -> int:
        if self._xy is None and getattr(self, "_xy_loader", None) is not None:
            return self._lazy_count
        return len(self._xy)

    # -- 3D links -----------------------------------------------------------
    def set_point3D_for_point2D(self, point2D_idx: int, point3D_id: int):
        if self._p3d_ids[point2D_idx] == INVALID_POINT3D_ID:
            self.num_points3D += 1
        self._p3d_ids[point2D_idx] = point3D_id
        self.link_epoch += 1

    def reset_point3D_for_point2D(self, point2D_idx: int):
        if self._p3d_ids[point2D_idx] != INVALID_POINT3D_ID:
            self.num_points3D -= 1
        self._p3d_ids[point2D_idx] = INVALID_POINT3D_ID
        self.link_epoch += 1

    def has_point3D(self, point3D_id: int) -> bool:
        return bool(np.any(self._p3d_ids == np.uint64(point3D_id)))

    def get_observation_points2D_idxs(self):
        return np.nonzero(self._p3d_ids != INVALID_POINT3D_ID)[0]

    # -- registration & pose -----------------------------------------------
    @property
    def has_pose(self) -> bool:
        return self.registered

    def projection_center(self) -> np.ndarray:
        """World-space camera center -R^T t (ref: scene/image.h:162)."""
        inv = self.cam_from_world.inverse()
        return inv.translation

    def viewing_direction(self) -> np.ndarray:
        """World-space optical axis (third row of R)."""
        return self.cam_from_world.rotation.matrix()[2, :]

    def project_point(self, world_point, camera) -> np.ndarray | None:
        """Project a world point into this image; None if behind camera."""
        p_cam = self.cam_from_world * np.asarray(world_point, dtype=np.float64)
        if p_cam[2] <= 0:
            return None
        return camera.img_from_cam(p_cam[None, :])[0]

    def __eq__(self, other):
        return (
            isinstance(other, Image)
            and self.image_id == other.image_id
            and self.name == other.name
            and self.camera_id == other.camera_id
        )

    def __repr__(self):
        return (
            f"Image(image_id={self.image_id}, camera_id={self.camera_id}, "
            f"name=\"{self.name}\", registered={self.registered}, "
            f"num_points2D={self.num_points2D}, num_points3D={self.num_points3D})"
        )
