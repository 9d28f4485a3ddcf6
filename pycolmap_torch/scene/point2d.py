"""Point2D: a keypoint observation, optionally linked to a 3D point.

API parity: pycolmap/scene/point2D.h:32-58. In this framework images store
their keypoints as dense arrays (SoA) for device friendliness; Point2D is the
per-element view used by the object API.
"""

from __future__ import annotations

import numpy as np

INVALID_POINT3D_ID = 18446744073709551615  # uint64 max, matches COLMAP


class Point2D:
    __slots__ = ("xy", "point3D_id")

    def __init__(self, xy=(0.0, 0.0), point3D_id: int = INVALID_POINT3D_ID):
        self.xy = np.asarray(xy, dtype=np.float64).reshape(2)
        self.point3D_id = int(point3D_id)

    def has_point3D(self) -> bool:
        return self.point3D_id != INVALID_POINT3D_ID

    def __eq__(self, other):
        return (
            isinstance(other, Point2D)
            and np.allclose(self.xy, other.xy)
            and self.point3D_id == other.point3D_id
        )

    def __repr__(self):
        return f"Point2D(xy={self.xy.tolist()}, point3D_id={self.point3D_id})"
