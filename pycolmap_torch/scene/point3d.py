"""Point3D: a triangulated world point with color, error, and track.

API parity: pycolmap/scene/point3D.h:22-43.
"""

from __future__ import annotations

import numpy as np

from pycolmap_torch.scene.track import Track


class Point3D:
    __slots__ = ("xyz", "color", "error", "track")

    def __init__(self, xyz=(0.0, 0.0, 0.0), color=(0, 0, 0), error: float = -1.0, track=None):
        self.xyz = np.asarray(xyz, dtype=np.float64).reshape(3)
        self.color = np.asarray(color, dtype=np.uint8).reshape(3)
        self.error = float(error)
        self.track = track if track is not None else Track()

    @property
    def x(self):
        return float(self.xyz[0])

    @property
    def y(self):
        return float(self.xyz[1])

    @property
    def z(self):
        return float(self.xyz[2])

    def __eq__(self, other):
        return (
            isinstance(other, Point3D)
            and np.allclose(self.xyz, other.xyz)
            and self.error == other.error
        )

    def __repr__(self):
        return (
            f"Point3D(xyz={np.round(self.xyz, 6).tolist()}, "
            f"track_length={self.track.length()}, error={self.error:.4g})"
        )
