"""Two-view geometry records.

Port of the two definitions of ``pycolmap_tpu/estimators/two_view_geometry.py``
that the database layer reads and writes (API parity:
pycolmap/estimators/two_view_geometry.h): the configuration enum (:67-77)
and the result container. The estimators of that module (E/F/H
arbitration over batched LO-RANSACs) come with the mapping slice
(ROADMAP.md).
"""

from __future__ import annotations

import enum

import numpy as np


class TwoViewGeometryConfiguration(enum.IntEnum):
    """Matches upstream TwoViewGeometry::ConfigurationType (two_view_geometry.h:67-77)."""

    UNDEFINED = 0
    DEGENERATE = 1
    CALIBRATED = 2
    UNCALIBRATED = 3
    PLANAR = 4
    PANORAMIC = 5
    PLANAR_OR_PANORAMIC = 6
    WATERMARK = 7
    MULTIPLE = 8


class TwoViewGeometry:
    """Result container (mirrors upstream TwoViewGeometry struct)."""

    __slots__ = (
        "config", "E", "F", "H", "cam2_from_cam1",
        "inlier_matches", "tri_angle",
    )

    def __init__(self):
        self.config = int(TwoViewGeometryConfiguration.UNDEFINED)
        self.E = None
        self.F = None
        self.H = None
        self.cam2_from_cam1 = None
        self.inlier_matches = np.zeros((0, 2), dtype=np.uint32)
        self.tri_angle = 0.0

    def invalidate(self):
        self.__init__()

    def __repr__(self):
        return (
            f"TwoViewGeometry(config={TwoViewGeometryConfiguration(self.config).name}, "
            f"num_inliers={len(self.inlier_matches)})"
        )
