"""Two-view geometry estimation with E/F/H arbitration.

Port of ``pycolmap_tpu/estimators/two_view_geometry.py`` (API parity:
pycolmap/estimators/two_view_geometry.h): the configuration enum (:67-77),
``TwoViewGeometryOptions`` (:41-63), the result container,
``estimate_calibrated_two_view_geometry`` (:95),
``estimate_two_view_geometry`` (:124) and
``estimate_two_view_geometry_pose`` (:153).

The models are estimated as batched LO-RANSACs on one device; the winning
configuration follows the reference's inlier-ratio arbitration. The pose
is recovered from the inliers at their own size (the reference pads them
to pow2 buckets for its executable cache).
"""

from __future__ import annotations

import copy
import enum

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators import essential_matrix as em
from pycolmap_torch.estimators import fundamental_matrix as fm
from pycolmap_torch.estimators import homography_matrix as hm
from pycolmap_torch.estimators.ransac import RANSACOptions
from pycolmap_torch.geometry import Rigid3d, Rotation3d
from pycolmap_torch.ops import epipolar
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


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


@options_dataclass
class TwoViewGeometryOptions(BaseOptions):
    """Defaults mirror the reference (two_view_geometry.h:41-63)."""

    min_num_inliers: int = 15
    min_E_F_inlier_ratio: float = 0.95
    max_H_inlier_ratio: float = 0.8
    watermark_min_inlier_ratio: float = 0.7
    watermark_border_size: float = 0.1
    detect_watermark: bool = True
    multiple_ignore_watermark: bool = True
    force_H_use: bool = False
    compute_relative_pose: bool = False
    multiple_models: bool = False
    ransac: RANSACOptions = None

    def __post_init__(self):
        if self.ransac is None:
            self.ransac = RANSACOptions()


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


def _detect_watermark(x1_px, x2_px, inlier_mask, camera1, camera2, options):
    """Watermark = translation-only H inliers concentrated in the border
    (upstream DetectWatermark)."""
    inl = np.asarray(inlier_mask, dtype=bool)
    if inl.sum() == 0:
        return False
    d = x2_px[inl] - x1_px[inl]
    # translational model: median shift, count agreement
    shift = np.median(d, axis=0)
    agree = np.sum(np.sum((d - shift) ** 2, axis=1) <= options.ransac.max_error**2)
    if agree < options.watermark_min_inlier_ratio * inl.sum():
        return False
    bs1x = options.watermark_border_size * camera1.width
    bs1y = options.watermark_border_size * camera1.height
    in_border1 = (
        (x1_px[inl][:, 0] < bs1x)
        | (x1_px[inl][:, 0] > camera1.width - bs1x)
        | (x1_px[inl][:, 1] < bs1y)
        | (x1_px[inl][:, 1] > camera1.height - bs1y)
    )
    return np.mean(in_border1) > options.watermark_min_inlier_ratio


def _estimate_multiple(single_fn, matches, options) -> TwoViewGeometry:
    """MULTIPLE-configuration recovery (ref: two_view_geometry.h:67-77 and
    upstream EstimateMultipleTwoViewGeometries): repeatedly estimate a
    geometry on the remaining matches, peel its inliers off, and continue
    while each new geometry clears min_num_inliers. More than one surviving
    geometry -> config MULTIPLE with the union of inlier matches; exactly
    one -> that geometry; none -> DEGENERATE. Watermark geometries are
    peeled but not collected when multiple_ignore_watermark is set."""
    sub = copy.deepcopy(options)
    sub.multiple_models = False
    remaining = matches
    geometries = []
    while len(remaining) >= options.min_num_inliers:
        g = single_fn(remaining, sub)
        if len(g.inlier_matches) < options.min_num_inliers:
            break
        inl = {tuple(m) for m in g.inlier_matches.tolist()}
        keep = np.array(
            [tuple(m) not in inl for m in remaining.tolist()], dtype=bool
        )
        remaining = remaining[keep]
        if (
            g.config == int(TwoViewGeometryConfiguration.WATERMARK)
            and options.multiple_ignore_watermark
        ):
            continue
        geometries.append(g)
    if not geometries:
        out = TwoViewGeometry()
        out.config = int(TwoViewGeometryConfiguration.DEGENERATE)
        return out
    if len(geometries) == 1:
        return geometries[0]
    out = TwoViewGeometry()
    out.config = int(TwoViewGeometryConfiguration.MULTIPLE)
    out.inlier_matches = np.concatenate(
        [g.inlier_matches for g in geometries]
    ).astype(np.uint32)
    # keep the dominant geometry's models for downstream consumers
    out.E, out.F, out.H = (
        geometries[0].E, geometries[0].F, geometries[0].H
    )
    return out


def _matches(points2D1, matches):
    if matches is None:
        matches = np.stack(
            [np.arange(len(points2D1)), np.arange(len(points2D1))], axis=1)
    return np.asarray(matches).reshape(-1, 2)


def estimate_calibrated_two_view_geometry(
    camera1, points2D1, camera2, points2D2, matches=None,
    options: TwoViewGeometryOptions = None, device=None,
) -> TwoViewGeometry:
    """E + F + H estimation with degeneracy arbitration (ref: :95-123). Runs
    on `device` (default: the card)."""
    if options is None:
        options = TwoViewGeometryOptions()
    device = resolve_device(device)
    points2D1 = np.asarray(points2D1, dtype=np.float64).reshape(-1, 2)
    points2D2 = np.asarray(points2D2, dtype=np.float64).reshape(-1, 2)
    if matches is None and len(points2D1) != len(points2D2):
        raise ValueError("without matches, point arrays must align")
    matches = _matches(points2D1, matches)
    if options.multiple_models:
        return _estimate_multiple(
            lambda m, o: estimate_calibrated_two_view_geometry(
                camera1, points2D1, camera2, points2D2, m, o, device=device
            ),
            matches, options,
        )
    geometry = TwoViewGeometry()
    if len(matches) < options.min_num_inliers:
        geometry.config = int(TwoViewGeometryConfiguration.DEGENERATE)
        return geometry

    x1_px = points2D1[matches[:, 0]]
    x2_px = points2D2[matches[:, 1]]

    e_res = em.estimate_essential_matrix(
        x1_px, x2_px, camera1, camera2, options.ransac, device=device)
    f_res = fm.estimate_fundamental_matrix(x1_px, x2_px, options.ransac,
                                           device=device)
    h_res = hm.estimate_homography_matrix(x1_px, x2_px, options.ransac,
                                          device=device)

    e_inl = e_res["num_inliers"] if e_res else 0
    f_inl = f_res["num_inliers"] if f_res else 0
    h_inl = h_res["num_inliers"] if h_res else 0

    if max(e_inl, f_inl, h_inl) < options.min_num_inliers:
        geometry.config = int(TwoViewGeometryConfiguration.DEGENERATE)
        return geometry

    best_inl = max(e_inl, f_inl)
    if e_inl >= options.min_num_inliers and e_inl >= options.min_E_F_inlier_ratio * f_inl:
        mask = e_res["inliers"]
        geometry.config = int(TwoViewGeometryConfiguration.CALIBRATED)
    elif f_inl >= options.min_num_inliers:
        mask = f_res["inliers"]
        geometry.config = int(TwoViewGeometryConfiguration.UNCALIBRATED)
    else:
        mask = h_res["inliers"]
        geometry.config = int(TwoViewGeometryConfiguration.PLANAR_OR_PANORAMIC)

    # a planar scene explains the epipolar inliers as well: the epipolar
    # model's inliers are kept (as upstream keeps the best model's)
    if (
        geometry.config
        in (
            int(TwoViewGeometryConfiguration.CALIBRATED),
            int(TwoViewGeometryConfiguration.UNCALIBRATED),
        )
        and h_inl > options.max_H_inlier_ratio * best_inl
    ):
        geometry.config = int(TwoViewGeometryConfiguration.PLANAR_OR_PANORAMIC)

    if e_res is not None:
        geometry.E = e_res["E"]
    if f_res is not None:
        geometry.F = f_res["F"]
    if h_res is not None:
        geometry.H = h_res["H"]

    if options.detect_watermark and _detect_watermark(
        x1_px, x2_px, mask, camera1, camera2, options
    ):
        geometry.config = int(TwoViewGeometryConfiguration.WATERMARK)

    geometry.inlier_matches = matches[np.asarray(mask, dtype=bool)].astype(np.uint32)
    if options.compute_relative_pose:
        estimate_two_view_geometry_pose(
            camera1, points2D1, camera2, points2D2, geometry, device=device
        )
    return geometry


def estimate_two_view_geometry(
    camera1, points2D1, camera2, points2D2, matches=None,
    options: TwoViewGeometryOptions = None, device=None,
) -> TwoViewGeometry:
    """Uncalibrated entry point (ref: :124-152): F + H only. Runs on
    `device` (default: the card)."""
    if options is None:
        options = TwoViewGeometryOptions()
    device = resolve_device(device)
    points2D1 = np.asarray(points2D1, dtype=np.float64).reshape(-1, 2)
    points2D2 = np.asarray(points2D2, dtype=np.float64).reshape(-1, 2)
    matches = _matches(points2D1, matches)
    if options.multiple_models:
        return _estimate_multiple(
            lambda m, o: estimate_two_view_geometry(
                camera1, points2D1, camera2, points2D2, m, o, device=device
            ),
            matches, options,
        )
    geometry = TwoViewGeometry()
    if len(matches) < options.min_num_inliers:
        geometry.config = int(TwoViewGeometryConfiguration.DEGENERATE)
        return geometry
    x1_px = points2D1[matches[:, 0]]
    x2_px = points2D2[matches[:, 1]]
    f_res = fm.estimate_fundamental_matrix(x1_px, x2_px, options.ransac,
                                           device=device)
    h_res = hm.estimate_homography_matrix(x1_px, x2_px, options.ransac,
                                          device=device)
    f_inl = f_res["num_inliers"] if f_res else 0
    h_inl = h_res["num_inliers"] if h_res else 0
    if max(f_inl, h_inl) < options.min_num_inliers:
        geometry.config = int(TwoViewGeometryConfiguration.DEGENERATE)
        return geometry
    if h_inl > options.max_H_inlier_ratio * f_inl:
        geometry.config = int(TwoViewGeometryConfiguration.PLANAR_OR_PANORAMIC)
        mask = h_res["inliers"]
    else:
        geometry.config = int(TwoViewGeometryConfiguration.UNCALIBRATED)
        mask = f_res["inliers"]
    if f_res is not None:
        geometry.F = f_res["F"]
    if h_res is not None:
        geometry.H = h_res["H"]
    if options.detect_watermark and _detect_watermark(
        x1_px, x2_px, mask, camera1, camera2, options
    ):
        geometry.config = int(TwoViewGeometryConfiguration.WATERMARK)
    geometry.inlier_matches = matches[np.asarray(mask, dtype=bool)].astype(np.uint32)
    if options.compute_relative_pose:
        estimate_two_view_geometry_pose(
            camera1, points2D1, camera2, points2D2, geometry, device=device
        )
    return geometry


def estimate_two_view_geometry_pose(
    camera1, points2D1, camera2, points2D2, geometry: TwoViewGeometry,
    device=None,
) -> bool:
    """Recover cam2_from_cam1 + median tri angle for an estimated geometry
    (ref: :153-160; upstream EstimateTwoViewGeometryPose). Runs on `device`
    (default: the card)."""
    if len(geometry.inlier_matches) == 0:
        return False
    device = resolve_device(device)
    points2D1 = np.asarray(points2D1, dtype=np.float64).reshape(-1, 2)
    points2D2 = np.asarray(points2D2, dtype=np.float64).reshape(-1, 2)
    m = geometry.inlier_matches

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    x1 = dev(camera1.cam_from_img(points2D1[m[:, 0]]))
    x2 = dev(camera2.cam_from_img(points2D2[m[:, 1]]))
    cfg = geometry.config
    C = TwoViewGeometryConfiguration
    if cfg in (int(C.CALIBRATED), int(C.UNCALIBRATED)):
        if cfg == int(C.CALIBRATED) and geometry.E is not None:
            E = geometry.E
        else:
            # build E from F: E = K2^T F K1
            E = (camera2.calibration_matrix().T @ geometry.F
                 @ camera1.calibration_matrix())
        quat, trans, X, front = epipolar.pose_from_essential(dev(E), x1, x2)
    elif cfg in (int(C.PLANAR), int(C.PANORAMIC), int(C.PLANAR_OR_PANORAMIC)):
        Hn = np.linalg.solve(
            camera2.calibration_matrix(),
            np.asarray(geometry.H, np.float64) @ camera1.calibration_matrix())
        quat, trans, _, X, front = epipolar.pose_from_homography(
            dev(Hn), x1, x2)
        # refine config: pure rotation -> PANORAMIC
        if float(torch.linalg.norm(trans)) < 1e-6:
            geometry.config = int(C.PANORAMIC)
        elif cfg == int(C.PLANAR_OR_PANORAMIC):
            geometry.config = int(C.PLANAR)
    else:
        return False

    quat = quat.cpu().numpy().astype(np.float64)
    trans_np = trans.cpu().numpy().astype(np.float64)
    norm = np.linalg.norm(trans_np)
    if norm > 1e-12:
        trans_np = trans_np / norm
    rotation = Rotation3d(np.array([quat[1], quat[2], quat[3], quat[0]]))
    geometry.cam2_from_cam1 = Rigid3d(rotation, trans_np)
    # median triangulation angle over the points in front
    X = X.cpu().numpy().astype(np.float64)
    front = front.cpu().numpy()
    if front.sum() > 0:
        c2 = -np.asarray(rotation.matrix().T @ trans_np)
        Xf = X[front]
        r2 = Xf - c2
        cosang = np.sum(Xf * r2, axis=1) / np.maximum(
            np.linalg.norm(Xf, axis=1) * np.linalg.norm(r2, axis=1), 1e-12
        )
        geometry.tri_angle = float(np.median(np.arccos(np.clip(cosang, -1, 1))))
    return True
