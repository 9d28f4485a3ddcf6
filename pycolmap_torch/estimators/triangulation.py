"""Robust multi-view triangulation (API parity: pycolmap/estimators/triangulation.h).

Port of ``pycolmap_tpu/estimators/triangulation.py``: RANSAC over view
pairs. Sample two observations, DLT-triangulate, score by reprojection over
all observing views with per-view pixel thresholds and a minimum
triangulation angle (ref: triangulation.h:22-76).
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.ransac import BatchedLORANSAC, RANSACOptions
from pycolmap_torch.ops import solvers
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class EstimateTriangulationOptions(BaseOptions):
    min_tri_angle: float = 1.5  # degrees (upstream default 1.5deg)
    ransac: RANSACOptions = None

    def __post_init__(self):
        if self.ransac is None:
            self.ransac = RANSACOptions()


def _tri_residual(model, x, proj, fsq, centers):
    """model: X [K, S, 3]; residual = pixel^2 reprojection over views."""
    Xh = torch.cat([model, torch.ones_like(model[..., :1])], dim=-1)  # [K,S,4]
    p = torch.einsum("mij,ksj->ksmi", proj, Xh)  # [K,S,M,3]
    z = p[..., 2]
    behind = z <= 1e-8
    z_safe = torch.where(behind, torch.ones_like(z), z)
    uv = p[..., :2] / z_safe[..., None]
    err = torch.sum((uv - x[None, None]) ** 2, dim=-1) * fsq[None, None]
    return torch.where(behind, torch.full_like(err, 1e12), err)


def _make_minimal(min_tri_angle_rad):
    def minimal(idx, x, proj, fsq, centers):
        # idx [K, 2] view pairs
        X = solvers.triangulate_dlt(proj[idx], x[idx])  # [K,3]
        # triangulation angle check
        r1 = centers[idx[:, 0]] - X
        r2 = centers[idx[:, 1]] - X
        denom = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1)
        cosang = torch.sum(r1 * r2, dim=-1) / torch.clamp(denom, min=1e-12)
        angle = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        return X[:, None], (angle >= min_tri_angle_rad)[:, None]

    return minimal


def _refit(weights, x, proj, fsq, centers):
    X = solvers.triangulate_dlt(proj[None], x[None], weights[None])
    return X[:, None], torch.ones((1, 1), dtype=torch.bool, device=X.device)


def estimate_triangulation(
    points2D,
    cams_from_world,
    cameras,
    options: EstimateTriangulationOptions = None,
    device=None,
):
    """Triangulate a track robustly.

    points2D: Mx2 pixel observations; cams_from_world: list of M Rigid3d;
    cameras: list of M Camera. Returns dict(point3D, inliers) or None. Runs
    on `device` (default: the card).
    """
    if options is None:
        options = EstimateTriangulationOptions()
    device = resolve_device(device)
    M = len(points2D)
    if M < 2:
        return None
    x_norm = np.stack(
        [
            np.asarray(cameras[i].cam_from_img(np.asarray(points2D[i])[None]))[0]
            for i in range(M)
        ]
    ).astype(np.float32)
    proj = np.stack([t.matrix() for t in cams_from_world]).astype(np.float32)
    fsq = np.array(
        [cameras[i].mean_focal_length() ** 2 for i in range(M)], dtype=np.float32
    )
    centers = np.stack(
        [t.inverse().translation for t in cams_from_world]
    ).astype(np.float32)

    min_angle_rad = float(np.float32(np.deg2rad(options.min_tri_angle)))
    engine = BatchedLORANSAC(
        minimal_solver=_make_minimal(min_angle_rad),
        residual_fn=_tri_residual,
        sample_size=2,
        refit_solver=_refit,
        chunk_size=64,
    )
    report = engine.estimate(options.ransac, x_norm, proj, fsq, centers,
                             device=device, seed=0)
    if not report.success or report.support_num_inliers < 2:
        return None
    return {
        "point3D": np.asarray(report.model, dtype=np.float64),
        "inliers": report.inlier_mask,
        "num_inliers": report.support_num_inliers,
    }


estimate_triangulation_robust = estimate_triangulation
