"""Fundamental matrix estimation (API parity: pycolmap/estimators/fundamental_matrix.h).

Port of ``pycolmap_tpu/estimators/fundamental_matrix.py``: LO-RANSAC with the
7-point minimal solver and the weighted 8-point local optimization
(ref: fundamental_matrix.h:26-28 — LORANSAC<7pt, 8pt>), batched on the
device. Deterministic: a fixed seed per call (ref: fundamental_matrix.h:21
SetPRNGSeed(0)).
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.ransac import BatchedLORANSAC, RANSACOptions
from pycolmap_torch.ops import solvers


def _sampson_batched(F, x1, x2):
    """F [K, S, 3, 3]; x [N, 2] -> [K, S, N] squared Sampson error."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Fx1 = torch.einsum("ksij,nj->ksni", F, p1)
    Ftx2 = torch.einsum("ksji,nj->ksni", F, p2)
    x2Fx1 = torch.einsum("ni,ksni->ksn", p2, Fx1)
    denom = (Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2
             + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2)
    return x2Fx1**2 / torch.clamp(denom, min=1e-12)


def _minimal_7pt(idx, x1, x2):
    return solvers.fundamental_7pt(x1[idx], x2[idx])  # [K, 3, 3, 3], [K, 3]


def _refit_8pt(weights, x1, x2):
    F = solvers.fundamental_8pt(x1[None], x2[None], weights[None])
    return F[:, None], torch.ones((1, 1), dtype=torch.bool, device=F.device)


_engine = BatchedLORANSAC(
    minimal_solver=_minimal_7pt,
    residual_fn=_sampson_batched,
    sample_size=7,
    refit_solver=_refit_8pt,
)


def estimate_fundamental_matrix(points2D1, points2D2,
                                options: RANSACOptions = None, device=None):
    """LORANSAC F estimation. Returns dict(F, num_inliers, inliers) or None.

    points2D1/2: Nx2 pixel coordinates; options.max_error in pixels. Runs on
    `device` (default: the card).
    """
    if options is None:
        options = RANSACOptions()
    options.check()
    device = resolve_device(device)
    x1 = np.asarray(points2D1, dtype=np.float32)
    x2 = np.asarray(points2D2, dtype=np.float32)
    if x1.shape != x2.shape or x1.ndim != 2 or x1.shape[1] != 2:
        raise ValueError("points2D1/points2D2 must be matching Nx2 arrays")
    report = _engine.estimate(options, x1, x2, device=device, seed=0)
    if not report.success:
        return None
    return {
        "F": np.asarray(report.model, dtype=np.float64),
        "num_inliers": report.support_num_inliers,
        "inliers": report.inlier_mask,
        "num_trials": report.num_trials,
    }


# reference-compatible name (ref: fundamental_matrix.h:44)
fundamental_matrix_estimation = estimate_fundamental_matrix
