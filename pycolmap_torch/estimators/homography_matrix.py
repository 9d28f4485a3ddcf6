"""Homography estimation (API parity: pycolmap/estimators/homography_matrix.h).

Port of ``pycolmap_tpu/estimators/homography_matrix.py``: LO-RANSAC with
batched 4-point DLT hypotheses and weighted-DLT local optimization
(ref: homography_matrix.h:25-27).
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.ransac import BatchedLORANSAC, RANSACOptions
from pycolmap_torch.ops import solvers


def _transfer_batched(H, x1, x2):
    """H [K, S, 3, 3]; x [N, 2] -> [K, S, N] squared transfer error."""
    p1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    Hx1 = torch.einsum("ksij,nj->ksni", H, p1)
    w = Hx1[..., 2]
    bad = torch.abs(w) < 1e-8
    w_safe = torch.where(bad, torch.ones_like(w), w)
    err = torch.sum((Hx1[..., :2] / w_safe[..., None] - x2) ** 2, dim=-1)
    return torch.where(bad, torch.full_like(err, 1e12), err)


def _minimal_4pt(idx, x1, x2):
    H = solvers.homography_dlt(x1[idx], x2[idx])
    # degenerate (collinear) samples produce near-singular H; mark invalid
    det = torch.abs(torch.linalg.det(H))
    return H[:, None], (det > 1e-12)[:, None]


def _refit_dlt(weights, x1, x2):
    H = solvers.homography_dlt(x1[None], x2[None], weights[None])
    return H[:, None], torch.ones((1, 1), dtype=torch.bool, device=H.device)


_engine = BatchedLORANSAC(
    minimal_solver=_minimal_4pt,
    residual_fn=_transfer_batched,
    sample_size=4,
    refit_solver=_refit_dlt,
)


def estimate_homography_matrix(points2D1, points2D2,
                               options: RANSACOptions = None, device=None):
    """LORANSAC H estimation. Returns dict(H, num_inliers, inliers) or None.

    Runs on `device` (default: the card)."""
    if options is None:
        options = RANSACOptions()
    options.check()
    device = resolve_device(device)
    x1 = np.asarray(points2D1, dtype=np.float32)
    x2 = np.asarray(points2D2, dtype=np.float32)
    report = _engine.estimate(options, x1, x2, device=device, seed=0)
    if not report.success:
        return None
    return {
        "H": np.asarray(report.model, dtype=np.float64),
        "num_inliers": report.support_num_inliers,
        "inliers": report.inlier_mask,
        "num_trials": report.num_trials,
    }


homography_matrix_estimation = estimate_homography_matrix
