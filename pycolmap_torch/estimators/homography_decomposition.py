"""Homography decomposition API (parity: pycolmap/geometry/homography_matrix.h:33-41).

Port of ``pycolmap_tpu/estimators/homography_decomposition.py``:
``homography_decomposition(H, K1, K2, points1, points2)`` ->
dict(R, t, n, points3D), the cheirality-selected decomposition.
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.ops import epipolar
from pycolmap_torch.ops import quaternion as qops


def homography_decomposition(H, K1, K2, points1, points2, device=None):
    """Decompose H (pixel-space, x2 ~ H x1) with calibration K1/K2.

    points1/points2: Nx2 pixel correspondences used for the cheirality test.
    Returns dict(R, t, n, points3D). Runs on `device` (default: the card).
    """
    device = resolve_device(device)
    H = np.asarray(H, dtype=np.float64)
    K1 = np.asarray(K1, dtype=np.float64)
    K2 = np.asarray(K2, dtype=np.float64)
    x1 = np.asarray(points1, dtype=np.float64).reshape(-1, 2)
    x2 = np.asarray(points2, dtype=np.float64).reshape(-1, 2)

    def norm(K, x):
        xh = np.concatenate([x, np.ones((len(x), 1))], axis=1)
        xn = np.linalg.solve(K, xh.T).T
        return torch.from_numpy((xn[:, :2] / xn[:, 2:]).astype(np.float32))

    Hn = np.linalg.solve(K2, H @ K1).astype(np.float32)
    quat, trans, n, X, front = epipolar.pose_from_homography(
        torch.from_numpy(Hn).to(device), norm(K1, x1).to(device),
        norm(K2, x2).to(device))
    R = qops.quat_to_matrix(quat)
    front = front.cpu().numpy()
    return {
        "R": R.cpu().numpy().astype(np.float64),
        "t": trans.cpu().numpy().astype(np.float64),
        "n": n.cpu().numpy().astype(np.float64),
        "points3D": X.cpu().numpy().astype(np.float64)[front],
    }
