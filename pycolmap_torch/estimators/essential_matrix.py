"""Essential matrix estimation (API parity: pycolmap/estimators/essential_matrix.h).

Port of ``pycolmap_tpu/estimators/essential_matrix.py``. As the reference
(essential_matrix.h:25-93): normalize pixel points through the cameras,
scale the pixel threshold to normalized units (:42-47), run LO-RANSAC, then
recover the relative pose by cheirality (:77-83).

Minimal solver: the batched Nistér 5-point (``ops/solvers.essential_5pt``:
degree-10 roots by tan-angle bisection), 128 samples a chunk, so 1280
hypotheses; local optimization refits with the weighted 8-point solver
projected on the essential manifold. The pose is recovered from the
inliers at their own size (the reference pads them to 4x steps for its
executable cache).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.fundamental_matrix import _sampson_batched
from pycolmap_torch.estimators.ransac import BatchedLORANSAC, RANSACOptions
from pycolmap_torch.geometry import Rigid3d, Rotation3d
from pycolmap_torch.ops import epipolar, solvers


def _minimal_5pt(idx, x1, x2):
    return solvers.essential_5pt(x1[idx], x2[idx])  # [K,10,3,3], [K,10]


def _refit_8pt(weights, x1, x2):
    E = solvers.essential_8pt(x1[None], x2[None], weights[None])
    return E[:, None], torch.ones((1, 1), dtype=torch.bool, device=E.device)


_engine = BatchedLORANSAC(
    minimal_solver=_minimal_5pt,
    residual_fn=_sampson_batched,
    sample_size=5,
    refit_solver=_refit_8pt,
    chunk_size=128,  # x10 solutions per sample = 1280 hypotheses per chunk
)


def estimate_essential_matrix(
    points2D1, points2D2, camera1, camera2, options: RANSACOptions = None,
    device=None,
):
    """LORANSAC E estimation + cheirality pose recovery.

    Returns dict(E, cam2_from_cam1, num_inliers, inliers) or None.
    points are pixel coordinates; options.max_error is in pixels and is
    rescaled by the mean focal lengths (ref: essential_matrix.h:42-47).
    Runs on `device` (default: the card).
    """
    if options is None:
        options = RANSACOptions()
    options.check()
    device = resolve_device(device)
    x1 = np.asarray(camera1.cam_from_img(points2D1), dtype=np.float32)
    x2 = np.asarray(camera2.cam_from_img(points2D2), dtype=np.float32)
    opt = copy.deepcopy(options)
    opt.max_error = 0.5 * (
        options.max_error / camera1.mean_focal_length()
        + options.max_error / camera2.mean_focal_length()
    )
    report = _engine.estimate(opt, x1, x2, device=device, seed=0)
    if not report.success:
        return None
    E = np.asarray(report.model, dtype=np.float64)
    quat, trans, points3D, front = epipolar.pose_from_essential(
        torch.from_numpy(E.astype(np.float32)).to(device),
        torch.from_numpy(x1).to(device), torch.from_numpy(x2).to(device),
        torch.from_numpy(report.inlier_mask).to(device))
    quat = quat.cpu().numpy().astype(np.float64)
    cam2_from_cam1 = Rigid3d(
        Rotation3d(np.array([quat[1], quat[2], quat[3], quat[0]])),
        trans.cpu().numpy().astype(np.float64),
    )
    return {
        "E": E,
        "cam2_from_cam1": cam2_from_cam1,
        "num_inliers": report.support_num_inliers,
        "inliers": report.inlier_mask,
        "points3D": points3D.cpu().numpy().astype(np.float64)[
            front.cpu().numpy()],
        "num_trials": report.num_trials,
    }


essential_matrix_estimation = estimate_essential_matrix
