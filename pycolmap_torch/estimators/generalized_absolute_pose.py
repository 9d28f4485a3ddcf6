"""Generalized (multi-camera rig) absolute pose estimation.

API parity: pycolmap/estimators/generalized_absolute_pose.h:82-95
(``rig_absolute_pose_estimation``): 2D-3D correspondences distributed over a
rig of cameras with known cams_from_rig extrinsics -> rig_from_world pose.

Port of ``pycolmap_tpu/estimators/generalized_absolute_pose.py``. Hypotheses
come from batched P3P on samples drawn within a single member camera (each
per-camera pose composes with the known extrinsic into a rig pose
hypothesis) and are scored against all rig observations at once on the
device. A sample is valid only if its three observations share one
camera's extrinsics: with k rig cameras of equal share, about 1/k² of the
draws. The pose is then polished by 15 Gauss-Newton steps over the rig's
inliers, with no host synchronisation.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.absolute_pose import (
    AbsolutePoseEstimationOptions,
    AbsolutePoseRefinementOptions,
    _rigid3d_from_wxyz,
)
from pycolmap_torch.estimators.ransac import BatchedLORANSAC
from pycolmap_torch.ops import quaternion as qops
from pycolmap_torch.ops import solvers


def _rig_residual(model, x, X, cam_quat, cam_trans):
    """model: (quat [K,S,4], trans [K,S,3]) rig_from_world.

    x [N,2] normalized per-obs points; X [N,3] world; cam_quat/trans [N,...]
    per-observation cam_from_rig extrinsics.
    """
    quat, trans = model
    # world -> rig -> cam
    p_rig = (qops.quat_rotate(quat[:, :, None, :], X[None, None])
             + trans[:, :, None, :])
    p_cam = (qops.quat_rotate(cam_quat[None, None], p_rig)
             + cam_trans[None, None])
    z = p_cam[..., 2]
    behind = z <= 1e-8
    z_safe = torch.where(behind, torch.ones_like(z), z)
    proj = p_cam[..., :2] / z_safe[..., None]
    err = torch.sum((proj - x[None, None]) ** 2, dim=-1)
    return torch.where(behind, torch.full_like(err, 1e12), err)


def _same_camera(idx, cq, ct):
    """[K]: the sample's three observations share one camera's extrinsics."""
    def close(a, i, j):
        return torch.all(torch.abs(a[idx[:, i]] - a[idx[:, j]]) < 1e-6, dim=-1)

    return close(cq, 0, 1) & close(cq, 0, 2) & close(ct, 0, 1) & close(ct, 0, 2)


def _minimal(idx, x, Xw, cq, ct, same_counts=None):
    """P3P in the sampled observations' own camera frames, composed into rig
    poses; samples across cameras are rejected through validity."""
    same = _same_camera(idx, cq, ct)
    if same_counts is not None:
        same_counts.append(torch.sum(same))
    quat_c, trans_c, valid = solvers.p3p(x[idx], Xw[idx])  # cam_from_world
    # rig_from_world = (cam_from_rig)^-1 * cam_from_world
    qi, ti = qops.rigid_inverse(cq[idx[:, 0]], ct[idx[:, 0]])
    quat_r, trans_r = qops.rigid_compose(
        qi[:, None, :], ti[:, None, :], quat_c, trans_c
    )
    return (quat_r, trans_r), valid & same[:, None]


def _refine_rig_gn(quat0, trans0, x, X, cam_quat, cam_trans, w, steps=15):
    """The reference's undamped Gauss-Newton over the rig pose: the
    Jacobian from ``torch.func.jacfwd``, each step solved with ``solve_ex``,
    so no step synchronises the host."""

    def residuals(params):
        quat = qops.quat_boxplus(quat0, params[:3])
        p_rig = qops.quat_rotate(quat[None], X) + params[3:6][None]
        p_cam = qops.quat_rotate(cam_quat, p_rig) + cam_trans
        z = p_cam[:, 2]
        z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
        proj = p_cam[:, :2] / z[:, None]
        return ((proj - x) * w[:, None]).reshape(-1)

    jacobian = torch.func.jacfwd(residuals)
    eye = 1e-6 * torch.eye(6, dtype=x.dtype, device=x.device)
    params = torch.cat([torch.zeros_like(trans0), trans0])
    for _ in range(steps):
        J = jacobian(params)
        r = residuals(params)
        params = params - solvers._solve(J.T @ J + eye, (J.T @ r)[:, None])[:, 0]
    return qops.quat_boxplus(quat0, params[:3]), params[3:6]


def _unproject(points2D, cameras):
    """Normalized coordinates of each observation: one ``cam_from_img``
    call per distinct camera object over all its observations."""
    x = np.zeros((len(points2D), 2), dtype=np.float64)
    groups = {}
    for i, cam in enumerate(cameras):
        groups.setdefault(id(cam), (cam, []))[1].append(i)
    for cam, rows in groups.values():
        x[rows] = cam.cam_from_img(points2D[rows])
    return x, groups


def rig_absolute_pose_estimation(
    points2D,
    points3D,
    cameras,
    cams_from_rig,
    estimation_options: AbsolutePoseEstimationOptions = None,
    refinement_options: AbsolutePoseRefinementOptions = None,
    device=None,
    stats: dict = None,
):
    """Estimate rig_from_world. points2D[i] is observed by cameras[i], whose
    cam_from_rig extrinsic is cams_from_rig[i].

    Arguments follow the reference binding: points2D Nx2 pixels, points3D
    Nx3, ``cameras`` a Camera per observation, cams_from_rig a Rigid3d per
    observation. Runs on `device` (None = the card). Given a ``stats``
    dict, fills in ``samples`` (minimal samples drawn) and
    ``valid_samples`` (those whose three observations share one camera).
    Returns dict(rig_from_world, num_inliers, inliers) or None.
    """
    if estimation_options is None:
        estimation_options = AbsolutePoseEstimationOptions()
    if refinement_options is None:
        refinement_options = AbsolutePoseRefinementOptions()
    device = resolve_device(device)
    points2D = np.asarray(points2D, dtype=np.float64)
    points3D = np.asarray(points3D, dtype=np.float64)
    n = len(points2D)
    if n < 3 or len(cameras) != n or len(cams_from_rig) != n:
        return None

    # normalized coords + per-obs extrinsics (wxyz)
    x_norm, groups = _unproject(points2D, cameras)
    x_norm = x_norm.astype(np.float32)
    q = np.asarray([c.rotation.quat for c in cams_from_rig], dtype=np.float64)
    cam_quat = q[:, [3, 0, 1, 2]].astype(np.float32)
    cam_trans = np.asarray([c.translation for c in cams_from_rig],
                           dtype=np.float32)
    focal = np.zeros(n)
    for cam, rows in groups.values():
        focal[rows] = cam.mean_focal_length()
    X = points3D.astype(np.float32)

    opt = copy.deepcopy(estimation_options.ransac)
    opt.max_error = estimation_options.ransac.max_error / max(np.mean(focal), 1e-9)
    same_counts = [] if stats is not None else None
    engine = BatchedLORANSAC(
        minimal_solver=functools.partial(_minimal, same_counts=same_counts),
        residual_fn=_rig_residual,
        sample_size=3,
        chunk_size=1024,
    )
    report = engine.estimate(opt, x_norm, X, cam_quat, cam_trans,
                             device=device, seed=0)
    if stats is not None:
        stats["samples"] = report.num_trials
        stats["valid_samples"] = (int(torch.stack(same_counts).sum())
                                  if same_counts else 0)
    if not report.success:
        return None
    if report.support_num_inliers < 3:
        return None

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    quat, trans = _refine_rig_gn(
        dev(report.model[0]), dev(report.model[1]), dev(x_norm), dev(X),
        dev(cam_quat), dev(cam_trans), dev(report.inlier_mask))
    return {
        "rig_from_world": _rigid3d_from_wxyz(
            quat.cpu().numpy().astype(np.float64),
            trans.cpu().numpy().astype(np.float64)),
        "num_inliers": report.support_num_inliers,
        "inliers": report.inlier_mask,
    }
