"""Absolute camera pose from 2D-3D matches (API parity: pycolmap/estimators/absolute_pose.h).

Port of ``pycolmap_tpu/estimators/absolute_pose.py``: RANSAC over batched
P3P hypotheses (upstream P3PEstimator), EPnP local optimization (upstream
EPNPEstimator, the non-minimal solver), then Levenberg-Marquardt pose
refinement on the inliers in the tangent space, the counterpart of the
Ceres refinement (ref: absolute_pose.h:106-158). Default max_error = 12 px
(ref: absolute_pose.h:106).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.ransac import BatchedLORANSAC, RANSACOptions
from pycolmap_torch.geometry import Rigid3d, Rotation3d
from pycolmap_torch.ops import quaternion as qops
from pycolmap_torch.ops import solvers
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class AbsolutePoseEstimationOptions(BaseOptions):
    estimate_focal_length: bool = False
    ransac: RANSACOptions = None

    def __post_init__(self):
        if self.ransac is None:
            self.ransac = RANSACOptions()
            self.ransac.max_error = 12.0


@options_dataclass
class AbsolutePoseRefinementOptions(BaseOptions):
    refine_focal_length: bool = False
    refine_extra_params: bool = False
    max_num_iterations: int = 100
    gradient_tolerance: float = 1.0
    loss_function_scale: float = 1.0
    print_summary: bool = False


def _reproj_batched(model, x, X):
    """model = (quat [K,S,4], trans [K,S,3]); x [N,2] normalized; X [N,3]."""
    quat, trans = model
    p_cam = (qops.quat_rotate(quat[:, :, None, :], X[None, None])
             + trans[:, :, None, :])
    z = p_cam[..., 2]
    behind = z <= 1e-8
    z_safe = torch.where(behind, torch.ones_like(z), z)
    err = torch.sum((p_cam[..., :2] / z_safe[..., None] - x[None, None]) ** 2,
                    dim=-1)
    return torch.where(behind, torch.full_like(err, 1e12), err)


def _minimal_p3p(idx, x, X):
    quat, trans, valid = solvers.p3p(x[idx], X[idx])
    return (quat, trans), valid  # [K,4,...], [K,4]


def _refit_pnp(weights, x, X):
    # EPnP as the non-minimal local-opt solver (ref absolute_pose.h:148)
    quat, trans = solvers.epnp(x[None], X[None], weights[None])
    return ((quat[:, None], trans[:, None]),
            torch.ones((1, 1), dtype=torch.bool, device=quat.device))


_engine = BatchedLORANSAC(
    minimal_solver=_minimal_p3p,
    residual_fn=_reproj_batched,
    sample_size=3,
    refit_solver=_refit_pnp,
    # one chunk covers the default min_num_trials=1000
    chunk_size=1024,
)


# ---------------------------------------------------------------------------
# LM pose refinement (6-dof tangent; optional focal scale)
# ---------------------------------------------------------------------------


def _pose_residuals(params, quat0, x, X, w):
    """params: [6(+1)] tangent update (rot, trans[, log focal scale])."""
    quat = qops.quat_boxplus(quat0, params[:3])
    p_cam = qops.quat_rotate(quat[None, :], X) + params[3:6][None, :]
    z = p_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
    proj = p_cam[..., :2] / z[..., None]
    if params.shape[0] > 6:
        proj = proj * torch.exp(params[6])
    return ((proj - x) * w[:, None]).reshape(-1)


def _refine_pose_lm(quat0, trans0, x, X, w, loss_scale):
    """Levenberg-Marquardt with Cauchy IRLS weights and a fixed step count.

    The 2N x 6 Jacobian is ``torch.func.jacfwd`` of the residuals, as the
    reference's ``jax.jacfwd``; the damping and the accept test stay on the
    device (``torch.where``), so the loop never synchronises the host."""
    scale_sq = max(float(np.float32(loss_scale)) ** 2, 1e-12)

    def residual_fn(params, irls_w):
        return _pose_residuals(params, quat0, x, X, w * irls_w)

    def cauchy_weights(params):
        r = _pose_residuals(params, quat0, x, X, w).reshape(-1, 2)
        return 1.0 / torch.sqrt(1.0 + torch.sum(r * r, dim=-1) / scale_sq)

    jacobian = torch.func.jacfwd(residual_fn)
    params = torch.cat([torch.zeros_like(trans0), trans0])
    lam = torch.full((), 1e-3, dtype=x.dtype, device=x.device)
    for _ in range(20):
        irls_w = cauchy_weights(params)
        J = jacobian(params, irls_w)
        r = residual_fn(params, irls_w)
        JtJ = J.T @ J
        H = JtJ + lam * torch.diag(torch.clamp(torch.diagonal(JtJ), min=1e-8))
        new_params = params - solvers._solve(H, (J.T @ r)[:, None])[:, 0]
        improved = (torch.sum(residual_fn(new_params, irls_w) ** 2)
                    < torch.sum(r**2))
        params = torch.where(improved, new_params, params)
        lam = torch.where(improved, torch.clamp(lam * 0.33, min=1e-8), lam * 3.0)
    return qops.quat_boxplus(quat0, params[:3]), params[3:6]


def refine_pose_normalized(quat, trans, x_norm, X, inlier_mask, loss_scale=1.0,
                           device=None):
    """LM-refine cam_from_world on normalized 2D points. Returns (quat, trans)
    as float64 numpy. Runs at the points' own count on `device` (default:
    the card); the reference pads to 4x steps for its executable cache."""
    device = resolve_device(device)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)

    q, t = _refine_pose_lm(dev(quat), dev(trans), dev(x_norm), dev(X),
                           dev(inlier_mask), loss_scale)
    return (q.cpu().numpy().astype(np.float64),
            t.cpu().numpy().astype(np.float64))


def _rigid3d_from_wxyz(quat, trans):
    return Rigid3d(
        Rotation3d(np.array([quat[1], quat[2], quat[3], quat[0]])),
        np.asarray(trans, dtype=np.float64),
    )


def estimate_absolute_pose(
    points2D,
    points3D,
    camera,
    estimation_options: AbsolutePoseEstimationOptions = None,
    refinement_options: AbsolutePoseRefinementOptions = None,
    return_covariance: bool = False,
    device=None,
):
    """RANSAC P3P + LM refine. Returns dict(cam_from_world, num_inliers, inliers).

    points2D: Nx2 pixels; points3D: Nx3 world. max_error in pixels
    (ref: absolute_pose.h:148-157). Runs on `device` (default: the card).
    """
    if estimation_options is None:
        estimation_options = AbsolutePoseEstimationOptions()
    if refinement_options is None:
        refinement_options = AbsolutePoseRefinementOptions()
    device = resolve_device(device)
    points2D = np.asarray(points2D, dtype=np.float64)
    points3D = np.asarray(points3D, dtype=np.float64)
    if len(points2D) < 3:
        return None
    x_norm = np.asarray(camera.cam_from_img(points2D), dtype=np.float32)
    X = np.asarray(points3D, dtype=np.float32)

    opt = copy.deepcopy(estimation_options.ransac)
    opt.max_error = estimation_options.ransac.max_error / camera.mean_focal_length()
    report = _engine.estimate(opt, x_norm, X, device=device, seed=0)
    if not report.success:
        return None
    quat, trans = report.model
    quat, trans = refine_pose_normalized(
        quat, trans, x_norm, X, report.inlier_mask,
        loss_scale=refinement_options.loss_function_scale * opt.max_error,
        device=device,
    )
    result = {
        "cam_from_world": _rigid3d_from_wxyz(quat, trans),
        "num_inliers": report.support_num_inliers,
        "inliers": report.inlier_mask,
    }
    if return_covariance:
        # Gauss-Newton covariance approximation at the solution (6x6)
        def dev(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float32),
                                   device=device)

        q0, xn, Xd, w = dev(quat), dev(x_norm), dev(X), dev(report.inlier_mask)
        t0 = dev(trans)
        J = torch.func.jacfwd(
            lambda p: _pose_residuals(p, q0, xn, Xd, w)
        )(torch.cat([torch.zeros_like(t0), t0]))
        JtJ = (J.T @ J).cpu().numpy().astype(np.float64)
        result["covariance"] = np.linalg.pinv(JtJ)
    return result


def refine_absolute_pose(
    cam_from_world: Rigid3d,
    points2D,
    points3D,
    inlier_mask,
    camera,
    refinement_options: AbsolutePoseRefinementOptions = None,
    return_covariance: bool = False,
    device=None,
):
    """Refine a pose from given inliers (ref: absolute_pose.h:158-166). Runs
    on `device` (default: the card)."""
    if refinement_options is None:
        refinement_options = AbsolutePoseRefinementOptions()
    x_norm = np.asarray(camera.cam_from_img(np.asarray(points2D)), dtype=np.float32)
    X = np.asarray(points3D, dtype=np.float32)
    q_xyzw = cam_from_world.rotation.quat
    quat0 = np.array([q_xyzw[3], q_xyzw[0], q_xyzw[1], q_xyzw[2]])
    quat, trans = refine_pose_normalized(
        quat0,
        cam_from_world.translation,
        x_norm,
        X,
        np.asarray(inlier_mask, dtype=bool),
        loss_scale=refinement_options.loss_function_scale,
        device=device,
    )
    return {"cam_from_world": _rigid3d_from_wxyz(quat, trans)}


absolute_pose_estimation = estimate_absolute_pose
pose_refinement = refine_absolute_pose
