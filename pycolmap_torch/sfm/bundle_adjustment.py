"""Bundle adjustment: Levenberg-Marquardt with Schur-eliminated points and
preconditioned CG on the reduced camera system.

Port of ``pycolmap_tpu/sfm/bundle_adjustment.py`` (which replaces Ceres,
ref: pipeline/sfm.h:95-103, 260-333): the problem container, the options,
the robust losses and ``solve_bundle``, which delegates to the bucketed
solver in ``sfm/ba_kernels.py``, sharded over ``options.devices``'s mesh
where there is one. The reference's flat-layout ``_lm_core``
is not ported yet (ROADMAP.md).

Parameter blocks: image poses [num_images, 6] (tangent), shared camera
intrinsics [num_cameras, MAX_PARAMS] (masked by refine options), points
[num_points, 3]. Gauge fixing via per-image constant masks.
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import torch

from pycolmap_torch.utils.options import BaseOptions, options_dataclass


class LossFunctionType(enum.IntEnum):
    TRIVIAL = 0
    SOFT_L1 = 1
    CAUCHY = 2


@options_dataclass
class BundleAdjustmentOptions(BaseOptions):
    """Mirrors reference BundleAdjustmentOptions (ref: pipeline/sfm.h:260-333).

    ``devices`` selects the shard mesh of the solve, as the reference's
    selects its JAX mesh: ``"auto"`` (the default mesh, else one shard per
    rank of an initialized process group, else the one card the entry
    point's ``device`` names, else every local card where there are more
    than one), ``"none"``, a card count, or a
    :class:`~pycolmap_torch.parallel.device_ctx.ShardMesh`
    (``parallel/device_ctx.resolve_mesh``). The device of an unsharded
    solve is an argument of the entry points."""

    loss_function_type: LossFunctionType = LossFunctionType.TRIVIAL
    loss_function_scale: float = 1.0
    refine_focal_length: bool = True
    refine_principal_point: bool = False
    refine_extra_params: bool = True
    refine_extrinsics: bool = True
    max_num_iterations: int = 100
    max_linear_solver_iterations: int = 200
    # forcing-sequence (inexact Newton) tolerance for the inner PCG solve:
    # CG stops when the preconditioned residual norm drops below eta x its
    # initial value, or at the iteration cap (Ceres Solver::Options::eta)
    eta: float = 0.1
    function_tolerance: float = 0.0
    gradient_tolerance: float = 0.0
    parameter_tolerance: float = 0.0
    min_num_residuals_for_multi_threading: int = 50000
    print_summary: bool = True
    # the solve's shard mesh (see the class docstring); the counterpart of
    # the reference's Ceres num_threads (ref: pipeline/sfm.h:294)
    devices: object = "auto"


class BundleProblem(NamedTuple):
    """SoA bundle problem; host (CPU) tensors, f32 / int32."""

    # parameters
    cam_quat: torch.Tensor  # [I, 4] wxyz cam_from_world
    cam_trans: torch.Tensor  # [I, 3]
    intrinsics: torch.Tensor  # [C, >= MAX_PARAMS]
    points: torch.Tensor  # [P, 3]
    # structure
    # one camera model id, or a tuple of ids for a mixed-model bundle
    # (intrinsics then hold each camera's model id at mixed_sel_index)
    model_id: int
    obs_image_idx: torch.Tensor  # [M] int32
    obs_camera_idx: torch.Tensor  # [M] int32 (camera of the image)
    obs_point_idx: torch.Tensor  # [M] int32
    obs_xy: torch.Tensor  # [M, 2] pixel observations
    obs_mask: torch.Tensor  # [M] f32 validity (padding = 0)
    # freedoms
    pose_free: torch.Tensor  # [I, 6] f32 mask (gauge fixing / constant poses)
    intr_free: torch.Tensor  # [C, >= MAX_PARAMS] f32 mask
    point_free: torch.Tensor  # [P] f32 mask

    @property
    def num_images(self):
        return self.cam_quat.shape[0]

    @property
    def num_cameras(self):
        return self.intrinsics.shape[0]

    @property
    def num_points(self):
        return self.points.shape[0]

    @property
    def num_obs(self):
        return self.obs_xy.shape[0]


class BASummary(NamedTuple):
    initial_cost: float
    final_cost: float
    num_iterations: int
    num_residuals: int

    def __repr__(self):
        return (
            f"BASummary(initial_cost={self.initial_cost:.6g}, "
            f"final_cost={self.final_cost:.6g}, "
            f"iterations={self.num_iterations}, residuals={self.num_residuals})"
        )


# ---------------------------------------------------------------------------
# robust losses (plain versions; ``_robust`` in sfm/csrc/ba_device.cuh is the
# device twin)
# ---------------------------------------------------------------------------


def _robust_weight(sq_norm, loss_type: int, scale: float):
    """IRLS weight sqrt(rho'(s)) for the robust losses (s = squared norm)."""
    s = sq_norm / max(scale * scale, 1e-12)
    if loss_type == int(LossFunctionType.TRIVIAL):
        return torch.ones_like(sq_norm)
    if loss_type == int(LossFunctionType.SOFT_L1):
        # rho(s) = 2 (sqrt(1+s) - 1); rho'(s) = 1/sqrt(1+s)
        return (1.0 + s) ** -0.25
    # CAUCHY: rho(s) = log(1+s); rho'(s) = 1/(1+s)
    return 1.0 / torch.sqrt(1.0 + s)


def _robust_cost(sq_norm, loss_type: int, scale: float):
    sc = max(scale * scale, 1e-12)
    s = sq_norm / sc
    if loss_type == int(LossFunctionType.TRIVIAL):
        return sq_norm
    if loss_type == int(LossFunctionType.SOFT_L1):
        return 2.0 * sc * (torch.sqrt(1.0 + s) - 1.0)
    return sc * torch.log1p(s)


def solve_bundle(problem: BundleProblem, options: BundleAdjustmentOptions,
                 cg_iters: int = 30, device=None, cg_bf16=None, mesh=None,
                 dense_schur_max_d=None):
    """Run LM to convergence. Returns (new BundleProblem, BASummary).

    Dispatches to the bucketed solver (sfm/ba_kernels.py). ``device``:
    None = the card (raises on a host without CUDA), or ``"cpu"`` for the
    plain PyTorch versions of the kernels. ``cg_bf16``: the CG matvec's J
    type, None = bf16 on the card, f32 on the CPU. ``dense_schur_max_d``:
    the dense reduced system's cutoff, None = the device's (512 on the
    card, 2048 on the CPU), 0 = always the implicit PCG (see
    ``ba_kernels.dense_schur_selected``). ``mesh``: a ShardMesh,
    or None to resolve one from ``options.devices`` (for ``device``, see
    ``parallel/device_ctx.resolve_mesh``); a mesh's devices take the place
    of ``device``, and ones that disagree with it raise ValueError.
    """
    from pycolmap_torch.parallel.device_ctx import resolve_mesh
    from pycolmap_torch.sfm.ba_kernels import solve_bundle_fast

    if mesh is None:
        mesh = resolve_mesh(getattr(options, "devices", "auto"), device)
    return solve_bundle_fast(problem, options, cg_iters=cg_iters,
                             device=device, cg_bf16=cg_bf16, mesh=mesh,
                             dense_schur_max_d=dense_schur_max_d)
