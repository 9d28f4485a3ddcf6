"""Build/apply BundleProblem arrays from/to a Reconstruction.

The equivalent of upstream BundleAdjustmentConfig + problem setup
(ref: pipeline/sfm.h:95-103): select images/points, choose constant blocks
for gauge fixing, flatten observations into SoA arrays, and write the
optimized parameters back into the scene objects.

Port of ``pycolmap_tpu/sfm/problem.py``. The problem comes out as the
port's :class:`~pycolmap_torch.sfm.bundle_adjustment.BundleProblem` of host
tensors (int32 indices, f32 values); the solver moves it to its device.
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch.geometry import Rigid3d, Rotation3d
from pycolmap_torch.ops import camera_models as cm
from pycolmap_torch.scene.point2d import INVALID_POINT3D_ID
from pycolmap_torch.sfm.bundle_adjustment import BundleAdjustmentOptions, BundleProblem


class ProblemMapping:
    """Index maps from problem rows back to scene ids."""

    __slots__ = ("image_ids", "camera_ids", "point_ids")

    def __init__(self, image_ids, camera_ids, point_ids):
        self.image_ids = list(image_ids)
        self.camera_ids = list(camera_ids)
        self.point_ids = list(point_ids)


def _intr_free_mask(camera, options: BundleAdjustmentOptions):
    mask = np.zeros(cm.MAX_PARAMS, dtype=np.float32)
    info = cm.CAMERA_MODEL_BY_NAME[camera.model]
    if options.refine_focal_length:
        for i in info.focal_idxs:
            mask[i] = 1.0
    if options.refine_principal_point:
        for i in info.principal_idxs:
            mask[i] = 1.0
    if options.refine_extra_params:
        for i in info.extra_idxs:
            mask[i] = 1.0
    return mask


def build_bundle_problem(
    reconstruction,
    options: BundleAdjustmentOptions = None,
    image_ids=None,
    constant_pose_ids=(),
    constant_tvec_x_ids=(),
    constant_point_ids=(),
    variable_point_ids=None,
    dtype=torch.float32,
):
    """Flatten (a subset of) the reconstruction into a BundleProblem.

    image_ids: images to include (default: all registered). Points included
    are those observed by >= 2 included images unless variable_point_ids is
    given; points observed by excluded registered images stay variable (their
    other observations are simply not part of this local problem, matching
    local-BA semantics). dtype: the float dtype of the problem's arrays (a
    torch dtype or anything ``np.dtype`` reads); the card's kernels take
    float32 only, and its solvers raise on any other.
    """
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype
    if not dtype.is_floating_point:
        raise TypeError(f"dtype must be a float dtype, got {dtype}")
    if options is None:
        options = BundleAdjustmentOptions()
    if image_ids is None:
        image_ids = reconstruction.reg_image_ids
    image_ids = [i for i in image_ids if reconstruction.images[i].registered]
    image_index = {iid: k for k, iid in enumerate(image_ids)}

    camera_ids = sorted({reconstruction.images[i].camera_id for i in image_ids})
    camera_index = {cid: k for k, cid in enumerate(camera_ids)}
    model_ids = sorted(
        {
            cm.model_id_from_name(reconstruction.cameras[c].model)
            for c in camera_ids
        }
    )
    # mixed camera models (ref camera.h:42-47 CAMERA_MODEL_CASES): the
    # solver receives model_id as a tuple of the distinct ids plus one
    # extra per-camera selector column (see ops/camera_models.py
    # solver_num_params); a single-model bundle keeps the plain-int path.
    if len(model_ids) <= 1:
        model_id = model_ids[0] if model_ids else 1
        intr_width = cm.MAX_PARAMS
        sel_idx = None
    else:
        model_id = tuple(model_ids)
        sel_idx = cm.mixed_sel_index(model_id)
        intr_width = max(cm.MAX_PARAMS, sel_idx + 1)

    # collect observations of points seen by included images (vectorized:
    # one mask + gather per image, np.unique to build the point index — the
    # per-observation python loop dominated global-BA host prep at scale)
    per_img_pids, per_img_xy, per_img_rows, per_img_cam = [], [], [], []
    for iid in image_ids:
        img = reconstruction.images[iid]
        p3d = img.points2D_point3D_ids
        valid = p3d != np.uint64(INVALID_POINT3D_ID)
        pids_i = p3d[valid].astype(np.int64)
        xy_i = img.points2D_xy[valid]
        if variable_point_ids is not None:
            keep = np.isin(pids_i, np.fromiter(variable_point_ids, dtype=np.int64))
            pids_i = pids_i[keep]
            xy_i = xy_i[keep]
        per_img_pids.append(pids_i)
        per_img_xy.append(xy_i)
        per_img_rows.append(
            np.full(len(pids_i), image_index[iid], dtype=np.int32)
        )
        per_img_cam.append(
            np.full(len(pids_i), camera_index[img.camera_id], dtype=np.int32)
        )
    if per_img_pids and sum(len(p) for p in per_img_pids):
        all_pids = np.concatenate(per_img_pids)
        uniq, inverse = np.unique(all_pids, return_inverse=True)
        point_ids = uniq.tolist()
        point_index = {int(p): k for k, p in enumerate(uniq)}
        obs_image = np.concatenate(per_img_rows)
        obs_cam = np.concatenate(per_img_cam)
        obs_point = inverse.astype(np.int32)
        obs_xy = np.concatenate(per_img_xy) if len(all_pids) else np.zeros((0, 2))
    else:
        point_ids = []
        point_index = {}
        obs_image = np.zeros(0, dtype=np.int32)
        obs_cam = np.zeros(0, dtype=np.int32)
        obs_point = np.zeros(0, dtype=np.int32)
        obs_xy = np.zeros((0, 2))

    num_i, num_c, num_p, num_m = (
        len(image_ids), len(camera_ids), len(point_ids), len(obs_image),
    )
    cam_quat = np.zeros((max(num_i, 1), 4), dtype=np.float64)
    cam_trans = np.zeros((max(num_i, 1), 3), dtype=np.float64)
    cam_quat[:, 0] = 1.0
    for iid, k in image_index.items():
        q = reconstruction.images[iid].cam_from_world.rotation.quat  # xyzw
        cam_quat[k] = [q[3], q[0], q[1], q[2]]
        cam_trans[k] = reconstruction.images[iid].cam_from_world.translation

    intrinsics = np.zeros((max(num_c, 1), intr_width), dtype=np.float64)
    intr_free = np.zeros((max(num_c, 1), intr_width), dtype=np.float64)
    for cid, k in camera_index.items():
        cam = reconstruction.cameras[cid]
        intrinsics[k, : len(cam.params)] = cam.params
        intr_free[k, : cm.MAX_PARAMS] = _intr_free_mask(cam, options)
        if sel_idx is not None:
            # per-camera model selector (intr_free stays 0 there: the
            # selector is structure, not a parameter)
            intrinsics[k, sel_idx] = cm.model_id_from_name(cam.model)
            intr_free[k, sel_idx] = 0.0

    points = np.zeros((max(num_p, 1), 3), dtype=np.float64)
    for pid, k in point_index.items():
        points[k] = reconstruction.points3D[pid].xyz

    pose_free = np.ones((max(num_i, 1), 6), dtype=np.float64)
    if not options.refine_extrinsics:
        pose_free[:] = 0.0
    for iid in constant_pose_ids:
        if iid in image_index:
            pose_free[image_index[iid]] = 0.0
    for iid in constant_tvec_x_ids:
        if iid in image_index:
            pose_free[image_index[iid], 3] = 0.0

    point_free = np.ones(max(num_p, 1), dtype=np.float64)
    for pid in constant_point_ids:
        if pid in point_index:
            point_free[point_index[pid]] = 0.0

    def t(a):  # values are gathered in float64, rounded once to dtype
        a = torch.from_numpy(a)
        return a.to(dtype) if a.is_floating_point() else a

    problem = BundleProblem(
        cam_quat=t(cam_quat),
        cam_trans=t(cam_trans),
        intrinsics=t(intrinsics),
        points=t(points),
        model_id=model_id,
        obs_image_idx=t(np.asarray(obs_image, dtype=np.int32).reshape(-1)),
        obs_camera_idx=t(np.asarray(obs_cam, dtype=np.int32).reshape(-1)),
        obs_point_idx=t(np.asarray(obs_point, dtype=np.int32).reshape(-1)),
        obs_xy=t(np.asarray(obs_xy, dtype=np.float64).reshape(-1, 2)),
        obs_mask=t(np.ones(num_m, dtype=np.float64)),
        pose_free=t(pose_free),
        intr_free=t(intr_free),
        point_free=t(point_free),
    )
    mapping = ProblemMapping(image_ids, camera_ids, point_ids)
    return problem, mapping


def apply_bundle_solution(reconstruction, problem: BundleProblem, mapping: ProblemMapping):
    """Write optimized parameters back into the reconstruction."""
    cam_quat = np.asarray(problem.cam_quat, dtype=np.float64)
    cam_trans = np.asarray(problem.cam_trans, dtype=np.float64)
    intrinsics = np.asarray(problem.intrinsics, dtype=np.float64)
    points = np.asarray(problem.points, dtype=np.float64)
    for k, iid in enumerate(mapping.image_ids):
        q = cam_quat[k]
        reconstruction.images[iid].cam_from_world = Rigid3d(
            Rotation3d(np.array([q[1], q[2], q[3], q[0]])), cam_trans[k]
        )
    for k, cid in enumerate(mapping.camera_ids):
        cam = reconstruction.cameras[cid]
        cam.params[:] = intrinsics[k, : len(cam.params)]
    for k, pid in enumerate(mapping.point_ids):
        if pid in reconstruction.points3D:
            reconstruction.points3D[pid].xyz = points[k]
