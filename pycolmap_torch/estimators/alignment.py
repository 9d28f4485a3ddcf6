"""Reconstruction alignment and comparison (API parity: pycolmap/estimators/alignment.h).

Port of ``pycolmap_tpu/estimators/alignment.py``: Sim3 alignment via
shared-image projection centers / common 3D points (ref: alignment.h:26-113)
and ``compare_reconstructions`` with per-image rotation/projection-center
errors (ref: alignment.h:115-143).

- The robust Sim3 (``estimate_sim3d_robust``) is a ``BatchedLORANSAC`` of
  3-point Umeyama hypotheses in float32 on ``device`` (None = the card),
  its samples drawn from a ``torch.Generator`` seeded ``seed``;
- the one-shot Umeyama (``_sim3_from_umeyama``) solves in float64 on the
  host, where the reference solves in float32;
- the alignments that reach the robust Sim3 take ``device`` and pass it on;
  the projection-center alignment is host work and takes none.
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.ransac import BatchedLORANSAC, RANSACOptions
from pycolmap_torch.geometry import Rotation3d, Sim3d
from pycolmap_torch.ops import quaternion as qops
from pycolmap_torch.ops import solvers


class ImageAlignmentError:
    """Per-image errors (ref: alignment.h:18-24)."""

    __slots__ = ("image_name", "rotation_error_deg", "proj_center_error")

    def __init__(self, image_name="", rotation_error_deg=np.inf, proj_center_error=np.inf):
        self.image_name = image_name
        self.rotation_error_deg = rotation_error_deg
        self.proj_center_error = proj_center_error

    def __repr__(self):
        return (
            f"ImageAlignmentError(image_name={self.image_name}, "
            f"rotation_error_deg={self.rotation_error_deg:.4f}, "
            f"proj_center_error={self.proj_center_error:.6f})"
        )


def _sim3_minimal(idx, s, d):
    scale, quat, trans = solvers.umeyama(s[idx], d[idx])
    ok = (
        torch.isfinite(scale)
        & (scale > 1e-8)
        & torch.all(torch.isfinite(quat), dim=-1)
        & torch.all(torch.isfinite(trans), dim=-1)
    )
    return (scale[:, None], quat[:, None], trans[:, None]), ok[:, None]


def _sim3_residual(model, s, d):
    scale, quat, trans = model  # [K,1], [K,1,4], [K,1,3]
    rot = qops.quat_rotate(quat[:, :, None, :], s[None, None])
    pred = scale[:, :, None, None] * rot + trans[:, :, None, :]
    return torch.sum((pred - d[None, None]) ** 2, dim=-1)


def _sim3_refit(weights, s, d):
    scale, quat, trans = solvers.umeyama(s[None], d[None], weights[None])
    return (
        (scale[:, None], quat[:, None], trans[:, None]),
        torch.ones((1, 1), dtype=torch.bool, device=scale.device),
    )


_sim3_engine = BatchedLORANSAC(
    minimal_solver=_sim3_minimal,
    residual_fn=_sim3_residual,
    sample_size=3,
    refit_solver=_sim3_refit,
    chunk_size=256,
)


def _sim3d_from_wxyz(scale, quat, trans):
    q = np.asarray(quat, dtype=np.float64).reshape(4)
    return Sim3d(
        float(np.asarray(scale).reshape(())),
        Rotation3d(np.array([q[1], q[2], q[3], q[0]])),
        np.asarray(trans, dtype=np.float64).reshape(3),
    )


def estimate_sim3d_robust(src, dst, max_error: float, seed: int = 0,
                          device=None):
    """Batched-LORANSAC Sim3: 3-point Umeyama hypotheses scored against all
    correspondences in one tensor op, weighted Umeyama LO refit (the robust
    counterpart of upstream AlignReconstructions RANSAC). Runs in float32 on
    `device` (None = the card).

    Returns (Sim3d, inlier_mask) or (None, None).
    """
    device = resolve_device(device)
    src = np.asarray(src, dtype=np.float32)
    dst = np.asarray(dst, dtype=np.float32)
    opts = RANSACOptions()
    opts.max_error = float(max_error)
    report = _sim3_engine.estimate(opts, src, dst, device=device, seed=seed)
    if not report.success:
        return None, None
    return _sim3d_from_wxyz(*report.model), report.inlier_mask


def _sim3_from_umeyama(src_pts, dst_pts, fixed_scale=False):
    """One-shot Umeyama in float64 on the host."""
    scale, quat, trans = solvers.umeyama(
        torch.as_tensor(np.asarray(src_pts, dtype=np.float64))[None],
        torch.as_tensor(np.asarray(dst_pts, dtype=np.float64))[None],
        with_scale=not fixed_scale,
    )
    return _sim3d_from_wxyz(scale[0].numpy(), quat[0].numpy(),
                            trans[0].numpy())


def align_reconstructions_via_proj_centers(
    src_reconstruction, tgt_reconstruction, max_proj_center_error: float = 0.1,
    min_common_images: int = 3,
):
    """Sim3 aligning src to tgt using shared registered images' centers
    (ref: alignment.h:48-63). Returns Sim3d or None."""
    names = {}
    for img in src_reconstruction.images.values():
        if img.registered:
            names[img.name] = img
    src_centers, tgt_centers = [], []
    for img in tgt_reconstruction.images.values():
        if img.registered and img.name in names:
            src_centers.append(names[img.name].projection_center())
            tgt_centers.append(img.projection_center())
    if len(src_centers) < min_common_images:
        return None
    src_centers = np.asarray(src_centers)
    tgt_centers = np.asarray(tgt_centers)
    tform = _sim3_from_umeyama(src_centers, tgt_centers)
    # robust re-fit: drop outlier pairs and re-estimate once
    resid = np.linalg.norm(
        np.stack([tform * c for c in src_centers]) - tgt_centers, axis=1
    )
    inliers = resid <= max_proj_center_error
    if inliers.sum() >= min_common_images and inliers.sum() < len(src_centers):
        tform = _sim3_from_umeyama(src_centers[inliers], tgt_centers[inliers])
    return tform


def _track_arrays(reconstruction, name_code):
    """Every track element of the model's points, in point then element
    order, whose image the model holds: (point3D id, image-name code,
    point2D_idx) as int64 arrays."""
    pids, iids, idxs = [], [], []
    for pid, pt in reconstruction.points3D.items():
        for el in pt.track.elements:
            pids.append(pid)
            iids.append(el.image_id)
            idxs.append(el.point2D_idx)
    pids = np.asarray(pids, dtype=np.int64)
    iids = np.asarray(iids, dtype=np.int64)
    idxs = np.asarray(idxs, dtype=np.int64)
    known = np.fromiter(
        (i in reconstruction.images for i in iids.tolist()), bool, len(iids))
    codes = np.fromiter(
        (name_code[reconstruction.images[i].name]
         for i in iids[known].tolist()), np.int64, int(known.sum()))
    return pids[known], codes, idxs[known]


def _common_point_pairs(src, tgt, min_common_observations):
    """(src point3D id, tgt point3D id) pairs sharing at least
    `min_common_observations` (image name, point2D_idx) observations, in the
    order the reference's dicts produce them: a later src point claims an
    observation over an earlier one, and pairs come in the order of their
    first shared tgt observation."""
    names = sorted({img.name for rec in (src, tgt)
                    for img in rec.images.values()})
    name_code = {n: k for k, n in enumerate(names)}
    s_pid, s_code, s_idx = _track_arrays(src, name_code)
    t_pid, t_code, t_idx = _track_arrays(tgt, name_code)
    if not len(s_pid) or not len(t_pid):
        return []
    width = int(max(s_idx.max(), t_idx.max())) + 1
    s_key = s_code * width + s_idx
    t_key = t_code * width + t_idx
    # the last src observation of each key wins (dict assignment order)
    last = len(s_key) - 1 - np.unique(s_key[::-1], return_index=True)[1]
    keys, owner = s_key[last], s_pid[last]
    pos = np.clip(np.searchsorted(keys, t_key), 0, len(keys) - 1)
    hit = keys[pos] == t_key
    sp, tp = owner[pos[hit]], t_pid[hit]
    if not len(sp):
        return []
    pair = np.stack([sp, tp], axis=1)
    uniq, first, counts = np.unique(pair, axis=0, return_index=True,
                                    return_counts=True)
    order = np.argsort(first, kind="stable")
    keep = order[counts[order] >= min_common_observations]
    return [(int(a), int(b)) for a, b in uniq[keep]]


def align_reconstructions_via_points(
    src_reconstruction, tgt_reconstruction,
    min_common_observations: int = 3,
    max_error: float = 0.005,
    min_inlier_ratio: float = 0.3,
    device=None,
):
    """Sim3 via 3D points sharing common (image_name, point2D_idx) observations
    (ref: alignment.h:65-89). Returns Sim3d or None. The robust Sim3 runs on
    `device` (None = the card)."""
    pairs = _common_point_pairs(src_reconstruction, tgt_reconstruction,
                                min_common_observations)
    if len(pairs) < 3:
        return None
    src_pts = np.asarray([src_reconstruction.points3D[s].xyz for s, _ in pairs])
    tgt_pts = np.asarray([tgt_reconstruction.points3D[t].xyz for _, t in pairs])
    tform = _sim3_from_umeyama(src_pts, tgt_pts)
    resid = np.linalg.norm(tform * src_pts - tgt_pts, axis=1)
    scale = np.median(resid) if len(resid) else 0.0
    thresh = max(max_error, 3.0 * scale)
    if len(src_pts) >= 8:
        # full RANSAC (upstream AlignReconstructions robust estimation);
        # threshold adapted to the one-shot residual scale so raw
        # (unnormalized) reconstructions keep working
        robust, _ = estimate_sim3d_robust(src_pts, tgt_pts, thresh,
                                          device=device)
        if robust is not None:
            return robust
    # fallback: one robust re-fit pass
    inliers = resid <= thresh
    if inliers.sum() >= max(3, min_inlier_ratio * len(src_pts)):
        tform = _sim3_from_umeyama(src_pts[inliers], tgt_pts[inliers])
    return tform


def align_reconstruction_to_locations(
    src_reconstruction,
    image_names,
    locations,
    min_common_images: int = 3,
    ransac_options=None,
    device=None,
):
    """Robust Sim3 aligning a reconstruction to per-image 3D locations
    (e.g. GPS priors), ref: alignment.h:91-113 / upstream
    AlignReconstructionToLocations.

    image_names[i] names a registered image whose projection center should
    map to locations[i]. Returns Sim3d (locations_from_src) or None.

    ``ransac_options.max_error`` is a distance threshold in LOCATION units
    (metres for GPS), not pixels. When omitted, the pixel-scale default
    (4.0) is used and a warning is logged. The robust Sim3 runs on `device`
    (None = the card).
    """
    if min_common_images < 3:
        raise ValueError("min_common_images must be >= 3")
    locations = np.asarray(locations, dtype=np.float64)
    if len(image_names) != len(locations):
        raise ValueError("image_names and locations must have equal length")
    by_name = {
        img.name: img
        for img in src_reconstruction.images.values()
        if img.registered
    }
    src_centers, dst_locations = [], []
    for name, loc in zip(image_names, locations):
        img = by_name.get(name)
        if img is not None:
            src_centers.append(img.projection_center())
            dst_locations.append(loc)
    if len(src_centers) < min_common_images:
        return None
    src_centers = np.asarray(src_centers)
    dst_locations = np.asarray(dst_locations)
    if ransac_options is None:
        from pycolmap_torch.utils import logging as _logging

        ransac_options = RANSACOptions()
        _logging.get_logger().warning(
            "align_reconstruction_to_locations: no ransac_options given; "
            f"using max_error={ransac_options.max_error} in LOCATION units "
            "(scene-dependent) — pass explicit options for real data"
        )
    tform, inlier_mask = estimate_sim3d_robust(
        src_centers, dst_locations, float(ransac_options.max_error),
        device=device,
    )
    if tform is None or int(np.sum(inlier_mask)) < min_common_images:
        return None
    return tform


# the reference binds this name with a typo (alignment.h:92
# "align_reconstrution_to_locations"); keep it callable for drop-in parity
align_reconstrution_to_locations = align_reconstruction_to_locations


def align_reconstructions_via_reprojections(
    src_reconstruction, tgt_reconstruction,
    min_inlier_observations: float = 0.3,
    max_reproj_error: float = 8.0,
    device=None,
):
    """Sim3 via reprojection agreement (ref: alignment.h:26-46).

    Uses common-point alignment, and the projection centers where too few
    points are shared.
    """
    tform = align_reconstructions_via_points(
        src_reconstruction, tgt_reconstruction, device=device)
    if tform is None:
        tform = align_reconstructions_via_proj_centers(
            src_reconstruction, tgt_reconstruction
        )
    return tform


def compare_reconstructions(
    reconstruction1,
    reconstruction2,
    alignment_error: str = "reprojection",
    min_inlier_observations: float = 0.3,
    max_reproj_error: float = 8.0,
    max_proj_center_error: float = 0.1,
    device=None,
):
    """Align rec1 to rec2 and report per-image pose errors (ref: alignment.h:115-143).

    Returns dict(rec2_from_rec1, errors=[ImageAlignmentError]) or None.
    "reprojection" aligns by common points, robustly on `device` (None = the
    card); "proj_center" aligns on the host.
    """
    if alignment_error == "proj_center":
        tform = align_reconstructions_via_proj_centers(
            reconstruction1, reconstruction2, max_proj_center_error
        )
    else:
        tform = align_reconstructions_via_reprojections(
            reconstruction1, reconstruction2,
            min_inlier_observations, max_reproj_error, device=device,
        )
    if tform is None:
        return None
    by_name = {
        img.name: img
        for img in reconstruction2.images.values()
        if img.registered
    }
    errors = []
    for img1 in reconstruction1.images.values():
        if not img1.registered or img1.name not in by_name:
            continue
        img2 = by_name[img1.name]
        aligned = tform.transform_camera_world(img1.cam_from_world)
        rot_err = np.rad2deg(
            aligned.rotation.angle_to(img2.cam_from_world.rotation)
        )
        c1 = aligned.inverse().translation
        c2 = img2.projection_center()
        errors.append(
            ImageAlignmentError(img1.name, rot_err, float(np.linalg.norm(c1 - c2)))
        )
    return {"rec2_from_rec1": tform, "errors": errors}
