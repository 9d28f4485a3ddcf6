"""MVS workspace: per-image depth ranges and source-view selection (port
of ``pycolmap_tpu/mvs/workspace.py``, host numpy on the port's
``Reconstruction``: the same ranges and the same ``src_ids`` in the same
order, ties broken by the model's point and track order).

Upstream analog: colmap/mvs Workspace + Model (consumed by PatchMatch via
the COLMAP-undistorted workspace produced by ``undistort_images``,
ref: pipeline/images.h:96-148). Source views are ranked by shared sparse
points with sufficient triangulation angle, as upstream does.
"""

from __future__ import annotations

from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

from pycolmap_torch.scene import Reconstruction


class MVSImage:
    __slots__ = ("image_id", "name", "K", "R", "t", "width", "height",
                 "depth_min", "depth_max", "src_ids")

    def __init__(self, image_id, name, K, R, t, width, height):
        self.image_id = image_id
        self.name = name
        self.K = K
        self.R = R
        self.t = t
        self.width = width
        self.height = height
        self.depth_min = 0.0
        self.depth_max = 0.0
        self.src_ids = []

    def project(self, X):
        """World [N,3] -> (xy [N,2], depth [N])."""
        Xc = X @ self.R.T + self.t
        z = Xc[:, 2]
        uv = Xc[:, :2] / np.maximum(z[:, None], 1e-9)
        xy = uv @ self.K[:2, :2].T + self.K[:2, 2]
        return xy, z


class MVSModel:
    def __init__(self, workspace_path):
        workspace_path = Path(workspace_path)
        rec = Reconstruction(workspace_path / "sparse")
        self.reconstruction = rec
        self.images: dict[int, MVSImage] = {}
        for iid in rec.reg_image_ids:
            img = rec.images[iid]
            cam = rec.cameras[img.camera_id]
            self.images[iid] = MVSImage(
                iid, img.name, cam.calibration_matrix(),
                img.cam_from_world.rotation.matrix(),
                img.cam_from_world.translation,
                cam.width, cam.height,
            )
        self._compute_depth_ranges()
        self._select_sources()

    def _compute_depth_ranges(self, robust_percentile=1.0, margin=0.25):
        depths = defaultdict(list)
        for pid, pt in self.reconstruction.points3D.items():
            for el in pt.track.elements:
                mimg = self.images.get(el.image_id)
                if mimg is None:
                    continue
                z = (mimg.R @ pt.xyz + mimg.t)[2]
                if z > 0:
                    depths[el.image_id].append(z)
        for iid, ds in depths.items():
            ds = np.asarray(ds)
            lo = np.percentile(ds, robust_percentile)
            hi = np.percentile(ds, 100 - robust_percentile)
            self.images[iid].depth_min = max(lo * (1 - margin), 1e-3)
            self.images[iid].depth_max = hi * (1 + margin)

    def _select_sources(self, max_num_src=8, min_tri_angle_deg=1.0):
        # shared-point counts weighted by triangulation angle
        obs = defaultdict(list)
        for pid, pt in self.reconstruction.points3D.items():
            ids = [el.image_id for el in pt.track.elements if el.image_id in self.images]
            for iid in ids:
                obs[iid].append((pid, ids))
        centers = {
            iid: -(m.R.T @ m.t) for iid, m in self.images.items()
        }
        for iid, m in self.images.items():
            score = defaultdict(float)
            for pid, ids in obs.get(iid, []):
                pt = self.reconstruction.points3D[pid].xyz
                for other in ids:
                    if other == iid:
                        continue
                    r1 = centers[iid] - pt
                    r2 = centers[other] - pt
                    denom = np.linalg.norm(r1) * np.linalg.norm(r2)
                    if denom < 1e-12:
                        continue
                    ang = np.degrees(
                        np.arccos(np.clip(np.dot(r1, r2) / denom, -1, 1))
                    )
                    # favor baselines near ~10 deg (upstream-style weighting)
                    w = min(ang / 10.0, 1.0) if ang >= min_tri_angle_deg else 0.0
                    score[other] += w
            ranked = sorted(score.items(), key=lambda kv: -kv[1])
            m.src_ids = [o for o, s in ranked[:max_num_src] if s > 0]


def rotate(R, X):
    """``einsum("ij,jhw->ihw", R, X)`` for R [3, 3], X [3, H, W] tensors,
    summed in numpy einsum's order (j = 0, 1, 2), so that float64 results
    match the reference's bit for bit."""
    return torch.stack([R[i, 0] * X[0] + R[i, 1] * X[1] + R[i, 2] * X[2]
                        for i in range(3)])


def rotate_t(R, X):
    """``einsum("ji,jhw->ihw", R, X)``: R transposed applied to X."""
    return rotate(R.T, X)


def pixel_rays(K, H, W, device):
    """K^-1 (x + 0.5, y + 0.5, 1) for every pixel, [3, H, W] float64, from
    the f32 pixel grid the reference builds (``np.mgrid(...).astype(
    float32)``)."""
    yy, xx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    pix = torch.stack([xx + 0.5, yy + 0.5, torch.ones_like(xx)]).double()
    K_inv = torch.as_tensor(np.linalg.inv(K), dtype=torch.float64,
                            device=device)
    return rotate(K_inv, pix)
