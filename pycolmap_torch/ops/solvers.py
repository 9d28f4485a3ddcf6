"""Batched minimal and linear solvers.

Port of ``pycolmap_tpu/ops/solvers.py``, for now only what the known-pose
triangulator needs: the weighted multi-view DLT ``triangulate_dlt`` (:577)
and its symmetric eigen-solve ``smallest_eigvec`` (:162). The absolute-pose,
epipolar and alignment solvers come with the mapping slice (ROADMAP.md).
Every function runs on the device of its inputs.
"""

from __future__ import annotations

import torch


def smallest_eigvec(A):
    """Eigenvector of the smallest eigenvalue of symmetric A [..., n, n]."""
    _, v = torch.linalg.eigh(A)
    return v[..., :, 0]


def triangulate_dlt(proj, x, w=None):
    """Multi-view DLT triangulation.

    proj: [..., M, 3, 4] projection matrices (world -> normalized image plane,
    i.e. [R|t] for calibrated cameras); x: [..., M, 2] normalized points;
    w: [..., M] view weights/mask. Returns X [..., 3] (world).
    """
    if w is None:
        w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device)
    r0 = x[..., 0:1] * proj[..., 2, :] - proj[..., 0, :]  # [..., M, 4]
    r1 = x[..., 1:2] * proj[..., 2, :] - proj[..., 1, :]
    A = torch.cat([r0 * w[..., None], r1 * w[..., None]], dim=-2)
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    Xh = smallest_eigvec(AtA)
    wcoord = Xh[..., 3]
    denom = torch.where(torch.abs(wcoord) < 1e-12,
                        torch.full_like(wcoord, 1e-12), wcoord)
    return Xh[..., :3] / denom[..., None]
