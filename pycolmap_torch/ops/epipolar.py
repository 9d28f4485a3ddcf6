"""Epipolar geometry residuals and pose recovery, batched.

Port of ``pycolmap_tpu/ops/epipolar.py``: the squared Sampson error
(ref: two_view_geometry.h:161-175), the homography transfer error, the
cheirality-aware pose from an essential matrix (upstream
PoseFromEssentialMatrix) and the plane-aware pose from a homography
(upstream HomographyDecomposition).

Every function broadcasts over leading axes: matrices [..., 3, 3], points
[..., N, 2] in normalized camera coordinates. The reference ``vmap``s the
cheirality test over the four candidate poses; here the candidates are one
more leading axis of the same call.
"""

from __future__ import annotations

import torch

from pycolmap_torch.ops import quaternion as qops
from pycolmap_torch.ops import solvers


def _homogeneous(x):
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def sampson_error(E, x1, x2):
    """Squared Sampson distance. E/F: [..., 3, 3]; x: [..., N, 2].

    Units: squared (normalized or pixel) image coordinates, matching the
    units of x.
    """
    p1 = _homogeneous(x1)  # [..., N, 3]
    p2 = _homogeneous(x2)
    Ex1 = torch.einsum("...ij,...nj->...ni", E, p1)
    Etx2 = torch.einsum("...ji,...nj->...ni", E, p2)
    x2Ex1 = torch.sum(p2 * Ex1, dim=-1)
    denom = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
             + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return x2Ex1**2 / torch.clamp(denom, min=1e-12)


def epipolar_line_error(E, x1, x2):
    """Squared point-to-epipolar-line distance of x2 w.r.t. line E x1."""
    Ex1 = torch.einsum("...ij,...nj->...ni", E, _homogeneous(x1))
    num = torch.sum(_homogeneous(x2) * Ex1, dim=-1) ** 2
    denom = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
    return num / torch.clamp(denom, min=1e-12)


def homography_transfer_error(H, x1, x2):
    """Squared one-sided transfer error |x2 - proj(H x1)|^2."""
    Hx1 = torch.einsum("...ij,...nj->...ni", H, _homogeneous(x1))
    w = Hx1[..., 2]
    # points mapping to infinity get a huge (but finite) error
    bad = torch.abs(w) < 1e-8
    w_safe = torch.where(bad, torch.ones_like(w), w)
    err = torch.sum((Hx1[..., :2] / w_safe[..., None] - x2) ** 2, dim=-1)
    return torch.where(bad, torch.full_like(err, 1e12), err)


def reprojection_error_normalized(quat, trans, points2D, points3D):
    """Squared reprojection error in the normalized plane for cam_from_world.

    quat [..., 4] wxyz, trans [..., 3], points2D [..., N, 2] (normalized),
    points3D [..., N, 3] (world). Points behind the camera get huge error.
    """
    p_cam = qops.quat_rotate(quat[..., None, :], points3D) + trans[..., None, :]
    z = p_cam[..., 2]
    behind = z <= 1e-8
    z_safe = torch.where(behind, torch.ones_like(z), z)
    err = torch.sum((p_cam[..., :2] / z_safe[..., None] - points2D) ** 2, dim=-1)
    return torch.where(behind, torch.full_like(err, 1e12), err)


def triangulate_and_count_cheirality(quat, trans, x1, x2, max_depth=None):
    """Triangulate x1/x2 under cam2_from_cam1=(quat,trans); count points with
    positive depth in both views (the cheirality test used to disambiguate
    E/H decompositions).

    Returns (points3D_in_cam1 [..., N, 3], front_mask [..., N]).
    """
    R = qops.quat_to_matrix(quat)
    shape = torch.broadcast_shapes(R.shape[:-2], x1.shape[:-2])
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device).expand(shape + (3, 3))
    zero = torch.zeros(shape + (3, 1), dtype=x1.dtype, device=x1.device)
    P1 = torch.cat([eye, zero], dim=-1)  # [..., 3, 4]
    P2 = torch.cat([R.expand(shape + (3, 3)),
                    trans[..., :, None].expand(shape + (3, 1))], dim=-1)
    proj = torch.stack([P1, P2], dim=-3)  # [..., 2, 3, 4]
    n = x1.shape[-2]
    proj_n = proj[..., None, :, :, :].expand(shape + (n, 2, 3, 4))
    x = torch.stack(torch.broadcast_tensors(x1, x2), dim=-2)  # [..., N, 2, 2]
    X = solvers.triangulate_dlt(proj_n, x)  # [..., N, 3]
    z1 = X[..., 2]
    z2 = (qops.quat_rotate(quat[..., None, :], X) + trans[..., None, :])[..., 2]
    # reasonable depth bounds as in upstream CheckCheirality:
    # kMinDepth < z < max_depth (max_depth = 1000 * baseline)
    if max_depth is None:
        max_d = 1000.0 * torch.linalg.norm(trans, dim=-1)
    else:
        max_d = torch.as_tensor(max_depth, dtype=x1.dtype, device=x1.device)
    max_d = max_d[..., None]
    eps = 1e-6
    front = (z1 > eps) & (z2 > eps) & (z1 < max_d) & (z2 < max_d)
    return X, front


def _best_candidate(counts, *cands):
    """Per batch element, the candidate (axis -1 of `counts`) with the most
    points in front (the first of equals), taken from each [..., C, ...]."""
    best = torch.argmax(counts, dim=-1)  # [...]
    out = []
    for c in cands:
        idx = best.reshape(best.shape + (1,) * (c.dim() - best.dim()))
        idx = idx.expand(best.shape + (1,) + c.shape[best.dim() + 1:])
        out.append(torch.gather(c, best.dim(), idx).squeeze(best.dim()))
    return out


def pose_from_essential(E, x1, x2, inlier_mask=None):
    """Recover cam2_from_cam1 from E via cheirality (upstream PoseFromEssentialMatrix).

    E [..., 3, 3]; x [..., N, 2]. Returns (quat wxyz, trans, points3D, front_mask)
    for the best of the 4 candidate decompositions.
    """
    R1, R2, t = solvers.decompose_essential(E)
    q1 = qops.matrix_to_quat(R1)
    q2 = qops.matrix_to_quat(R2)
    cands_q = torch.stack([q1, q1, q2, q2], dim=-2)  # [..., 4, 4]
    cands_t = torch.stack([t, -t, t, -t], dim=-2)  # [..., 4, 3]
    if inlier_mask is None:
        inlier_mask = torch.ones(x1.shape[:-1], dtype=torch.bool,
                                 device=x1.device)
    X, front = triangulate_and_count_cheirality(
        cands_q, cands_t, x1[..., None, :, :], x2[..., None, :, :])
    counts = torch.sum(front & inlier_mask[..., None, :], dim=-1)  # [..., 4]
    quat, trans, X_best, front_best = _best_candidate(
        counts, cands_q, cands_t, X, front)
    return quat, trans, X_best, front_best & inlier_mask


def decompose_homography(H, K1=None, K2=None):
    """Malis–Vargas homography decomposition into (R, t, n) candidates.

    H maps normalized coords cam1 -> cam2 (K's already removed if None).
    Returns (R [..., 4, 3, 3], t [..., 4, 3], n [..., 4, 3]).
    """
    if K1 is not None:
        H = solvers._solve(K2, H @ K1)
    # normalize by middle singular value
    _, S, _ = solvers._svd(H)
    Hn = H / S[..., 1:2, None]
    # ensure det-positive orientation
    Hn = Hn * torch.where(torch.linalg.det(Hn) < 0, -1.0, 1.0)[..., None, None]

    S_mat = Hn.mT @ Hn - torch.eye(3, dtype=H.dtype, device=H.device)

    # Malis-Vargas analytic decomposition
    s11, s12, s13 = S_mat[..., 0, 0], S_mat[..., 0, 1], S_mat[..., 0, 2]
    s22, s23, s33 = S_mat[..., 1, 1], S_mat[..., 1, 2], S_mat[..., 2, 2]

    def opp_minor(a, b, c):
        return b * b - a * c  # M_opposite = s_ab^2 - s_aa s_bb

    M11 = opp_minor(s22, s23, s33)
    M22 = opp_minor(s11, s13, s33)
    M33 = opp_minor(s11, s12, s22)
    M12 = s13 * s23 - s12 * s33
    M13 = s12 * s23 - s13 * s22
    M23 = s12 * s13 - s23 * s11

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=0.0))

    def eps_sign(x):
        return torch.where(x >= 0, 1.0, -1.0)

    # pick pivot = largest |s_ii|
    pivot = torch.argmax(
        torch.stack([torch.abs(s11), torch.abs(s22), torch.abs(s33)], dim=-1),
        dim=-1)

    # candidate normals for each pivot choice
    na_1 = torch.stack([s11, s12 + safe_sqrt(M33), s13 + eps_sign(M23) * safe_sqrt(M22)], dim=-1)
    nb_1 = torch.stack([s11, s12 - safe_sqrt(M33), s13 - eps_sign(M23) * safe_sqrt(M22)], dim=-1)
    na_2 = torch.stack([s12 + safe_sqrt(M33), s22, s23 - eps_sign(M13) * safe_sqrt(M11)], dim=-1)
    nb_2 = torch.stack([s12 - safe_sqrt(M33), s22, s23 + eps_sign(M13) * safe_sqrt(M11)], dim=-1)
    na_3 = torch.stack([s13 + eps_sign(M12) * safe_sqrt(M22), s23 + safe_sqrt(M11), s33], dim=-1)
    nb_3 = torch.stack([s13 - eps_sign(M12) * safe_sqrt(M22), s23 - safe_sqrt(M11), s33], dim=-1)

    pivot_e = pivot[..., None]
    na = torch.where(pivot_e == 0, na_1, torch.where(pivot_e == 1, na_2, na_3))
    nb = torch.where(pivot_e == 0, nb_1, torch.where(pivot_e == 1, nb_2, nb_3))
    # both normals as one batch: [..., 2, 3]
    n = torch.stack([na, nb], dim=-2)
    n = n / torch.clamp(torch.linalg.norm(n, dim=-1, keepdim=True), min=1e-12)

    # For each candidate normal n, recover R and t from Hn = R + t n^T by a
    # fixpoint of polar decompositions: given t, R is the polar factor of
    # (Hn - t n^T); given R, t = (Hn - R) n.
    Hn2 = Hn[..., None, :, :]
    t_est = torch.zeros_like(n)
    for _ in range(10):
        U, _, Vt = solvers._svd(Hn2 - t_est[..., :, None] * n[..., None, :])
        dsign = torch.linalg.det(U @ Vt)
        D = torch.stack([torch.ones_like(dsign), torch.ones_like(dsign), dsign],
                        dim=-1)
        R_est = U @ (D[..., :, None] * Vt)
        t_est = torch.einsum("...ij,...j->...i", Hn2 - R_est, n)
    Ra, Rb = R_est.unbind(-3)
    ta, tb = t_est.unbind(-2)
    na, nb = n.unbind(-2)
    # the (R, -t, -n) pair shares R with (R, t, n)
    return (torch.stack([Ra, Ra, Rb, Rb], dim=-3),
            torch.stack([ta, -ta, tb, -tb], dim=-2),
            torch.stack([na, -na, nb, -nb], dim=-2))


def pose_from_homography(H, x1, x2, inlier_mask=None):
    """cam2_from_cam1 from H + cheirality (plane-induced or pure rotation).

    Returns (quat, trans, n, points3D, front_mask).
    """
    R_c, t_c, n_c = decompose_homography(H)
    q_c = qops.matrix_to_quat(R_c)  # [..., 4cand, 4]
    if inlier_mask is None:
        inlier_mask = torch.ones(x1.shape[:-1], dtype=torch.bool,
                                 device=x1.device)
    X, front = triangulate_and_count_cheirality(
        q_c, t_c, x1[..., None, :, :], x2[..., None, :, :])
    counts = torch.sum(front & inlier_mask[..., None, :], dim=-1)
    quat, trans, n, X_best, front_best = _best_candidate(
        counts, q_c, t_c, n_c, X, front)
    return quat, trans, n, X_best, front_best & inlier_mask
