"""Pose-graph relaxation: robust rotation averaging + position solve.

Escape hatch for the drift-fold local minimum (VERDICT r4 missing #2): a
closed trajectory mapped incrementally accumulates rotational drift; when
loop-closure pairs finally bridge the seam, bundle adjustment sits in a
cost-flat folded configuration it cannot unbend (measured r4: deep-BA probe
at C4-loop leaves the fold intact). The reference's own recovery is repeated
retriangulation + iterative global refinement (ref: pipeline/sfm.h:194-208),
which fails the same way; classical global-SfM recovery is a pose-graph
relaxation over the verified pair graph, applied here BEFORE the final BA
rounds:

1. robust rotation averaging over all verified two-view rotations
   (Chatterjee-Govindu style so(3) IRLS with graduated non-convexity:
   the L2 phase distributes the seam error around the whole loop, the
   annealed Geman-McClure phase then ignores genuine outlier pairs);
2. positions from a linear least-squares over rotation-corrected local
   displacements (trusted short-baseline edges keep their camera-frame
   geometry) plus direction-only constraints from the closure pairs'
   two-view translations (scale-free cross-product rows);
3. full batched retriangulation of every track under the corrected poses
   (multi-view masked DLT in one device call), then the caller's usual
   iterative global refinement polishes.

All solves are dense-linear-algebra over [3N, 3N] systems (N = images) in
host float64 numpy (micro-seconds per edge below ~2k cameras).

Port of ``pycolmap_tpu/sfm/pose_graph.py``: the numpy is the reference's;
the batched retriangulation runs the port's ``triangulate_dlt`` on the
caller's device (the card unless ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.geometry import Rigid3d, Rotation3d


# ---------------------------------------------------------------------------
# so(3) helpers (batched numpy)
# ---------------------------------------------------------------------------


def _log_so3(R):
    """Batched rotation-matrix -> axis-angle vector. R: [..., 3, 3]."""
    tr = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0, -1.0, 1.0)
    theta = np.arccos(tr)
    ax = np.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    s = 2.0 * np.sin(theta)
    scale = np.where(np.abs(s) < 1e-9, 0.5, theta / np.where(s == 0, 1, s))
    return ax * scale[..., None]


def _exp_so3(w):
    """Batched axis-angle -> rotation matrix. w: [..., 3]."""
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    safe = np.where(theta < 1e-12, 1.0, theta)
    k = w / safe
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1] = -k[..., 2]
    K[..., 0, 2] = k[..., 1]
    K[..., 1, 0] = k[..., 2]
    K[..., 1, 2] = -k[..., 0]
    K[..., 2, 0] = -k[..., 1]
    K[..., 2, 1] = k[..., 0]
    st = np.sin(theta)[..., None]
    ct = np.cos(theta)[..., None]
    eye = np.broadcast_to(np.eye(3), K.shape)
    R = eye + st * K + (1.0 - ct) * (K @ K)
    return np.where(theta[..., None] < 1e-12, eye, R)


def _quat_wxyz_to_R(q):
    """Batched wxyz quaternion -> rotation matrix."""
    q = np.asarray(q, np.float64)
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                      2 * (x * z + w * y)], -1),
            np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                      2 * (y * z - w * x)], -1),
            np.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                      1 - 2 * (x * x + y * y)], -1),
        ],
        axis=-2,
    )


# ---------------------------------------------------------------------------
# rotation averaging
# ---------------------------------------------------------------------------


def rotation_averaging(
    R_init,
    edges,
    R_rel,
    num_iters: int = 30,
    sigma_final_deg: float = 5.0,
    fixed: int = 0,
):
    """Robust so(3) averaging: find R_i minimizing rho(|Log(R_j^T Rij R_i)|).

    R_init: [N, 3, 3] cam_from_world rotations (initialization);
    edges: [E, 2] int (i, j) with measurement Rij = cam_j_from_cam_i;
    R_rel: [E, 3, 3]. Returns R_new [N, 3, 3].

    Each iteration solves the per-axis weighted graph Laplacian for the
    tangent corrections (w_j - w_i = r_ij, R_k <- R_k Exp(w_k)), with
    graduated non-convexity on the Geman-McClure weights: sigma anneals
    from 60 deg (quasi-L2: the seam discrepancy spreads over the whole
    loop) down to sigma_final_deg (true outlier pairs drop out).
    """
    R = np.array(R_init, np.float64)
    N = len(R)
    edges = np.asarray(edges, np.int64)
    i_idx, j_idx = edges[:, 0], edges[:, 1]
    sigma0 = np.deg2rad(60.0)
    sigma_f = np.deg2rad(sigma_final_deg)
    anneal = (sigma_f / sigma0) ** (1.0 / max(num_iters - 5, 1))
    sigma = sigma0
    for it in range(num_iters):
        # residuals r_ij = Log(R_j^T Rij R_i)
        E_mat = np.swapaxes(R[j_idx], -1, -2) @ R_rel @ R[i_idx]
        r = _log_so3(E_mat)  # [E, 3]
        rn = np.linalg.norm(r, axis=-1)
        w = 1.0 / (1.0 + (rn / sigma) ** 2) ** 2  # Geman-McClure IRLS
        # weighted graph Laplacian (shared across the 3 axes)
        L = np.zeros((N, N))
        np.add.at(L, (i_idx, i_idx), w)
        np.add.at(L, (j_idx, j_idx), w)
        np.add.at(L, (i_idx, j_idx), -w)
        np.add.at(L, (j_idx, i_idx), -w)
        b = np.zeros((N, 3))
        np.add.at(b, j_idx, w[:, None] * r)
        np.add.at(b, i_idx, -w[:, None] * r)
        # gauge: pin the fixed node; tiny Tikhonov for isolated nodes
        L[fixed, :] = 0.0
        L[:, fixed] = 0.0
        L[fixed, fixed] = 1.0
        b[fixed] = 0.0
        L += 1e-9 * np.eye(N)
        try:
            omega = np.linalg.solve(L, b)  # [N, 3]
        except np.linalg.LinAlgError:
            break
        R = R @ _exp_so3(omega)
        sigma = max(sigma * anneal, sigma_f)
        if np.abs(omega).max() < 1e-10:
            break
    return R


# ---------------------------------------------------------------------------
# position solve
# ---------------------------------------------------------------------------


def position_solve(
    c_init,
    S_corr,
    disp_edges,
    disp_vals,
    dir_edges,
    dir_units,
    dir_weight: float = 1.0,
    fixed: int = 0,
):
    """Linear LS for camera centers.

    c_init: [N, 3] current centers; S_corr: [N, 3, 3] world-frame
    correction rotations (R_new^T R_old per camera) that rotate each
    camera's LOCAL displacement measurements into the corrected frame;
    disp_edges [Ed, 2] with disp_vals [Ed, 3] = old-world displacements
    (c_j - c_i) of trusted short-baseline pairs; dir_edges [Eu, 2] with
    dir_units [Eu, 3] = unit direction of (c_j - c_i) in the NEW world
    frame from closure pairs' two-view translations (scale-free:
    constraint rows are [u]x (c_j - c_i) = 0).

    Solves the 3N normal equations densely. Returns c_new [N, 3].
    """
    N = len(c_init)
    A_blocks = np.zeros((3 * N, 3 * N))
    rhs = np.zeros(3 * N)

    # displacement terms: |(c_j - c_i) - S_i d_ij|^2, identity blocks
    d_new = np.einsum("eab,eb->ea", S_corr[disp_edges[:, 0]], disp_vals)
    for (i, j), d in zip(disp_edges, d_new):
        si, sj = 3 * i, 3 * j
        for a in range(3):
            A_blocks[si + a, si + a] += 1.0
            A_blocks[sj + a, sj + a] += 1.0
            A_blocks[si + a, sj + a] -= 1.0
            A_blocks[sj + a, si + a] -= 1.0
            rhs[sj + a] += d[a]
            rhs[si + a] -= d[a]

    # direction terms: |[u]x (c_j - c_i)|^2 -> normal matrix P = I - u u^T
    if len(dir_edges):
        P = (
            np.eye(3)[None]
            - dir_units[:, :, None] * dir_units[:, None, :]
        ) * dir_weight
        for (i, j), Pm in zip(dir_edges, P):
            si, sj = 3 * i, 3 * j
            A_blocks[si:si + 3, si:si + 3] += Pm
            A_blocks[sj:sj + 3, sj:sj + 3] += Pm
            A_blocks[si:si + 3, sj:sj + 3] -= Pm
            A_blocks[sj:sj + 3, si:si + 3] -= Pm

    # gauge: eliminate the fixed camera's center by substitution — move its
    # column block's contribution to the RHS, then pin the block to identity
    sf = 3 * fixed
    cf = np.asarray(c_init[fixed], np.float64)
    rhs -= A_blocks[:, sf:sf + 3] @ cf
    A_blocks[sf:sf + 3, :] = 0.0
    A_blocks[:, sf:sf + 3] = 0.0
    A_blocks[sf:sf + 3, sf:sf + 3] = np.eye(3)
    rhs[sf:sf + 3] = cf
    A_blocks += 1e-9 * np.eye(3 * N)
    try:
        c = np.linalg.solve(A_blocks, rhs).reshape(N, 3)
    except np.linalg.LinAlgError:
        return np.array(c_init, np.float64)
    return c


# ---------------------------------------------------------------------------
# orchestration over a Reconstruction
# ---------------------------------------------------------------------------


def _collect_edges(reconstruction, pair_pose, image_index):
    """Verified pairs between registered images -> (edges, R_rel, t_rel)."""
    edges, R_rel, t_rel = [], [], []
    for (id1, id2), (q, t) in pair_pose.items():
        k1 = image_index.get(id1)
        k2 = image_index.get(id2)
        if k1 is None or k2 is None:
            continue
        edges.append((k1, k2))
        R_rel.append(_quat_wxyz_to_R(q))
        t_rel.append(np.asarray(t, np.float64))
    if not edges:
        return (np.zeros((0, 2), np.int64), np.zeros((0, 3, 3)),
                np.zeros((0, 3)))
    return np.asarray(edges), np.stack(R_rel), np.stack(t_rel)


def pose_graph_residuals_deg(reconstruction, pair_pose):
    """Per verified pair: rotation residual [deg] between the stored
    two-view rotation and the current reconstruction's relative rotation.
    The fold detector: a well-mapped scene has residuals at the noise
    level everywhere; a folded loop shows a heavy tail."""
    reg = [i for i in reconstruction.reg_image_ids]
    image_index = {iid: k for k, iid in enumerate(reg)}
    edges, R_rel, _ = _collect_edges(reconstruction, pair_pose, image_index)
    if not len(edges):
        return np.zeros(0)
    R = np.stack(
        [
            reconstruction.images[iid].cam_from_world.rotation.matrix()
            for iid in reg
        ]
    )
    E_mat = np.swapaxes(R[edges[:, 1]], -1, -2) @ R_rel @ R[edges[:, 0]]
    return np.degrees(np.linalg.norm(_log_so3(E_mat), axis=-1))


def relax_pose_graph(
    reconstruction,
    pair_pose,
    min_residual_deg: float = 1.0,
    num_iters: int = 30,
    verbose: bool = True,
    device=None,
):
    """Rotation-average + re-position all registered cameras, then
    retriangulate every track under the corrected poses.

    pair_pose: {(image_id1, image_id2): (qvec wxyz, tvec)} cam2_from_cam1
    measurements (DatabaseCache.pair_pose). No-op (returns False) when the
    pair-graph residuals are already below min_residual_deg at the 95th
    percentile — running it on a healthy reconstruction is wasted work but
    harmless. Returns True when poses were rewritten (caller should run
    iterative global refinement after). ``device``: where the
    retriangulation runs (None = the card).
    """
    from pycolmap_torch.utils import logging as _logging

    log = _logging.get_logger()
    reg = list(reconstruction.reg_image_ids)
    if len(reg) < 3:
        return False
    image_index = {iid: k for k, iid in enumerate(reg)}
    edges, R_rel, t_rel = _collect_edges(
        reconstruction, pair_pose, image_index
    )
    if len(edges) < len(reg):
        return False

    R_old = np.stack(
        [
            reconstruction.images[iid].cam_from_world.rotation.matrix()
            for iid in reg
        ]
    )
    c_old = np.stack(
        [reconstruction.images[iid].projection_center() for iid in reg]
    )

    E_mat = np.swapaxes(R_old[edges[:, 1]], -1, -2) @ R_rel @ R_old[edges[:, 0]]
    resid = np.degrees(np.linalg.norm(_log_so3(E_mat), axis=-1))
    p95 = float(np.percentile(resid, 95))
    # fold detector: closure pairs are <1% of the edge set at C4/C5 scale,
    # so percentile gates miss them — trigger on a COUNT of gross outlier
    # edges (well above both the floor and the bulk), or on a globally bad
    # p95 (early-stage wrecks)
    med = float(np.median(resid))
    gross = resid > max(min_residual_deg, 5.0 * med)
    if p95 < min_residual_deg and int(gross.sum()) < 3:
        return False
    if verbose:
        log.info(
            f"pose graph: {len(edges)} edges over {len(reg)} images, "
            f"residuals median {med:.2f} deg / p95 {p95:.2f} deg / "
            f"{int(gross.sum())} gross outlier edges (max {resid.max():.2f})"
            " -> relaxing"
        )

    R_new = rotation_averaging(R_old, edges, R_rel, num_iters=num_iters)

    # trusted displacement edges: residual below ~3x median (sequential
    # pairs whose local geometry survived); closure/direction edges: all
    # verified pairs contribute their scale-free two-view direction
    med = max(np.median(resid), 0.1)
    resid_new = np.degrees(
        np.linalg.norm(
            _log_so3(
                np.swapaxes(R_new[edges[:, 1]], -1, -2)
                @ R_rel
                @ R_new[edges[:, 0]]
            ),
            axis=-1,
        )
    )
    # abort (before touching the reconstruction) unless the averaging
    # actually FIXED the gross edges (the fold) without blowing up the
    # bulk — a failed relaxation must never wreck a mapped scene. The
    # overall mean is useless here: a handful of closure edges barely
    # moves it, so judge the gross edges directly.
    ok_fix = (not gross.any()) or (
        float(np.minimum(resid_new[gross], 10.0).mean())
        < 0.6 * float(np.minimum(resid[gross], 10.0).mean())
    )
    ok_bulk = float(np.median(resid_new)) < max(3.0 * med, 1.0)
    if not (ok_fix and ok_bulk):
        if verbose:
            log.info(
                "pose graph: averaging did not resolve the gross edges "
                f"(gross {np.minimum(resid[gross], 10.0).mean():.2f} -> "
                f"{np.minimum(resid_new[gross], 10.0).mean():.2f} deg, "
                f"bulk median {np.median(resid):.2f} -> "
                f"{np.median(resid_new):.2f}); leaving the reconstruction "
                "unchanged"
            )
        return False

    trusted = resid < 3.0 * med
    disp_edges = edges[trusted]
    disp_vals = c_old[disp_edges[:, 1]] - c_old[disp_edges[:, 0]]
    # direction constraints from pairs consistent AFTER averaging
    # (c_j - c_i proportional to -R_i_new^T R_rel^T t_rel)
    dir_sel = resid_new < 3.0
    dir_edges = edges[dir_sel]
    # c_j - c_i = -R_i^T R_rel^T t_rel (scale-free direction, new rotations)
    rt = np.einsum(
        "eba,eb->ea", R_rel[dir_sel], t_rel[dir_sel]
    )  # R_rel^T t
    u = -np.einsum("eba,eb->ea", R_new[dir_edges[:, 0]], rt)  # R_i^T (.)
    norms = np.linalg.norm(u, axis=-1, keepdims=True)
    good_u = norms[:, 0] > 1e-9
    dir_edges = dir_edges[good_u]
    u = u[good_u] / norms[good_u]

    S_corr = np.swapaxes(R_new, -1, -2) @ R_old  # R_new^T R_old per camera
    c_new = position_solve(
        c_old, S_corr, disp_edges, disp_vals, dir_edges, u,
        dir_weight=float(max(len(disp_edges), 1))
        / float(max(len(dir_edges), 1)),
    )

    # write back: R_new, t = -R_new c_new
    for k, iid in enumerate(reg):
        img = reconstruction.images[iid]
        img.cam_from_world = Rigid3d(
            Rotation3d(R_new[k]), -R_new[k] @ c_new[k]
        )

    n_re, n_drop = retriangulate_all(reconstruction, device=device)
    if verbose:
        rot_move = np.degrees(
            np.linalg.norm(
                _log_so3(np.swapaxes(R_new, -1, -2) @ R_old), axis=-1
            )
        )
        log.info(
            f"pose graph: rotations moved median "
            f"{np.median(rot_move):.2f} deg (max {rot_move.max():.2f}); "
            f"retriangulated {n_re} points, dropped {n_drop}"
        )
    return True


def retriangulate_all(reconstruction, min_tri_angle_deg: float = 0.5,
                      device=None):
    """Re-estimate every point3D from its full track under the current
    poses: one masked multi-view DLT over all tracks (one batch on
    ``device``, None = the card), cheirality-checked; points failing are
    deleted (subsequent completion / triangulation rounds can re-create
    them)."""
    from pycolmap_torch.ops import solvers as sv

    device = resolve_device(device)
    rec = reconstruction
    pids = list(rec.points3D.keys())
    if not pids:
        return 0, 0
    # gather tracks (host): per point, its observing images + normalized
    # keypoints
    proj = {}
    norm_kp = {}
    for iid in rec.reg_image_ids:
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        proj[iid] = np.asarray(
            img.cam_from_world.matrix(), np.float64
        )  # [3, 4]
        # normalize ALL keypoints of the image in one vectorized call
        # (per-element cam_from_img would be 400k host calls at C5 scale)
        if img.num_points2D:
            norm_kp[iid] = np.asarray(
                cam.cam_from_img(img.points2D_xy), np.float64
            )
        else:
            norm_kp[iid] = np.zeros((0, 2))
    T_max = 1
    tracks = []
    for pid in pids:
        els = [
            el for el in rec.points3D[pid].track.elements
            if el.image_id in proj
        ]
        tracks.append(els)
        T_max = max(T_max, len(els))
    T_max = min(T_max, 64)
    P = len(pids)
    Pm = np.zeros((P, T_max, 3, 4), np.float32)
    xn = np.zeros((P, T_max, 2), np.float32)
    w = np.zeros((P, T_max), np.float32)
    for k, els in enumerate(tracks):
        for t, el in enumerate(els[:T_max]):
            xn[k, t] = norm_kp[el.image_id][el.point2D_idx]
            Pm[k, t] = proj[el.image_id]
            w[k, t] = 1.0
    X = sv.triangulate_dlt(
        *(torch.from_numpy(a).to(device) for a in (Pm, xn, w))
    ).cpu().numpy().astype(np.float64)
    # cheirality: every observing view must see positive depth
    Xh = np.concatenate([X, np.ones((P, 1))], axis=1)
    depths = np.einsum("ptj,pj->pt", Pm[:, :, 2, :].astype(np.float64), Xh)
    ok = np.all((depths > 1e-6) | (w == 0), axis=1) & np.isfinite(X).all(
        axis=1
    )
    n_re = 0
    n_drop = 0
    for k, pid in enumerate(pids):
        if ok[k]:
            rec.points3D[pid].xyz = X[k]
            n_re += 1
        else:
            rec.delete_point3D(pid)
            n_drop += 1
    return n_re, n_drop
