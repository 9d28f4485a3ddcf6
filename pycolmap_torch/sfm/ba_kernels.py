"""Bucketed bundle adjustment: the LM solver with Schur-eliminated PCG.

Port of ``pycolmap_tpu/sfm/ba_kernels.py``. Observations are bucketed BY
POINT into dense ``[T, P]`` grids (T = padded track length, P = points in
the bucket), per-observation values are component-first ``[comp, T, P]``,
and per-point reductions are sums over T. On the card every bucket goes
through the CUDA kernels behind ``sfm/cg_kernel.py``; on the CPU through
their plain PyTorch versions, built from the helpers here. The reference's
per-bucket Pallas/XLA router, one-hot MXU gathers and scatters, 4x padding
of the camera counts and executable cache are TPU machinery with no
counterpart here.

The LM loop is a Python loop with the reference's semantics (λ₀ = 1e-4,
÷3 / ×4, the three convergence tests, SCHUR_JACOBI preconditioning and
eta-forcing PCG). Where the reference's ``while_loop`` tests a condition on
the device, this loop reads it on the host: once per CG iteration and once
per LM step. ``_lm_solve_bucketed`` counts those syncs.

The CG matvec reads J either in f32 or packed to bf16 once per LM step
(``cg_bf16``). The default follows the device, as the reference's does
(``PYCOLMAP_TPU_BA_CG_BF16``, default on, takes effect on its accelerator
path only): bf16 on the card, f32 on the CPU.

A small unsharded problem solves its reduced camera system densely
instead (the reference's ``_dense_schur_solve``): S = U + damping -
W V^-1 W^T built in float64 as one [D, D] matrix, D = 6 I + NP C, and
rounded to f32 once, then PCG on it (plain PyTorch on the caller's
device; no kernel of its own: the reference builds it in XLA).
The choice is the reference's (:func:`dense_schur_selected`): its padded
dimension at or under 512 on the card, where its kernels run, or 2048 on
the CPU; ``dense_schur_max_d`` replaces the cutoff, 0 keeps every solve
implicit (the reference's ``PYCOLMAP_TPU_DENSE_SCHUR_MAX_D``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from pycolmap_torch.ops import ba_math as bm
from pycolmap_torch.ops.camera_models import (
    CAMERA_MODEL_BY_ID,
    mixed_sel_index,
    solver_num_params,
)
from pycolmap_torch.sfm.bundle_adjustment import BASummary, BundleProblem

_BUCKET_TS = (4, 8, 16, 32, 64)
# the reference's dense-Schur cutoffs on its padded system dimension: with
# its kernels on (the card's path) and on its CPU path
_DENSE_SCHUR_MAX_D = {"cuda": 512, "cpu": 2048}


class Bucket(NamedTuple):
    img_idx: torch.Tensor  # [T, P] int32
    cam_idx: torch.Tensor  # [T, P] int32
    xy: torch.Tensor  # [2, T, P] f32
    mask: torch.Tensor  # [T, P] f32 (0 = padding)
    points: torch.Tensor  # [3, P] f32 (bucket-local point positions)
    point_free: torch.Tensor  # [P] f32
    point_rows: torch.Tensor  # [P] int32 original row in BundleProblem.points


def _pad_4x(n, lo):
    """Next 4x step (lo, 4lo, 16lo, ...) >= n: the reference's bucket
    widths, kept so both packages bucket a problem identically."""
    n = max(n, lo)
    b = lo
    while b < n:
        b *= 4
    return b


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _track_lengths(problem: BundleProblem):
    """The valid observations, their point-sorted order, each point's start
    and end in that order, and the emitted buckets: (T, selected point
    rows, padded width) up to the bucket covering the longest track, empty
    ones inside that prefix at width 128."""
    obs_pt = _np(problem.obs_point_idx)
    obs_mask = _np(problem.obs_mask)
    P = _np(problem.points).shape[0]
    valid = obs_mask > 0
    order = np.argsort(obs_pt[valid], kind="stable")
    v_pt = obs_pt[valid][order]
    starts = np.searchsorted(v_pt, np.arange(P))
    ends = np.searchsorted(v_pt, np.arange(P) + 1)
    lens = ends - starts
    max_len = int(lens.max()) if len(lens) else 1
    n_buckets = next(
        (k + 1 for k, T in enumerate(_BUCKET_TS) if max_len <= T),
        len(_BUCKET_TS),
    )
    emitted = []
    for T in _BUCKET_TS[:n_buckets]:
        lo = 0 if T == _BUCKET_TS[0] else _BUCKET_TS[_BUCKET_TS.index(T) - 1]
        if T == _BUCKET_TS[n_buckets - 1]:
            sel = np.nonzero(lens > lo)[0]  # includes over-long tracks
        else:
            sel = np.nonzero((lens > lo) & (lens <= T))[0]
        emitted.append((T, sel, _pad_4x(len(sel), 128)))
    return valid, order, starts, ends, emitted


def bucketize(problem: BundleProblem, col_range=None):
    """Host-side: flat obs -> per-track-length buckets of numpy arrays.

    The reference's ``bucketize``: only buckets up to the one covering the
    longest track are emitted, empty ones inside that prefix at width 128.
    col_range: optional (index, count): fill only that contiguous share of
    each bucket's point columns, [index w, (index + 1) w) with w = width /
    count; a width not divisible by count raises ValueError."""
    valid, order, starts, ends, emitted = _track_lengths(problem)
    v_img = _np(problem.obs_image_idx)[valid][order]
    v_cam = _np(problem.obs_camera_idx)[valid][order]
    v_xy = _np(problem.obs_xy)[valid][order]
    points = _np(problem.points)
    point_free = _np(problem.point_free)
    buckets = []
    for T, sel, width in emitted:
        if col_range is not None:
            pid, nproc = col_range
            if width % nproc != 0:
                raise ValueError(
                    f"bucket width {width} not divisible by {nproc} shards")
            width //= nproc
            sel = sel[pid * width:(pid + 1) * width]
        n_sel = len(sel)
        flat_pos = starts[sel][None, :] + np.arange(T)[:, None]  # [T, n_sel]
        in_track = flat_pos < ends[sel][None, :]  # over-long tracks truncate
        flat_safe = np.where(in_track, flat_pos, 0)
        img_idx = np.zeros((T, width), dtype=np.int32)
        cam_idx = np.zeros((T, width), dtype=np.int32)
        xy = np.zeros((2, T, width), dtype=np.float32)
        mask = np.zeros((T, width), dtype=np.float32)
        pts = np.zeros((3, width), dtype=np.float32)
        pfree = np.zeros(width, dtype=np.float32)
        rows = np.zeros(width, dtype=np.int32)
        img_idx[:, :n_sel] = np.where(in_track, v_img[flat_safe], 0)
        cam_idx[:, :n_sel] = np.where(in_track, v_cam[flat_safe], 0)
        xy[0, :, :n_sel] = np.where(in_track, v_xy[flat_safe, 0], 0.0)
        xy[1, :, :n_sel] = np.where(in_track, v_xy[flat_safe, 1], 0.0)
        mask[:, :n_sel] = in_track.astype(np.float32)
        pts[:, :n_sel] = points[sel].T
        pfree[:n_sel] = point_free[sel]
        rows[:n_sel] = sel
        buckets.append(Bucket(img_idx, cam_idx, xy, mask, pts, pfree, rows))
    return tuple(buckets)


def bucket_meta(problem: BundleProblem):
    """Selection metadata only (no [T, P] planes): per bucket, the FULL
    (point_rows [Pb], columns holding a point [Pb] bool, Pb, T), what a
    process holding only its bucket slices needs to write every point
    back."""
    out = []
    for T, sel, Pb in _track_lengths(problem)[4]:
        rows = np.zeros(Pb, dtype=np.int32)
        rows[: len(sel)] = sel
        out.append((rows, np.arange(Pb) < len(sel), Pb, T))
    return out


def shard_buckets(problem: BundleProblem, mesh):
    """This process's shards of the bucket columns: one tuple of host
    buckets per local shard of ``mesh``, shard k holding columns [s w, (s +
    1) w) of every bucket, s = ``mesh.shard_index(k)``, w = width /
    ``mesh.size``. The process fills only its own share
    (``bucketize(col_range=(rank, processes))``), then splits it among its
    shards, as the reference places a process's slice on its local
    devices. A width not divisible by the shard count raises
    ValueError."""
    nproc, n = mesh.num_processes, mesh.local_size
    shards = [[] for _ in range(n)]
    for b in bucketize(problem, col_range=(mesh.rank, nproc)):
        width = b.mask.shape[1]
        if width % n:
            raise ValueError(f"bucket width {width * nproc} not divisible "
                             f"by {mesh.size} shards")
        w = width // n
        for k in range(n):
            shards[k].append(Bucket(*(a[..., k * w:(k + 1) * w] for a in b)))
    return [tuple(bl) for bl in shards]


def bucket_to(bucket: Bucket, device) -> Bucket:
    """A bucket of numpy arrays as contiguous tensors on ``device``."""
    return Bucket(*(torch.as_tensor(np.ascontiguousarray(a)).to(device)
                    for a in bucket))


# ---------------------------------------------------------------------------
# per-bucket plain math (the CUDA kernels' reference arithmetic)
# ---------------------------------------------------------------------------


def _gather_table(table, idx):
    """table [N, k] -> tuple of k tensors gathered with idx [...]."""
    idx = idx.long()
    return tuple(table[:, c][idx] for c in range(table.shape[1]))


def _residual_vals(model_id, xy, mask, q, t, k, X):
    """Masked reprojection residual from per-obs parameters (no deltas)."""
    px, py, z = bm.project_cf(model_id, k, q, t, X)
    rx = (px - xy[0]) * mask
    ry = (py - xy[1]) * mask
    behind = (z <= 1e-8) & (mask > 0)
    rx = torch.where(behind, torch.full_like(rx, 1e3), rx)
    ry = torch.where(behind, torch.full_like(ry, 1e3), ry)
    return rx, ry


def _bucket_res_and_jac(model_id, bucket, q_obs, t_obs, k_obs, intr_free_obs):
    """Residual [2, T, P] + analytic Jacobian [2, 9+n, T, P], n =
    len(intr_free_obs) (the model's NP in the solver).

    Column order: [rot(3), trans(3), intrinsics(n), point(3)]. The chain
    rule is assembled in closed form; only the 2-D distortion is linearized,
    by ``torch.func.jvp`` (two passes for d(dist)/d(u,v) plus one per extra
    parameter), as the reference does with ``jax.jvp``.

    model_id may be a tuple (a mixed-model bundle): each model's residual
    and Jacobian come from this same path and are selected per observation
    by the selector plane ``k_obs[mixed_sel_index(models)]`` with
    ``torch.where`` (an observation whose selector names no listed model
    takes the first one, as in the reference). Columns past a model's own
    parameter count, the selector's among them, are exact zeros.
    """
    if isinstance(model_id, tuple):
        sel = k_obs[mixed_sel_index(model_id)]
        res_out = J_out = None
        for m in model_id:
            res_m, J_m = _bucket_res_and_jac(m, bucket, q_obs, t_obs, k_obs,
                                             intr_free_obs)
            c = sel == m
            res_out = (res_m if res_out is None
                       else torch.where(c[None], res_m, res_out))
            J_out = (J_m if J_out is None
                     else torch.where(c[None, None], J_m, J_out))
        return res_out, J_out
    info = CAMERA_MODEL_BY_ID[model_id]
    X = (
        bucket.points[0][None],
        bucket.points[1][None],
        bucket.points[2][None],
    )
    vx, vy, vz = bm.quat_rotate_cf(q_obs, X)
    cx = vx + t_obs[0]
    cy = vy + t_obs[1]
    cz = vz + t_obs[2]
    z_safe = torch.where(torch.abs(cz) < 1e-8, torch.full_like(cz, 1e-8), cz)
    inv_z = 1.0 / z_safe
    u = cx * inv_z
    v = cy * inv_z

    dist = bm._DISTORT_CF[model_id]
    k_obs = tuple(k_obs)
    ones = torch.ones_like(u)
    zeros = torch.zeros_like(u)
    (du_, dv_), (ddu_u, ddv_u) = torch.func.jvp(
        lambda uu: dist(k_obs, uu, v), (u,), (ones,)
    )
    _, (ddu_v, ddv_v) = torch.func.jvp(
        lambda vv: dist(k_obs, u, vv), (v,), (ones,)
    )

    if len(info.focal_idxs) == 1:
        fx = fy = k_obs[info.focal_idxs[0]]
        focal_cols = {info.focal_idxs[0]: "both"}
    else:
        fx = k_obs[info.focal_idxs[0]]
        fy = k_obs[info.focal_idxs[1]]
        focal_cols = {info.focal_idxs[0]: "x", info.focal_idxs[1]: "y"}
    pcx = k_obs[info.principal_idxs[0]]
    pcy = k_obs[info.principal_idxs[1]]
    px = fx * du_ + pcx
    py = fy * dv_ + pcy

    mask = bucket.mask
    behind = (cz <= 1e-8) & (mask > 0)
    thousand = torch.full_like(px, 1e3)
    rx = torch.where(behind, thousand, (px - bucket.xy[0]) * mask)
    ry = torch.where(behind, thousand, (py - bucket.xy[1]) * mask)
    res = torch.stack([rx, ry])

    # per-obs column weight: mask, and zero where the constant 1e3 residual
    # replaced the projection (matches the jvp of the where())
    wgt = mask * (1.0 - behind.to(u.dtype))

    # A = d(px,py)/d(u,v); B = A @ d(u,v)/dXc (2x3 perspective)
    A11 = fx * ddu_u
    A12 = fx * ddu_v
    A21 = fy * ddv_u
    A22 = fy * ddv_v
    B1x = A11 * inv_z
    B1y = A12 * inv_z
    B1z = -(A11 * u + A12 * v) * inv_z
    B2x = A21 * inv_z
    B2y = A22 * inv_z
    B2z = -(A21 * u + A22 * v) * inv_z

    def col(jx, jy):
        return torch.stack([jx * wgt, jy * wgt])

    NP = info.num_params
    cols = []
    # rotation (left tangent): dXc/dth = -[RX]x
    cols.append(col(-B1y * vz + B1z * vy, -B2y * vz + B2z * vy))
    cols.append(col(B1x * vz - B1z * vx, B2x * vz - B2z * vx))
    cols.append(col(-B1x * vy + B1y * vx, -B2x * vy + B2y * vx))
    # translation: dXc/dt = I
    cols.append(col(B1x, B2x))
    cols.append(col(B1y, B2y))
    cols.append(col(B1z, B2z))
    for j in range(len(intr_free_obs)):
        if j >= NP:
            cols.append(torch.stack([zeros, zeros]))
            continue
        kind = focal_cols.get(j)
        if kind == "both":
            c = col(du_, dv_)
        elif kind == "x":
            c = col(du_, zeros)
        elif kind == "y":
            c = col(zeros, dv_)
        elif j == info.principal_idxs[0]:
            c = col(ones, zeros)
        elif j == info.principal_idxs[1]:
            c = col(zeros, ones)
        elif j in info.extra_idxs:
            tang = tuple(ones if i == j else zeros for i in range(len(k_obs)))
            _, (ddu_k, ddv_k) = torch.func.jvp(
                lambda *kk: dist(kk, u, v), k_obs, tang
            )
            c = col(fx * ddu_k, fy * ddv_k)
        else:
            c = torch.stack([zeros, zeros])
        cols.append(c * intr_free_obs[j][None])
    # point: dXc/dX = R(q)
    w, qx, qy, qz = q_obs
    R00 = 1 - 2 * (qy * qy + qz * qz)
    R01 = 2 * (qx * qy - w * qz)
    R02 = 2 * (qx * qz + w * qy)
    R10 = 2 * (qx * qy + w * qz)
    R11 = 1 - 2 * (qx * qx + qz * qz)
    R12 = 2 * (qy * qz - w * qx)
    R20 = 2 * (qx * qz - w * qy)
    R21 = 2 * (qy * qz + w * qx)
    R22 = 1 - 2 * (qx * qx + qy * qy)
    for Rc in ((R00, R10, R20), (R01, R11, R21), (R02, R12, R22)):
        cols.append(
            col(
                B1x * Rc[0] + B1y * Rc[1] + B1z * Rc[2],
                B2x * Rc[0] + B2y * Rc[1] + B2z * Rc[2],
            )
            * bucket.point_free[None, None, :]
        )
    J = torch.stack(cols, dim=1)  # [2, 9+n, T, P]
    return res, J


def _inv3x3_planes(V):
    """V: [6, P] packed symmetric (a,b,c,d,e,f) = (00,01,02,11,12,22).

    Returns the packed inverse [6, P]."""
    a, b, c, d, e, f = V
    A = d * f - e * e
    B = c * e - b * f
    C = b * e - c * d
    det = a * A + b * B + c * C
    det = torch.where(torch.abs(det) < 1e-12, torch.full_like(det, 1e-12), det)
    D = a * f - c * c
    E = b * c - a * e
    F = a * d - b * b
    return torch.stack([A, B, C, D, E, F]) / det[None]


def _jt_apply(Jsub, res):
    """[2, k, T, P] x [2, T, P] -> [k, T, P]: per-obs J^T r."""
    return Jsub[0] * res[0][None] + Jsub[1] * res[1][None]


def _jt_apply_sum_t(Jsub, res):
    """[2, k, T, P] x [2, T, P] -> [k, P]: J^T r summed over the track."""
    return torch.sum(_jt_apply(Jsub, res), dim=1)


def _j_apply_pt(Jsub, z):
    """[2, k, T, P] x [k, P] -> [2, T, P]: apply point-block columns."""
    return torch.sum(Jsub * z[None, :, None, :], dim=1)


def _sym3_apply(Vp, y):
    """Packed symmetric [6, P] times vector tuple (3 x [P])."""
    a, b, c, d, e, f = Vp
    y0, y1, y2 = y
    return (
        a * y0 + b * y1 + c * y2,
        b * y0 + d * y1 + e * y2,
        c * y0 + e * y1 + f * y2,
    )


def _chol3x3_planes(Vp):
    """Closed-form Cholesky of packed SPD 3x3 planes [6, P]: the six
    nonzero entries (l00, l10, l20, l11, l21, l22) of lower L, L L^T = V."""
    a, b, c, d, e, f = Vp
    l00 = torch.sqrt(torch.clamp(a, min=1e-20))
    l10 = b / l00
    l20 = c / l00
    l11 = torch.sqrt(torch.clamp(d - l10 * l10, min=1e-20))
    l21 = (e - l10 * l20) / l11
    l22 = torch.sqrt(torch.clamp(f - l20 * l20 - l21 * l21, min=1e-20))
    return l00, l10, l20, l11, l21, l22


def _scatter_cam(values, idx, num_segments):
    """values [k, T, P] -> [num_segments, k], summed by idx [T, P]
    (the reference's one-hot MXU scatter, as ``index_add_``).

    Accumulated in float64: at the bench shape a sequential f32
    ``index_add_`` of 600k terms onto one camera row is ~4e-4 off the
    float64 sum, and on a 32-image problem that alone moves the camera
    translations by 3e-4 in 6 LM steps."""
    k = values.shape[0]
    out = torch.zeros(
        (num_segments, k), dtype=torch.float64, device=values.device
    )
    out.index_add_(0, idx.reshape(-1).long(), values.reshape(k, -1).T.double())
    return out.to(values.dtype)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------

_TRI = [(i, j) for i in range(6) for j in range(i, 6)]


class LMResult(NamedTuple):
    quat: torch.Tensor  # [I, 4]
    trans: torch.Tensor  # [I, 3]
    intr: torch.Tensor  # [C, NP]
    points: list  # per shard, per bucket [3, P]
    initial_cost: torch.Tensor  # 0-d
    final_cost: torch.Tensor  # 0-d
    iterations: int
    host_syncs: int  # device-to-host reads of loop conditions
    cg_iterations: int  # implicit matvecs over the whole solve
    dense: bool  # every step solved the dense reduced system
    dense_cg_iterations: int  # PCG iterations on the dense system


def cg_bf16_default(device, cg_bf16=None) -> bool:
    """The CG matvec's J type: ``cg_bf16`` if given, else bf16 on the card
    and f32 on the CPU (the reference's defaults on its accelerator and its
    CPU)."""
    if cg_bf16 is None:
        return torch.device(device).type == "cuda"
    return bool(cg_bf16)


def dense_schur_dim(I, C, NP) -> int:
    """The reference's reduced-system dimension, from its padded counts:
    6 _pad_4x(I, 8) + NP _pad_4x(C, 1) (its ba_kernels.py:1645-1646)."""
    return 6 * _pad_4x(I, 8) + NP * _pad_4x(C, 1)


def dense_schur_cutoff(device, dense_schur_max_d=None) -> int:
    """``dense_schur_max_d`` if given, else the reference's cutoff on the
    device's path: 512 on the card (its kernels on), 2048 on the CPU."""
    if dense_schur_max_d is not None:
        return int(dense_schur_max_d)
    return _DENSE_SCHUR_MAX_D[torch.device(device).type]


def dense_schur_selected(I, C, NP, device, dense_schur_max_d=None,
                         mesh=None, img2cam=None) -> bool:
    """Whether a solve takes the dense reduced system: unsharded, given an
    image-to-camera map, and the reference's padded dimension at or under
    the cutoff (its ba_kernels.py:900-910). The port pads nothing; it only
    reads the reference's dimension, so both pick the same solver."""
    return (mesh is None and img2cam is not None
            and dense_schur_dim(I, C, NP)
            <= dense_schur_cutoff(device, dense_schur_max_d))


def _first(parts):
    """The unsharded solve's reduction: its one partial, untouched."""
    return parts[0]


def _shards(shards, devs, mesh):
    """(k, buckets, device) per shard; on a mesh the shard's card is the
    current device while the caller's loop body runs, so the kernels launch
    there, on its current stream."""
    for k, (bl, d) in enumerate(zip(shards, devs)):
        if mesh is not None and d.type == "cuda":
            with torch.cuda.device(d):
                yield k, bl, d
        else:
            yield k, bl, d


def _dot(a, b):
    """Sum of the elementwise products of two tuples of tensors."""
    out = torch.sum(a[0] * b[0])
    for u, v in zip(a[1:], b[1:]):
        out = out + torch.sum(u * v)
    return out


def _pcg(matvec, precond, rhs, cg_iters, eta):
    """PCG from x = 0 with the reference's forcing sequence (inexact
    Newton, Ceres eta): stop when r.z drops below eta^2 times its initial
    value, or after cg_iters matvecs. Vectors are tuples of tensors;
    matvec and precond map one to another. Returns (x, iterations, host
    syncs): the stop test is read on the host once per iteration."""
    z = precond(*rhs)
    rz = _dot(rhs, z)
    stop = eta * eta * rz
    x = tuple(torch.zeros_like(r) for r in rhs)
    r, p = rhs, z
    k = syncs = 0
    while k < cg_iters:
        syncs += 1
        if not bool(rz > stop):
            break
        Ap = matvec(*p)
        pAp = _dot(p, Ap)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20,
                                 torch.full_like(pAp, 1e-20), pAp)
        x = tuple(xi + alpha * pi for xi, pi in zip(x, p))
        r = tuple(ri - alpha * api for ri, api in zip(r, Ap))
        z = precond(*r)
        rz_new = _dot(r, z)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20,
                                    torch.full_like(rz, 1e-20), rz)
        p = tuple(zi + beta * pi for zi, pi in zip(z, p))
        rz = rz_new
        k += 1
    return x, k, syncs


def _schur_jacobi(pose_free, intr_free):
    """The implicit path's damping and SCHUR_JACOBI preconditioner, as a
    function of one LM step's lam and prepare's reduced rows (udp [I, 6],
    udi [C, NP], S_blocks [I, 21]) that returns (damp_pose, damp_intr,
    precond)."""
    dev = pose_free.device
    I = pose_free.shape[0]
    tri_i = torch.tensor([i for i, _ in _TRI], device=dev)
    tri_j = torch.tensor([j for _, j in _TRI], device=dev)
    eye6 = torch.eye(6, device=dev)

    def step(lam, udp, udi, S_blocks):
        damp_pose = lam * torch.clamp(udp, min=1e-6)
        damp_intr = lam * torch.clamp(udi, min=1e-6)
        S_full = torch.zeros((I, 6, 6), device=dev)
        S_full[:, tri_i, tri_j] = S_blocks
        S_full[:, tri_j, tri_i] = S_blocks
        S_full = S_full + torch.diag_embed(damp_pose + 1e-8)
        # inv_ex: no singularity check, so no host sync (the reference's
        # jnp.linalg.inv returns inf/nan there too)
        P_inv = torch.linalg.inv_ex(S_full + 1e-6 * eye6)[0]
        denom = udi + damp_intr
        denom = torch.where(denom < 1e-8, torch.ones_like(denom), denom)

        def precond(r_pose, r_intr):
            p_pose = torch.einsum("iab,ib->ia", P_inv, r_pose) * pose_free
            return p_pose, r_intr / denom * intr_free

        return damp_pose, damp_intr, precond

    return step


class DenseIndex(NamedTuple):
    """Where each observation slot of one shard's buckets (their [T, P]
    slots in bucket order, padding included) lands in the dense build."""
    point: torch.Tensor  # [N] its point's column in the buckets' [., sum P]
    image: torch.Tensor  # [N] int64
    camera: torch.Tensor  # [N] int64
    z: torch.Tensor  # [(6 + NP) 3 N] its W entries' flat positions in Z


def dense_schur_index(buckets, I, NP) -> DenseIndex:
    """The dense build's tables of `buckets` (one shard's) for I images and
    NP intrinsics: fixed for a solve, so the LM loop builds them once. Z
    is [D, 3 sum P]: row 6 i + k (pose k of image i) or 6 I + NP c + k
    (intrinsic k of camera c), column a sum P + p (point p's axis a)."""
    dev = buckets[0].mask.device
    points, image, camera, off = [], [], [], 0
    for b in buckets:
        T, P = b.mask.shape
        points.append((off + torch.arange(P, device=dev)).expand(T, P))
        image.append(b.img_idx.reshape(-1))
        camera.append(b.cam_idx.reshape(-1))
        off += P
    point = torch.cat([q.reshape(-1) for q in points])
    image, camera = torch.cat(image).long(), torch.cat(camera).long()
    rows = torch.cat([
        6 * image + torch.arange(6, device=dev)[:, None],
        6 * I + NP * camera + torch.arange(NP, device=dev)[:, None],
    ])  # [nk, N]
    cols = torch.arange(3, device=dev)[:, None] * off + point  # [3, N]
    return DenseIndex(point, image, camera,
                      (rows[:, None] * (3 * off) + cols[None]).reshape(-1))


def dense_schur_system(buckets, J_l, Vinv_l, lam, pose_free, intr_free,
                       img2cam, index=None):
    """The damped, masked reduced camera system as one dense [D, D] f32
    matrix, D = 6 I + NP C, rows [pose (i, k) at 6 i + k | intrinsics
    (c, k) at 6 I + NP c + k] (the reference's ``_dense_schur_solve``,
    ba_kernels.py:620-742, without its padded rows). lam: 0-d tensor;
    img2cam [I]: each image's camera; index: the buckets'
    :func:`dense_schur_index`, built here when None.

    With L = chol(Vinv) and W = Jc^T Jp L per observation, Z[(i, k),
    (a, p)] sums W over the observations of point p in image i (camera c
    for the intrinsics rows): one ``index_add_`` over every bucket's
    slots into Z [D, 3 sum P], and S -= Z Z^T is one product. The U blocks
    (pose-pose, pose-intrinsics through ``img2cam``,
    intrinsics-intrinsics) are one ``index_add_`` by image and one by
    camera. All of it runs in float64 from the f32 J and Vinv, and S
    rounds to f32 once: at the mapper's windows S's entries are ~1e-5 of
    U's (a rotation row's U ~5e8), so an f32 difference U - Z Z^T (the
    reference's CPU path; its TPU rounds Z to bf16) would keep few of S's
    bits. Then the damping lam max(diag U, 1e-6), and the fixed
    parameters' rows and columns replaced by the identity."""
    I = pose_free.shape[0]
    C, NP = intr_free.shape
    D = 6 * I + NP * C
    nk = 6 + NP
    dev = pose_free.device
    f64 = torch.float64
    if index is None:
        index = dense_schur_index(buckets, I, NP)
    J = torch.cat([J.reshape(2, nk + 3, -1) for J in J_l], dim=2).to(f64)
    Jn, Jp = J[:, :nk], J[:, nk:]  # [2, ., N]
    Vinv = torch.cat(list(Vinv_l), dim=1).to(f64)  # [6, sum P]
    l00, l10, l20, l11, l21, l22 = torch.stack(
        _chol3x3_planes(Vinv))[:, index.point]  # [6, N]
    JpL = torch.stack([
        Jp[:, 0] * l00 + Jp[:, 1] * l10 + Jp[:, 2] * l20,
        Jp[:, 1] * l11 + Jp[:, 2] * l21,
        Jp[:, 2] * l22,
    ], dim=1)  # [2, 3, N]
    W = Jn[0][:, None] * JpL[0][None] + Jn[1][:, None] * JpL[1][None]
    cols = 3 * Vinv.shape[1]
    Z = torch.zeros(D * cols, dtype=f64, device=dev)
    Z.index_add_(0, index.z, W.reshape(-1))
    Z = Z.reshape(D, cols)
    G = Jn[0][:, None] * Jn[0][None] + Jn[1][:, None] * Jn[1][None]
    acc_i = torch.zeros((I, 6 * nk), dtype=f64, device=dev)
    acc_i.index_add_(0, index.image, G[:6].reshape(6 * nk, -1).T)
    acc_c = torch.zeros((C, NP * NP), dtype=f64, device=dev)
    acc_c.index_add_(0, index.camera, G[6:, 6:].reshape(NP * NP, -1).T)
    lam = lam.to(f64)
    U_pp = acc_i.reshape(I, 6, nk)[:, :, :6]
    U_pi = acc_i.reshape(I, 6, nk)[:, :, 6:]
    U_ii = acc_c.reshape(C, NP, NP)
    U_pp = U_pp + torch.diag_embed(
        lam * torch.clamp(torch.diagonal(U_pp, dim1=1, dim2=2), min=1e-6))
    U_ii = U_ii + torch.diag_embed(
        lam * torch.clamp(torch.diagonal(U_ii, dim1=1, dim2=2), min=1e-6))
    k6 = torch.arange(6, device=dev)
    kNP = torch.arange(NP, device=dev)
    arI = torch.arange(I, device=dev)
    rows_p = (6 * arI[:, None, None] + k6[None, :, None]).expand(I, 6, 6)
    cols_i = (6 * I + NP * img2cam.long()[:, None, None]
              + kNP[None, None, :]).expand(I, 6, NP)
    rows_pi = rows_p[:, :, :1].expand(I, 6, NP)
    arC = torch.arange(C, device=dev)
    rows_c = (6 * I + NP * arC[:, None, None] + kNP[None, :, None]).expand(
        C, NP, NP)
    U = torch.zeros((D, D), dtype=f64, device=dev)
    U[rows_p, rows_p.transpose(1, 2)] = U_pp
    U[rows_pi, cols_i] = U_pi
    U[cols_i, rows_pi] = U_pi
    U[rows_c, rows_c.transpose(1, 2)] = U_ii
    S = (U - Z @ Z.T).to(torch.float32)
    free = torch.cat([pose_free.reshape(-1), intr_free.reshape(-1)])
    return S * free[:, None] * free[None, :] + torch.diag(1.0 - free)


def _dense_schur_solve(S, rhs_pose, rhs_intr, pose_free, intr_free,
                       cg_iters, eta):
    """PCG on the dense system S (:func:`dense_schur_system`) with a
    block-Jacobi preconditioner from its 6x6 pose blocks and its
    intrinsics diagonal (the reference's ba_kernels.py:744-821). Returns
    (x_pose [I, 6], x_intr [C, NP], iterations, host syncs)."""
    I = pose_free.shape[0]
    C, NP = intr_free.shape
    dev = S.device
    arI = torch.arange(I, device=dev)
    blk = S[:6 * I, :6 * I].reshape(I, 6, I, 6)[arI, :, arI, :]  # [I, 6, 6]
    P_inv = torch.linalg.inv_ex(blk + 1e-6 * torch.eye(6, device=dev))[0]
    dint = torch.diagonal(S)[6 * I:]
    dint = torch.where(torch.abs(dint) < 1e-8, torch.ones_like(dint), dint)
    free = torch.cat([pose_free.reshape(-1), intr_free.reshape(-1)])

    def precond(r):
        zp = torch.einsum("iab,ib->ia", P_inv, r[:6 * I].reshape(I, 6))
        return (torch.cat([zp.reshape(-1), r[6 * I:] / dint]) * free,)

    rhs = torch.cat([rhs_pose.reshape(-1), rhs_intr.reshape(-1)])
    (x,), k, syncs = _pcg(lambda p: (S @ p,), precond, (rhs,), cg_iters, eta)
    return (x[:6 * I].reshape(I, 6) * pose_free,
            x[6 * I:].reshape(C, NP) * intr_free, k, syncs)


def _lm_solve_bucketed(
    buckets, quat0, trans0, intr0, pose_free, intr_free, model_id,
    loss_type, loss_scale, cg_iters, max_iterations, eta=0.1, cg_bf16=False,
    mesh=None, img2cam=None, dense_schur_max_d=None,
):
    """LM over device-resident buckets.

    quat0 [I, 4], trans0 [I, 3], intr0 / intr_free [C, >= NP] (sliced to
    the model's NP), pose_free [I, 6]: the camera system, on one device.
    The bucket ``points`` fields are the starting point positions.
    cg_bf16: run every CG matvec from J packed to bf16 (the reference's
    ba_kernels.py:1064-1102). Returns an :class:`LMResult`.

    img2cam: [I] each image's camera, or None. With it, no mesh, and the
    reference's padded dimension within ``dense_schur_max_d`` (None: the
    device's cutoff; :func:`dense_schur_selected`), every step solves the
    dense reduced system (:func:`dense_schur_system`) by PCG capped at
    max(cg_iters, 64) iterations, as the reference's; prepare and finish
    still launch once a step, the matvec kernels and the bf16 pack never.

    buckets: one tuple of buckets per local shard, each on its shard's
    device; the result's ``points`` are one list per shard likewise.
    mesh: None, with one shard on the camera system's device; or a
    :class:`~pycolmap_torch.parallel.device_ctx.ShardMesh`, with the
    shards of :func:`shard_buckets`, the camera system on the mesh's first
    device. Each shard eliminates its own points. Every reduction over
    observations (the costs, prepare's camera rows, each CG matvec) is a
    partial per shard summed by ``mesh.reduce``, so every shard of every
    rank solves one and the same camera system; the damping and the
    preconditioner apply once, after the sum, and the loops' stop tests
    read only reduced values, so every rank takes the same branch. Vinv,
    g_pt and the points stay on their shards. Without a mesh the reduction
    is the one partial itself and issues no operation.
    """
    from pycolmap_torch.sfm import cg_kernel as ck

    shards = list(buckets)
    reduce = _first if mesh is None else mesh.reduce
    dev = quat0.device
    devs = [bl[0].mask.device for bl in shards]

    def each():
        return _shards(shards, devs, mesh)

    I, C = quat0.shape[0], intr0.shape[0]
    NP = solver_num_params(model_id)
    intr0 = intr0[:, :NP].contiguous()
    intr_free = intr_free[:, :NP].contiguous()
    free_l = [intr_free.to(d) for d in devs]
    dense = dense_schur_selected(I, C, NP, dev, dense_schur_max_d, mesh,
                                 img2cam)
    index = dense_schur_index(shards[0], I, NP) if dense else None
    jacobi = _schur_jacobi(pose_free, intr_free)
    syncs = 0
    cg_total = 0
    dense_cg = 0

    pts = [[b.points for b in bl] for bl in shards]
    # resjac's table per shard, once per solve: only the points change
    rj_l = [ck.resjac_launch(bl, model_id) for bl in shards]
    cost0 = reduce([
        ck.total_cost(bl, pts[s], quat0.to(d), trans0.to(d), intr0.to(d),
                      model_id, loss_type, loss_scale)
        for s, bl, d in each()])
    quat, trans, intr = quat0, trans0, intr0
    lam = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    cost = cost0
    done = torch.tensor(False, device=dev)
    it = 0
    while it < max_iterations:
        # --- per shard: residuals, Jacobians, robust weights; V inverses,
        # gradients and the shard's part of the reduced rhs, damping
        # diagonals and SCHUR_JACOBI blocks --------------------------------
        J_l, Vinv_l, g_pt_l, cam_l = [], [], [], []
        for s, bl, d in each():
            res, J = ck.res_and_jac(bl, pts[s], quat.to(d), trans.to(d),
                                    intr.to(d), free_l[s], model_id,
                                    loss_type, loss_scale, launch=rj_l[s])
            Vinv, g_pt, *cam = ck.schur_prepare(bl, J, res, lam.to(d), I, C)
            J_l.append(J)
            Vinv_l.append(Vinv)
            g_pt_l.append(g_pt)
            cam_l.append(cam)
        rhs_pose, rhs_intr, udp, udi, S_blocks = reduce(cam_l)
        rhs_pose = rhs_pose * pose_free
        rhs_intr = rhs_intr * intr_free
        if not dense:
            damp_pose, damp_intr, precond = jacobi(lam, udp, udi, S_blocks)
        # one kernel table per LM step and shard for finish; on an implicit
        # step also one pack (bf16) and one table for the matvecs
        J16_l, mv_l, fin_l = [], [], []
        for s, bl, d in each():
            if not dense and cg_bf16:
                J16_l.append([ck.pack_j_bf16(J) for J in J_l[s]])
                mv_l.append(ck.matvec_launch("matvec16", bl, J16_l[s],
                                             Vinv_l[s], I, C))
            elif not dense:
                mv_l.append(ck.matvec_launch("matvec", bl, J_l[s],
                                             Vinv_l[s], I, C))
            fin_l.append(ck.finish_launch(bl, pts[s], J_l[s], Vinv_l[s],
                                          g_pt_l[s]))

        if dense:  # one shard: the dense path never runs on a mesh
            S = dense_schur_system(shards[0], J_l[0], Vinv_l[0], lam,
                                   pose_free, intr_free, img2cam, index)
            x_pose, x_intr, k, n_sync = _dense_schur_solve(
                S, rhs_pose, rhs_intr, pose_free, intr_free,
                max(cg_iters, 64), eta)
            dense_cg += k
        else:
            def matvec(x_pose, x_intr):
                parts = []
                for s, bl, d in each():
                    if cg_bf16:
                        parts.append(ck.schur_matvec16(
                            bl, J16_l[s], Vinv_l[s], x_pose.to(d),
                            x_intr.to(d), I, C, launch=mv_l[s]))
                    else:
                        parts.append(ck.schur_matvec(
                            bl, J_l[s], Vinv_l[s], x_pose.to(d),
                            x_intr.to(d), I, C, launch=mv_l[s]))
                mp, mi = reduce(parts)
                return ((damp_pose * x_pose + mp) * pose_free,
                        (damp_intr * x_intr + mi) * intr_free)

            (x_pose, x_intr), k, n_sync = _pcg(
                matvec, precond, (rhs_pose, rhs_intr), cg_iters, eta)
            cg_total += k
        syncs += n_sync

        # --- apply the step, back-substitute points, cost at the update --
        nq = bm.quat_boxplus_cf(
            (quat[:, 0], quat[:, 1], quat[:, 2], quat[:, 3]),
            (-x_pose[:, 0], -x_pose[:, 1], -x_pose[:, 2]),
        )
        new_quat = torch.stack(nq, dim=1)
        new_trans = trans - x_pose[:, 3:6]
        new_intr = intr - x_intr
        fin = [
            ck.backsub_and_cost(
                bl, pts[s], J_l[s], Vinv_l[s], g_pt_l[s], x_pose.to(d),
                x_intr.to(d), new_quat.to(d), new_trans.to(d),
                new_intr.to(d), model_id, loss_type, loss_scale,
                launch=fin_l[s])
            for s, bl, d in each()]
        new_cost = reduce([c for _, c in fin])

        # --- accept/reject -----------------------------------------------
        improved = new_cost < cost
        quat = torch.where(improved, new_quat, quat)
        trans = torch.where(improved, new_trans, trans)
        intr = torch.where(improved, new_intr, intr)
        pts = [[torch.where(improved.to(d), n, o)
                for n, o in zip(new_pts, old)]
               for (new_pts, _), old, d in zip(fin, pts, devs)]
        cost_out = torch.where(improved, new_cost, cost)
        lam = torch.where(improved, torch.clamp(lam / 3.0, min=1e-10),
                          lam * 4.0)
        rel = (cost - cost_out) / torch.clamp(cost, min=1e-20)
        done = done | (improved & (rel < 1e-7))
        # an ATTEMPTED cost within 1e-7 relative of the current one signals
        # convergence even when rejected (re-solves of converged problems)
        att_rel = torch.abs(new_cost - cost) / torch.clamp(cost, min=1e-20)
        done = done | (att_rel < 1e-7) | (lam > 1e10)
        cost = cost_out
        it += 1
        if it < max_iterations:
            syncs += 1
            if bool(done):
                break
    return LMResult(quat, trans, intr, pts, cost0, cost, it, syncs,
                    cg_total, dense, dense_cg)


def solve_bundle_fast(problem: BundleProblem, options, cg_iters: int = 30,
                      device=None, cg_bf16=None, mesh=None,
                      dense_schur_max_d=None):
    """Bucketed solver; same contract as bundle_adjustment.solve_bundle.

    Runs one solve of a :class:`~pycolmap_torch.sfm.resident.
    ResidentBundleSolver` and fetches the result. ``device``: None = the
    card (raises on a host without CUDA), or ``"cpu"``. ``cg_bf16``: the CG
    matvec's J type, None = the device's default (:func:`cg_bf16_default`);
    False is the reference's ``PYCOLMAP_TPU_BA_CG_BF16=0``. ``mesh``: a
    :class:`~pycolmap_torch.parallel.device_ctx.ShardMesh` to shard the
    points over (its devices take the place of ``device``; one that
    disagrees raises), or None for one device. ``dense_schur_max_d``: the
    dense reduced system's cutoff (:func:`dense_schur_selected`), None =
    the device's (512 on the card, 2048 on the CPU), 0 = always implicit
    (the reference's ``PYCOLMAP_TPU_DENSE_SCHUR_MAX_D=0``).
    """
    from pycolmap_torch.parallel.device_ctx import mesh_device
    from pycolmap_torch.sfm.resident import ResidentBundleSolver

    mesh_device(mesh, device)  # raises before any work, as the solver would
    if problem.num_obs == 0 or float(_np(problem.obs_mask).sum()) == 0:
        return problem, BASummary(0.0, 0.0, 0, 0)
    solver = ResidentBundleSolver(problem, options, cg_iters=cg_iters,
                                  device=device, cg_bf16=cg_bf16, mesh=mesh,
                                  dense_schur_max_d=dense_schur_max_d)
    summary = solver.solve()
    return solver.fetch_problem(), summary
