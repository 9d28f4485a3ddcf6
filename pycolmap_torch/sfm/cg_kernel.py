"""The bundle-adjustment kernels of the LM step, with their wrappers.

Port of ``pycolmap_tpu/sfm/cg_kernel.py``. Each wrapper keeps the return
contract of its reference twin and either launches the CUDA kernel
(``sfm/csrc``, bound by ``sfm/_cuda.py``; one launch for all buckets of a
call, except the gather, which takes one bucket) for CUDA tensors or runs
the plain PyTorch version beside it, per bucket, for CPU tensors. There is
no fallback: a CUDA tensor goes to the kernel or the launch raises.

| wrapper              | CUDA kernel               | reference Pallas kernel          |
|----------------------|---------------------------|----------------------------------|
| res_and_jac          | resjac.cu                 | resjac_bucket (cg_kernel.py:625) |
| total_cost           | cost.cu cost_kernel       | cost_bucket (:708)               |
| backsub_and_cost     | cost.cu finish_kernel     | finish_bucket (:821)             |
| schur_prepare        | schur.cu prepare_kernel   | schur_prepare_bucket (:1088)     |
| schur_matvec         | schur.cu matvec_kernel    | cg_matvec_bucket (:183)          |
| schur_matvec16       | schur.cu matvec16_kernel  | cg_matvec16_bucket (:352)        |
| gather_params_bucket | gather.cu                 | gather_params_bucket (:466)      |

Inside, parameter tables stay ``[I, 7]`` (quat | trans) and ``[C, NP]``;
the reference's 128-lane transposed tables are a TPU layout.

A mixed-model bundle passes ``model_id`` as a tuple of ids. Its width NP
is ``mixed_sel_index(models) + 1``: the last intrinsics column holds each
camera's model id (the selector), with ``intr_free`` 0 and a zero Jacobian
column, so the solve never moves it. On the card ``res_and_jac``,
``total_cost`` and ``backsub_and_cost`` launch the mixed variants of their
kernels (``*_mixed``: one kernel per function and width, a runtime switch
on each observation's selector into the same per-model device code); the
Schur kernels read J at its width and need no variant. The plain versions
where-select per observation, as the reference does.

``res_and_jac`` is one launch for all buckets (up to 16, of any width),
one thread per track slot, over a table of the buckets' operands and
output offsets (``resjac_table``, in a :class:`ResJacLaunch`) that the LM
solve builds once per solve and shard (``resjac_launch``): within a solve
only the points change, and each call writes their pointers into the
table. Every bucket's residual and Jacobian are contiguous views of one
allocation per call.

``schur_matvec16`` reads J packed to bf16 by ``pack_j_bf16`` (the
reference's layout and rounding), once per LM step; prepare, the f32
matvec, finish and the cost read the f32 J, as in the reference. On the
card each of the three Schur wrappers is one launch for all buckets, over
a table of their tiles (``tile_table``, in a :class:`TileLaunch`): the
matvecs' is built once per LM step (``matvec_launch``), prepare's per
call. The kernels take buckets of a multiple of 8 columns (bucketize pads
to multiples of 128); the plain versions take any width.

``total_cost`` and ``backsub_and_cost`` are one launch each for all
buckets of any width, over a table of the same tiles (``cost_table``, in
a :class:`CostLaunch`): finish's is built once per LM step
(``finish_launch``), the cost's per call. Both sum their total on the card
in a fixed order (one partial per tile, added in tile order), so a call
repeats to the bit, and finish at x = 0 with every point fixed returns the
cost's bits.

``LAUNCHES`` counts kernel launches per kernel; ``PLAIN_ON_CUDA`` counts
calls of a plain version on CUDA tensors (only ``chip_smoke.py``'s
comparisons make those). ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import torch

from pycolmap_torch.ops.camera_models import solver_num_params
from pycolmap_torch.sfm import _cuda
from pycolmap_torch.sfm import ba_kernels as bk
from pycolmap_torch.sfm.bundle_adjustment import _robust_cost, _robust_weight

KERNELS = ("resjac", "cost", "finish", "prepare", "matvec", "matvec16",
           "resjac_mixed", "cost_mixed", "finish_mixed", "gather")
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_ON_CUDA = dict.fromkeys(KERNELS, 0)


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_ON_CUDA[k] = 0


def _is_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"unsupported device {t.device}")


def _plain_call(name, t, model_id=0):
    if t.is_cuda:
        PLAIN_ON_CUDA[_kernel_name(name, model_id)] += 1


def _kernel_name(name, model_id):
    return f"{name}_mixed" if isinstance(model_id, tuple) else name


def _model(model_id):
    """(model, NP): one model's id and parameter count, or a mixed
    bundle's tuple of ids and its width, the selector column last."""
    if isinstance(model_id, tuple):
        model = tuple(int(m) for m in model_id)
    else:
        model = int(model_id)
    return model, solver_num_params(model)


def _launch(name, model, NP, *args):
    """Launch the kernel of `name` for one model, or its mixed variant for
    a tuple (the launcher takes the width and the listed ids as a bit mask;
    resjac also the first id, which observations naming no listed model
    take)."""
    key = _kernel_name(name, model)
    LAUNCHES[key] += 1
    if isinstance(model, tuple):
        head = (NP, sum(1 << m for m in set(model)))
        if name == "resjac":
            head += (model[0],)
        getattr(_cuda, key)(*head, *args)
    else:
        getattr(_cuda, key)(model, *args)


# ---------------------------------------------------------------------------
# plain versions, one bucket each (the kernels' reference arithmetic)
# ---------------------------------------------------------------------------


def resjac_plain(b, pts, itab, intr, ifree, model_id, loss_type, loss_scale):
    """Robust-weighted residual [2, T, P] and Jacobian [2, 9+NP, T, P]."""
    _plain_call("resjac", pts, model_id)
    q_obs = bk._gather_table(itab[:, :4], b.img_idx)
    t_obs = bk._gather_table(itab[:, 4:7], b.img_idx)
    k_obs = bk._gather_table(intr, b.cam_idx)
    ifo = bk._gather_table(ifree, b.cam_idx)
    res, J = bk._bucket_res_and_jac(
        model_id, b._replace(points=pts), q_obs, t_obs, k_obs, ifo
    )
    sq = res[0] * res[0] + res[1] * res[1]
    sw = torch.sqrt(_robust_weight(sq, loss_type, loss_scale) * b.mask)
    return res * sw[None], J * sw[None, None]


def _bucket_cost(b, pts, itab, intr, model_id, loss_type, loss_scale):
    q_obs = bk._gather_table(itab[:, :4], b.img_idx)
    t_obs = bk._gather_table(itab[:, 4:7], b.img_idx)
    k_obs = bk._gather_table(intr, b.cam_idx)
    X = (pts[0][None], pts[1][None], pts[2][None])
    rx, ry = bk._residual_vals(model_id, b.xy, b.mask, q_obs, t_obs, k_obs, X)
    sq = rx * rx + ry * ry
    return torch.sum(_robust_cost(sq, loss_type, loss_scale) * b.mask)


def cost_plain(b, pts, itab, intr, model_id, loss_type, loss_scale):
    """Robust cost of one bucket (0-d)."""
    _plain_call("cost", pts, model_id)
    return _bucket_cost(b, pts, itab, intr, model_id, loss_type, loss_scale)


def finish_plain(b, pts, J, Vinv, g_pt, x_pose, x_intr, nitab, nintr,
                 model_id, loss_type, loss_scale):
    """Back-substituted points [3, P] and the cost at the update (0-d)."""
    _plain_call("finish", pts, model_id)
    NP = x_intr.shape[1]
    nk = 6 + NP
    xc = torch.cat([
        torch.stack(bk._gather_table(x_pose, b.img_idx)),
        torch.stack(bk._gather_table(x_intr, b.cam_idx)),
    ])  # [nk, T, P]
    a_obs = torch.sum(J[:, :nk] * xc[None], dim=1)  # [2, T, P]
    bt = bk._jt_apply_sum_t(J[:, nk:nk + 3], a_obs)
    dp = torch.stack(bk._sym3_apply(
        Vinv, (g_pt[0] - bt[0], g_pt[1] - bt[1], g_pt[2] - bt[2])
    ))
    new_pts = pts - dp * b.point_free[None]
    cost = _bucket_cost(b, new_pts, nitab, nintr, model_id, loss_type,
                        loss_scale)
    return new_pts, cost


def prepare_plain(b, J, res, lam, I, C):
    """(Vinv [6, P], g_pt [3, P], image rows [I, 33], camera rows [C, 2NP])
    with image rows 6 rhs | 6 diag(U) | 21 packed 6x6 blocks and camera
    rows NP rhs | NP diag(U)."""
    _plain_call("prepare", J)
    nk = J.shape[1] - 3
    Jc = J[:, :6]
    Ji = J[:, 6:nk]
    Jp = J[:, nk:nk + 3]
    pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    V = torch.stack([torch.sum(Jp[:, a] * Jp[:, c], dim=(0, 1))
                     for a, c in pairs])
    V = V.clone()
    for k in (0, 3, 5):
        V[k] = V[k] + lam * torch.clamp(V[k], min=1e-6)
    Vinv = bk._inv3x3_planes(V)
    g_pt = bk._jt_apply_sum_t(Jp, res)
    z0 = torch.stack(bk._sym3_apply(Vinv, (g_pt[0], g_pt[1], g_pt[2])))
    rmj = res - bk._j_apply_pt(Jp, z0)
    W = Jc[0][:, None] * Jp[0][None] + Jc[1][:, None] * Jp[1][None]  # [6,3,T,P]
    a_, bb, c_, d_, e_, f_ = Vinv
    VW = torch.stack([
        a_ * W[:, 0] + bb * W[:, 1] + c_ * W[:, 2],
        bb * W[:, 0] + d_ * W[:, 1] + e_ * W[:, 2],
        c_ * W[:, 0] + e_ * W[:, 1] + f_ * W[:, 2],
    ], dim=1)  # [6, 3, T, P]
    blocks = torch.stack([
        Jc[0, i] * Jc[0, j] + Jc[1, i] * Jc[1, j]
        - torch.sum(VW[i] * W[j], dim=0)
        for i, j in bk._TRI
    ])
    img_vals = torch.cat([
        bk._jt_apply(Jc, rmj), Jc[0] ** 2 + Jc[1] ** 2, blocks,
    ])  # [33, T, P]
    cam_vals = torch.cat([bk._jt_apply(Ji, rmj), Ji[0] ** 2 + Ji[1] ** 2])
    return (Vinv, g_pt, bk._scatter_cam(img_vals, b.img_idx, I),
            bk._scatter_cam(cam_vals, b.cam_idx, C))


def matvec_plain(b, J, Vinv, x_pose, x_intr, I, C):
    """One bucket's J_c^T (I - J_p V^-1 J_p^T) J_c x: ([I, 6], [C, NP])."""
    _plain_call("matvec", J)
    return _matvec(b, J, Vinv, x_pose, x_intr, I, C)


def _matvec(b, J, Vinv, x_pose, x_intr, I, C):
    nk = J.shape[1] - 3
    xc = torch.cat([
        torch.stack(bk._gather_table(x_pose, b.img_idx)),
        torch.stack(bk._gather_table(x_intr, b.cam_idx)),
    ])
    a_obs = torch.sum(J[:, :nk] * xc[None], dim=1)  # [2, T, P]
    y_p = bk._jt_apply_sum_t(J[:, nk:nk + 3], a_obs)
    z_p = torch.stack(bk._sym3_apply(Vinv, (y_p[0], y_p[1], y_p[2])))
    d = a_obs - bk._j_apply_pt(J[:, nk:nk + 3], z_p)
    return (bk._scatter_cam(bk._jt_apply(J[:, :6], d), b.img_idx, I),
            bk._scatter_cam(bk._jt_apply(J[:, 6:nk], d), b.cam_idx, C))


def pack_j_bf16(J):
    """[2, nj, T, P] f32 -> [nj, 2T, P] bf16 (rows 0..T-1 = residual row 0);
    round to nearest even, as the reference's ``astype(jnp.bfloat16)``."""
    _, nj, T, P = J.shape
    return J.transpose(0, 1).reshape(nj, 2 * T, P).to(torch.bfloat16)


def unpack_j_bf16(J16, dtype=torch.float32):
    """[nj, 2T, P] bf16 -> [2, nj, T, P] in dtype (exact)."""
    nj, T2, P = J16.shape
    return J16.reshape(nj, 2, T2 // 2, P).transpose(0, 1).to(dtype)


def matvec16_plain(b, J16, Vinv, x_pose, x_intr, I, C):
    """matvec_plain on the unpacked bf16 J, in the dtype of Vinv."""
    _plain_call("matvec16", J16)
    return _matvec(b, unpack_j_bf16(J16, Vinv.dtype), Vinv, x_pose, x_intr,
                   I, C)


# ---------------------------------------------------------------------------
# wrappers over all buckets (the reference's return contracts)
# ---------------------------------------------------------------------------


def _itab(quat, trans):
    return torch.cat([quat, trans], dim=1).contiguous()


def res_and_jac(buckets, pts_list, quat, trans, intr, intr_free, model_id,
                loss_type, loss_scale, launch=None):
    """Robust-weighted residuals [2, T, P] and NP-narrow Jacobians
    [2, 9+NP, T, P] of every bucket: (res_l, J_l), zero at every masked
    slot. On the card one launch covers every bucket, over `launch`
    (resjac_launch of these buckets, built here when None); the outputs
    are contiguous views of one allocation per call."""
    model, NP = _model(model_id)
    intr = intr[:, :NP].contiguous()
    ifree = intr_free[:, :NP].contiguous()
    if buckets and _is_cuda(pts_list[0]):
        if launch is None:
            launch = ResJacLaunch(buckets, NP)
        elif launch.NP != NP or len(launch.buckets) != len(buckets) \
                or not all(a is b for a, b in zip(launch.buckets, buckets)):
            raise ValueError("resjac: launch was built for other buckets")
        if len(pts_list) != len(buckets):
            raise ValueError(f"resjac: {len(pts_list)} point sets for "
                             f"{len(buckets)} buckets")
        _cuda.set_points(launch.table, pts_list)
        out = torch.empty(launch.n_floats, device=pts_list[0].device)
        if launch.n_blocks:
            _launch("resjac", model, NP, launch, quat.contiguous(),
                    trans.contiguous(), intr, ifree, int(loss_type),
                    float(loss_scale), out)
        return launch.outputs(out)
    itab = _itab(quat, trans)
    res_l, J_l = [], []
    for b, pts in zip(buckets, pts_list):
        res, J = resjac_plain(b, pts, itab, intr, ifree, model,
                              int(loss_type), float(loss_scale))
        res_l.append(res)
        J_l.append(J)
    return res_l, J_l


def total_cost(buckets, pts_list, quat, trans, intr, model_id, loss_type,
               loss_scale):
    """Robust total cost over all buckets (0-d tensor). On the card one
    launch covers every bucket (a :class:`CostLaunch` built per call)."""
    model, NP = _model(model_id)
    if buckets and _is_cuda(pts_list[0]):
        launch = CostLaunch("cost", buckets, pts_list)
        out = torch.empty((), device=pts_list[0].device)
        _launch("cost", model, NP, launch, quat.contiguous(),
                trans.contiguous(), intr[:, :NP].contiguous(),
                int(loss_type), float(loss_scale), out)
        return out
    itab = _itab(quat, trans)
    intr = intr[:, :NP].contiguous()
    cost = torch.zeros((), device=quat.device)
    for b, pts in zip(buckets, pts_list):
        cost = cost + cost_plain(b, pts, itab, intr, model, int(loss_type),
                                 float(loss_scale))
    return cost


def backsub_and_cost(buckets, pts_list, J_l, Vinv_l, g_pt_l, x_pose, x_intr,
                     new_quat, new_trans, new_intr, model_id, loss_type,
                     loss_scale, launch=None):
    """Point back-substitution + robust cost at the updated parameters.
    x_intr is [C, NP]. Returns (new_pts_list, new_cost). On the card one
    launch covers every bucket, over `launch` (finish_launch of these
    operands, built here when None); the new points are the launch's
    buffers, which each call with it writes anew."""
    model, NP = _model(model_id)
    x_pose = x_pose.contiguous()
    x_intr = x_intr[:, :NP].contiguous()
    nintr = new_intr[:, :NP].contiguous()
    if buckets and _is_cuda(pts_list[0]):
        ops = _finish_operands(pts_list, J_l, Vinv_l, g_pt_l)
        if launch is None:
            launch = CostLaunch("finish", buckets, pts_list, J_l, Vinv_l,
                                g_pt_l)
        elif launch.kind != "finish" or len(launch.operands) != len(ops) \
                or not all(a is b for a, b in zip(launch.operands, ops)):
            raise ValueError("finish: launch was built for other operands")
        if any(J.shape[1] != 9 + NP for J in J_l):
            raise ValueError(f"finish: J of width {J_l[0].shape[1]} for a "
                             f"model of {NP} parameters")
        out = torch.empty((), device=x_pose.device)
        _launch("finish", model, NP, launch, new_quat.contiguous(),
                new_trans.contiguous(), nintr, x_pose, x_intr,
                int(loss_type), float(loss_scale), out)
        return list(launch.new_pts), out
    nitab = _itab(new_quat, new_trans)
    new_pts_l = []
    cost = torch.zeros((), device=x_pose.device)
    for b, pts, J, Vinv, g_pt in zip(buckets, pts_list, J_l, Vinv_l, g_pt_l):
        new_pts, part = finish_plain(b, pts, J, Vinv, g_pt, x_pose, x_intr,
                                     nitab, nintr, model, int(loss_type),
                                     float(loss_scale))
        new_pts_l.append(new_pts)
        cost = cost + part
    return new_pts_l, cost


def schur_prepare(buckets, J_l, res_l, lam, I, C):
    """LM preparation over all buckets: (Vinv_l, g_pt_l, rhs_pose [I, 6],
    rhs_intr [C, NP], U_diag_pose [I, 6], U_diag_intr [C, NP],
    S_blocks [I, 21]). Free masks stay with the caller. lam: 0-d tensor on
    the buckets' device (the kernel reads it there: no host sync). On the
    card one launch covers every bucket (bucket widths multiples of 8)."""
    NP = J_l[0].shape[1] - 9
    dev = J_l[0].device
    lam = torch.as_tensor(lam, dtype=torch.float32, device=dev).reshape(())
    if _is_cuda(J_l[0]):
        Vinv_l = [torch.empty((6, J.shape[-1]), device=dev) for J in J_l]
        g_pt_l = [torch.empty((3, J.shape[-1]), device=dev) for J in J_l]
        launch = TileLaunch("prepare", buckets, J_l, Vinv_l, I, C,
                            res_l=res_l, gpt_l=g_pt_l)
        mk = torch.empty if launch.sums == SUMS_FIXED else torch.zeros
        acc_i = mk((I, 33), device=dev)
        acc_c = mk((C, 2 * NP), device=dev)
        LAUNCHES["prepare"] += 1
        _cuda.prepare(NP, launch, lam, I, C, acc_i, acc_c)
    else:
        acc_i = torch.zeros((I, 33), device=dev)
        acc_c = torch.zeros((C, 2 * NP), device=dev)
        Vinv_l, g_pt_l = [], []
        for b, J, res in zip(buckets, J_l, res_l):
            vinv, gpt, oi, oc = prepare_plain(b, J, res, lam, I, C)
            Vinv_l.append(vinv)
            g_pt_l.append(gpt)
            acc_i = acc_i + oi
            acc_c = acc_c + oc
    return (Vinv_l, g_pt_l, acc_i[:, :6], acc_c[:, :NP], acc_i[:, 6:12],
            acc_c[:, NP:], acc_i[:, 12:33])


def _matvec_buckets(plain, NP, buckets, J_l, Vinv_l, x_pose, x_intr, I, C):
    """Sum one matvec's plain version over all buckets."""
    dev = J_l[0].device
    x_intr = x_intr[:, :NP]
    out_pose = torch.zeros((I, 6), device=dev)
    out_intr = torch.zeros((C, NP), device=dev)
    for b, J, Vinv in zip(buckets, J_l, Vinv_l):
        op, oi = plain(b, J, Vinv, x_pose, x_intr, I, C)
        out_pose = out_pose + op
        out_intr = out_intr + oi
    return out_pose, out_intr


def _schur_matvec(kind, plain, NP, buckets, J_l, Vinv_l, x_pose, x_intr, I,
                  C, launch):
    if not _is_cuda(J_l[0]):
        return _matvec_buckets(plain, NP, buckets, J_l, Vinv_l, x_pose,
                               x_intr, I, C)
    if launch is None:
        launch = TileLaunch(kind, buckets, J_l, Vinv_l, I, C)
    elif launch.kind != kind or not all(
            a is b for a, b in zip(launch.operands, J_l)):
        raise ValueError(f"{kind}: launch was built for other operands")
    dev = J_l[0].device
    x_pose = x_pose.contiguous()
    x_intr = x_intr[:, :NP].contiguous()
    mk = torch.empty if launch.sums == SUMS_FIXED else torch.zeros
    out_pose = mk((I, 6), device=dev)
    out_intr = mk((C, NP), device=dev)
    LAUNCHES[kind] += 1
    getattr(_cuda, kind)(NP, launch, x_pose, x_intr, I, C, out_pose, out_intr)
    return out_pose, out_intr


def schur_matvec(buckets, J_l, Vinv_l, x_pose, x_intr, I, C, launch=None):
    """Implicit S x over all buckets (no damping or free masking: the
    caller owns those). x_pose [I, 6]; x_intr [C, NP]. Returns
    (out_pose [I, 6], out_intr [C, NP]). On the card one launch covers
    every bucket, over `launch` (matvec_launch("matvec", ...) of these
    operands, built here when None). Bucket widths must be multiples of
    8."""
    return _schur_matvec("matvec", matvec_plain, J_l[0].shape[1] - 9,
                         buckets, J_l, Vinv_l, x_pose, x_intr, I, C, launch)


def schur_matvec16(buckets, J16_l, Vinv_l, x_pose, x_intr, I, C,
                   launch=None):
    """Implicit S x over all buckets from bf16-packed J (see pack_j_bf16);
    otherwise as schur_matvec (`launch`: matvec_launch("matvec16", ...))."""
    return _schur_matvec("matvec16", matvec16_plain, J16_l[0].shape[0] - 9,
                         buckets, J16_l, Vinv_l, x_pose, x_intr, I, C, launch)


# ---------------------------------------------------------------------------
# resjac's bucket table: one launch over every bucket, a thread per slot
# ---------------------------------------------------------------------------

RESJAC_MAX_BUCKETS = 16  # kResJacMaxBuckets in csrc/resjac.cu
RESJAC_COLS = 256  # kResJacCols: columns of a block's run of one slot row
RESJAC_ALIGN = 64  # floats (256 B) each output view starts on


def resjac_table(shapes, NP):
    """resjac's bucket table from the buckets' [T, P] at width NP: per
    bucket (T, P, runs, first_block, res_off, J_off) in launch order, the
    block count and the floats of the one output allocation. A bucket has
    T blocks of `runs` = ceil(P / 256) runs each; its residual [2, T, P]
    starts at float res_off, its Jacobian [2, 9+NP, T, P] at J_off, each
    on a multiple of 64 floats. Any width P >= 0, up to 16 buckets."""
    if not 1 <= len(shapes) <= RESJAC_MAX_BUCKETS:
        raise ValueError(f"resjac takes 1..{RESJAC_MAX_BUCKETS} buckets, "
                         f"got {len(shapes)}")
    rows, first, off = [], 0, 0
    for T, P in shapes:
        if T < 1 or P < 0:
            raise ValueError(f"resjac: bucket of shape [{T}, {P}]")
        runs = -(-P // RESJAC_COLS)
        r_off = off
        j_off = r_off + -(-2 * T * P // RESJAC_ALIGN) * RESJAC_ALIGN
        off = j_off + -(-2 * (9 + NP) * T * P // RESJAC_ALIGN) * RESJAC_ALIGN
        rows.append((T, P, runs, first, r_off, j_off))
        first += T * runs
    return tuple(rows), first, off


def resjac_views(rows, NP):
    """Per bucket of a resjac_table, the (size, stride, offset) of its
    residual [2, T, P] and of its Jacobian [2, 9+NP, T, P] in the output
    allocation: two lists, for ``as_strided``."""
    nj = 9 + NP
    res, J = [], []
    for T, P, _, _, r_off, j_off in rows:
        TP = T * P
        res.append(((2, T, P), (TP, P, 1), r_off))
        J.append(((2, nj, T, P), (nj * TP, TP, P, 1), j_off))
    return res, J


class ResJacLaunch:
    """What resjac on the card needs beside its per-call inputs, for one
    list of buckets at width NP: the bucket table (a ctypes struct passed
    by value, holding each bucket's index, xy, mask and free-flag pointers
    and its output offsets) and the output views. The LM solve builds one
    per solve and shard: its buckets do not change within a solve, and a
    call writes only its points' pointers into the table."""

    def __init__(self, buckets, NP):
        self.NP = NP
        self.buckets = list(buckets)
        self.rows, self.n_blocks, self.n_floats = resjac_table(
            [tuple(b.mask.shape) for b in buckets], NP)
        for i, (b, (T, P, *_)) in enumerate(zip(buckets, self.rows)):
            for t, shape in ((b.img_idx, (T, P)), (b.cam_idx, (T, P)),
                             (b.xy, (2, T, P)), (b.point_free, (P,))):
                if tuple(t.shape) != shape:
                    raise ValueError(f"resjac: bucket {i} operand of shape "
                                     f"{tuple(t.shape)}, expected {shape}")
        self._res, self._J = resjac_views(self.rows, NP)
        self.table = _cuda.resjac_table(self.rows, self.n_blocks, buckets)

    def outputs(self, out):
        """(res_l, J_l): each bucket's contiguous views of the output
        allocation `out` (n_floats)."""
        return ([out.as_strided(*v) for v in self._res],
                [out.as_strided(*v) for v in self._J])


def resjac_launch(buckets, model_id):
    """The :class:`ResJacLaunch` of one LM solve's buckets for
    res_and_jac; None off the card, where the plain version needs none."""
    if not buckets or not _is_cuda(buckets[0].mask):
        return None
    return ResJacLaunch(buckets, _model(model_id)[1])


# ---------------------------------------------------------------------------
# the Schur kernels' bucket table: one launch over every bucket
# ---------------------------------------------------------------------------

TILE_KINDS = ("matvec16", "matvec", "prepare")  # csrc/schur.cu TileKind
TILE_SLOTS = 256  # kTileSlots: T x columns a tile
TILE_MAX_T = 64  # kTileMaxT: the bucket ladder's longest tracks
TILE_MAX_BUCKETS = 8  # kTileMaxBuckets
TILE_CLUSTER = 8  # kTileCluster: blocks whose sums meet in DSMEM
SUMS_FIXED = 2  # kSumsFixed: sums without atomics, in a fixed order


def tile_p(T):
    """Columns per tile of a bucket of T slots: the largest power of two
    with T tile_p <= 256, at most 128 (4 at the ladder's T = 64)."""
    if not 1 <= T <= TILE_MAX_T:
        raise ValueError(f"the Schur kernels take buckets of 1..{TILE_MAX_T} "
                         f"slots, got T = {T}")
    return min(128, 1 << ((TILE_SLOTS // T).bit_length() - 1))


def tile_table(shapes):
    """The Schur kernels' bucket table from the buckets' [T, P]: per bucket
    (T, P, tile_p, first_tile) in launch order, and the tile count. P must
    be a multiple of 8 (bucketize pads to multiples of 128)."""
    if not 1 <= len(shapes) <= TILE_MAX_BUCKETS:
        raise ValueError(f"the Schur kernels take 1..{TILE_MAX_BUCKETS} "
                         f"buckets, got {len(shapes)}")
    rows, first = [], 0
    for T, P in shapes:
        if P % 8:
            raise ValueError(f"the Schur kernels take buckets of a multiple "
                             f"of 8 columns, got P = {P}")
        tp = tile_p(T)
        rows.append((T, P, tp, first))
        first += -(-P // tp)
    return tuple(rows), first


class TileLaunch:
    """What a Schur kernel on the card needs beside its per-call inputs,
    for one set of bucket operands: the kernel (`kind`, one of
    TILE_KINDS), the bucket table (a ctypes struct passed by value, holding
    the operands' pointers), where the sums live, and for the fixed-order
    sums the clusters' partial rows and the ticket (0 between launches). A
    matvec's is built once per LM step; prepare builds one per call, with
    its residuals in and its Vinv and g_pt out."""

    def __init__(self, kind, buckets, J_l, Vinv_l, I, C, res_l=None,
                 gpt_l=None):
        dev = J_l[0].device
        bf16 = kind == "matvec16"
        NP = (J_l[0].shape[0] if bf16 else J_l[0].shape[1]) - 9
        ops = [t for b, J, V in zip(buckets, J_l, Vinv_l)
               for t in (b.img_idx, b.cam_idx, J, V)]
        ops += list(res_l or ()) + list(gpt_l or ())
        if any(t.data_ptr() % 16 for t in ops):
            raise ValueError(f"{kind} operands must be 16-byte aligned")
        self.kind = kind
        self.operands = list(J_l)
        self._alive = (Vinv_l, buckets, res_l, gpt_l)
        self.rows, self.n_tiles = tile_table(
            [tuple(b.img_idx.shape) for b in buckets])
        self.table = _cuda.tile_table(
            self.rows, self.n_tiles, buckets, J_l,
            torch.bfloat16 if bf16 else torch.float32, Vinv_l, res_l, gpt_l)
        self.sums = _cuda.tile_config(TILE_KINDS.index(kind), NP, I,
                                      C)["sums"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        # at most 8 blocks per SM (csrc kTileMaxPerSm), 8 per cluster
        self.max_clusters = -(-8 * sms // TILE_CLUSTER)
        n_acc = (I * 33 + C * 2 * NP if kind == "prepare"
                 else I * 6 + C * NP)
        if kind == "prepare":  # then its rhs rows in double (2 floats each)
            n_acc += 2 * (I * 6 + C * NP)
        fixed = self.sums == SUMS_FIXED
        self.partials = torch.empty(
            self.max_clusters * n_acc + 1 if fixed else 1, device=dev)
        self.ticket = torch.zeros(1, dtype=torch.int32, device=dev)


def matvec_launch(kind, buckets, J_l, Vinv_l, I, C):
    """The :class:`TileLaunch` of one LM step's operands for schur_matvec
    (kind "matvec", f32 J) or schur_matvec16 ("matvec16", bf16 J); None off
    the card, where the plain version needs none."""
    if not _is_cuda(J_l[0]):
        return None
    return TileLaunch(kind, buckets, J_l, Vinv_l, I, C)


# ---------------------------------------------------------------------------
# cost and finish's bucket table: one launch over every bucket
# ---------------------------------------------------------------------------

COST_MAX_BUCKETS = 16  # kCostMaxBuckets in csrc/cost.cu
_TICKETS = {}  # device -> cost and finish's ticket (csrc/cost.cu)


def cost_table(shapes):
    """Cost and finish's bucket table from the buckets' [T, P]: per bucket
    (T, P, tile_p, first_tile) in launch order, and the tile count. The
    tiles are the Schur kernels' (tile_p), but any width P >= 0 is taken,
    and up to 16 buckets."""
    if not 1 <= len(shapes) <= COST_MAX_BUCKETS:
        raise ValueError(f"cost and finish take 1..{COST_MAX_BUCKETS} "
                         f"buckets, got {len(shapes)}")
    rows, first = [], 0
    for T, P in shapes:
        if P < 0:
            raise ValueError(f"bucket width P = {P}")
        tp = tile_p(T)
        rows.append((T, P, tp, first))
        first += -(-P // tp)
    return tuple(rows), first


def _ticket(dev):
    """The ticket of cost and finish's fixed-order sum on `dev`: 0 between
    launches (each launch's last block resets it), so the launches of one
    stream share it and a call needs no fill."""
    t = _TICKETS.get(dev)
    if t is None:
        t = _TICKETS[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    return t


def _finish_operands(pts_l, J_l, Vinv_l, g_pt_l):
    return [*pts_l, *J_l, *Vinv_l, *g_pt_l]


class CostLaunch:
    """What the cost (`kind` "cost") or finish ("finish") kernel on the
    card needs beside its per-call inputs, for one set of bucket operands:
    the bucket table (a ctypes struct holding the operands' pointers), one
    partial sum per tile, the ticket and, for finish, the new points [3, P]
    per bucket, which every launch writes. Finish's is built once per LM
    step (J, Vinv and g_pt come from that step's prepare), the cost's per
    call."""

    def __init__(self, kind, buckets, pts_l, J_l=None, Vinv_l=None,
                 g_pt_l=None):
        fin = kind == "finish"
        dev = pts_l[0].device
        self.kind = kind
        self.rows, self.n_tiles = cost_table(
            [tuple(b.mask.shape) for b in buckets])
        self.operands = (_finish_operands(pts_l, J_l, Vinv_l, g_pt_l)
                         if fin else list(pts_l))
        pts_l = [p.contiguous() for p in pts_l]
        for i, (b, pts) in enumerate(zip(buckets, pts_l)):
            T, P = b.mask.shape
            want = [(pts, (3, P)), (b.img_idx, (T, P)), (b.cam_idx, (T, P)),
                    (b.xy, (2, T, P))]
            if fin:
                want += [(J_l[i], (2, J_l[0].shape[1], T, P)),
                         (Vinv_l[i], (6, P)), (g_pt_l[i], (3, P)),
                         (b.point_free, (P,))]
            for t, shape in want:
                if tuple(t.shape) != shape:
                    raise ValueError(f"{kind}: bucket {i} operand of shape "
                                     f"{tuple(t.shape)}, expected {shape}")
        self.new_pts = ([torch.empty((3, b.mask.shape[1]), device=dev)
                         for b in buckets] if fin else None)
        self._alive = (buckets, pts_l, J_l, Vinv_l, g_pt_l)
        self.table = _cuda.cost_table(self.rows, self.n_tiles, buckets,
                                      pts_l, J_l, Vinv_l, g_pt_l,
                                      self.new_pts)
        self.partials = torch.empty(max(self.n_tiles, 1), device=dev)
        self.ticket = _ticket(dev)


def finish_launch(buckets, pts_l, J_l, Vinv_l, g_pt_l):
    """The :class:`CostLaunch` of one LM step's operands for
    backsub_and_cost; None off the card, where the plain version needs
    none."""
    if not _is_cuda(pts_l[0]):
        return None
    return CostLaunch("finish", buckets, pts_l, J_l, Vinv_l, g_pt_l)


# ---------------------------------------------------------------------------
# per-observation parameter gather
# ---------------------------------------------------------------------------


def _take(tab, idx):
    """tab [R, N] at idx [T, P] -> [R, T, P]; 0 at an index outside
    [0, N), as the reference's chunked lane gather gives there."""
    idx = idx.long()
    inside = (idx >= 0) & (idx < tab.shape[1])
    out = tab[:, idx.clamp(0, tab.shape[1] - 1)]
    return torch.where(inside[None], out, out.new_zeros(()))


def gather_params_plain(img_tab_t, cam_tab_t, img_idx, cam_idx):
    """The plain version of :func:`gather_params_bucket`."""
    _plain_call("gather", img_idx)
    return _take(img_tab_t, img_idx), _take(cam_tab_t, cam_idx)


def gather_params_bucket(img_tab_t, cam_tab_t, img_idx, cam_idx):
    """Per-observation parameter gather of one bucket, both index spaces.

    img_tab_t [Ri, I] and cam_tab_t [Rc, C] f32 (one table row per
    parameter, no padding needed), img_idx / cam_idx [T, P] int32. Returns
    (out_i [Ri, T, P], out_c [Rc, T, P]) with out_i[r] = img_tab_t[r,
    img_idx], 0 at an index outside the table."""
    if not _is_cuda(img_idx):
        return gather_params_plain(img_tab_t, cam_tab_t, img_idx, cam_idx)
    T, P = img_idx.shape
    img_tab_t = img_tab_t.contiguous()
    cam_tab_t = cam_tab_t.contiguous()
    out_i = torch.empty((img_tab_t.shape[0], T, P), device=img_idx.device)
    out_c = torch.empty((cam_tab_t.shape[0], T, P), device=img_idx.device)
    LAUNCHES["gather"] += 1
    _cuda.gather(img_tab_t, cam_tab_t, img_idx, cam_idx, out_i, out_c)
    return out_i, out_c


def gather_obs_params(bucket, quat, trans, intr):
    """quat [I, 4], trans [I, 3], intr [C, NP] per observation: (q_obs
    4-tuple, t_obs 3-tuple, k_obs NP-tuple) of [T, P] tensors."""
    oi, oc = gather_params_bucket(_itab(quat, trans).T, intr.T,
                                  bucket.img_idx, bucket.cam_idx)
    return tuple(oi[:4]), tuple(oi[4:7]), tuple(oc)


def gather_x(bucket, x_pose, x_intr):
    """CG solution vectors per observation: x_pose [I, 6], x_intr [C, NP]
    -> (xp [6, T, P], xi [NP, T, P])."""
    return gather_params_bucket(x_pose.T, x_intr.T, bucket.img_idx,
                                bucket.cam_idx)
