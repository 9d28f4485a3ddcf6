"""Bind the bundle-adjustment CUDA kernels (``sfm/csrc``).

The sources are built with the port's other kernels by
``pycolmap_torch/_cuda_build.py`` (nvcc into ctypes libraries, at first use).
This module holds their C signatures and one launcher per kernel.
"""

from __future__ import annotations

import ctypes

from pycolmap_torch._cuda_build import i32 as _i32
from pycolmap_torch._cuda_build import launch
from pycolmap_torch._cuda_build import ptr as _ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# the mixed-model launchers take (width, model bit mask) where the
# single-model ones take the model id; resjac also takes the first model
_MIXED = [_I, _I]
# table, quat, trans, intr, ifree, loss, scale, out, stream
_RESJAC = [_P] * 5 + [_I, _F, _P, _P]
# table, quat, trans, intr (finish: xpose, xintr), loss, scale, partials,
# ticket, out, stream
_COST = [_P] * 4 + [_I, _F] + [_P] * 4
_FINISH = [_P] * 6 + [_I, _F] + [_P] * 4
_TILE_MATVEC = [_I] + [_P] * 3 + [_I] * 3 + [_P, _I] + [_P] * 4
# C signatures of the launchers (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    "resjac.cu": {
        "ba_resjac": [_I] + _RESJAC,
        "ba_resjac_mixed": _MIXED + [_I] + _RESJAC,
    },
    "cost.cu": {
        "ba_cost": [_I] + _COST,
        "ba_finish": [_I] + _FINISH,
        "ba_cost_mixed": _MIXED + _COST,
        "ba_finish_mixed": _MIXED + _FINISH,
        "ba_cost_config": [_I] * 3 + [_P] * 3,
    },
    "schur.cu": {
        "ba_prepare": [_I] + [_P] * 2 + [_I] * 3 + [_P, _I] + [_P] * 4,
        "ba_matvec": _TILE_MATVEC,
        "ba_matvec16": _TILE_MATVEC,
        "ba_tile_config": [_I] * 4 + [_P] * 5,
    },
    "gather.cu": {
        "ba_gather": [_P] * 4 + [_I] * 5 + [_P] * 3,
    },
}


def _call(source: str, fn: str, *args) -> None:
    launch(f"sfm/csrc/{source}", fn, _SIGNATURES[source][fn], *args)


# ---------------------------------------------------------------------------
# launchers: argument order as the C functions; shapes are checked by the
# callers in sfm/cg_kernel.py, which also allocate every output
# ---------------------------------------------------------------------------


def _resjac(fn, head, launch, quat, trans, intr, ifree, loss, scale, out):
    _call("resjac.cu", fn, *head, ctypes.addressof(launch.table), _ptr(quat),
          _ptr(trans), _ptr(intr), _ptr(ifree), loss, scale, _ptr(out))


def _cost(fn, head, launch, quat, trans, intr, loss, scale, out):
    _call("cost.cu", fn, *head, ctypes.addressof(launch.table), _ptr(quat),
          _ptr(trans), _ptr(intr), loss, scale, _ptr(launch.partials),
          _i32(launch.ticket), _ptr(out))


def _finish(fn, head, launch, quat, trans, intr, xpose, xintr, loss, scale,
            out):
    _call("cost.cu", fn, *head, ctypes.addressof(launch.table), _ptr(quat),
          _ptr(trans), _ptr(intr), _ptr(xpose), _ptr(xintr), loss, scale,
          _ptr(launch.partials), _i32(launch.ticket), _ptr(out))


def resjac(model, *args):
    """One launch of resjac over a table (cg_kernel.ResJacLaunch)."""
    _resjac("ba_resjac", (model,), *args)


def cost(model, *args):
    """One launch of the cost over a table (cg_kernel.CostLaunch)."""
    _cost("ba_cost", (model,), *args)


def finish(model, *args):
    """One launch of finish over a table (cg_kernel.CostLaunch)."""
    _finish("ba_finish", (model,), *args)


# mixed-model variants: NP the solver width (selector column last), models
# the listed ids as a bit mask; resjac's first is the id an observation
# naming no listed model takes (the cost projects it to pixel 0)


def resjac_mixed(NP, models, first, *args):
    _resjac("ba_resjac_mixed", (NP, models, first), *args)


def cost_mixed(NP, models, *args):
    _cost("ba_cost_mixed", (NP, models), *args)


def finish_mixed(NP, models, *args):
    _finish("ba_finish_mixed", (NP, models), *args)


class _ResJacBucket(ctypes.Structure):
    """ResJacBucket in csrc/resjac.cu: one row of resjac's table."""
    _fields_ = [("img", _P), ("cam", _P), ("xy", _P), ("mask", _P),
                ("pts", _P), ("pfree", _P), ("res_off", ctypes.c_longlong),
                ("J_off", ctypes.c_longlong), ("T", _I), ("P", _I),
                ("runs", _I), ("first_block", _I)]


class _ResJacTable(ctypes.Structure):
    """ResJacTable in csrc/resjac.cu (kResJacMaxBuckets rows)."""
    _fields_ = [("b", _ResJacBucket * 16), ("nb", _I), ("n_blocks", _I)]


def resjac_table(rows, n_blocks, buckets):
    """resjac's bucket table: each bucket's index, xy, mask and free-flag
    pointers beside its row (T, P, runs, first_block, res_off, J_off) of
    cg_kernel.resjac_table; the points' pointers are written per call
    (set_points)."""
    tab = _ResJacTable(nb=len(rows), n_blocks=n_blocks)
    for i, ((T, P, runs, first, r_off, j_off), b) in enumerate(
            zip(rows, buckets)):
        tab.b[i] = _ResJacBucket(
            _i32(b.img_idx), _i32(b.cam_idx), _ptr(b.xy), _ptr(b.mask),
            None, _ptr(b.point_free), r_off, j_off, T, P, runs, first)
    return tab


def set_points(tab, pts_l):
    """Write each bucket's points [3, P] into resjac's table."""
    for i, (row, pts) in enumerate(zip(tab.b, pts_l)):
        if pts.shape != (3, row.P):
            raise ValueError(f"resjac: bucket {i} points of shape "
                             f"{tuple(pts.shape)}, expected (3, {row.P})")
        row.pts = _ptr(pts.contiguous())


class _CostBucket(ctypes.Structure):
    """CostBucket in csrc/cost.cu: one row of cost and finish's table."""
    _fields_ = [("J", _P), ("vinv", _P), ("gpt", _P), ("img", _P),
                ("cam", _P), ("xy", _P), ("mask", _P), ("pts", _P),
                ("pfree", _P), ("new_pts", _P), ("T", _I), ("P", _I),
                ("tile_p", _I), ("first_tile", _I)]


class _CostTable(ctypes.Structure):
    """CostTable in csrc/cost.cu (kCostMaxBuckets rows)."""
    _fields_ = [("b", _CostBucket * 16), ("nb", _I), ("n_tiles", _I)]


def cost_table(rows, n_tiles, buckets, pts_l, J_l=None, vinv_l=None,
               gpt_l=None, new_pts_l=None):
    """Cost and finish's bucket table: the operands' pointers beside each
    row (T, P, tile_p, first_tile) of cg_kernel.cost_table; J, Vinv, g_pt,
    the free flags and the new points only for finish."""
    fin = J_l is not None
    tab = _CostTable(nb=len(rows), n_tiles=n_tiles)
    for i, ((T, P, tp, first), b, pts) in enumerate(zip(rows, buckets,
                                                        pts_l)):
        tab.b[i] = _CostBucket(
            _ptr(J_l[i]) if fin else None, _ptr(vinv_l[i]) if fin else None,
            _ptr(gpt_l[i]) if fin else None, _i32(b.img_idx),
            _i32(b.cam_idx), _ptr(b.xy), _ptr(b.mask), _ptr(pts),
            _ptr(b.point_free) if fin else None,
            _ptr(new_pts_l[i]) if fin else None, T, P, tp, first)
    return tab


def cost_config(finish, mixed, ident):
    """Resident blocks per SM and dynamic shared memory (bytes) of the cost
    (finish False) or finish kernel for model id `ident`, or (mixed) at
    mixed width `ident`."""
    vals = [ctypes.c_int(0) for _ in range(2)]
    _call("cost.cu", "ba_cost_config", int(finish), int(mixed), ident,
          *(ctypes.byref(v) for v in vals))
    return dict(blocks_per_sm=vals[0].value, smem_bytes=vals[1].value)


class _TileBucket(ctypes.Structure):
    """TileBucket in csrc/schur.cu: one row of the bucket table."""
    _fields_ = [("J", _P), ("res", _P), ("img", _P), ("cam", _P),
                ("vinv", _P), ("gpt", _P), ("T", _I), ("P", _I),
                ("tile_p", _I), ("first_tile", _I)]


class _TileTable(ctypes.Structure):
    """TileTable in csrc/schur.cu (kTileMaxBuckets rows)."""
    _fields_ = [("b", _TileBucket * 8), ("nb", _I), ("n_tiles", _I)]


def tile_table(rows, n_tiles, buckets, J_l, j_dtype, vinv_l, res_l=None,
               gpt_l=None):
    """The kernels' bucket table: the operands' pointers beside each row
    (T, P, tile_p, first_tile) of cg_kernel.tile_table. J of j_dtype (bf16
    for matvec16, else f32); res and gpt only for prepare."""
    tab = _TileTable(nb=len(rows), n_tiles=n_tiles)
    for i, ((T, P, tp, first), b, J, V) in enumerate(
            zip(rows, buckets, J_l, vinv_l)):
        tab.b[i] = _TileBucket(
            _ptr(J, j_dtype), _ptr(res_l[i]) if res_l else None,
            _i32(b.img_idx), _i32(b.cam_idx), _ptr(V),
            _ptr(gpt_l[i]) if gpt_l else None, T, P, tp, first)
    return tab


def _matvec(fn, NP, launch, xpose, xintr, I, C, out_pose, out_intr):
    _call("schur.cu", fn, NP, ctypes.addressof(launch.table), _ptr(xpose),
          _ptr(xintr), I, C, launch.sums, _ptr(launch.partials),
          launch.max_clusters, _i32(launch.ticket), _ptr(out_pose),
          _ptr(out_intr))


def matvec16(*args):
    """One launch of the bf16 matvec over a table (cg_kernel.TileLaunch)."""
    _matvec("ba_matvec16", *args)


def matvec(*args):
    """One launch of the f32 matvec over a table (cg_kernel.TileLaunch)."""
    _matvec("ba_matvec", *args)


def prepare(NP, launch, lam, I, C, acc_img, acc_cam):
    """One launch of the LM preparation over a table (cg_kernel.TileLaunch);
    lam a 0-d f32 tensor on the card."""
    _call("schur.cu", "ba_prepare", NP, ctypes.addressof(launch.table),
          _ptr(lam), I, C, launch.sums, _ptr(launch.partials),
          launch.max_clusters, _i32(launch.ticket), _ptr(acc_img),
          _ptr(acc_cam))


def tile_config(kind, NP, I, C):
    """Where a launch of kernel `kind` (0 matvec16, 1 matvec, 2 prepare)
    at width NP with I images and C cameras keeps its sums (``sums``: 2
    fixed order, 1 per block, 0 global atomics), its dynamic shared memory
    (bytes), resident blocks per SM and, in the fixed order, resident
    clusters."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    _call("schur.cu", "ba_tile_config", kind, NP, I, C,
          *(ctypes.byref(v) for v in vals))
    return dict(sums=vals[0].value, smem_bytes=vals[1].value,
                blocks_per_sm=vals[2].value, clusters=vals[3].value)


def gather(img_tab, cam_tab, img_idx, cam_idx, out_i, out_c):
    T, P = img_idx.shape
    _call("gather.cu", "ba_gather", _ptr(img_tab), _ptr(cam_tab),
          _i32(img_idx), _i32(cam_idx), img_tab.shape[0], img_tab.shape[1],
          cam_tab.shape[0], cam_tab.shape[1], T * P, _ptr(out_i),
          _ptr(out_c))
