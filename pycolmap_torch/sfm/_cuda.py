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
_RESJAC = [_P] * 9 + [_I, _I, _I, _F, _P, _P, _P]
_COST = [_P] * 7 + [_I, _I, _I, _F, _P, _P]
_FINISH = [_P] * 13 + [_I, _I, _I, _F, _P, _P, _P]
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


def _resjac(fn, head, itab, intr, ifree, img_idx, cam_idx, xy, mask, pts,
            pfree, loss, scale, res, J):
    T, P = img_idx.shape
    _call("resjac.cu", fn, *head, _ptr(itab), _ptr(intr), _ptr(ifree),
          _i32(img_idx), _i32(cam_idx), _ptr(xy), _ptr(mask), _ptr(pts),
          _ptr(pfree), T, P, loss, scale, _ptr(res), _ptr(J))


def _cost(fn, head, itab, intr, img_idx, cam_idx, xy, mask, pts, loss, scale,
          partials):
    T, P = img_idx.shape
    _call("cost.cu", fn, *head, _ptr(itab), _ptr(intr), _i32(img_idx),
          _i32(cam_idx), _ptr(xy), _ptr(mask), _ptr(pts), T, P, loss, scale,
          _ptr(partials))


def _finish(fn, head, J, vinv, gpt, img_idx, cam_idx, xy, mask, pts, pfree,
            xpose, xintr, nitab, nintr, loss, scale, new_pts, partials):
    T, P = img_idx.shape
    _call("cost.cu", fn, *head, _ptr(J), _ptr(vinv), _ptr(gpt),
          _i32(img_idx), _i32(cam_idx), _ptr(xy), _ptr(mask), _ptr(pts),
          _ptr(pfree), _ptr(xpose), _ptr(xintr), _ptr(nitab), _ptr(nintr),
          T, P, loss, scale, _ptr(new_pts), _ptr(partials))


def resjac(model, *args):
    _resjac("ba_resjac", (model,), *args)


def cost(model, *args):
    _cost("ba_cost", (model,), *args)


def finish(model, *args):
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
