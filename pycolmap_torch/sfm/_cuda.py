"""Bind the bundle-adjustment CUDA kernels (``sfm/csrc``).

The sources are built with the port's other kernels by
``pycolmap_torch/_cuda_build.py`` (nvcc into ctypes libraries, at first use).
This module holds their C signatures and one launcher per kernel.
"""

from __future__ import annotations

import ctypes

import torch

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
        "ba_prepare": [_I] + [_P] * 5 + [_I] * 4 + [_P] * 5,
        "ba_matvec": [_I] + [_P] * 6 + [_I] * 4 + [_P] * 3,
        "ba_matvec16": [_I] + [_P] * 3 + [_I] * 3 + [_P, _I] + [_P] * 4,
        "ba_matvec16_config": [_I] * 3 + [_P] * 4,
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


def prepare(NP, J, res, img_idx, cam_idx, lam, I, C, vinv, gpt, acc_img,
            acc_cam):
    T, P = img_idx.shape
    _call("schur.cu", "ba_prepare", NP, _ptr(J), _ptr(res), _i32(img_idx),
          _i32(cam_idx), _ptr(lam), T, P, I, C, _ptr(vinv), _ptr(gpt),
          _ptr(acc_img), _ptr(acc_cam))


def matvec(NP, J, img_idx, cam_idx, vinv, xpose, xintr, I, C, out_pose,
           out_intr):
    T, P = img_idx.shape
    _call("schur.cu", "ba_matvec", NP, _ptr(J), _i32(img_idx), _i32(cam_idx),
          _ptr(vinv), _ptr(xpose), _ptr(xintr), T, P, I, C, _ptr(out_pose),
          _ptr(out_intr))


class _Mv16Bucket(ctypes.Structure):
    """Mv16Bucket in csrc/schur.cu: one row of the bucket table."""
    _fields_ = [("J16", _P), ("img", _P), ("cam", _P), ("vinv", _P),
                ("T", _I), ("P", _I), ("tile_p", _I), ("first_tile", _I)]


class _Mv16Table(ctypes.Structure):
    """Mv16Table in csrc/schur.cu (kMv16MaxBuckets rows)."""
    _fields_ = [("b", _Mv16Bucket * 8), ("nb", _I), ("n_tiles", _I)]


def matvec16_table(rows, n_tiles, buckets, J16_l, Vinv_l):
    """The kernel's bucket table: the operands' pointers beside each row
    (T, P, tile_p, first_tile) of cg_kernel.matvec16_table."""
    tab = _Mv16Table(nb=len(rows), n_tiles=n_tiles)
    for i, ((T, P, tp, first), b, J16, V) in enumerate(
            zip(rows, buckets, J16_l, Vinv_l)):
        tab.b[i] = _Mv16Bucket(_ptr(J16, torch.bfloat16), _i32(b.img_idx),
                               _i32(b.cam_idx), _ptr(V), T, P, tp, first)
    return tab


def matvec16(NP, launch, xpose, xintr, I, C, out_pose, out_intr):
    """One launch over `launch`'s table (cg_kernel.Matvec16Launch)."""
    _call("schur.cu", "ba_matvec16", NP, ctypes.addressof(launch.table),
          _ptr(xpose), _ptr(xintr), I, C, launch.sums, _ptr(launch.partials),
          launch.max_clusters, _i32(launch.ticket), _ptr(out_pose),
          _ptr(out_intr))


def matvec16_config(NP, I, C):
    """Where a matvec16 launch at width NP with I images and C cameras
    keeps x and its sums (``sums``: 2 per warp, 1 per block, 0 global
    atomics), its dynamic shared memory (bytes) and resident blocks per
    SM."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    _call("schur.cu", "ba_matvec16_config", NP, I, C,
          *(ctypes.byref(v) for v in vals))
    return dict(sums=vals[0].value, smem_bytes=vals[1].value,
                blocks_per_sm=vals[2].value)


def gather(img_tab, cam_tab, img_idx, cam_idx, out_i, out_c):
    T, P = img_idx.shape
    _call("gather.cu", "ba_gather", _ptr(img_tab), _ptr(cam_tab),
          _i32(img_idx), _i32(cam_idx), img_tab.shape[0], img_tab.shape[1],
          cam_tab.shape[0], cam_tab.shape[1], T * P, _ptr(out_i),
          _ptr(out_c))
