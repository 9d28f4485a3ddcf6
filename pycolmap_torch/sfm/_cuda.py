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
# C signatures of the launchers (see the extern "C" functions in csrc/*.cu)
_SIGNATURES = {
    "resjac.cu": {
        "ba_resjac": [_I] + [_P] * 9 + [_I, _I, _I, _F, _P, _P, _P],
    },
    "cost.cu": {
        "ba_cost": [_I] + [_P] * 7 + [_I, _I, _I, _F, _P, _P],
        "ba_finish": [_I] + [_P] * 13 + [_I, _I, _I, _F, _P, _P, _P],
    },
    "schur.cu": {
        "ba_prepare": [_I] + [_P] * 5 + [_I] * 4 + [_P] * 5,
        "ba_matvec": [_I] + [_P] * 6 + [_I] * 4 + [_P] * 3,
        "ba_matvec16": [_I] + [_P] * 6 + [_I] * 4 + [_P] * 3,
    },
}


def _call(source: str, fn: str, *args) -> None:
    launch(f"sfm/csrc/{source}", fn, _SIGNATURES[source][fn], *args)


# ---------------------------------------------------------------------------
# launchers: argument order as the C functions; shapes are checked by the
# callers in sfm/cg_kernel.py, which also allocate every output
# ---------------------------------------------------------------------------


def resjac(model, itab, intr, ifree, img_idx, cam_idx, xy, mask, pts, pfree,
           loss, scale, res, J):
    T, P = img_idx.shape
    _call("resjac.cu", "ba_resjac", model, _ptr(itab), _ptr(intr), _ptr(ifree),
          _i32(img_idx), _i32(cam_idx), _ptr(xy), _ptr(mask), _ptr(pts),
          _ptr(pfree), T, P, loss, scale, _ptr(res), _ptr(J))


def cost(model, itab, intr, img_idx, cam_idx, xy, mask, pts, loss, scale,
         partials):
    T, P = img_idx.shape
    _call("cost.cu", "ba_cost", model, _ptr(itab), _ptr(intr), _i32(img_idx),
          _i32(cam_idx), _ptr(xy), _ptr(mask), _ptr(pts), T, P, loss, scale,
          _ptr(partials))


def finish(model, J, vinv, gpt, img_idx, cam_idx, xy, mask, pts, pfree,
           xpose, xintr, nitab, nintr, loss, scale, new_pts, partials):
    T, P = img_idx.shape
    _call("cost.cu", "ba_finish", model, _ptr(J), _ptr(vinv), _ptr(gpt),
          _i32(img_idx), _i32(cam_idx), _ptr(xy), _ptr(mask), _ptr(pts),
          _ptr(pfree), _ptr(xpose), _ptr(xintr), _ptr(nitab), _ptr(nintr),
          T, P, loss, scale, _ptr(new_pts), _ptr(partials))


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


def matvec16(NP, J16, img_idx, cam_idx, vinv, xpose, xintr, I, C, out_pose,
             out_intr):
    T, P = img_idx.shape
    _call("schur.cu", "ba_matvec16", NP, _ptr(J16, torch.bfloat16),
          _i32(img_idx), _i32(cam_idx), _ptr(vinv), _ptr(xpose), _ptr(xintr),
          T, P, I, C, _ptr(out_pose), _ptr(out_intr))
