"""Bind the MVS CUDA kernel (``mvs/csrc/pm_cost.cu``).

The source is built with the port's other kernels by
``pycolmap_torch/_cuda_build.py`` (nvcc into ctypes libraries, at first use).
This module holds its C signature and launcher; the caller
(``pm_kernels.pm_view_costs``) checks shapes and allocates the output.
"""

from __future__ import annotations

import ctypes

from pycolmap_torch._cuda_build import launch, ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_PM_VIEW_COSTS = [_P] * 9 + [_I] * 5 + [_P, _P]


def pm_view_costs(srcs, src_depths, w_off, wr_off, depth, normal, stats,
                  params, offs, geom, out):
    K, H, W = srcs.shape
    launch("mvs/csrc/pm_cost.cu", "pm_view_costs", _PM_VIEW_COSTS,
           ptr(srcs), ptr(src_depths) if geom else None, ptr(w_off),
           ptr(wr_off), ptr(depth), ptr(normal), ptr(stats), ptr(params),
           ptr(offs), K, H, W, w_off.shape[0], int(geom), ptr(out))
