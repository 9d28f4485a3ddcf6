"""Bind the PatchMatch cost kernel (``mvs/csrc/pm_cost.cu``).

The source is built with the port's other kernels by
``pycolmap_torch/_cuda_build.py`` (nvcc into ctypes libraries, at first use).
This module holds its C signatures and launchers; the caller
(``pm_kernels.pm_view_costs``) checks shapes and allocates the output.
"""

from __future__ import annotations

import ctypes

from pycolmap_torch._cuda_build import launch, ptr

_SRC = "mvs/csrc/pm_cost.cu"
_P = ctypes.c_void_p
_I = ctypes.c_int
_PM_VIEW_COSTS = [_P] * 9 + [_I] * 6 + [_P, _P]


def pm_view_costs(srcs, src_depths, w_off, wr_off, depth, normal, stats,
                  params, offs, geom, parity, out):
    K, H, W = srcs.shape
    launch(_SRC, "pm_view_costs", _PM_VIEW_COSTS,
           ptr(srcs), ptr(src_depths) if geom else None, ptr(w_off),
           ptr(wr_off), ptr(depth), ptr(normal), ptr(stats), ptr(params),
           ptr(offs), K, H, W, w_off.shape[0], int(geom),
           -1 if parity is None else int(parity), ptr(out))


def occupancy(parity: bool, nw: int) -> int:
    """Resident blocks per SM of the full-field or the parity kernel."""
    blocks = ctypes.c_int(0)
    launch(_SRC, "pm_cost_occupancy", [_I, _I, _P, _P], int(parity), nw,
           ctypes.byref(blocks))
    return blocks.value
