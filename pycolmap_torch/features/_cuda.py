"""Bind the feature-stage CUDA kernels (``features/csrc``).

The sources are built with the port's other kernels by
``pycolmap_torch/_cuda_build.py`` (nvcc into ctypes libraries, at first use).
This module holds their C signatures and one launcher per kernel; the
callers (``window_sampler.py``, ``match_kernels.py``) check shapes and
allocate every output.
"""

from __future__ import annotations

import ctypes

from pycolmap_torch._cuda_build import i32, launch, ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_SAMPLE_WINDOWS = [_P, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P, _P]
_TOP2 = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P]


def sample_windows(vol, ch0, ys, xs, win_y, win_x, out):
    LHp, Wp, NC = vol.shape
    # the kernel reads taps, coordinates and writes samples as float2
    if any(t.data_ptr() % 8 for t in (vol, ys, xs, out)):
        raise ValueError("window sampler operands must be 8-byte aligned")
    launch("features/csrc/window_sampler.cu", "sift_sample_windows",
           _SAMPLE_WINDOWS, ptr(vol), NC, LHp, Wp, i32(ch0), ptr(ys), ptr(xs),
           ch0.shape[0], int(win_y), int(win_x), ptr(out))


def top2(d1, d2, n2, split, best, second, idx, part, tickets):
    B, N1, D = d1.shape
    launch("features/csrc/top2.cu", "match_top2", _TOP2,
           ptr(d1), ptr(d2), i32(n2), B, N1, d2.shape[1], D, int(split),
           ptr(best), ptr(second), i32(idx), ptr(part), i32(tickets))


def top2_resources(D: int) -> dict:
    """Registers, shared memory at D and resident blocks per SM of the
    top-2 kernel."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    launch("features/csrc/top2.cu", "match_top2_resources", [_I] + [_P] * 4,
           int(D), *(ctypes.byref(v) for v in vals))
    return dict(zip(("registers", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def sample_windows_occupancy() -> int:
    """Resident blocks per SM of the window sampler kernel."""
    blocks = ctypes.c_int(0)
    launch("features/csrc/window_sampler.cu", "sift_sample_windows_occupancy",
           [_P, _P], ctypes.byref(blocks))
    return blocks.value
