"""Bind the gather-probe CUDA kernel (``scripts/csrc/gather_probe.cu``).

The source is built with the port's other kernels by
``pycolmap_torch/_cuda_build.py`` (nvcc into ctypes libraries, at first use).
This module holds its C signature and launcher; the caller
(``proto_gather``) checks shapes and allocates the output.
"""

from __future__ import annotations

import ctypes

from pycolmap_torch._cuda_build import i32, launch, ptr

_P = ctypes.c_void_p
_I = ctypes.c_int
_GATHER_PROBE = [_I, _P, _P, _P, _I, _I, _I, ctypes.c_longlong, _P, _P]


def gather_probe(form, src, idx, idx2, rows, cols, out_cols, out):
    """Launch index form `form` (the kernel's ``Form``) of out[o] =
    src[offset(o)] over every element of `out`."""
    launch("scripts/csrc/gather_probe.cu", "gather_probe", _GATHER_PROBE,
           form, ptr(src), i32(idx), None if idx2 is None else i32(idx2),
           rows, cols, out_cols, out.numel(), ptr(out))
