"""Build and load every CUDA kernel of the port.

Each ``.cu`` source under a ``csrc/`` directory of the package (``SOURCES``)
compiles with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface, loaded with ``ctypes``. At first use every library that is not
built yet builds, all in parallel, one ``nvcc`` each, into
``build/pycolmap_torch/<stem>-<hash>/`` beside the package. Each library's
hash covers its own source, the shared headers and its flags, so an edit to
one source rebuilds only its library. ``nvcc``'s output (ptxas register
counts) is kept beside each library. Nothing is built or imported when this
module is imported: the CPU tests import every module and such a host has
no ``nvcc``.

The launcher modules (``sfm/_cuda.py``, ``features/_cuda.py``,
``mvs/_cuda.py``, ``scripts/_cuda.py``) hold the C signatures and call
:func:`launch`. Every C launcher takes PyTorch's current stream as its
last argument, allocates nothing, and returns ``cudaGetLastError()``
after the launch; a nonzero code raises here.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

PACKAGE = Path(__file__).resolve().parent
# package-relative paths; every source exports kernel_error_string(int)
SOURCES = (
    "sfm/csrc/resjac.cu",
    "sfm/csrc/cost.cu",
    "sfm/csrc/schur.cu",
    "sfm/csrc/gather.cu",
    "features/csrc/window_sampler.cu",
    "features/csrc/top2.cu",
    "mvs/csrc/pm_cost.cu",
    "scripts/csrc/gather_probe.cu",
)
HEADERS = ("sfm/csrc/ba_device.cuh",)
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_FLAGS = (_ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
          "-Xptxas", "-v")
# per-source flags: the PatchMatch cost kernel rounds every product before
# its sum, as PyTorch's separate kernels do, so that it computes its plain
# version's f32 arithmetic operation for operation
SOURCE_FLAGS = {"mvs/csrc/pm_cost.cu": ("-fmad=false",)}
BUILD_ROOT = PACKAGE.parent / "build" / "pycolmap_torch"

_lock = threading.Lock()
_libs: dict | None = None
build_log = ""  # compiler output of every library (ptxas register counts)
build_seconds = None  # wall time of this process's build, None if none ran


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build on a host "
                       "with the CUDA toolkit")


def _lib_path(source: str) -> Path:
    """build/pycolmap_torch/<stem>-<hash>/<stem>.so: the hash of the source,
    the shared headers and the flags it builds with."""
    h = hashlib.blake2b(digest_size=12)
    for name in (source,) + HEADERS:
        h.update(name.encode())
        h.update((PACKAGE / name).read_bytes())
    h.update(" ".join(_FLAGS + SOURCE_FLAGS.get(source, ())).encode())
    stem = Path(source).stem
    return BUILD_ROOT / f"{stem}-{h.hexdigest()}" / f"{stem}.so"


def _build(sources) -> None:
    """Compile `sources` in parallel (one nvcc each) to their library
    paths, each with its compiler output beside it."""
    global build_seconds
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in sources:
        src, lib = PACKAGE / name, _lib_path(name)
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.tmp{os.getpid()}")
        cmd = [nvcc, *_FLAGS, *SOURCE_FLAGS.get(name, ()), "-I",
               str(src.parent), "-o", str(tmp), str(src)]
        procs.append((name, lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed, logs = [], []
    for name, lib, tmp, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
        else:
            lib.with_suffix(".log").write_text(out)
            os.replace(tmp, lib)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))


def libs() -> dict:
    """The loaded kernel libraries by source path, building the missing
    ones first."""
    global _libs, build_log
    with _lock:
        if _libs is None:
            missing = [n for n in SOURCES if not _lib_path(n).exists()]
            if missing:
                _build(missing)
            loaded, logs = {}, []
            for name in SOURCES:
                path = _lib_path(name)
                lib = ctypes.CDLL(str(path))
                lib.kernel_error_string.argtypes = [ctypes.c_int]
                lib.kernel_error_string.restype = ctypes.c_char_p
                loaded[name] = lib
                log = path.with_suffix(".log")
                logs.append(f"== {name}\n"
                            + (log.read_text() if log.exists() else ""))
            build_log = "\n".join(logs)
            _libs = loaded
        return _libs


def source_log(source: str) -> str:
    """The compiler output of one source's library (after :func:`libs`)."""
    part = build_log.split(f"== {source}\n", 1)
    return part[1].split("\n== ", 1)[0] if len(part) == 2 else ""


def launch(source: str, fn: str, argtypes, *args) -> None:
    """Call the C launcher `fn` of `source` on the current stream.
    argtypes: its ctypes signature, the trailing stream pointer included."""
    lib = libs()[source]
    f = getattr(lib, fn)
    if f.argtypes is None:
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    code = f(*args, torch.cuda.current_stream().cuda_stream)
    if code != 0:
        msg = lib.kernel_error_string(code).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {code} ({msg})")


def ptr(t: torch.Tensor, dtype=torch.float32) -> int:
    if not t.is_cuda or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"kernel operand must be a contiguous CUDA {dtype} tensor, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    return t.data_ptr()


def i32(t: torch.Tensor) -> int:
    return ptr(t, torch.int32)
