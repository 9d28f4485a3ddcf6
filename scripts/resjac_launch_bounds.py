#!/usr/bin/env python3
"""resjac.cu under two launch bounds, side by side on one card.

Builds ``pycolmap_torch/sfm/csrc/resjac.cu`` twice with nvcc, as committed
(``__launch_bounds__(256)``) and with ``__launch_bounds__(256, 1)``, into
``build/resjac_launch_bounds/``; prints every instance's ptxas registers and
spill bytes under each; then, at chip_smoke.py's bench bundle (128 images,
100k points), times the SIMPLE_RADIAL (``Single<2>``) and RADIAL
(``Single<3>``) instances of both libraries in turns (A, B, B, A; median of
25 CUDA events each) over one table, and checks that both write the same
bits. The last line is one JSON object. Run from the repository root on a
host with the card and the CUDA toolkit:

    python3 scripts/resjac_launch_bounds.py
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from pycolmap_torch import _cuda_build  # noqa: E402
from pycolmap_torch._timing import time_gpu  # noqa: E402
from pycolmap_torch.sfm import _cuda as sfm_cuda  # noqa: E402
from pycolmap_torch.sfm import cg_kernel as ck  # noqa: E402

CSRC = ROOT / "pycolmap_torch" / "sfm" / "csrc"
OUT = ROOT / "build" / "resjac_launch_bounds"
BOUNDS = {"(256)": "__launch_bounds__(kResJacCols)",
          "(256, 1)": "__launch_bounds__(kResJacCols, 1)"}


def build(tag: str, bound: str) -> tuple[Path, dict]:
    """One library of resjac.cu with `bound`; (its path, per instance its
    registers and spill bytes)."""
    src = (CSRC / "resjac.cu").read_text()
    if BOUNDS["(256)"] not in src:
        raise RuntimeError("resjac.cu no longer declares "
                           f"{BOUNDS['(256)']}")
    stem = "rj_" + re.sub(r"\W", "", tag)
    cu = OUT / f"{stem}.cu"
    cu.write_text(src.replace(BOUNDS["(256)"], bound))
    lib = OUT / f"{stem}.so"
    log = subprocess.run(
        [_cuda_build._nvcc(), *_cuda_build._FLAGS, f"-I{CSRC}", str(cu), "-o",
         str(lib)], capture_output=True, text=True, check=True)
    regs, name = {}, None
    for ln in (log.stdout + log.stderr).splitlines():
        m = re.search(r"Compiling entry function '_Z\d+resjac_kernelI\d+"
                      r"(Single|Mixed)ILi(\d+)E", ln)
        if m:
            name = f"{m[1]}<{m[2]}>"
            regs[name] = {}
        elif "Compiling entry function" in ln:
            name = None
        elif name and "spill stores" in ln:
            regs[name]["spill_bytes"] = int(re.search(
                r"(\d+) bytes spill stores", ln)[1])
        elif name and "Used" in ln and "registers" in ln:
            regs[name]["registers"] = int(ln.split("Used ")[1].split()[0])
    return lib, regs


def main() -> int:
    if not torch.cuda.is_available():
        print("resjac_launch_bounds: no CUDA device available",
              file=sys.stderr)
        return 1
    OUT.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(BOUNDS)) as pool:
        built = dict(zip(BOUNDS, pool.map(lambda kv: build(*kv),
                                          BOUNDS.items())))
    fns = {}
    for tag, (lib, regs) in built.items():
        print(f"__launch_bounds__{tag}: {json.dumps(regs)}", flush=True)
        f = ctypes.CDLL(str(lib)).ba_resjac
        f.argtypes = sfm_cuda._SIGNATURES["resjac.cu"]["ba_resjac"]
        f.restype = ctypes.c_int
        fns[tag] = f
    _cuda_build.libs()  # the tables' pointers come from the package
    dev = torch.device("cuda")
    case, _ = cs.bench_case(dev)
    out = {"card": cs.nvidia_smi_line(),
           "registers": {t: r for t, (_, r) in built.items()}}
    for model, NP in ((2, 4), (3, 5)):
        launch = ck.ResJacLaunch(case.buckets, NP)
        sfm_cuda.set_points(launch.table, case.pts)
        intr = case.intr[:, :NP].contiguous()
        free = case.intr_free[:, :NP].contiguous()
        buf = torch.empty(launch.n_floats, device=dev)
        args = (ctypes.addressof(launch.table), case.quat.data_ptr(),
                case.trans.data_ptr(), intr.data_ptr(), free.data_ptr(),
                case.loss_type, case.loss_scale, buf.data_ptr())

        def call(tag):
            code = fns[tag](model, *args,
                            torch.cuda.current_stream().cuda_stream)
            if code:
                raise RuntimeError(f"ba_resjac {tag}: CUDA error {code}")

        got = {}
        for tag in BOUNDS:
            call(tag)
            got[tag] = buf.clone()
        ms = {tag: [] for tag in BOUNDS}
        a, b = BOUNDS
        for tag in (a, b, b, a):
            ms[tag].append(time_gpu(lambda: call(tag)))
        out[f"Single<{model}> bench"] = dict(
            ms=ms, bit_equal=torch.equal(got[a], got[b]))
        print(f"Single<{model}> at the bench shape: "
              f"{json.dumps(out[f'Single<{model}> bench'])}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
