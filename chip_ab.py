#!/usr/bin/env python3
"""Time the bundle-adjustment kernels of two checkouts in turns on one card,
and report prepare's and resjac's errors, output by output, at the
incremental mapper's own operands.

Two versions of a kernel are compared only inside one process tree on one
card: each checkout runs in its own process (its own ``chip_smoke.py``,
package and kernel build), in the order A, B, B, A, and each run prints
``chip_smoke.check_case``'s times at phase 2's bench case (resjac, cost,
finish, prepare, the f32 matvec; median of 25 CUDA events each) and the
Schur kernels' times at the width-9 operands phase 16's two-model solve
gives them (``chip_smoke.check_case_schur``). With ``--mapper-errors``
the first B run also maps bench.py run_mapping's 30-image database on the
card, and the same orbit with its images alternating between a
SIMPLE_RADIAL and a PINHOLE camera, records one global and one
local-window BA step of each (``chip_smoke.ResJacRecorder``) and prints,
per output of resjac and prepare, the kernel's and the f32 plain
version's scaled error against the float64 plain version.

With ``--unsharded`` each checkout instead runs, once and in the order A,
B, its unsharded BA paths: phase 4's bf16 bench solve and phase 20's
timed ``incremental_mapping`` of the 30-image orbit, the latter on the
implicit PCG (``dense_schur_max_d=0``, passed where the checkout's
``incremental_mapping`` takes it: a checkout without the dense reduced
system has only that path). Each run prints one line ``UNSHARDED
{json}`` with the launch counts, the LM steps and CG iterations, and
SHA-1 digests of the solved points and quaternions and of the registered
poses, so the two compare launch for launch and bit for bit.

Run from the root of checkout B on a host with the card, checkout A
unpacked anywhere (e.g. ``git archive <commit> | tar -x -C build/parent``):

    python3 chip_ab.py build/parent . [--mapper-errors | --unsharded]

It exits 1 on a host without CUDA.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import tempfile
from pathlib import Path


def _errors(cs, ck, torch, case, tag):
    """Per output of resjac and prepare at `case`: the kernel's and the f32
    plain version's scaled error against the float64 plain version."""
    res_l, J_l = ck.res_and_jac(case.buckets, case.pts, case.quat,
                                case.trans, case.intr, case.intr_free,
                                case.model_id, case.loss_type,
                                case.loss_scale)
    I, C, NP = case.I, case.C, case.NP
    prep = ck.schur_prepare(case.buckets, J_l, res_l, case.lam, I, C)
    kern = dict(res=torch.cat([r.reshape(-1) for r in res_l]),
                J=torch.cat([j.reshape(-1) for j in J_l]),
                Vinv=torch.cat([v.reshape(-1) for v in prep[0]]),
                g=torch.cat([g.reshape(-1) for g in prep[1]]),
                rhs_pose=prep[2], rhs_intr=prep[3], udp=prep[4],
                udi=prep[5], S=prep[6])
    plain = {}
    for dt in (torch.float64, torch.float32):
        itab = torch.cat([case.quat, case.trans], 1).to(dt)
        rj = [ck.resjac_plain(cs._bucket_as(b, dt), b.points.to(dt), itab,
                              case.intr[:, :NP].to(dt),
                              case.intr_free[:, :NP].to(dt), case.model_id,
                              case.loss_type, case.loss_scale)
              for b in case.buckets]
        acc_i = torch.zeros((I, 33), device=itab.device, dtype=dt)
        acc_c = torch.zeros((C, 2 * NP), device=itab.device, dtype=dt)
        vs, gs = [], []
        for b, J, r in zip(case.buckets, J_l, res_l):
            v, g, oi, oc = ck.prepare_plain(cs._bucket_as(b, dt), J.to(dt),
                                            r.to(dt), case.lam.to(dt), I, C)
            vs.append(v.reshape(-1))
            gs.append(g.reshape(-1))
            acc_i, acc_c = acc_i + oi, acc_c + oc
        plain[dt] = dict(res=torch.cat([o[0].reshape(-1) for o in rj]),
                         J=torch.cat([o[1].reshape(-1) for o in rj]),
                         Vinv=torch.cat(vs), g=torch.cat(gs),
                         rhs_pose=acc_i[:, :6], rhs_intr=acc_c[:, :NP],
                         udp=acc_i[:, 6:12], udi=acc_c[:, NP:],
                         S=acc_i[:, 12:33])
    for name, got in kern.items():
        ref = plain[torch.float64][name].reshape(-1)
        k = cs.scaled_err(got.reshape(-1), ref)
        p = cs.scaled_err(plain[torch.float32][name].reshape(-1), ref)
        print(f"ERR {tag} {name}: kernel {k[1]:.3e} (abs {k[0]:.3e}), f32 "
              f"plain {p[1]:.3e} (abs {p[0]:.3e}), max |float64| "
              f"{float(ref.abs().max()):.3e}", flush=True)


def _sha(a) -> str:
    import numpy as np

    return hashlib.sha1(np.ascontiguousarray(a).tobytes()).hexdigest()


def _unsharded(cs, tree: Path):
    """Phase 4's bf16 bench solve and phase 20's timed mapping on the
    implicit PCG: their launches, loop counts and result digests."""
    import inspect

    import numpy as np

    launches, _, solver, rate = cs.bench_solve(cg_bf16=True)
    p = solver.fetch_problem()
    out = {"tree": str(tree), "phase4": dict(
        launches={k: v for k, v in launches.items() if v}, rate=rate,
        points_sha=_sha(p.points.numpy()),
        quat_sha=_sha(p.cam_quat.numpy()))}
    del solver
    with tempfile.TemporaryDirectory(dir=tree / "build") as tmp:
        tmp = Path(tmp)
        gt = cs.write_orbit_database(tmp / "map.db", cs.MAP_IMAGES,
                                     cs.MAP_POINTS, cs.MAP_NOISE)
        implicit = ({"dense_schur_max_d": 0} if "dense_schur_max_d" in
                    inspect.signature(cs.psfm.incremental_mapping).parameters
                    else {})
        cs.zero_counts()
        rec, dt, t = cs.map_and_check(tmp / "map.db", tmp / "m", gt,
                                      cs.mapping_options(), "cuda",
                                      "chip_ab unsharded", cs.MAP_IMAGES,
                                      **implicit)
        counts, _ = cs.read_counts()
        poses = np.stack([rec.images[i].cam_from_world.rotation.quat
                          for i in sorted(rec.reg_image_ids)])
    out["phase20"] = dict(launches={k: v for k, v in counts.items() if v},
                          seconds=dt, steps=t["ba_lm_steps"],
                          cg=t["ba_cg_iterations"], solves=t["ba_solves"],
                          err=t["err"], rot=t["rot"], poses_sha=_sha(poses))
    print("UNSHARDED " + json.dumps(out), flush=True)


def one(tree: Path, mapper_errors: bool, unsharded: bool) -> int:
    """The run of one checkout, in this process."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from pycolmap_torch import _cuda_build
    from pycolmap_torch.sfm import cg_kernel as ck

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda_build.libs()
    (tree / "build").mkdir(exist_ok=True)
    if unsharded:
        _unsharded(cs, tree)
        return 0
    case, _ = cs.bench_case(torch.device("cuda"))
    res = {}
    cs.check_case(case, "bench", res)
    del case
    torch.cuda.empty_cache()
    # the Schur kernels at phase 16's width-9 operands (phase 11's numbers,
    # which phase 16 only logs beside its own, stand in)
    single = {"lm": 1, "solve": 1.0, "entry_s": 1.0,
              "launches": {k: 1 for k in cs.SINGLE_BA}}
    with tempfile.TemporaryDirectory(dir=tree / "build") as tmp:
        _, captured = cs.mixed_model_bundle_adjustment(Path(tmp), single)
    buckets, pts, *rest = captured
    schur = {k: {} for k in ck.TILE_KINDS}
    cs.check_case_schur("width 9", cs.Case(
        [b._replace(points=p) for b, p in zip(buckets, pts)], *rest, 0),
        "chip_ab", schur)
    print("AB " + json.dumps({"tree": str(tree), **{
        k: round(v["ms"], 5) for k, v in res.items()}, **{
        f"{k} width 9": round(v["width 9"]["ms"], 5)
        for k, v in schur.items()}}), flush=True)
    if mapper_errors:
        two = [cs.Camera.create(1, "SIMPLE_RADIAL", 600.0, 640, 480),
               cs.Camera.create(2, "PINHOLE", 600.0, 640, 480)]
        for tag, cameras in (("mapping", None), ("two-model mapping", two)):
            with tempfile.TemporaryDirectory(dir=tree / "build") as tmp:
                tmp = Path(tmp)
                gt = cs.write_orbit_database(tmp / "map.db", cs.MAP_IMAGES,
                                             cs.MAP_POINTS, cs.MAP_NOISE,
                                             cameras=cameras)
                with cs.ResJacRecorder() as rec:
                    cs.map_and_check(tmp / "map.db", tmp / "map", gt,
                                     cs.mapping_options(4 if cameras else 6),
                                     "cuda", f"chip_ab {tag}",
                                     cs.MAP_IMAGES - (1 if cameras else 0))
            _errors(cs, ck, torch, cs.mapping_case(rec.global_args, 201),
                    f"{tag} global")
            _errors(cs, ck, torch, cs.mapping_case(rec.local_args, 202),
                    f"{tag} local")
    return 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return one(Path(argv[1]).resolve(), "--mapper-errors" in argv,
                   "--unsharded" in argv)
    flags = [a for a in argv if a.startswith("--")]
    trees = [Path(a).resolve() for a in argv if not a.startswith("--")]
    if len(trees) != 2 or len(flags) > 1:
        sys.exit(__doc__)
    a, b = trees
    if "--unsharded" in flags:
        runs = ((a, ["--unsharded"]), (b, ["--unsharded"]))
    else:
        runs = ((a, []), (b, flags), (b, []), (a, []))
    rc = 0
    for tree, extra in runs:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--one",
               str(tree)] + extra
        rc |= subprocess.run(cmd, cwd=tree).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
