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
gives them (``chip_smoke.check_case_schur``). Before the four runs one
process of checkout B maps bench.py run_mapping's 30-image database on
the card, and the same orbit with its images alternating between a
SIMPLE_RADIAL and a PINHOLE camera, records one global and one
local-window BA step of each (``chip_smoke.ResJacRecorder``) and saves
their operands; every run then times ``res_and_jac`` at those steps, at
the bench case and at phase 16's two-model inputs as its checkout's LM
loop calls it (device ms, median of 25 CUDA events; host wall ms per
call; launches per call), one line ``RESJAC {json}``,
and saves its outputs, which the end compares run for run (``BITS
{json}``: equal bit for bit, or the largest difference). With
``--mapper-errors`` the first B run also prints, per output of resjac and
prepare at the recorded steps, the kernel's and the f32 plain version's
scaled error against the float64 plain version.

With ``--unsharded`` each checkout instead runs, once and in the order A,
B, its unsharded BA paths: phase 4's bf16 bench solve and phase 20's
timed ``incremental_mapping`` of the 30-image orbit, the latter on the
implicit PCG (``dense_schur_max_d=0``, passed where the checkout's
``incremental_mapping`` takes it: a checkout without the dense reduced
system has only that path). Each run prints one line ``UNSHARDED
{json}`` with the launch counts, the LM steps and CG iterations, and
SHA-1 digests of the solved points and quaternions and of the registered
poses, so the two compare launch for launch and bit for bit; the end
prints ``UNSHARDED-SAME {json}``: which of them agree, resjac's counts
apart (one launch per bucket or per call), and resjac's launches per LM
step of each.

Run from the root of checkout B on a host with the card, checkout A
unpacked anywhere (e.g. ``git archive <commit> | tar -x -C build/parent``):

    python3 chip_ab.py build/parent . [--mapper-errors | --unsharded]

It exits 1 on a host without CUDA.
"""

from __future__ import annotations

import hashlib
import json
import shutil
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


STEPS = "chip_ab_steps.pt"  # the recorded steps, under checkout B's build/


def _cpu_args(args):
    """res_and_jac operands with every tensor on the host, as plain tuples
    (torch.load's weights-only form)."""
    b_l, pts, *rest = args
    return ([tuple(t.cpu() for t in b) for b in b_l], [p.cpu() for p in pts],
            *(a.cpu() if hasattr(a, "cpu") else a for a in rest))


def _card_args(bk, args):
    b_l, pts, *rest = args
    return ([bk.Bucket(*(t.cuda() for t in b)) for b in b_l],
            [p.cuda() for p in pts],
            *(a.cuda() if hasattr(a, "cuda") else a for a in rest))


def record(tree: Path) -> int:
    """Map the orbit and its two-model twin on the card and save one
    global and one local-window step of each under build/."""
    sys.path.insert(0, str(tree))
    import torch

    import chip_smoke as cs
    from pycolmap_torch import _cuda_build

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    _cuda_build.libs()
    (tree / "build").mkdir(exist_ok=True)
    two = [cs.Camera.create(1, "SIMPLE_RADIAL", 600.0, 640, 480),
           cs.Camera.create(2, "PINHOLE", 600.0, 640, 480)]
    steps = {}
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
        steps[f"{tag} global"] = _cpu_args(rec.global_args)
        steps[f"{tag} local"] = _cpu_args(rec.local_args)
    torch.save(steps, tree / "build" / STEPS)
    return 0


def _resjac_runs(ck, torch, cases):
    """resjac at each case ({tag: res_and_jac operands}) as this
    checkout's LM loop calls it (its table once per solve where it has
    one): device ms and host wall ms per call, and the outputs on the
    host."""
    from pycolmap_torch._timing import host_ms, time_gpu

    times, outs = {}, {}
    for tag, args in cases.items():
        kw = ({"launch": ck.resjac_launch(args[0], args[6])}
              if hasattr(ck, "resjac_launch") else {})

        def call():
            return ck.res_and_jac(*args, **kw)

        before = dict(ck.LAUNCHES)
        res_l, J_l = call()
        torch.cuda.synchronize()
        launches = sum(ck.LAUNCHES[k] - before[k]
                       for k in ("resjac", "resjac_mixed"))
        outs[tag] = [t.cpu() for t in res_l + J_l]
        shapes = [tuple(b.mask.shape) for b in args[0]]
        times[tag] = dict(ms=time_gpu(call), call_host_ms=host_ms(call),
                          launches_per_call=launches, buckets=shapes)
    return times, outs


def _unsharded(cs, tree: Path):
    """Phase 4's bf16 bench solve and phase 20's timed mapping on the
    implicit PCG: their launches, loop counts and result digests."""
    import inspect

    import numpy as np

    launches, per_step, solver, rate = cs.bench_solve(cg_bf16=True)
    p = solver.fetch_problem()
    out = {"tree": str(tree), "phase4": dict(
        launches={k: v for k, v in launches.items() if v}, rate=rate,
        resjac_per_lm_step=per_step["resjac"],
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
    return out


def _same_unsharded(a, b):
    """Which of two runs' UNSHARDED numbers agree: loop counts, SHA-1s and
    launches, resjac's apart (the parent launched it once per bucket)."""
    def other(launches):
        return {k: v for k, v in launches.items()
                if k not in ("resjac", "resjac_mixed")}

    pa, pb = a["phase4"], b["phase4"]
    ma, mb = a["phase20"], b["phase20"]
    return dict(
        phase4_sha=(pa["points_sha"], pa["quat_sha"])
        == (pb["points_sha"], pb["quat_sha"]),
        phase4_launches_but_resjac=other(pa["launches"])
        == other(pb["launches"]),
        phase4_resjac_per_lm_step=[pa.get("resjac_per_lm_step"),
                                   pb.get("resjac_per_lm_step")],
        phase20_steps_cg=(ma["steps"], ma["cg"]) == (mb["steps"], mb["cg"]),
        phase20_sha=ma["poses_sha"] == mb["poses_sha"],
        phase20_launches_but_resjac=other(ma["launches"])
        == other(mb["launches"]),
        phase20_resjac_per_lm_step=[
            x["launches"].get("resjac", 0) / max(x["steps"], 1)
            for x in (ma, mb)])


def _compare_bits(files):
    """Per case, run 1 (A) against run 2 (B) and run 2 against run 3 (B
    again): equal bit for bit, or the largest absolute difference."""
    import torch

    runs = [torch.load(f) for f in files]
    out = {}
    for tag in runs[0]:
        for i, j in ((0, 1), (1, 2)):
            a, b = runs[i][tag], runs[j][tag]
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            diff = max(float((x.double() - y.double()).abs().max())
                       if x.numel() else 0.0 for x, y in zip(a, b))
            out[f"{tag}: run {i + 1} vs {j + 1}"] = dict(
                bit_equal=same, max_abs_diff=diff,
                where=None if same else int(next(
                    k for k, (x, y) in enumerate(zip(a, b))
                    if not torch.equal(x, y))))
    return out


def one(tree: Path, mapper_errors: bool, unsharded: bool, run: int) -> int:
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
    result = Path(__file__).resolve().parent / "build" / f"chip_ab_{run}"
    if unsharded:
        out = _unsharded(cs, tree)
        result.with_suffix(".json").write_text(json.dumps(out))
        return 0
    from pycolmap_torch.sfm import ba_kernels as bk

    case, _ = cs.bench_case(torch.device("cuda"))
    res = {}
    cs.check_case(case, "bench", res)
    steps = torch.load(Path(__file__).resolve().parent / "build" / STEPS)
    cases = {"bench": (case.buckets, case.pts, case.quat, case.trans,
                       case.intr[:, :case.NP].contiguous(),
                       case.intr_free[:, :case.NP].contiguous(),
                       case.model_id, case.loss_type, case.loss_scale)}
    cases.update({k: _card_args(bk, v) for k, v in steps.items()})
    del case
    # the Schur kernels at phase 16's width-9 operands (phase 11's numbers,
    # which phase 16 only logs beside its own, stand in); resjac there too
    single = {"lm": 1, "solve": 1.0, "entry_s": 1.0,
              "launches": {k: 1 for k in cs.SINGLE_BA}}
    with tempfile.TemporaryDirectory(dir=tree / "build") as tmp:
        _, captured = cs.mixed_model_bundle_adjustment(Path(tmp), single)
    cases["phase 16 capture"] = captured
    times, outs = _resjac_runs(ck, torch, cases)
    print("RESJAC " + json.dumps({"tree": str(tree), **times}), flush=True)
    torch.save(outs, result.with_suffix(".pt"))
    del cases, outs
    torch.cuda.empty_cache()
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
        for seed, (tag, args) in enumerate(steps.items(), 201):
            _errors(cs, ck, torch,
                    cs.mapping_case(_card_args(bk, args), seed), tag)
    return 0


def main(argv) -> int:
    if argv[:1] == ["--one"]:
        return one(Path(argv[1]).resolve(), "--mapper-errors" in argv,
                   "--unsharded" in argv, int(argv[2]))
    if argv[:1] == ["--record"]:
        return record(Path(argv[1]).resolve())
    flags = [a for a in argv if a.startswith("--")]
    trees = [Path(a).resolve() for a in argv if not a.startswith("--")]
    if len(trees) != 2 or len(flags) > 1:
        sys.exit(__doc__)
    a, b = trees
    me = str(Path(__file__).resolve())
    build = Path(me).parent / "build"
    build.mkdir(exist_ok=True)
    unsharded = "--unsharded" in flags
    if unsharded:
        runs = ((a, ["--unsharded"]), (b, ["--unsharded"]))
    else:
        runs = ((a, []), (b, flags), (b, []), (a, []))
        if subprocess.run([sys.executable, me, "--record", str(b)],
                          cwd=b).returncode:
            return 1
        if (b / "build" / STEPS).resolve() != (build / STEPS).resolve():
            shutil.copy(b / "build" / STEPS, build / STEPS)
    rc = 0
    for k, (tree, extra) in enumerate(runs, 1):
        cmd = [sys.executable, me, "--one", str(tree), str(k)] + extra
        rc |= subprocess.run(cmd, cwd=tree).returncode
    if rc:
        return rc
    if unsharded:
        got = [json.loads((build / f"chip_ab_{k}.json").read_text())
               for k in (1, 2)]
        print("UNSHARDED-SAME " + json.dumps(_same_unsharded(*got)),
              flush=True)
    else:
        print("BITS " + json.dumps(_compare_bits(
            [build / f"chip_ab_{k}.pt" for k in (1, 2, 3)])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
