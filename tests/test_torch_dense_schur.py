"""The dense reduced camera system (the reference's ``_dense_schur_solve``)
in the port vs the reference on the CPU, both at their CPU defaults, no
pin: these bundles' padded system dimension is under 2,048, so both solve
every step densely.

The problems are tests/test_torch_solver.py's 16-image / 512-point bundle
and a two-camera, two-model variant of it (even images SIMPLE_RADIAL, odd
images PINHOLE, as tests/test_mixed_models.py's make_mixed_problem: C > 1,
so the pose-intrinsics blocks go through the image-to-camera map). One LM
step compares within 1e-4 scaled; whole solves at test_torch_solver.py's
tolerances. On the port alone: S v against the implicit matvec's plain
version, and the rule that picks the solver.

The reference's packed solver is re-jitted here with ``max_iterations``
traced, so its one-step and whole solves of a problem share one compile
(the same function; only the jit's static arguments differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycolmap_tpu.sfm import ba_kernels as jbk
from pycolmap_tpu.sfm.bundle_adjustment import BundleAdjustmentOptions as JOpt
from pycolmap_tpu.sfm.bundle_adjustment import BundleProblem as JProblem
from pycolmap_torch import convert
from pycolmap_torch.ops import camera_models as tcm
from pycolmap_torch.parallel.device_ctx import ShardMesh
from pycolmap_torch.parallel.synthetic import make_synthetic_bundle as tsyn
from pycolmap_torch.sfm import ba_kernels as tbk
from pycolmap_torch.sfm import cg_kernel as ck
from pycolmap_torch.sfm import resident as tres

SYN = dict(num_images=16, num_points=512, obs_per_point=6, pose_noise=0.05,
           point_noise=0.1, refine_intrinsics=True, seed=0)
CG_ITERS = 20
ITERS = 8
PINHOLE, SIMPLE_RADIAL = 1, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One PyTorch intra-op thread (parallel test workers' thread pools
    would contend); the reference at its CPU defaults (tests/
    test_cg_kernel_solver.py sets its solver knobs in ``os.environ`` when
    imported, and every test worker imports it at collection); its packed
    solver with a traced max_iterations."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    packed = jbk._solve_bucketed_packed_jit
    mp = pytest.MonkeyPatch()
    for knob in ("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "PYCOLMAP_TPU_BA_PALLAS",
                 "PYCOLMAP_TPU_BA_PALLAS_MIN_SLOTS"):
        mp.delenv(knob, raising=False)
    mp.setattr(jbk, "_solve_bucketed_packed_jit", jax.jit(
        packed.__wrapped__,
        static_argnames=("npts", "num_images", "num_cameras", "model_id",
                         "loss_type", "cg_iters", "knobs")))
    yield
    mp.undo()
    torch.set_num_threads(n)


def _two_models(arrs):
    """The bundle's arrays with two cameras of two models: images alternate
    between a SIMPLE_RADIAL camera (f, k free) and a PINHOLE one (fx, fy
    free) of the same projection."""
    models = (PINHOLE, SIMPLE_RADIAL)
    sel = tcm.mixed_sel_index(models)
    width = max(tcm.MAX_PARAMS, sel + 1)
    f, cx, cy, k = arrs["intrinsics"][0, :4]
    intr = np.zeros((2, width), np.float32)
    intr[0, :4] = [f, cx, cy, k]
    intr[0, sel] = SIMPLE_RADIAL
    intr[1, :4] = [f, f, cx, cy]
    intr[1, sel] = PINHOLE
    free = np.zeros((2, width), np.float32)
    free[0, [0, 3]] = 1.0
    free[1, [0, 1]] = 1.0
    cam = (arrs["obs_image_idx"] % 2).astype(np.int32)
    return models, dict(arrs, intrinsics=intr, intr_free=free,
                        obs_camera_idx=cam)


@pytest.fixture(scope="module")
def problems():
    """{cameras: (reference problem, port problem)} from the same numpy
    arrays: the port's generator's draw of the bundle (the reference's
    generator draws the same values, tests/test_torch_mixed_models.py)."""
    tp = tsyn(**SYN)
    arrs = {k: v.numpy() for k, v in tp._asdict().items() if k != "model_id"}
    out = {}
    for cams, (model, a) in {1: (tp.model_id, arrs),
                             2: _two_models(arrs)}.items():
        jp = JProblem(**{k: jnp.asarray(v) for k, v in a.items()},
                      model_id=model)
        out[cams] = (jp, convert.bundle_problem_from_numpy(a, model))
    return out


def _options(iters):
    jo = JOpt()
    jo.max_num_iterations = iters
    jo.print_summary = False
    jo.devices = "none"
    return jo, convert.ba_options_from_dict(jo.todict())


@pytest.fixture(scope="module")
def solves(problems):
    """Per (cameras, LM steps): the reference's default solve and the
    port's, each (problem, summary), and the port's LMResult."""
    out = {}
    for cams, (jp, tp) in problems.items():
        for iters in (1, ITERS):
            jo, to = _options(iters)
            solver = tres.ResidentBundleSolver(tp, to, cg_iters=CG_ITERS,
                                               device="cpu")
            summary = solver.solve()
            out[cams, iters] = dict(
                ref=jbk.solve_bundle_fast(jp, jo, cg_iters=CG_ITERS),
                port=(solver.fetch_problem(), summary),
                result=solver.last_result)
    return out


def _close_problem(got, ref, atol):
    """test_torch_solver.py's comparison: intrinsics scaled by their
    largest magnitude."""
    for f in ("cam_quat", "cam_trans", "intrinsics", "points"):
        g, r = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        scale = max(np.abs(r).max(), 1.0) if f == "intrinsics" else 1.0
        np.testing.assert_allclose(g / scale, r / scale, atol=atol,
                                   err_msg=f)


@pytest.mark.parametrize("cams", [1, 2])
@pytest.mark.parametrize("iters", [1, ITERS], ids=["one_step", "whole"])
def test_dense_solve_matches_reference(solves, cams, iters):
    """One step: the parameters within 1e-4 scaled. The whole solve:
    initial cost 1e-5, final cost 1e-3, parameters 1e-3 scaled. The port
    took the dense path at every step and launched no matvec."""
    s = solves[cams, iters]
    (jr, js), (tr, ts), r = s["ref"], s["port"], s["result"]
    assert r.dense and r.cg_iterations == 0 and r.dense_cg_iterations > 0
    assert ts.num_iterations == r.iterations
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3)
    assert ts.num_residuals == js.num_residuals
    if iters == ITERS:
        assert ts.final_cost < ts.initial_cost / 50
    _close_problem(tr, jr, 1e-4 if iters == 1 else 1e-3)


@pytest.mark.parametrize("cams", [1, 2])
def test_dense_system_matches_implicit_matvec(problems, cams):
    """S v (S the damped, masked dense system) equals the implicit path's
    matvec at the same operands: (damping v + the plain matvec over every
    bucket) masked by the free parameters, within 1e-5 scaled."""
    _, tp = problems[cams]
    solver = tres.ResidentBundleSolver(tp, _options(1)[1], device="cpu")
    bl = solver._buckets[0]
    NP = solver._NP
    quat, trans, intr = solver._quat, solver._trans, solver._intr[:, :NP]
    pose_free = solver._pose_free
    intr_free = solver._intr_free[:, :NP].contiguous()
    I, C = quat.shape[0], intr.shape[0]
    lam = torch.tensor(1e-2)
    res, J = ck.res_and_jac(bl, [b.points for b in bl], quat, trans, intr,
                            intr_free, tp.model_id, 0, 1.0)
    Vinv, _, _, _, udp, udi, S_blocks = ck.schur_prepare(bl, J, res, lam,
                                                         I, C)
    S = tbk.dense_schur_system(bl, J, Vinv, lam, pose_free, intr_free,
                               solver._img2cam)
    assert S.shape == (6 * I + NP * C,) * 2
    rng = np.random.default_rng(cams)
    v_pose = torch.from_numpy(rng.normal(size=(I, 6)).astype(np.float32))
    v_intr = torch.from_numpy(rng.normal(size=(C, NP)).astype(np.float32))
    v_pose, v_intr = v_pose * pose_free, v_intr * intr_free
    damp_pose, damp_intr, _ = tbk._schur_jacobi(pose_free, intr_free)(
        lam, udp, udi, S_blocks)
    mp, mi = ck.schur_matvec(bl, J, Vinv, v_pose, v_intr, I, C)
    want = torch.cat([((damp_pose * v_pose + mp) * pose_free).reshape(-1),
                      ((damp_intr * v_intr + mi) * intr_free).reshape(-1)])
    got = S @ torch.cat([v_pose.reshape(-1), v_intr.reshape(-1)])
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy() / scale, want.numpy() / scale,
                               atol=1e-5)


@pytest.mark.parametrize("I, C, NP, device, knob, dense", [
    (16, 1, 4, "cpu", None, True),  # the 16-image bundle: D_ref 196
    (16, 1, 4, "cuda", None, True),
    (128, 1, 4, "cuda", None, False),  # the bench bundle: D_ref 772
    (128, 1, 4, "cpu", None, True),
    (341, 1, 2, "cpu", None, False),  # D_ref 6 * 512 + 2
    (16, 1, 4, "cpu", 196, True),  # the cutoff is inclusive
    (16, 1, 4, "cpu", 195, False),
    (16, 1, 4, "cpu", 0, False),  # the reference's pin to the implicit PCG
])
def test_selection_rule(I, C, NP, device, knob, dense):
    """The reference's padded dimension against the cutoff: 512 on the
    card, 2048 on the CPU, or the given one; no card needed to read it."""
    assert tbk.dense_schur_cutoff("cuda") == 512
    assert tbk.dense_schur_cutoff("cpu") == 2048
    assert tbk.dense_schur_cutoff("cuda", 100) == 100
    assert tbk.dense_schur_dim(16, 1, 4) == 196
    assert tbk.dense_schur_dim(30, 2, 5) == 6 * 32 + 5 * 4
    got = tbk.dense_schur_selected(I, C, NP, device, knob,
                                   img2cam=torch.zeros(I, dtype=torch.long))
    assert got is dense
    # without an image-to-camera map, or on a mesh, never
    assert not tbk.dense_schur_selected(I, C, NP, device, knob)
    assert not tbk.dense_schur_selected(
        I, C, NP, device, knob, mesh=ShardMesh(["cpu"] * 2),
        img2cam=torch.zeros(I, dtype=torch.long))


@pytest.mark.parametrize("kw, dense", [
    ({}, True),
    (dict(dense_schur_max_d=196), True),
    (dict(dense_schur_max_d=195), False),
    (dict(dense_schur_max_d=0), False),
    (dict(mesh=ShardMesh(["cpu"] * 2)), False),
], ids=["default", "at_cutoff", "below_cutoff", "pinned", "mesh"])
def test_solver_takes_the_selected_path(problems, kw, dense):
    """One LM step of the 16-image bundle through ResidentBundleSolver:
    the dense path counts its PCG iterations and launches no matvec; the
    implicit path (above the cutoff, pinned, or on a mesh) only matvecs."""
    _, tp = problems[1]
    solver = tres.ResidentBundleSolver(tp, _options(1)[1],
                                       cg_iters=CG_ITERS, device="cpu", **kw)
    summary = solver.solve()
    r = solver.last_result
    assert summary.final_cost < summary.initial_cost
    assert r.dense is dense
    if dense:
        assert r.cg_iterations == 0 and 0 < r.dense_cg_iterations <= 64
    else:
        assert r.dense_cg_iterations == 0
        assert 0 < r.cg_iterations <= CG_ITERS


def test_mapper_cache_counts_dense_solves(problems):
    """MapperResidentBA counts the dense solves, their LM steps and PCG
    iterations apart from the implicit matvecs, and keys its entries by
    the cutoff."""
    _, tp = problems[1]
    _, to = _options(2)
    cache = tres.MapperResidentBA(device="cpu")
    p1, s1 = cache.solve(tp, to, cg_iters=CG_ITERS)
    assert (cache.dense_solves, cache.dense_lm_steps) == (
        1, s1.num_iterations)
    assert cache.lm_steps == s1.num_iterations
    assert cache.cg_iterations == 0 < cache.dense_cg_iterations
    # the written-back problem hits under the same cutoff, misses under
    # another, and solves implicitly there
    cache.solve(p1, to, cg_iters=CG_ITERS)
    assert (cache.hits, cache.misses, cache.dense_solves) == (1, 1, 2)
    cache.dense_schur_max_d = 0
    _, s3 = cache.solve(p1, to, cg_iters=CG_ITERS)
    assert (cache.hits, cache.misses, cache.dense_solves) == (1, 2, 2)
    assert cache.cg_iterations > 0
    assert cache.lm_steps == cache.dense_lm_steps + s3.num_iterations
