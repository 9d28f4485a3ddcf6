"""The port's bucketed LM solver vs the reference on the CPU: one
16-image / 512-point problem solved by both packages' solve_bundle_fast and
ResidentBundleSolver (solve, perturb, re-solve, fetch). Both packages are
pinned to the implicit Schur-PCG path (the path the CUDA kernels
replace): the reference by PYCOLMAP_TPU_DENSE_SCHUR_MAX_D=0, the port by
dense_schur_max_d=0 (tests/test_torch_dense_schur.py holds their default
dense path on these problems)."""

import numpy as np
import pytest
import torch

from pycolmap_tpu.parallel.synthetic import make_synthetic_bundle as jsyn
from pycolmap_tpu.sfm import ba_kernels as jbk
from pycolmap_tpu.sfm import resident as jres
from pycolmap_tpu.sfm.bundle_adjustment import BundleAdjustmentOptions as JOpt
from pycolmap_tpu.sfm.bundle_adjustment import LossFunctionType as JLoss
from pycolmap_torch import convert
from pycolmap_torch.sfm import ba_kernels as tbk
from pycolmap_torch.sfm import resident as tres

SYN = dict(num_images=16, num_points=512, obs_per_point=6, pose_noise=0.05,
           point_noise=0.1, refine_intrinsics=True, seed=0)
CG_ITERS = 20
ITERS = 8


@pytest.fixture(autouse=True)
def _implicit_reference_path(monkeypatch):
    monkeypatch.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")


def _problems():
    jp = jsyn(**SYN)
    tp = convert.bundle_problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items() if k != "model_id"},
        jp.model_id,
    )
    return jp, tp


def _options(loss):
    jo = JOpt()
    jo.max_num_iterations = ITERS
    jo.print_summary = False
    jo.devices = "none"
    if loss:
        jo.loss_function_type = JLoss.CAUCHY
        jo.loss_function_scale = 2.0
    return jo, convert.ba_options_from_dict(jo.todict())


def _close_problem(got, ref, atol=1e-3):
    for f in ("cam_quat", "cam_trans", "intrinsics", "points"):
        g, r = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        scale = max(np.abs(r).max(), 1.0) if f == "intrinsics" else 1.0
        np.testing.assert_allclose(g / scale, r / scale, atol=atol,
                                   err_msg=f)


@pytest.mark.parametrize("robust", [False, True])
def test_solve_bundle_fast_matches(robust):
    jp, tp = _problems()
    jo, to = _options(robust)
    jr, js = jbk.solve_bundle_fast(jp, jo, cg_iters=CG_ITERS)
    tr, ts = tbk.solve_bundle_fast(tp, to, cg_iters=CG_ITERS, device="cpu",
                                   dense_schur_max_d=0)
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3)
    assert ts.final_cost < ts.initial_cost / 50
    assert ts.num_residuals == js.num_residuals
    _close_problem(tr, jr)


def test_resident_solver_matches():
    jp, tp = _problems()
    jo, to = _options(False)
    js_ = jres.ResidentBundleSolver(jp, jo, cg_iters=CG_ITERS)
    ts_ = tres.ResidentBundleSolver(tp, to, cg_iters=CG_ITERS, device="cpu",
                                    dense_schur_max_d=0)
    for step in ("solve", "perturb", "solve"):
        if step == "perturb":
            js_.perturb_points(1e-3)
            ts_.perturb_points(1e-3)
            continue
        j_sum, t_sum = js_.solve(), ts_.solve()
        assert t_sum.initial_cost == pytest.approx(j_sum.initial_cost,
                                                   rel=1e-3)
        assert t_sum.final_cost == pytest.approx(j_sum.final_cost, rel=1e-3)
        assert t_sum.final_cost <= t_sum.initial_cost
    _close_problem(ts_.fetch_problem(), js_.fetch_problem())
    r = ts_.last_result
    assert r.host_syncs >= r.iterations  # one per LM step, one per CG check
    assert r.cg_iterations >= 1


def _bf16_problem():
    """tests/test_cg_kernel_solver.py's problem."""
    jp = jsyn(num_images=7, num_points=120, obs_per_point=4, pose_noise=0.03,
              point_noise=0.05, refine_intrinsics=True, seed=3)
    return convert.bundle_problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items() if k != "model_id"},
        jp.model_id,
    )


def test_bf16_setting_converges_on_the_cpu():
    """The CG matvecs from bf16-packed J (the card's default) converge as
    tests/test_cg_kernel_solver.py requires (final < 0.1 x initial), and
    land within 1e-3 relative of the f32 setting's final cost."""
    tp = _bf16_problem()
    _, to = _options(False)
    to.max_num_iterations = 5
    out = {}
    for bf16 in (True, False):
        _, out[bf16] = tbk.solve_bundle_fast(tp, to, cg_iters=15,
                                             device="cpu", cg_bf16=bf16,
                                             dense_schur_max_d=0)
    assert out[True].final_cost < 0.1 * out[True].initial_cost
    assert out[True].final_cost == pytest.approx(out[False].final_cost,
                                                 rel=1e-3)


def test_cg_bf16_defaults_follow_the_device():
    """bf16 on the card, f32 on the CPU, as the reference on its
    accelerator and its CPU; one argument selects either."""
    assert tbk.cg_bf16_default("cuda") is True
    assert tbk.cg_bf16_default("cpu") is False
    assert tbk.cg_bf16_default("cuda", False) is False
    tp = _bf16_problem()
    _, to = _options(False)
    assert tres.ResidentBundleSolver(tp, to, device="cpu").cg_bf16 is False
    assert tres.ResidentBundleSolver(tp, to, device="cpu",
                                     cg_bf16=True).cg_bf16 is True


# --- MapperResidentBA: the mapper's cache of resident solvers -------------


def _mapper_problem():
    """tests/test_resident.py's problem and options (4 LM steps)."""
    jp = jsyn(num_images=6, num_points=300, obs_per_point=4, pose_noise=0.03,
              point_noise=0.05, refine_intrinsics=True, seed=3)
    tp = convert.bundle_problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items() if k != "model_id"},
        jp.model_id,
    )
    jo = JOpt()
    jo.max_num_iterations = 4
    jo.print_summary = False
    jo.devices = "none"
    return jp, tp, jo, convert.ba_options_from_dict(jo.todict())


def _round_trip(p):
    """The problem as the mapper rebuilds it from float64 scene objects."""
    return p._replace(
        points=torch.from_numpy(np.asarray(p.points, np.float64)
                                .astype(np.float32)),
        cam_quat=torch.from_numpy(np.asarray(p.cam_quat, np.float64)
                                  .astype(np.float32)),
    )


@pytest.fixture
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_mapper_resident_cache_hits(_one_thread):
    """tests/test_resident.py test_mapper_resident_cache_hits on the port:
    a re-solve of the fetched problem hits the cache and matches a fresh
    solve_bundle chain within 1e-3; the reference's cache counts the same
    hits and misses and lands on the same cost."""
    from pycolmap_torch.sfm.bundle_adjustment import solve_bundle

    jp, tp, jo, to = _mapper_problem()
    cache = tres.MapperResidentBA(device="cpu", dense_schur_max_d=0)
    p1, s1 = cache.solve(tp, to, cg_iters=15)
    assert (cache.misses, cache.hits) == (1, 0)
    p2, s2 = cache.solve(_round_trip(p1), to, cg_iters=15)
    assert (cache.misses, cache.hits) == (1, 1)
    assert (cache.solves, cache.lm_steps) == (2, s1.num_iterations
                                              + s2.num_iterations)
    assert cache.cg_iterations >= cache.lm_steps
    ref1, _ = solve_bundle(tp, to, cg_iters=15, device="cpu",
                           dense_schur_max_d=0)
    _, s2_ref = solve_bundle(ref1, to, cg_iters=15, device="cpu",
                             dense_schur_max_d=0)
    assert s2.final_cost == pytest.approx(s2_ref.final_cost, rel=1e-3)

    jcache = jres.MapperResidentBA()
    jp1, js1 = jcache.solve(jp, jo, cg_iters=15)
    jp1 = jp1._replace(
        points=np.asarray(np.asarray(jp1.points, np.float64), np.float32),
        cam_quat=np.asarray(np.asarray(jp1.cam_quat, np.float64), np.float32),
    )
    _, js2 = jcache.solve(jp1, jo, cg_iters=15)
    assert (jcache.misses, jcache.hits) == (cache.misses, cache.hits)
    assert s1.initial_cost == pytest.approx(js1.initial_cost, rel=1e-5)
    assert s2.final_cost == pytest.approx(js2.final_cost, rel=1e-3)


def test_mapper_resident_cache_miss_on_structure_change(_one_thread):
    """tests/test_resident.py's structure-change case: dropping one
    observation misses."""
    _, tp, _, to = _mapper_problem()
    to.max_num_iterations = 2
    cache = tres.MapperResidentBA(device="cpu", dense_schur_max_d=0)
    p1, _ = cache.solve(tp, to, cg_iters=10)
    mask = p1.obs_mask.clone()
    mask[0] = 0.0
    cache.solve(p1._replace(obs_mask=mask), to, cg_iters=10)
    assert (cache.misses, cache.hits) == (2, 0)
    # an unchanged re-solve of the first problem's result still hits
    cache.solve(p1, to, cg_iters=10)
    assert cache.hits == 1


def test_mapper_resident_cache_passes_over_only_empty_problems(
        _one_thread, monkeypatch):
    """An empty problem returns a zero summary without a solver; a
    ValueError raised by a solve (a failed kernel launch raises so)
    propagates."""
    _, tp, _, to = _mapper_problem()
    cache = tres.MapperResidentBA(device="cpu", dense_schur_max_d=0)
    empty = tp._replace(obs_mask=torch.zeros_like(tp.obs_mask))
    out, s = cache.solve(empty, to)
    assert out is empty and s.num_iterations == 0 and cache.misses == 0

    def fail(self, max_iterations=None):
        raise ValueError("kernel operand must be a contiguous CUDA tensor")

    monkeypatch.setattr(tres.ResidentBundleSolver, "solve", fail)
    with pytest.raises(ValueError, match="kernel operand"):
        cache.solve(tp, to)
