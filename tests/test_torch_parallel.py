"""The port's multi-device layer vs the reference on the CPU: the mesh
selectors, the bucket column slices, the padding, the camera-row
sharding, and point-sharded bundle adjustment on 2- and 4-shard CPU
meshes (``ShardMesh(["cpu"] * n)``) of a 16-image / 1,536-point bundle
(4 observations a point: one bucket, so the reference compiles one
solver body), held to the port's unsharded solve and to the reference's
single-device solve. 1,536 points fill a 2,048-column bucket, so every
shard of two holds points and one of four holds none. The reference runs its
virtual-device meshes (tests/conftest.py). Every unsharded solve of both
packages is pinned to the implicit PCG path, the only one on a mesh (the
reference by PYCOLMAP_TPU_DENSE_SCHUR_MAX_D=0, the port by
dense_schur_max_d=0)."""

import numpy as np
import pytest
import torch

import jax
from jax.sharding import Mesh

import pycolmap_torch
from pycolmap_tpu.parallel import camera_sharding as jcs
from pycolmap_tpu.parallel import sharded_ba as jsb
from pycolmap_tpu.parallel.synthetic import make_synthetic_bundle as jsyn
from pycolmap_tpu.sfm import ba_kernels as jbk
from pycolmap_tpu.sfm.bundle_adjustment import BundleAdjustmentOptions as JOpt
from pycolmap_tpu.sfm.bundle_adjustment import solve_bundle as j_solve_bundle
from pycolmap_torch import convert
from pycolmap_torch.parallel import camera_sharding as tcs
from pycolmap_torch.parallel import device_ctx
from pycolmap_torch.parallel import sharded_ba as tsb
from pycolmap_torch.parallel.device_ctx import ShardMesh
from pycolmap_torch.pipeline import bundle_adjustment
from pycolmap_torch.scene import Reconstruction
from pycolmap_torch.sfm import ba_kernels as tbk
from pycolmap_torch.sfm.bundle_adjustment import (
    BundleAdjustmentOptions,
    solve_bundle,
)
from pycolmap_torch.sfm.resident import MapperResidentBA, ResidentBundleSolver

from test_scene import build_synthetic_reconstruction

SYN = dict(num_images=16, num_points=1536, obs_per_point=4, pose_noise=0.05,
           point_noise=0.1, refine_intrinsics=True, seed=0)
ITERS, CG_ITERS = 4, 10


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, whose thread pools would otherwise contend. The
    reference solves on its implicit PCG path."""
    monkeypatch.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problems(**kw):
    jp = jsyn(**{**SYN, **kw})
    tp = convert.bundle_problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items() if k != "model_id"},
        jp.model_id,
    )
    return jp, tp


def _options(iters=ITERS):
    jo = JOpt()
    jo.max_num_iterations = iters
    jo.print_summary = False
    jo.devices = "none"
    return jo, convert.ba_options_from_dict(jo.todict())


def _jax_mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("obs",))


@pytest.fixture(scope="module")
def solves():
    """The reference's single-device solve and the port's unsharded one of
    the same problem (computed once: the reference compiles its solver)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        jp, tp = _problems()
        jo, to = _options()
        jr, js = j_solve_bundle(jp, jo, cg_iters=CG_ITERS)
        tr, ts = solve_bundle(tp, to, cg_iters=CG_ITERS, device="cpu",
                              dense_schur_max_d=0)
    finally:
        torch.set_num_threads(n)
        mp.undo()
    return dict(tp=tp, to=to, jr=jr, js=js, tr=tr, ts=ts)


# ---------------------------------------------------------------------------
# the mesh selectors
# ---------------------------------------------------------------------------


def test_resolve_mesh_specs():
    """The twin of tests/test_mesh_pipeline.py's: CPU shard meshes stand
    in for the reference's virtual devices."""
    assert device_ctx.resolve_mesh("none") is None
    assert device_ctx.resolve_mesh(None) is None
    assert device_ctx.resolve_mesh(1) is None
    assert device_ctx.resolve_mesh("off") is None
    # the CPU: auto stays on one device
    assert device_ctx.resolve_mesh("auto") is None
    assert device_ctx.resolve_mesh("auto", "cpu") is None
    m = ShardMesh(["cpu"] * 4)
    assert m.size == 4 and m.local_size == 4 and m.num_processes == 1
    assert device_ctx.resolve_mesh(m) is m
    # an explicit default mesh wins for "auto"
    device_ctx.set_default_mesh(m)
    try:
        assert device_ctx.resolve_mesh("auto") is m
        assert device_ctx.get_default_mesh() is m
    finally:
        device_ctx.set_default_mesh(None)
    # a card count: the first n local cards, and this host has none
    with pytest.raises(ValueError):
        device_ctx.resolve_mesh(10**6)
    with pytest.raises(ValueError):
        device_ctx.resolve_mesh(2)
    # package-level exports
    assert pycolmap_torch.resolve_mesh is device_ctx.resolve_mesh
    assert pycolmap_torch.set_default_mesh is device_ctx.set_default_mesh
    assert pycolmap_torch.get_default_mesh is device_ctx.get_default_mesh


def test_auto_mesh_on_a_host_of_two_cards(monkeypatch):
    """"auto" on two cards: every card where the entry point names none
    (the reference's default), that card alone where it names one, and
    the named card as the rank's shard in a process group; an explicit
    mesh that disagrees with the named card still raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    for dev in (None, "cuda"):
        m = device_ctx.resolve_mesh("auto", dev)
        assert [str(d) for d in m.devices] == ["cuda:0", "cuda:1"]
        assert device_ctx.mesh_device(m, dev) == torch.device("cuda:0")
    for dev in ("cuda:0", "cuda:1"):
        m = device_ctx.resolve_mesh("auto", dev)
        assert m is None
        assert device_ctx.mesh_device(m, dev) == torch.device(dev)
    two = device_ctx.resolve_mesh(2, "cuda:1")
    with pytest.raises(ValueError):
        device_ctx.mesh_device(two, "cuda:1")
    monkeypatch.setattr(device_ctx.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(device_ctx.dist, "get_world_size", lambda *a: 2)
    m = device_ctx.resolve_mesh("auto", "cuda:1")
    assert m.devices == (torch.device("cuda:1"),)
    assert device_ctx.mesh_device(m, "cuda:1") == torch.device("cuda:1")


def test_mesh_keys_and_devices():
    """Caches key a mesh by content; a mesh's devices take the place of
    ``device``, and ones that disagree raise; no card, no card mesh."""
    a, b = ShardMesh(["cpu", "cpu"]), ShardMesh([torch.device("cpu")] * 2)
    assert a.key() == b.key() != ShardMesh(["cpu"] * 4).key()
    assert [a.shard_index(k) for k in range(2)] == [0, 1]
    assert device_ctx.mesh_device(a, "cpu") == torch.device("cpu")
    assert device_ctx.mesh_device(a) == torch.device("cpu")
    with pytest.raises(RuntimeError):
        device_ctx.mesh_device(a, "cuda")
    with pytest.raises(ValueError):
        ShardMesh([])
    with pytest.raises(RuntimeError):
        tsb.make_obs_mesh()
    with pytest.raises(RuntimeError):
        ShardMesh(["cuda:0"])
    with pytest.raises(RuntimeError):
        tsb.dryrun_multichip(2)
    # the reduction: local partials summed in shard order, tuples whole
    parts = [(torch.full((2,), float(k)), torch.tensor(k + 1.0))
             for k in range(4)]
    s, t = ShardMesh(["cpu"] * 4).reduce(parts)
    assert s.tolist() == [6.0, 6.0] and float(t) == 10.0


# ---------------------------------------------------------------------------
# the bucket slices and the padding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nproc", [1, 2, 4])
def test_bucket_slices_match_reference(nproc):
    jp, tp = _problems(num_points=700, obs_per_point=5, seed=3)
    # drop some observations so the track lengths spread over buckets
    mask = np.asarray(jp.obs_mask).copy()
    mask[::7] = 0.0
    jp = jp._replace(obs_mask=mask)
    tp = tp._replace(obs_mask=torch.from_numpy(mask))
    for pid in range(nproc):
        want = jbk.bucketize(jp, col_range=(pid, nproc))
        got = tbk.bucketize(tp, col_range=(pid, nproc))
        assert len(got) == len(want) >= 2
        for g, w in zip(got, want):
            for name, a, b in zip(tbk.Bucket._fields, g, w):
                np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    for (gr, gs, gp, gt), (wr, ws, wp, wt) in zip(tbk.bucket_meta(tp),
                                                  jbk.bucket_meta(jp)):
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gs, ws)
        assert (gp, gt) == (wp, wt)


def test_bucket_slices_refuse_uneven_widths():
    jp, tp = _problems(num_points=100)
    with pytest.raises(ValueError):
        jbk.bucketize(jp, col_range=(0, 3))
    with pytest.raises(ValueError):
        tbk.bucketize(tp, col_range=(0, 3))
    with pytest.raises(ValueError):
        solve_bundle(tp, _options()[1], cg_iters=CG_ITERS,
                     mesh=ShardMesh(["cpu"] * 3))


def test_shard_buckets_are_the_column_slices():
    _, tp = _problems(num_points=300)
    mesh = ShardMesh(["cpu"] * 4)
    full = tbk.bucketize(tp)
    for k, shard in enumerate(tbk.shard_buckets(tp, mesh)):
        for b, f in zip(shard, full):
            w = f.mask.shape[1] // 4
            for a, c in zip(b, f):
                np.testing.assert_array_equal(a, c[..., k * w:(k + 1) * w])


@pytest.mark.parametrize("n", [3, 4])
def test_padding_matches_reference(n):
    jp, tp = _problems(num_points=101, obs_per_point=3)
    want = jsb.shard_bundle_problem(jp, _jax_mesh(n))
    got = tsb.shard_bundle_problem(tp, ShardMesh(["cpu"] * n))
    assert got.num_obs % n == 0 and got.num_obs == want.num_obs
    for f in got._fields:
        if f != "model_id":
            np.testing.assert_array_equal(np.asarray(getattr(got, f)),
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
    same = tsb.pad_observations(tp, 1)
    assert same is tp
    np.testing.assert_array_equal(
        tsb.pad_observations(tp, 7).obs_mask.numpy(),
        np.asarray(jsb.pad_observations(jp, 7).obs_mask))


# ---------------------------------------------------------------------------
# the camera rows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(1000, 8, 8), (130, 3, 8), (17, 4, 2)])
def test_block_cyclic_assignment_matches_reference(args):
    np.testing.assert_array_equal(tcs.assign_cameras_block_cyclic(*args),
                                  jcs.assign_cameras_block_cyclic(*args))


def test_shard_rows():
    arr = np.arange(130 * 6, dtype=np.float32).reshape(130, 6)
    blocks = tcs.shard_rows(arr, ShardMesh(["cpu"] * 4))
    assert [b.shape for b in blocks] == [(33, 6)] * 4
    full = torch.cat(blocks).numpy()
    np.testing.assert_array_equal(full[:130], arr)
    assert not full[130:].any()


@pytest.mark.parametrize("n", [2, 4])
def test_two_level_schur_solve_matches_reference(n):
    """tests/test_camera_sharding.py's system and tolerance."""
    rng = np.random.default_rng(0)
    D = 6 * 20 + 4
    A = rng.normal(size=(D, D)).astype(np.float32)
    S = A @ A.T + D * np.eye(D, dtype=np.float32)
    rhs = rng.normal(size=D).astype(np.float32)
    x = tcs.two_level_schur_solve(S, rhs, ShardMesh(["cpu"] * n),
                                  cg_iters=200, eta=1e-7)
    x_ref = np.linalg.solve(S.astype(np.float64), rhs.astype(np.float64))
    x_jax = jcs.two_level_schur_solve(S, rhs, _jax_mesh(n), cg_iters=200,
                                      eta=1e-7)
    for other in (x_ref, x_jax):
        assert np.linalg.norm(x - other) / np.linalg.norm(other) < 1e-3


# ---------------------------------------------------------------------------
# sharded solves
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_solve_matches_unsharded_and_reference(solves, n):
    mesh = ShardMesh(["cpu"] * n)
    got, s = solve_bundle(solves["tp"], solves["to"], cg_iters=CG_ITERS,
                          mesh=mesh)
    ts, js = solves["ts"], solves["js"]
    # the port's unsharded solve: only the summation order differs
    assert s.num_iterations == ts.num_iterations
    assert s.final_cost == pytest.approx(ts.final_cost, rel=1e-5)
    assert s.initial_cost == pytest.approx(ts.initial_cost, rel=1e-5)
    # the reference's single-device solve (test_resident.py:87-90 and
    # test_camera_sharding.py:79-82's tolerances)
    assert s.initial_cost == pytest.approx(js.initial_cost, rel=1e-4)
    assert s.final_cost == pytest.approx(js.final_cost, rel=1e-3)
    assert s.final_cost < s.initial_cost / 50
    np.testing.assert_allclose(got.cam_trans.numpy(),
                               np.asarray(solves["jr"].cam_trans), atol=1e-3)
    np.testing.assert_allclose(got.points.numpy(),
                               solves["tr"].points.numpy(), atol=1e-3)


def test_sharded_solve_through_options_devices(solves):
    """``options.devices`` holding a mesh shards solve_bundle itself."""
    to = BundleAdjustmentOptions(**{**solves["to"].todict(),
                                    "devices": ShardMesh(["cpu"] * 2)})
    _, s = solve_bundle(solves["tp"], to, cg_iters=CG_ITERS)
    assert s.num_iterations == solves["ts"].num_iterations
    assert s.final_cost == pytest.approx(solves["ts"].final_cost, rel=1e-5)


def test_resident_mesh_resolves(solves):
    """ResidentBundleSolver(mesh): the shards' point planes stay resident,
    a re-solve chains from the first's result."""
    mesh = ShardMesh(["cpu"] * 2)
    solver = ResidentBundleSolver(solves["tp"], solves["to"],
                                  cg_iters=CG_ITERS, mesh=mesh)
    s1 = solver.solve()
    assert s1.final_cost == pytest.approx(solves["ts"].final_cost, rel=1e-5)
    s2 = solver.solve()
    assert s2.initial_cost <= s1.final_cost * 1.01
    assert s2.final_cost <= s2.initial_cost
    solver.perturb_points(1e-3)
    s3 = solver.solve(max_iterations=1)
    assert s3.initial_cost > s2.final_cost
    fetched = solver.fetch_problem()
    assert fetched.points.shape == solves["tp"].points.shape
    assert bool(torch.isfinite(fetched.points).all())


def test_mapper_resident_cache_keys_meshes_by_content(solves):
    cache = MapperResidentBA(device="cpu")
    p1, _ = cache.solve(solves["tp"], solves["to"], cg_iters=CG_ITERS,
                        mesh=ShardMesh(["cpu"] * 2))
    assert (cache.hits, cache.misses) == (0, 1)
    # another mesh object of the same content hits
    p2, s2 = cache.solve(p1, solves["to"], cg_iters=CG_ITERS,
                         mesh=ShardMesh([torch.device("cpu")] * 2))
    assert (cache.hits, cache.misses) == (1, 1)
    # another layout, or no mesh, misses
    cache.solve(p2, solves["to"], cg_iters=CG_ITERS,
                mesh=ShardMesh(["cpu"] * 4))
    assert (cache.hits, cache.misses) == (1, 2)
    with pytest.raises(ValueError):
        cache.solve(solves["tp"], solves["to"], cg_iters=CG_ITERS,
                    mesh=ShardMesh(["cpu"] * 3))


def test_public_bundle_adjustment_on_mesh(tmp_path):
    """pipeline.bundle_adjustment with ``devices`` a 2-shard mesh matches
    ``devices="none"`` (tests/test_mesh_pipeline.py:53-80)."""
    rec = build_synthetic_reconstruction(num_images=5, num_points=120, seed=7)
    rng = np.random.default_rng(0)
    for pt in rec.points3D.values():
        pt.xyz = pt.xyz + rng.normal(0, 0.01, 3)
    rec.write_binary(tmp_path)
    rec_mesh, rec_single = Reconstruction(tmp_path), Reconstruction(tmp_path)
    before = rec_single.compute_mean_reprojection_error()
    opt_mesh = BundleAdjustmentOptions(print_summary=False,
                                       max_num_iterations=30,
                                       devices=ShardMesh(["cpu"] * 2))
    opt_single = BundleAdjustmentOptions(print_summary=False,
                                         max_num_iterations=30,
                                         devices="none")
    s_mesh = bundle_adjustment(rec_mesh, opt_mesh, device="cpu")
    s_single = bundle_adjustment(rec_single, opt_single, device="cpu",
                                 dense_schur_max_d=0)
    assert s_mesh is not None and s_single is not None
    e_mesh = rec_mesh.compute_mean_reprojection_error()
    e_single = rec_single.compute_mean_reprojection_error()
    assert e_single < before
    assert e_mesh == pytest.approx(e_single, rel=1e-2, abs=1e-3)
