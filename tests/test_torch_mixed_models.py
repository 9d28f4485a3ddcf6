"""Mixed-camera-model bundles in the port vs the reference on the CPU.

A bundle whose cameras span several models carries ``model_id`` as a tuple
of the distinct ids and one more intrinsics column, each camera's model id
(the selector, at ``mixed_sel_index``). Inputs are drawn from numpy seeds
and handed to both packages: the camera projections, the where-selected
residual and Jacobian, the plain versions of the tuple resjac / cost /
finish kernels against the reference's Pallas kernels in interpret mode,
the parameter gather, the bundle problem, both solvers and the two
known-pose entry points. Tolerances are the reference's own
(tests/test_mixed_models.py, tests/test_cg_kernel_fused.py,
tests/test_torch_solver.py). Both packages are pinned to the implicit
Schur-PCG path (the reference by PYCOLMAP_TPU_DENSE_SCHUR_MAX_D=0, the
port by dense_schur_max_d=0); tests/test_torch_dense_schur.py holds their
default dense path on a two-model bundle.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pycolmap_tpu.geometry import Rigid3d as JRigid3d
from pycolmap_tpu.geometry import Rotation3d as JRotation3d
from pycolmap_tpu.ops import ba_math as jbm
from pycolmap_tpu.ops import camera_models as jcm
from pycolmap_tpu.pipeline.sfm import IncrementalPipelineOptions as JPipe
from pycolmap_tpu.pipeline.sfm import bundle_adjustment as j_bundle_adjustment
from pycolmap_tpu.pipeline.sfm import triangulate_points as j_triangulate_points
from pycolmap_tpu.scene import Camera as JCamera
from pycolmap_tpu.scene import Image as JImage
from pycolmap_tpu.scene import Reconstruction as JRec
from pycolmap_tpu.scene.track import Track as JTrack
from pycolmap_tpu.scene.track import TrackElement as JTrackElement
from pycolmap_tpu.sfm import ba_kernels as jbk
from pycolmap_tpu.sfm import cg_kernel as jck
from pycolmap_tpu.sfm import resident as jres
from pycolmap_tpu.sfm.bundle_adjustment import BundleAdjustmentOptions as JOpt
from pycolmap_tpu.sfm.problem import build_bundle_problem as j_build
from pycolmap_torch import convert
from pycolmap_torch.ops import ba_math as tbm
from pycolmap_torch.ops import camera_models as tcm
from pycolmap_torch.parallel.synthetic import make_synthetic_bundle as tsyn
from pycolmap_torch.pipeline import bundle_adjustment, triangulate_points
from pycolmap_torch.scene import Reconstruction
from pycolmap_torch.sfm import ba_kernels as tbk
from pycolmap_torch.sfm import cg_kernel as tck
from pycolmap_torch.sfm import resident as tres
from pycolmap_torch.sfm.problem import apply_bundle_solution as t_apply
from pycolmap_torch.sfm.problem import build_bundle_problem as t_build

from test_incremental_mapping import make_synthetic_database
from test_torch_cg_kernel import check_cost_walk, walk_buckets
from test_mixed_models import make_mixed_problem as j_make_mixed_problem

SIMPLE_PINHOLE, PINHOLE, SIMPLE_RADIAL, OPENCV, FULL_OPENCV, FOV = (
    0, 1, 2, 4, 6, 7)
# (models, the FOV camera's omega): two models of one width, and three
# widths with FOV at omega ~ 0 (its tan division is near 0 / 0 there)
TUPLES = [((PINHOLE, SIMPLE_RADIAL), None),
          ((SIMPLE_PINHOLE, FULL_OPENCV, FOV), 1e-9)]
T, P, I = 4, 128, 6


@pytest.fixture(autouse=True)
def _one_thread_and_implicit_reference(monkeypatch):
    """Pin the reference to its implicit PCG path, and PyTorch to one
    intra-op thread (parallel test workers' thread pools would contend)."""
    monkeypatch.setenv("PYCOLMAP_TPU_DENSE_SCHUR_MAX_D", "0")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close_scaled(got, ref, atol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got / scale, ref / scale, atol=atol)


def _mixed_intrinsics(rng, models, C, omega=None):
    """[C, NP] intrinsics of C cameras cycling through `models`, the
    selector column last; intr_free random, 0 at the selector."""
    NP = tcm.solver_num_params(models)
    intr = np.zeros((C, NP), np.float32)
    for c in range(C):
        info = tcm.CAMERA_MODEL_BY_ID[models[c % len(models)]]
        for i in info.focal_idxs:
            intr[c, i] = 400.0 + 30.0 * rng.normal()
        intr[c, info.principal_idxs[0]] = 320.0
        intr[c, info.principal_idxs[1]] = 240.0
        for i in info.extra_idxs:
            intr[c, i] = rng.uniform(-0.05, 0.05)
        if info.name == "FOV":
            intr[c, info.extra_idxs[0]] = omega
        intr[c, NP - 1] = info.model_id
    intr_free = (rng.uniform(size=(C, NP)) > 0.3).astype(np.float32)
    intr_free[:, NP - 1] = 0.0
    return intr, intr_free


# ---------------------------------------------------------------------------
# camera projections
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("models,omega", TUPLES)
def test_img_from_cam_tuple_matches_reference(models, omega):
    rng = np.random.default_rng(1)
    intr, _ = _mixed_intrinsics(rng, models, 6, omega or 0.8)
    params = np.repeat(intr, 5, axis=0)  # 30 points, 5 per camera
    uv = rng.uniform(-0.4, 0.4, (30, 2)).astype(np.float32)
    got = tcm.img_from_cam(models, torch.from_numpy(params),
                           torch.from_numpy(uv)).numpy()
    want = np.asarray(jcm.img_from_cam_fixed(models)(jnp.asarray(params),
                                                     jnp.asarray(uv)))
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # each point as its own camera's single-model projection
    for i in range(30):
        m = int(params[i, -1])
        one = tcm.img_from_cam(m, torch.from_numpy(params[i]),
                               torch.from_numpy(uv[i])).numpy()
        np.testing.assert_allclose(got[i], one, rtol=1e-6)
    # the component-first projection of the solver, against the reference's
    k = tuple(params.T)
    gx, gy = tbm.img_from_cam_cf(models, tuple(torch.from_numpy(a) for a in k),
                                 torch.from_numpy(uv[:, 0]),
                                 torch.from_numpy(uv[:, 1]))
    wx, wy = jbm.img_from_cam_cf(models, tuple(jnp.asarray(a) for a in k),
                                 jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]))
    np.testing.assert_allclose(np.stack([gx, gy]), np.stack([wx, wy]),
                               rtol=1e-6)


def test_mixed_with_fov_is_nan_safe():
    """tests/test_mixed_models.py's case: FOV's omega division on another
    model's all-zero extra parameters must not leak through the select."""
    models = (PINHOLE, FOV)
    sel = tcm.mixed_sel_index(models)
    params = np.zeros((1, max(tcm.MAX_PARAMS, sel + 1)), np.float32)
    params[0, :4] = [500.0, 520.0, 320.0, 240.0]  # PINHOLE; omega column 0
    params[0, sel] = PINHOLE
    uv = np.array([[0.3, 0.2]], np.float32)
    out = tcm.img_from_cam(models, torch.from_numpy(params),
                           torch.from_numpy(uv)).numpy()
    assert np.all(np.isfinite(out))
    want = np.asarray(jcm.img_from_cam_fixed(PINHOLE)(
        jnp.asarray(params[0, :4]), jnp.asarray(uv[0])))
    np.testing.assert_allclose(out[0], want, rtol=1e-6)
    # and an id naming no listed model maps to 0, as in the reference
    params[0, sel] = SIMPLE_RADIAL
    out = tcm.img_from_cam(models, torch.from_numpy(params),
                           torch.from_numpy(uv)).numpy()
    assert np.array_equal(out, np.zeros((1, 2), np.float32))


def test_cam_from_img_tuple_inverts_each_model():
    rng = np.random.default_rng(2)
    models = (SIMPLE_RADIAL, OPENCV)
    intr, _ = _mixed_intrinsics(rng, models, 4)
    params = np.repeat(intr, 4, axis=0)
    uv = rng.uniform(-0.3, 0.3, (16, 2)).astype(np.float32)
    xy = tcm.img_from_cam(models, torch.from_numpy(params),
                          torch.from_numpy(uv))
    back = tcm.cam_from_img(models, torch.from_numpy(params), xy).numpy()
    np.testing.assert_allclose(back, uv, atol=1e-5)
    for m in models:
        rows = params[:, -1] == m
        want = np.asarray(jcm.cam_from_img_fixed(m)(
            jnp.asarray(params[rows]), jnp.asarray(xy[rows].numpy())))
        np.testing.assert_allclose(back[rows], want, atol=1e-5)


# ---------------------------------------------------------------------------
# the where-selected residual and Jacobian, and the kernels' plain versions
# ---------------------------------------------------------------------------


def _bucket_case(seed, models, omega):
    """numpy inputs of one bucket: 4 cameras cycling through the models,
    the last one's selector naming no listed model (the reference's
    where-chains give it the first model's Jacobian and pixel 0), ~30%
    mask holes, ~20% fixed points, every point behind image 0."""
    rng = np.random.default_rng(seed)
    C = 4
    intr, intr_free = _mixed_intrinsics(rng, models, C, omega)
    intr[C - 1, -1] = min(set(range(11)) - set(models))
    bucket = dict(
        img_idx=rng.integers(0, I, (T, P)).astype(np.int32),
        cam_idx=rng.integers(0, C, (T, P)).astype(np.int32),
        xy=rng.uniform(0, 640, (2, T, P)).astype(np.float32),
        mask=(rng.uniform(size=(T, P)) > 0.3).astype(np.float32),
        points=rng.normal(size=(3, P)).astype(np.float32),
        point_free=(rng.uniform(size=P) > 0.2).astype(np.float32),
        point_rows=np.arange(P, dtype=np.int32),
    )
    quat = rng.normal(size=(I, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    trans = rng.normal(size=(I, 3)).astype(np.float32)
    trans[:, 2] += 8.0
    trans[0, 2] = -30.0
    return dict(bucket=bucket, quat=quat, trans=trans, intr=intr,
                intr_free=intr_free, rng=rng, C=C)


def _jb(case):
    return jbk.Bucket(**{k: jnp.asarray(v) for k, v in case["bucket"].items()})


def _tb(case):
    return tbk.Bucket(**{k: torch.from_numpy(v)
                         for k, v in case["bucket"].items()})


def _j(a):
    return jnp.asarray(np.asarray(a))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("models,omega", TUPLES)
def test_bucket_res_and_jac_tuple_matches_reference(models, omega):
    case = _bucket_case(3, models, omega or 0.8)
    b = case["bucket"]
    gather = lambda tab, idx: tuple(tab[:, c][idx]  # noqa: E731
                                    for c in range(tab.shape[1]))
    args = [gather(case["quat"], b["img_idx"]),
            gather(case["trans"], b["img_idx"]),
            gather(case["intr"], b["cam_idx"]),
            gather(case["intr_free"], b["cam_idx"])]
    res_j, J_j = jbk._bucket_res_and_jac(
        models, _jb(case), *[tuple(jnp.asarray(a) for a in x) for x in args])
    res_t, J_t = tbk._bucket_res_and_jac(
        models, _tb(case), *[tuple(torch.from_numpy(a) for a in x)
                             for x in args])
    NP = tcm.solver_num_params(models)
    assert J_t.shape == (2, 9 + NP, T, P)
    assert torch.isfinite(J_t).all() and torch.isfinite(res_t).all()
    _close_scaled(res_t, res_j, 1e-4)
    _close_scaled(J_t, J_j, 1e-4)
    assert not J_t[:, 6 + NP - 1].any()  # the selector's column


def _resjac_both(case, models, loss_type, scale):
    jb = _jb(case)
    ref = jck.res_and_jac(
        [jb], [jb.points], _j(case["quat"]), _j(case["trans"]),
        _j(case["intr"]), _j(case["intr_free"]), models, loss_type,
        jnp.float32(scale), interpret=True,
    )
    tb = _tb(case)
    got = tck.res_and_jac(
        [tb], [tb.points], _t(case["quat"]), _t(case["trans"]),
        _t(case["intr"]), _t(case["intr_free"]), models, loss_type, scale,
    )
    return ref, got


@pytest.mark.parametrize("loss_type", [0, 2])
@pytest.mark.parametrize("models,omega", TUPLES)
def test_resjac_tuple_matches_pallas(models, omega, loss_type):
    case = _bucket_case(10 + loss_type, models, omega or 0.8)
    (ref_res, ref_J), (got_res, got_J) = _resjac_both(case, models,
                                                      loss_type, 1.5)
    _close_scaled(got_res[0], ref_res[0], 1e-5)
    _close_scaled(got_J[0], ref_J[0], 1e-5)


@pytest.mark.parametrize("models,omega", TUPLES)
def test_total_cost_tuple_matches_pallas(models, omega):
    case = _bucket_case(20, models, omega or 0.8)
    jb = _jb(case)
    ref = float(jck.total_cost(
        [jb], [jb.points], _j(case["quat"]), _j(case["trans"]),
        _j(case["intr"]), models, 1, jnp.float32(1.5), interpret=True))
    tb = _tb(case)
    got = float(tck.total_cost(
        [tb], [tb.points], _t(case["quat"]), _t(case["trans"]),
        _t(case["intr"]), models, 1, 1.5))
    np.testing.assert_allclose(got, ref, rtol=1e-5)


@pytest.mark.parametrize("models,omega", TUPLES)
def test_backsub_and_cost_tuple_matches_pallas(models, omega):
    case = _bucket_case(30, models, omega or 0.8)
    rng, C = case["rng"], case["C"]
    NP = tcm.solver_num_params(models)
    (_, ref_J), _ = _resjac_both(case, models, 1, 1.5)
    J = np.asarray(ref_J[0])
    Vinv = rng.normal(scale=1e-3, size=(6, P)).astype(np.float32)
    g_pt = rng.normal(size=(3, P)).astype(np.float32)
    x_pose = rng.normal(scale=1e-3, size=(I, 6)).astype(np.float32)
    x_intr = rng.normal(scale=1e-3, size=(C, NP)).astype(np.float32)
    x_intr *= case["intr_free"]  # the solver's step: 0 at the selector
    q = case["quat"]
    nq = jbm.quat_boxplus_cf(tuple(jnp.asarray(q[:, i]) for i in range(4)),
                             tuple(jnp.asarray(-x_pose[:, i])
                                   for i in range(3)))
    new_quat = np.stack([np.asarray(a) for a in nq], axis=1)
    new_trans = case["trans"] - x_pose[:, 3:6]
    new_intr = case["intr"] - x_intr
    jb = _jb(case)
    ref_pts, ref_cost = jck.backsub_and_cost(
        [jb], [jb.points], [_j(J)], [_j(Vinv)], [_j(g_pt)], _j(x_pose),
        _j(x_intr), _j(new_quat), _j(new_trans), _j(new_intr), models, 1,
        jnp.float32(1.5), interpret=True,
    )
    tb = _tb(case)
    got_pts, got_cost = tck.backsub_and_cost(
        [tb], [tb.points], [_t(J)], [_t(Vinv)], [_t(g_pt)], _t(x_pose),
        _t(x_intr), _t(new_quat), _t(new_trans), _t(new_intr), models, 1,
        1.5,
    )
    _close_scaled(got_pts[0], ref_pts[0], 1e-5)
    np.testing.assert_allclose(float(got_cost), float(ref_cost), rtol=1e-4)


@pytest.mark.parametrize("models,omega", TUPLES)
def test_cost_finish_walk_tuple_matches_pallas(models, omega):
    """The cost and finish kernels' walk of their table on a tuple model
    (test_torch_cg_kernel.py's cost_walk: live slots only, tile partials
    in a fixed order) against the reference's Pallas kernels (interpret
    mode) and the plain versions: the bench's empty [4, 128] bucket beside
    a [8, 256] one of tracks of lengths 1..8 and padding columns.
    Tolerance 1e-5 scaled."""
    case = _bucket_case(50, models, omega or 0.8)
    tables = (case["quat"], case["trans"], case["intr"], case["intr_free"])
    check_cost_walk(tables, walk_buckets(51, I, case["C"]), models, 1, 52)


def test_card_wrappers_take_the_mixed_launchers(monkeypatch):
    """On a CUDA tensor a tuple model_id goes to the *_mixed launcher with
    the width and the ids' bit mask, and resjac's also with the first id;
    an int to the single-model one. (CPU tensors stand in for CUDA ones
    here.)"""
    calls = []
    for name in ("resjac", "cost", "resjac_mixed", "cost_mixed"):
        monkeypatch.setattr(tck._cuda, name,
                            lambda *a, _n=name: calls.append((_n, a[:3])))
    # the bucket tables hold device pointers: none here
    monkeypatch.setattr(tck._cuda, "cost_table", lambda *a: None)
    monkeypatch.setattr(tck._cuda, "resjac_table", lambda *a: None)
    monkeypatch.setattr(tck._cuda, "set_points", lambda *a: None)
    monkeypatch.setattr(tck, "_is_cuda", lambda t: True)
    tck.reset_counts()
    models = (SIMPLE_PINHOLE, FULL_OPENCV, FOV)
    case = _bucket_case(40, models, 0.8)
    tb = _tb(case)
    tables = (_t(case["quat"]), _t(case["trans"]), _t(case["intr"]))
    tck.res_and_jac([tb], [tb.points], *tables, _t(case["intr_free"]),
                    models, 0, 1.0)
    tck.total_cost([tb], [tb.points], *tables, models, 0, 1.0)
    tck.total_cost([tb], [tb.points], *tables, SIMPLE_RADIAL, 0, 1.0)
    mask = (1 << 0) | (1 << 6) | (1 << 7)
    assert [c[0] for c in calls] == ["resjac_mixed", "cost_mixed", "cost"]
    assert calls[0][1] == (13, mask, SIMPLE_PINHOLE)
    assert calls[1][1][:2] == (13, mask)
    assert isinstance(calls[1][1][2], tck.CostLaunch)  # no first id
    assert calls[2][1][0] == SIMPLE_RADIAL
    assert tck.LAUNCHES["resjac_mixed"] == tck.LAUNCHES["cost_mixed"] == 1
    assert tck.LAUNCHES["cost"] == 1 and not any(tck.PLAIN_ON_CUDA.values())


# ---------------------------------------------------------------------------
# the parameter gather
# ---------------------------------------------------------------------------


def test_gather_params_bucket_equals_reference():
    rng = np.random.default_rng(5)
    Tg, Pg, Ig, Cg = 8, 256, 150, 3
    itab = np.zeros((8, 256), np.float32)
    itab[:, :Ig] = rng.normal(size=(8, Ig))
    ctab = np.zeros((16, 128), np.float32)
    ctab[:, :Cg] = rng.normal(size=(16, Cg))
    ii = rng.integers(0, Ig, (Tg, Pg)).astype(np.int32)
    ci = rng.integers(0, Cg, (Tg, Pg)).astype(np.int32)
    ref = jck.gather_params_bucket(_j(itab), _j(ctab), _j(ii), _j(ci),
                                   interpret=True)
    got = tck.gather_params_bucket(_t(itab), _t(ctab), _t(ii), _t(ci))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    # unpadded tables give the same values; an index outside a table gives 0
    got = tck.gather_params_bucket(_t(itab[:, :Ig]), _t(ctab[:, :Cg]),
                                   _t(ii), _t(ci))
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))
    ii[0, :5] = [-1, Ig, Ig + 7, 0, -3]
    out_i, _ = tck.gather_params_bucket(_t(itab[:, :Ig]), _t(ctab[:, :Cg]),
                                        _t(ii), _t(ci))
    assert not out_i[:, 0, [0, 1, 2, 4]].any()
    assert np.array_equal(out_i[:, 0, 3].numpy(), itab[:, 0])


@pytest.mark.parametrize("models,omega", TUPLES)
def test_gather_obs_params_and_x_equal_reference(models, omega):
    case = _bucket_case(50, models, omega or 0.8)
    rng, C = case["rng"], case["C"]
    NP = tcm.solver_num_params(models)
    jb, tb = _jb(case), _tb(case)
    ref = jck.gather_obs_params(jb, _j(case["quat"]), _j(case["trans"]),
                                _j(case["intr"]), interpret=True)
    got = tck.gather_obs_params(tb, _t(case["quat"]), _t(case["trans"]),
                                _t(case["intr"]))
    assert [len(g) for g in got] == [4, 3, NP]
    for gs, rs in zip(got, ref):
        for g, r in zip(gs, rs):
            assert np.array_equal(g.numpy(), np.asarray(r))
    x_pose = rng.normal(size=(I, 6)).astype(np.float32)
    x_intr = rng.normal(size=(C, NP)).astype(np.float32)
    ref = jck.gather_x(jb, _j(x_pose), _j(x_intr), interpret=True)
    got = tck.gather_x(tb, _t(x_pose), _t(x_intr))
    assert got[0].shape == (6, T, P) and got[1].shape == (NP, T, P)
    for g, r in zip(got, ref):
        assert np.array_equal(g.numpy(), np.asarray(r))


# ---------------------------------------------------------------------------
# the bundle problem, the solvers and the entry points
# ---------------------------------------------------------------------------

# (camera model, params) of the mixed reconstructions: a SIMPLE_RADIAL and
# an OPENCV camera (width 9), or those and a FULL_OPENCV one (width 13)
CAMERAS = {
    "SIMPLE_RADIAL": [600.0, 320.0, 240.0, -0.03],
    "OPENCV": [610.0, 605.0, 320.0, 240.0, 0.02, -0.01, 1e-3, -1e-3],
    "FULL_OPENCV": [590.0, 595.0, 320.0, 240.0, 0.01, 0.005, 5e-4, -5e-4,
                    1e-3, 0.002, 0.001, 0.0005],
}


def _write_mixed_model(path, cams, num_images=6, num_points=150, seed=7):
    """A ring of images around a point cloud, image i through camera
    i % len(cams) of its own model; keypoints projected in float64 through
    each camera's model plus 0.3 px noise, points then moved by 0.01."""
    rng = np.random.default_rng(seed)
    rec = JRec()
    for c, name in enumerate(cams):
        rec.add_camera(JCamera(c + 1, name, 640, 480,
                               np.array(CAMERAS[name])))
    target = np.array([0.0, 0.0, 5.0])
    points = rng.uniform(-1, 1, (num_points, 3)) + target
    for i in range(num_images):
        theta = -0.5 + i / (num_images - 1)
        center = target + 5.0 * np.array([np.sin(theta), 0.1 * np.sin(
            2 * theta), -np.cos(theta)])
        fwd = (target - center) / np.linalg.norm(target - center)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R = np.stack([right, np.cross(fwd, right), fwd])
        cam_id = i % len(cams) + 1
        img = JImage(name=f"image{i}.jpg", camera_id=cam_id, id=i + 1)
        img.cam_from_world = JRigid3d(JRotation3d(R), -R @ center)
        p_cam = img.cam_from_world * points
        xy = rec.cameras[cam_id].img_from_cam(p_cam[:, :2] / p_cam[:, 2:])
        img.set_keypoints(xy + rng.normal(0, 0.3, xy.shape))
        img.registered = True
        rec.add_image(img)
    for j in range(num_points):
        rec.add_point3D(points[j] + rng.normal(0, 0.01, 3), JTrack(
            [JTrackElement(i + 1, j) for i in range(num_images)]))
    rec.write_binary(path)


@pytest.mark.parametrize("cams", [("SIMPLE_RADIAL", "OPENCV"),
                                  ("SIMPLE_RADIAL", "OPENCV", "FULL_OPENCV")])
def test_build_bundle_problem_mixed(tmp_path, cams):
    _write_mixed_model(tmp_path, cams)
    jrec, trec = JRec(tmp_path), Reconstruction(tmp_path)
    jp, jm = j_build(jrec, JOpt())
    tp, tm = t_build(trec)
    ids = tuple(sorted(tcm.model_id_from_name(c) for c in cams))
    assert jp.model_id == tp.model_id == ids
    width = 9 if len(cams) == 2 else 13
    assert tp.intrinsics.shape[1] == max(tcm.MAX_PARAMS, width)
    for f in jp._fields:
        if f != "model_id":
            assert np.array_equal(np.asarray(getattr(jp, f)),
                                  getattr(tp, f).numpy()), f
    assert (tm.image_ids, tm.camera_ids, tm.point_ids) == (
        jm.image_ids, jm.camera_ids, jm.point_ids)
    sel = tcm.mixed_sel_index(ids)
    assert np.array_equal(tp.intrinsics[:, sel].numpy(), np.array(
        [tcm.model_id_from_name(trec.cameras[c].model)
         for c in tm.camera_ids], np.float32))
    assert not tp.intr_free[:, sel].any()
    # the write-back sets each camera's own parameters, never the selector
    moved = tp._replace(intrinsics=tp.intrinsics + 1.0)
    t_apply(trec, moved, tm)
    for k, c in enumerate(tm.camera_ids):
        cam = trec.cameras[c]
        assert len(cam.params) == len(CAMERAS[cam.model])
        np.testing.assert_allclose(cam.params, np.array(CAMERAS[cam.model])
                                   + 1.0, rtol=1e-6)
    # the problem crosses to the port with its tuple
    tp2 = convert.bundle_problem_from_numpy(
        {k: np.asarray(v) for k, v in jp._asdict().items() if k != "model_id"},
        jp.model_id)
    assert tp2.model_id == ids


def _port_mixed_problem(**kw):
    """tests/test_mixed_models.py make_mixed_problem with the port's
    generator: even images SIMPLE_RADIAL (k = 0), odd images PINHOLE."""
    problem = tsyn(num_images=kw.pop("num_images", 12),
                   num_points=kw.pop("num_points", 500), obs_per_point=4,
                   refine_intrinsics=True, **kw)
    focal, cx, cy = 1000.0, 2000.0, 1500.0
    models = tuple(sorted((PINHOLE, SIMPLE_RADIAL)))
    sel = tcm.mixed_sel_index(models)
    intr = np.zeros((2, max(tcm.MAX_PARAMS, sel + 1)), np.float32)
    intr[0, :4] = [focal, cx, cy, 0.0]
    intr[0, sel] = SIMPLE_RADIAL
    intr[1, :4] = [focal, focal, cx, cy]
    intr[1, sel] = PINHOLE
    intr_free = np.zeros_like(intr)
    intr_free[0, [0, 3]] = 1.0
    intr_free[1, [0, 1]] = 1.0
    obs_cam = (problem.obs_image_idx.numpy() % 2).astype(np.int32)
    return problem._replace(model_id=models,
                            intrinsics=torch.from_numpy(intr),
                            intr_free=torch.from_numpy(intr_free),
                            obs_camera_idx=torch.from_numpy(obs_cam))


def _close_problem(got, ref, atol=1e-3):
    for f in ("cam_quat", "cam_trans", "intrinsics", "points"):
        g, r = np.asarray(getattr(got, f)), np.asarray(getattr(ref, f))
        assert g.shape == r.shape, f
        scale = max(np.abs(r).max(), 1.0) if f == "intrinsics" else 1.0
        np.testing.assert_allclose(g / scale, r / scale, atol=atol,
                                   err_msg=f)


def _solver_options():
    jo = JOpt()
    jo.max_num_iterations = 30
    jo.print_summary = False
    jo.devices = "none"
    return jo, convert.ba_options_from_dict(jo.todict())


def test_solve_bundle_fast_mixed_matches_reference():
    jp = j_make_mixed_problem(seed=5)
    tp = _port_mixed_problem(seed=5)
    # the port's generator draws the reference's problem
    for f in jp._fields:
        if f != "model_id":
            np.testing.assert_allclose(getattr(tp, f).numpy(),
                                       np.asarray(getattr(jp, f)), atol=1e-5)
    jo, to = _solver_options()
    jr, js = jbk.solve_bundle_fast(jp, jo, cg_iters=20)
    tr, ts = tbk.solve_bundle_fast(tp, to, cg_iters=20, device="cpu",
                                   dense_schur_max_d=0)
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3)
    assert ts.final_cost < ts.initial_cost / 20
    _close_problem(tr, jr)
    sel = tcm.mixed_sel_index(tp.model_id)
    assert np.array_equal(tr.intrinsics[:, sel].numpy(),
                          tp.intrinsics[:, sel].numpy())


def test_resident_solver_mixed_matches_reference():
    jp = j_make_mixed_problem(seed=6)
    tp = _port_mixed_problem(seed=6)
    jo, to = _solver_options()
    js_ = jres.ResidentBundleSolver(jp, jo, cg_iters=20)
    ts_ = tres.ResidentBundleSolver(tp, to, cg_iters=20, device="cpu",
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
    got = ts_.fetch_problem()
    _close_problem(got, js_.fetch_problem())
    sel = tcm.mixed_sel_index(tp.model_id)
    assert np.array_equal(got.intrinsics[:, sel].numpy(),
                          tp.intrinsics[:, sel].numpy())


def test_bundle_adjustment_mixed_matches_reference(tmp_path):
    _write_mixed_model(tmp_path / "in", ("SIMPLE_RADIAL", "OPENCV"))
    jrec, trec = JRec(tmp_path / "in"), Reconstruction(tmp_path / "in")
    err_before = trec.compute_mean_reprojection_error()
    jo, to = _solver_options()
    js = j_bundle_adjustment(jrec, jo)
    ts = bundle_adjustment(trec, to, device="cpu", dense_schur_max_d=0)
    assert trec.compute_mean_reprojection_error() < err_before
    assert ts.final_cost < ts.initial_cost
    assert ts.initial_cost == pytest.approx(js.initial_cost, rel=1e-5)
    assert ts.final_cost == pytest.approx(js.final_cost, rel=1e-3)
    for c in trec.cameras:  # scaled as _close_problem's intrinsics
        got, want = trec.cameras[c].params, jrec.cameras[c].params
        assert trec.cameras[c].model == jrec.cameras[c].model
        assert len(got) == len(want)
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-3)


def test_triangulate_points_mixed_matches_reference(tmp_path):
    db = tmp_path / "db.db"
    cams = [JCamera.create(0, "SIMPLE_RADIAL", 600.0, 640, 480),
            JCamera.create(0, "PINHOLE", 600.0, 640, 480)]
    gt = make_synthetic_database(db, num_images=6, num_points=200,
                                 cameras=cams)
    gt.write_binary(tmp_path / "gt")
    jrec, trec = JRec(tmp_path / "gt"), Reconstruction(tmp_path / "gt")
    assert {c.model for c in trec.cameras.values()} == {"SIMPLE_RADIAL",
                                                        "PINHOLE"}
    jo = JPipe()
    jo.devices = "none"
    to = convert.pipeline_options_from_dict(jo.todict())
    j_triangulate_points(jrec, db, tmp_path, tmp_path / "tri_j",
                         clear_points=True, options=jo, refine_intrinsics=True)
    out = triangulate_points(trec, db, tmp_path, tmp_path / "tri_t",
                             clear_points=True, options=to,
                             refine_intrinsics=True, device="cpu",
                             dense_schur_max_d=0)
    assert out.num_points3D > 100
    assert out.compute_mean_reprojection_error() < 1.5
    out.check()
    assert abs(out.num_points3D - jrec.num_points3D) <= 0.01 * jrec.num_points3D
    np.testing.assert_allclose(out.compute_mean_reprojection_error(),
                               jrec.compute_mean_reprojection_error(),
                               rtol=1e-3)


def test_resident_cache_keys_each_model_set(tmp_path):
    """The mapper's resident-BA cache on a two-model scene: a window of one
    model's images solves as an int-model problem on that model's planes,
    the whole scene as a tuple problem with the selector plane; each is its
    own entry, and a repeated solve hits it."""
    _write_mixed_model(tmp_path, ("SIMPLE_RADIAL", "OPENCV"))
    trec = Reconstruction(tmp_path)
    cache = tres.MapperResidentBA(device="cpu", dense_schur_max_d=0)
    opts = convert.ba_options_from_dict({})
    one, _ = t_build(trec, opts, image_ids=[1, 3, 5],
                     constant_pose_ids=[1])
    both, _ = t_build(trec, opts, constant_pose_ids=[1])
    assert one.model_id == SIMPLE_RADIAL and both.model_id == (
        SIMPLE_RADIAL, OPENCV)
    new_one, _ = cache.solve(one, opts)
    new_both, _ = cache.solve(both, opts)
    assert sorted(s._NP for s in cache._entries.values()) == [4, 9]
    assert cache.misses == 2 and cache.hits == 0
    # the next refinement round re-solves the written-back problems
    cache.solve(new_one, opts)
    cache.solve(new_both, opts)
    assert cache.misses == 2 and cache.hits == 2


def test_incremental_mapping_mixed_cameras(tmp_path):
    """incremental_mapping of an 8-image orbit whose images alternate
    between a SIMPLE_RADIAL and a PINHOLE camera (tests/test_mixed_models.py's
    mapping case at 8 images, judged at its bounds): its global BA solves
    tuple problems."""
    cameras = [JCamera.create(0, "SIMPLE_RADIAL", 600.0, 640, 480),
               JCamera.create(0, "PINHOLE", 600.0, 640, 480)]
    gt = make_synthetic_database(tmp_path / "db.db", num_images=8,
                                 num_points=200, pixel_noise=0.3,
                                 cameras=cameras)
    gt.write_binary(tmp_path / "gt")
    options = convert.pipeline_options_from_dict(JPipe().todict())
    options.min_model_size = 4
    options.extract_colors = False
    options.ba_refine_principal_point = False
    seen = []
    solve = tres.MapperResidentBA.solve

    def record(self, problem, *a, **kw):
        seen.append(problem.model_id)
        return solve(self, problem, *a, **kw)

    from pycolmap_torch.pipeline import incremental_mapping

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tres.MapperResidentBA, "solve", record)
        recs = incremental_mapping(tmp_path / "db.db", tmp_path,
                                   tmp_path / "sparse", options, device="cpu",
                                   dense_schur_max_d=0)
    rec = recs[0]
    assert rec.num_reg_images >= 7
    assert {c.model for c in rec.cameras.values()} == {"SIMPLE_RADIAL",
                                                       "PINHOLE"}
    assert rec.compute_mean_reprojection_error() < 1.0
    assert (PINHOLE, SIMPLE_RADIAL) in seen
    from pycolmap_torch.estimators import compare_reconstructions

    result = compare_reconstructions(rec, Reconstruction(tmp_path / "gt"),
                                     device="cpu")
    assert np.median([e.rotation_error_deg for e in result["errors"]]) < 0.5
