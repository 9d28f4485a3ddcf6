"""pycolmap_torch ops vs pycolmap_tpu ops on the CPU: quaternions, the 11
camera models and the component-first BA math, fed the same numpy inputs."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pycolmap_tpu.ops import ba_math as jbm
from pycolmap_tpu.ops import camera_models as jcm
from pycolmap_tpu.ops import quaternion as jq
from pycolmap_torch.ops import ba_math as tbm
from pycolmap_torch.ops import camera_models as tcm
from pycolmap_torch.ops import quaternion as tq


def _params(model_id, rng):
    """Padded parameters in the realistic range of each model."""
    info = tcm.CAMERA_MODEL_BY_ID[model_id]
    p = np.zeros(tcm.MAX_PARAMS, np.float32)
    for i in info.focal_idxs:
        p[i] = 500.0 + 50.0 * rng.uniform()
    p[info.principal_idxs[0]] = 320.0
    p[info.principal_idxs[1]] = 240.0
    for i in info.extra_idxs:
        p[i] = rng.uniform(-0.05, 0.05)
    if info.name == "FOV":
        p[info.extra_idxs[0]] = 0.8
    return p


def test_model_tables_match():
    assert tcm.MAX_PARAMS == jcm.MAX_PARAMS
    assert [tuple(m) for m in tcm.CAMERA_MODELS] == [
        tuple(m) for m in jcm.CAMERA_MODELS
    ]
    for m in jcm.CAMERA_MODELS:
        assert tcm.model_id_from_name(m.name) == m.model_id
        assert tcm.solver_num_params(m.model_id) == jcm.solver_num_params(
            m.model_id
        )
    assert tcm.solver_num_params((2, 4)) == jcm.solver_num_params((2, 4))


@pytest.mark.parametrize("model_id", list(range(11)))
def test_img_from_cam_matches(model_id):
    rng = np.random.default_rng(model_id)
    params = _params(model_id, rng)
    uv = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    ref = np.asarray(jcm.img_from_cam(model_id, jnp.asarray(params),
                                      jnp.asarray(uv)))
    got = tcm.img_from_cam(model_id, torch.from_numpy(params),
                           torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-3)


@pytest.mark.parametrize("model_id", list(range(11)))
def test_cam_from_img_matches(model_id):
    rng = np.random.default_rng(100 + model_id)
    params = _params(model_id, rng)
    xy = rng.uniform(50, 600, (64, 2)).astype(np.float32)
    ref = np.asarray(jcm.cam_from_img(model_id, jnp.asarray(params),
                                      jnp.asarray(xy)))
    got = tcm.cam_from_img(model_id, torch.from_numpy(params),
                           torch.from_numpy(xy)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("model_id", list(range(11)))
def test_project_cf_matches(model_id):
    rng = np.random.default_rng(200 + model_id)
    params = _params(model_id, rng)
    q = rng.normal(size=(4, 40)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    t = rng.normal(size=(3, 40)).astype(np.float32)
    t[2] += 6.0
    X = rng.normal(size=(3, 40)).astype(np.float32)
    X[:, :3] = [[0.0], [0.0], [-20.0]]  # some behind the camera
    k = [np.full(40, v, np.float32) for v in params]
    ref = jbm.project_cf(model_id, [jnp.asarray(a) for a in k],
                         tuple(jnp.asarray(a) for a in q),
                         tuple(jnp.asarray(a) for a in t),
                         tuple(jnp.asarray(a) for a in X))
    got = tbm.project_cf(model_id, [torch.from_numpy(a) for a in k],
                         tuple(torch.from_numpy(a) for a in q),
                         tuple(torch.from_numpy(a) for a in t),
                         tuple(torch.from_numpy(a) for a in X))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-3)


@pytest.mark.parametrize("name", [
    "matrix_to_quat", "axis_angle_to_quat", "quat_boxplus", "quat_rotate",
    "quat_to_axis_angle",
])
def test_quaternion_matches(name):
    rng = np.random.default_rng(7)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    aa = rng.normal(scale=0.3, size=(32, 3)).astype(np.float32)
    aa[0] = 0.0  # the series branch at the zero tangent
    v = rng.normal(size=(32, 3)).astype(np.float32)
    args = {
        "matrix_to_quat": (np.array(jq.quat_to_matrix(jnp.asarray(q))),),
        "axis_angle_to_quat": (aa,),
        "quat_boxplus": (q, aa),
        "quat_rotate": (q, v),
        "quat_to_axis_angle": (q,),
    }[name]
    ref = np.asarray(getattr(jq, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(tq, name)(*(torch.from_numpy(a) for a in args)).numpy()
    if name == "matrix_to_quat":  # q and -q are one rotation
        got = got * np.sign(got[:, :1] * ref[:, :1])
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_boxplus_cf_matches():
    rng = np.random.default_rng(9)
    q = rng.normal(size=(4, 50)).astype(np.float32)
    q /= np.linalg.norm(q, axis=0, keepdims=True)
    d = rng.normal(scale=1e-2, size=(3, 50)).astype(np.float32)
    ref = jbm.quat_boxplus_cf(tuple(jnp.asarray(a) for a in q),
                              tuple(jnp.asarray(a) for a in d))
    got = tbm.quat_boxplus_cf(tuple(torch.from_numpy(a) for a in q),
                              tuple(torch.from_numpy(a) for a in d))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=1e-6)


def _scaled_close(got, ref, tol=1e-6):
    """|got - ref| within tol of max(1, |ref|), NaN where ref is NaN."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = ~np.isnan(ref)
    scale = max(1.0, float(np.abs(ref[ok]).max(initial=0.0)))
    assert np.abs(got[ok] - ref[ok]).max(initial=0.0) <= tol * scale


@pytest.mark.parametrize("name", [
    "quat_angle", "rigid_transform", "rigid_compose", "rigid_inverse",
    "cross_matrix", "essential_from_pose", "project_center",
])
def test_quaternion_helpers_match(name):
    """The rigid-motion helpers against the reference's within 1e-6
    (float32); q and -q give one angle; a zero translation keeps
    essential_from_pose's 1e-12 floor (a zero matrix, no NaN)."""
    rng = np.random.default_rng(11)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    q2 = rng.normal(size=(32, 4)).astype(np.float32)
    q2 /= np.linalg.norm(q2, axis=1, keepdims=True)
    t = rng.normal(size=(32, 3)).astype(np.float32)
    t[0] = 0.0
    t2 = rng.normal(size=(32, 3)).astype(np.float32)
    p = rng.normal(size=(32, 3)).astype(np.float32)
    args = {
        "quat_angle": (q,), "rigid_transform": (q, t, p),
        "rigid_compose": (q, t, q2, t2), "rigid_inverse": (q, t),
        "cross_matrix": (t,), "essential_from_pose": (q, t),
        "project_center": (q, t),
    }[name]
    ref = getattr(jq, name)(*(jnp.asarray(a) for a in args))
    got = getattr(tq, name)(*(torch.from_numpy(a) for a in args))
    ref = ref if isinstance(ref, tuple) else (ref,)
    got = got if isinstance(got, tuple) else (got,)
    for g, r in zip(got, ref, strict=True):
        assert g.dtype == torch.float32
        _scaled_close(g.numpy(), np.asarray(r))
    if name == "quat_angle":
        neg = tq.quat_angle(torch.from_numpy(-q)).numpy()
        np.testing.assert_array_equal(neg, got[0].numpy())
    if name == "essential_from_pose":
        assert np.all(got[0].numpy()[0] == 0.0)


def test_rigid_compose_inverse():
    """tests/test_geometry.py's case: a pose composed with its inverse is
    the identity."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(14)
    xyzw = Rotation.random(random_state=rng).as_quat()
    q = torch.tensor(xyzw[[3, 0, 1, 2]], dtype=torch.float32)
    t = torch.tensor(rng.standard_normal(3), dtype=torch.float32)
    qi, ti = tq.rigid_inverse(q, t)
    qc, tc = tq.rigid_compose(q, t, qi, ti)
    assert np.abs(tc.numpy()).max() < 1e-5
    assert abs(abs(float(qc[0])) - 1) < 1e-5


@pytest.mark.parametrize("model_id", list(range(11)))
def test_fixed_projections_match(model_id):
    """img_from_cam_fixed / cam_from_img_fixed closures and
    calibration_matrix against the reference's within 1e-6 of the output's
    magnitude (float32), and pad_params."""
    rng = np.random.default_rng(300 + model_id)
    params = _params(model_id, rng)
    uv = rng.uniform(-0.6, 0.6, (64, 2)).astype(np.float32)
    xy = rng.uniform(50, 600, (64, 2)).astype(np.float32)
    jp, tp = jnp.asarray(params), torch.from_numpy(params)
    _scaled_close(tcm.img_from_cam_fixed(model_id)(tp, torch.from_numpy(uv)),
                  jcm.img_from_cam_fixed(model_id)(jp, jnp.asarray(uv)))
    _scaled_close(tcm.cam_from_img_fixed(model_id)(tp, torch.from_numpy(xy)),
                  jcm.cam_from_img_fixed(model_id)(jp, jnp.asarray(xy)))
    _scaled_close(tcm.calibration_matrix(model_id, tp[None].repeat(3, 1)),
                  jcm.calibration_matrix(model_id, jnp.tile(jp, (3, 1))))
    n = tcm.num_params_for_model(model_id)
    padded = tcm.pad_params(params[:n].astype(np.float64))
    assert padded.dtype == torch.float32 and padded.shape == (tcm.MAX_PARAMS,)
    np.testing.assert_array_equal(padded.numpy(),
                                  np.asarray(jcm.pad_params(params[:n])))


def test_img_from_cam_fixed_mixed_matches():
    """The tuple form (SIMPLE_RADIAL, FOV): each point is projected by the
    model its selector column names; a SIMPLE_RADIAL camera's NaN in the
    FOV-only omega column never reaches its output, and a selector naming
    no listed model maps to 0, as the reference's."""
    rng = np.random.default_rng(17)
    models = (2, 7)
    sel = jcm.mixed_sel_index(models)
    rows = []
    for k in range(40):
        m = (2, 7, 3)[k % 3]  # 3 names no listed model
        p = np.zeros(tcm.MAX_PARAMS + 1, np.float32)
        p[:tcm.MAX_PARAMS] = _params(m if m != 3 else 2, rng)
        if m == 2:
            p[4] = np.nan  # omega, read only by FOV
        p[sel] = m
        rows.append(p)
    params = np.stack(rows)
    uv = rng.uniform(-0.5, 0.5, (40, 2)).astype(np.float32)
    ref = np.asarray(jcm.img_from_cam_fixed(models)(jnp.asarray(params),
                                                    jnp.asarray(uv)))
    got = tcm.img_from_cam_fixed(models)(torch.from_numpy(params),
                                         torch.from_numpy(uv)).numpy()
    assert np.all(np.isfinite(got))
    assert np.all(got[2::3] == 0.0)
    _scaled_close(got, ref)


def test_reference_keywords():
    """The reference's keyword calls of img_from_cam_cf and project_cf run
    on the port and agree with it."""
    rng = np.random.default_rng(21)
    params = _params(4, rng)
    k = [np.full(8, v, np.float32) for v in params]
    u, v = (rng.uniform(-0.5, 0.5, 8).astype(np.float32) for _ in range(2))
    ref = jbm.img_from_cam_cf(model_id_static=4,
                              params=[jnp.asarray(a) for a in k],
                              u=jnp.asarray(u), v=jnp.asarray(v))
    got = tbm.img_from_cam_cf(model_id_static=4,
                              params=[torch.from_numpy(a) for a in k],
                              u=torch.from_numpy(u), v=torch.from_numpy(v))
    for g, r in zip(got, ref, strict=True):
        _scaled_close(g.numpy(), np.asarray(r))
    q = (np.ones(8, np.float32),) + tuple(np.zeros(8, np.float32)
                                          for _ in range(3))
    t = (np.zeros(8, np.float32), np.zeros(8, np.float32),
         np.full(8, 5.0, np.float32))
    X = tuple(rng.normal(size=8).astype(np.float32) for _ in range(3))
    ref = jbm.project_cf(model_id_static=4, intr=[jnp.asarray(a) for a in k],
                         quat=tuple(map(jnp.asarray, q)),
                         trans=tuple(map(jnp.asarray, t)),
                         X=tuple(map(jnp.asarray, X)))
    got = tbm.project_cf(model_id_static=4,
                         intr=[torch.from_numpy(a) for a in k],
                         quat=tuple(map(torch.from_numpy, q)),
                         trans=tuple(map(torch.from_numpy, t)),
                         X=tuple(map(torch.from_numpy, X)))
    for g, r in zip(got, ref, strict=True):
        _scaled_close(g.numpy(), np.asarray(r))
