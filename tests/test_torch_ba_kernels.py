"""pycolmap_torch bundle-problem plumbing vs pycolmap_tpu on the CPU:
the synthetic generator, bucketize, the NP-narrow analytic Jacobian of all
11 camera models, and the port's boundary (conversion, no JAX imports, no
silent CPU fallback)."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pycolmap_tpu.ops.camera_models import CAMERA_MODEL_BY_ID
from pycolmap_tpu.parallel.synthetic import make_synthetic_bundle as jsyn
from pycolmap_tpu.sfm import ba_kernels as jbk
from pycolmap_tpu.sfm.bundle_adjustment import BundleAdjustmentOptions as JOpt
from pycolmap_tpu.sfm.bundle_adjustment import LossFunctionType as JLoss
from pycolmap_torch import convert
from pycolmap_torch.parallel.synthetic import make_synthetic_bundle as tsyn
from pycolmap_torch.sfm import ba_kernels as tbk

REPO = Path(__file__).resolve().parents[1]
SYN = dict(num_images=10, num_points=700, obs_per_point=5, pose_noise=0.05,
           point_noise=0.1, refine_intrinsics=True, seed=3)


@pytest.fixture(scope="module")
def problems():
    return jsyn(**SYN), tsyn(**SYN)


def _fields(p):
    return [f for f in p._fields if f != "model_id"]


def test_synthetic_bundle_matches(problems):
    jp, tp = problems
    assert tp.model_id == jp.model_id
    for f in _fields(jp):
        ref = np.asarray(getattr(jp, f))
        got = np.asarray(getattr(tp, f))
        assert got.shape == ref.shape and got.dtype == ref.dtype, f
        np.testing.assert_allclose(got, ref, atol=1e-6, err_msg=f)


def test_bucketize_matches_exactly(problems):
    jp, tp = problems
    # knock out a third of the observations: mixed track lengths, holes
    mask = np.asarray(jp.obs_mask).copy()
    mask[np.random.default_rng(0).choice(len(mask), len(mask) // 3,
                                         replace=False)] = 0.0
    jb = jbk.bucketize(jp._replace(obs_mask=jnp.asarray(mask)))
    tb = tbk.bucketize(tp._replace(obs_mask=torch.from_numpy(mask)))
    assert len(tb) == len(jb) >= 2
    for b_t, b_j in zip(tb, jb):
        for name in b_j._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(b_t, name)), np.asarray(getattr(b_j, name)),
                err_msg=name)


@pytest.mark.parametrize("model_id", list(range(11)))
def test_bucket_res_and_jac_matches(model_id):
    """NP-narrow residual + analytic Jacobian for every camera model
    (tolerance of the reference's own cross-check,
    tests/test_ba_kernels.py:114-121)."""
    rng = np.random.default_rng(model_id)
    T, P = 4, 8
    info = CAMERA_MODEL_BY_ID[model_id]
    NP = info.num_params
    params = np.zeros(NP, dtype=np.float32)
    for i in info.focal_idxs:
        params[i] = 400.0
    params[info.principal_idxs[0]] = 320.0
    params[info.principal_idxs[1]] = 240.0
    for i in info.extra_idxs:
        params[i] = rng.uniform(-0.05, 0.05)
    if info.name == "FOV":
        params[info.extra_idxs[0]] = 0.8
    q = rng.normal(size=(T, P, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    t = rng.uniform(-0.5, 0.5, (3, T, P)).astype(np.float32)
    pts = rng.uniform(-1, 1, (3, P)).astype(np.float32)
    pts[2] += 6.0
    pts[2, 0] = -8.0  # one point behind every camera
    arrays = dict(
        img_idx=np.zeros((T, P), np.int32), cam_idx=np.zeros((T, P), np.int32),
        xy=rng.uniform(0, 600, (2, T, P)).astype(np.float32),
        mask=(rng.uniform(size=(T, P)) > 0.2).astype(np.float32),
        points=pts,
        point_free=(rng.uniform(size=P) > 0.3).astype(np.float32),
        point_rows=np.arange(P, dtype=np.int32),
    )
    free = (rng.uniform(size=NP) > 0.3).astype(np.float32)

    def run(bk, asarr):
        bucket = bk.Bucket(**{k: asarr(v) for k, v in arrays.items()})
        q_obs = tuple(asarr(np.ascontiguousarray(q[..., i])) for i in range(4))
        t_obs = tuple(asarr(t[i]) for i in range(3))
        k_obs = tuple(asarr(np.full((T, P), v, np.float32)) for v in params)
        ifree = tuple(asarr(np.full((T, P), v, np.float32)) for v in free)
        res, J = bk._bucket_res_and_jac(model_id, bucket, q_obs, t_obs,
                                        k_obs, ifree)
        return np.asarray(res), np.asarray(J)

    ref_res, ref_J = run(jbk, jnp.asarray)
    got_res, got_J = run(tbk, torch.from_numpy)
    assert got_J.shape == ref_J.shape == (2, 9 + NP, T, P)
    np.testing.assert_allclose(got_res, ref_res, atol=1e-4, rtol=1e-4)
    scale = np.abs(ref_J).max() + 1.0
    np.testing.assert_allclose(got_J / scale, ref_J / scale, atol=1e-4)


def test_convert_problem_and_options(problems):
    jp, tp = problems
    arrays = {f: np.asarray(getattr(jp, f)) for f in _fields(jp)}
    got = convert.bundle_problem_from_numpy(arrays, jp.model_id)
    for f in _fields(jp):
        assert torch.equal(getattr(got, f), getattr(tp, f)), f

    jo = JOpt()
    jo.loss_function_type = JLoss.CAUCHY
    jo.loss_function_scale = 2.5
    jo.max_num_iterations = 7
    jo.eta = 0.05
    to = convert.ba_options_from_dict(jo.todict())
    assert int(to.loss_function_type) == 2
    assert (to.loss_function_scale, to.max_num_iterations, to.eta) == (
        2.5, 7, 0.05)


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax():
    files = sorted((REPO / "pycolmap_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    bad = [
        (str(f.relative_to(REPO)), name)
        for f in files for name in _imports(f)
        if name.split(".")[0] in ("jax", "jaxlib", "pycolmap_tpu")
    ]
    assert not bad, bad


@pytest.mark.parametrize("entry", ["resolve_device", "solve_bundle",
                                   "solve_bundle_fast", "resident"])
def test_default_device_needs_cuda(entry, problems, monkeypatch):
    """With no device given the port runs on the card; on a host without
    CUDA it raises instead of falling back to the CPU."""
    import pycolmap_torch
    from pycolmap_torch.sfm.ba_kernels import solve_bundle_fast
    from pycolmap_torch.sfm.bundle_adjustment import (
        BundleAdjustmentOptions,
        solve_bundle,
    )
    from pycolmap_torch.sfm.resident import ResidentBundleSolver

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tp = problems
    opts = BundleAdjustmentOptions()
    call = {
        "resolve_device": lambda: pycolmap_torch.resolve_device(),
        "solve_bundle": lambda: solve_bundle(tp, opts),
        "solve_bundle_fast": lambda: solve_bundle_fast(tp, opts),
        "resident": lambda: ResidentBundleSolver(tp, opts),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert pycolmap_torch.resolve_device("cpu").type == "cpu"

