"""The port's bundle-problem builder and write-back vs the reference's on
the same model (read by both from the reference's files): equal index
arrays and equal f32 values, with and without constant poses and constant
x translations, and the same scene after writing a solution back."""

import numpy as np
import pytest
import torch

from pycolmap_tpu.scene import Reconstruction as JRec
from pycolmap_tpu.sfm.bundle_adjustment import BundleAdjustmentOptions as JOpt
from pycolmap_tpu.sfm.problem import apply_bundle_solution as j_apply
from pycolmap_tpu.sfm.problem import build_bundle_problem as j_build
from pycolmap_torch import convert
from pycolmap_torch.scene import Camera, Reconstruction
from pycolmap_torch.sfm import ba_kernels as tbk
from pycolmap_torch.sfm.bundle_adjustment import BundleProblem
from pycolmap_torch.sfm.problem import apply_bundle_solution, build_bundle_problem

from test_scene import build_synthetic_reconstruction

INDEX_FIELDS = ("obs_image_idx", "obs_camera_idx", "obs_point_idx")


def _models(tmp_path):
    ref = build_synthetic_reconstruction(num_images=5, num_points=70, seed=2)
    ref.deregister_image(4)
    ref.write_binary(tmp_path)
    return JRec(tmp_path), Reconstruction(tmp_path)


CASES = {
    "free": {},
    "gauge": dict(constant_pose_ids=[1], constant_tvec_x_ids=[2]),
    "subset": dict(image_ids=[1, 2, 3], constant_pose_ids=[2, 3],
                   constant_tvec_x_ids=[1], constant_point_ids=[3, 9]),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("refine", [False, True])
def test_build_bundle_problem_matches(tmp_path, case, refine):
    jrec, trec = _models(tmp_path)
    jo = JOpt()
    jo.refine_principal_point = refine
    jo.refine_extrinsics = not refine
    to = convert.ba_options_from_dict(jo.todict())
    jp, jm = j_build(jrec, jo, **CASES[case])
    tp, tm = build_bundle_problem(trec, to, **CASES[case])
    assert isinstance(tp, BundleProblem)
    assert tp.model_id == jp.model_id
    assert (tm.image_ids, tm.camera_ids, tm.point_ids) == (
        jm.image_ids, jm.camera_ids, jm.point_ids)
    for f in BundleProblem._fields:
        if f == "model_id":
            continue
        got, ref = getattr(tp, f), np.asarray(getattr(jp, f))
        assert got.dtype == (torch.int32 if f in INDEX_FIELDS else torch.float32)
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f)


def test_apply_bundle_solution_round_trips(tmp_path):
    jrec, trec = _models(tmp_path)
    jp, jm = j_build(jrec)
    tp, tm = build_bundle_problem(trec)
    rng = np.random.default_rng(0)
    q = np.asarray(jp.cam_quat) + rng.normal(0, 1e-3, jp.cam_quat.shape)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    new = dict(
        cam_quat=q,
        cam_trans=np.asarray(jp.cam_trans) + np.float32(0.01),
        intrinsics=np.asarray(jp.intrinsics) * np.float32(1.001),
        points=np.asarray(jp.points) - np.float32(0.02),
    )
    j_apply(jrec, jp._replace(**new), jm)
    apply_bundle_solution(
        trec, tp._replace(**{k: torch.from_numpy(v) for k, v in new.items()}),
        tm)
    jrec.write_binary(tmp_path / "j")
    trec.write_binary(tmp_path / "t")
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert ((tmp_path / "t" / name).read_bytes()
                == (tmp_path / "j" / name).read_bytes()), name
    # and back: the problem rebuilt from the updated scene holds the values
    tp2, _ = build_bundle_problem(trec)
    np.testing.assert_array_equal(tp2.points.numpy(), new["points"])


def test_mixed_models_build_but_do_not_solve(tmp_path):
    """A mixed-model scene builds a tuple problem; its solve runs on the
    CPU and leaves the selector column as it was (the name dates from when
    that solve raised; tests/test_torch_mixed_models.py holds it to the
    reference)."""
    _, trec = _models(tmp_path)
    trec.add_camera(Camera.create(2, "PINHOLE", 600.0, 640, 480))
    trec.images[3].camera_id = 2
    tp, tm = build_bundle_problem(trec)
    assert tp.model_id == (1, 2) and tm.camera_ids == [1, 2]
    out, summary = tbk.solve_bundle_fast(
        tp, convert.ba_options_from_dict({}), device="cpu")
    assert summary.final_cost < summary.initial_cost
    assert np.array_equal(out.intrinsics[:, 4].numpy(), [2.0, 1.0])


@pytest.mark.parametrize("dtype", ["reference", "float64"])
def test_build_bundle_problem_dtype(tmp_path, dtype):
    """The reference's ``dtype`` keyword: its own call
    (``dtype=jnp.float32``) builds the reference's problem; float64 keeps
    the float arrays in float64 (rounding to the reference's float32
    values), solves on the CPU, and raises for the card's float32-only
    kernels rather than being cast."""
    import jax.numpy as jnp

    from pycolmap_torch.sfm.resident import check_kernel_dtype

    jrec, trec = _models(tmp_path)
    jp, _ = j_build(jrec, dtype=jnp.float32)
    want = jnp.float32 if dtype == "reference" else torch.float64
    tp, _ = build_bundle_problem(trec, dtype=want)
    for f in BundleProblem._fields:
        if f == "model_id":
            continue
        got, ref = getattr(tp, f), np.asarray(getattr(jp, f))
        if f in INDEX_FIELDS:
            assert got.dtype == torch.int32
        else:
            assert got.dtype == (torch.float32 if dtype == "reference"
                                 else torch.float64)
        np.testing.assert_array_equal(got.numpy().astype(ref.dtype), ref,
                                      err_msg=f)
    check_kernel_dtype(build_bundle_problem(trec)[0], "cuda")
    if dtype == "float64":
        with pytest.raises(TypeError, match="float32 only"):
            check_kernel_dtype(tp, "cuda")
        _, summary = tbk.solve_bundle_fast(
            tp, convert.ba_options_from_dict({}), device="cpu")
        assert summary.final_cost < summary.initial_cost
