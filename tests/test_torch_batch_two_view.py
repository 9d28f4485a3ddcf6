"""The port's pair-parallel verification (pycolmap_torch/estimators/
batch_two_view.py) on the CPU: tests/test_batch_two_view.py's three cases
on the port, the configurations equal to the reference's on the same
pairs, and the relative pose against the truth.

The port's draws (a ``torch.Generator`` seeded 0) differ from the
reference's (``jax.random``), so blocks compare on outcomes (ROADMAP.md).
The reference runs once, on all nine pairs in one block: its normalized
threshold is the block's mean, the same for every pair here (one focal
length), and one block is one compile."""

import numpy as np
import pytest
import torch

from pycolmap_tpu.estimators.batch_two_view import (
    verify_pairs_batch as j_verify,
)
from pycolmap_tpu.scene import Camera as JCamera
from pycolmap_torch.estimators.batch_two_view import verify_pairs_batch
from pycolmap_torch.estimators.two_view_geometry import (
    TwoViewGeometryConfiguration,
    TwoViewGeometryOptions,
    estimate_calibrated_two_view_geometry,
)
from pycolmap_torch.scene import Camera
from test_estimators import synth_two_view

C = TwoViewGeometryConfiguration
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_camera(cam):
    return Camera(cam.camera_id, cam.model_name, cam.width, cam.height,
                  np.array(cam.params))


def _pair(x1, x2, cam):
    m = np.stack([np.arange(len(x1))] * 2, axis=1).astype(np.uint32)
    return {"x1_px": x1, "x2_px": x2, "cam1": cam, "cam2": cam, "matches": m}


def _cases():
    """tests/test_batch_two_view.py's three blocks, as reference pair dicts
    with the truth: five pairs at 25% outliers, three at 50%, and one of
    random points."""
    cases = {}
    for name, n, ratio, seeds in (("per_pair", 150, 0.25, range(5)),
                                  ("outliers", 200, 0.5, range(3))):
        pairs, truth = [], []
        for seed in seeds:
            cam, x1, x2, rel, gt = synth_two_view(n=n, outlier_ratio=ratio,
                                                  seed=seed)
            pairs.append(_pair(x1, x2, cam))
            truth.append((rel, gt))
        cases[name] = (pairs, truth)
    cam = JCamera.create(1, "PINHOLE", 600.0, 640, 480)
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 640, (40, 2))
    cases["degenerate"] = ([_pair(x, rng.uniform(0, 640, (40, 2)), cam)],
                           [None])
    return cases


def _to_port(pairs):
    return [dict(p, cam1=_port_camera(p["cam1"]), cam2=_port_camera(p["cam2"]))
            for p in pairs]


@pytest.fixture(scope="module")
def verified():
    """Each case through the port (one block per case, as the reference
    test), and all nine pairs through the reference in one block."""
    torch.set_num_threads(1)
    cases = _cases()
    options = TwoViewGeometryOptions()
    port = {k: verify_pairs_batch(_to_port(p), options, device=CPU)
            for k, (p, _) in cases.items()}
    posed = TwoViewGeometryOptions(compute_relative_pose=True)
    for k in ("per_pair", "outliers"):
        port[k + " posed"] = verify_pairs_batch(_to_port(cases[k][0]), posed,
                                                device=CPU)
    names = [k for k, (p, _) in cases.items() for _ in p]
    ref_all = j_verify([q for p, _ in cases.values() for q in p])
    ref = {k: [g for n, g in zip(names, ref_all) if n == k] for k in cases}
    return cases, port, ref


def _rot_err_deg(rel_est, rel_true):
    R = rel_est.rotation.matrix() @ rel_true.rotation.matrix().T
    return float(np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))))


def test_batch_matches_per_pair(verified):
    cases, port, _ = verified
    pairs, truth = cases["per_pair"]
    options = TwoViewGeometryOptions()
    assert len(port["per_pair"]) == 5
    for p, g_b, (_, gt) in zip(_to_port(pairs), port["per_pair"], truth):
        g_p = estimate_calibrated_two_view_geometry(
            p["cam1"], p["x1_px"], p["cam2"], p["x2_px"], p["matches"],
            options, device=CPU)
        assert g_b.config != int(C.DEGENERATE)
        assert len(g_b.inlier_matches) > 0.85 * len(g_p.inlier_matches)
        inl = set(map(tuple, g_b.inlier_matches.tolist()))
        true_inl = {(i, i) for i in np.nonzero(gt)[0]}
        assert len(inl & true_inl) / max(len(inl), 1) > 0.9


def test_batch_5pt_recall_high_outliers(verified):
    cases, port, _ = verified
    for g, (_, gt) in zip(port["outliers"], cases["outliers"][1]):
        assert g.config == int(C.CALIBRATED)
        inl = {m[0] for m in g.inlier_matches.tolist()}
        true_inl = set(np.nonzero(gt)[0].tolist())
        hit = len(inl & true_inl)
        assert hit / len(true_inl) > 0.9 and hit / max(len(inl), 1) > 0.9


def test_batch_degenerate_pair(verified):
    _, port, _ = verified
    assert port["degenerate"][0].config == int(C.DEGENERATE)


@pytest.mark.parametrize("case", ["per_pair", "outliers", "degenerate"])
def test_configurations_equal_reference(verified, case):
    _, port, ref = verified
    assert [g.config for g in port[case]] == [g.config for g in ref[case]]


@pytest.mark.parametrize("case", ["per_pair", "outliers"])
def test_relative_pose_within_a_degree(verified, case):
    """With compute_relative_pose, the pose recovered from the block-local
    inliers: the block's median rotation error within 1 degree of the
    truth, each pair's within 2, each unit translation's direction within
    5; the same draws, so the same inliers as without.

    The median, as tests/test_torch_estimators.py holds the per-pair
    essential estimator: the pose comes from E, and E is the LO refit only
    where the refit keeps at least as many inliers (the reference's rule).
    Where it keeps one fewer, the winning 5-point sample's E stays, and its
    pose depends on the draw: on the port's stream one pair of each block
    here lands at 1.2-1.8 degrees, on the reference's every pair under
    0.7."""
    cases, port, _ = verified
    errs = []
    for g, g0, (rel, _) in zip(port[case + " posed"], port[case],
                               cases[case][1]):
        np.testing.assert_array_equal(g.inlier_matches, g0.inlier_matches)
        assert g.config == g0.config and g.tri_angle > 0
        errs.append(_rot_err_deg(g.cam2_from_cam1, rel))
        t = rel.translation / np.linalg.norm(rel.translation)
        cos = float(np.dot(g.cam2_from_cam1.translation, t))
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 5.0
    assert np.median(errs) < 1.0 and max(errs) < 2.0, errs


def test_draws_repeat_and_chunking_changes_nothing(verified, monkeypatch):
    """The same block gives the same draws; scoring the hypotheses in
    chunks over K gives the same result as one slab."""
    from pycolmap_torch.estimators import batch_two_view as btv

    cases, port, _ = verified
    pairs = _to_port(cases["outliers"][0])
    monkeypatch.setattr(btv, "SCORE_ELEMS", 3 * 200 * 100)  # chunks of 100
    again = verify_pairs_batch(pairs, device=CPU)
    for g, h in zip(port["outliers"], again):
        assert g.config == h.config
        np.testing.assert_array_equal(g.inlier_matches, h.inlier_matches)
        np.testing.assert_allclose(g.F, h.F, rtol=1e-5, atol=1e-7)


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pairs = _to_port(_cases()["degenerate"][0])
    with pytest.raises(RuntimeError, match="CUDA"):
        verify_pairs_batch(pairs)
