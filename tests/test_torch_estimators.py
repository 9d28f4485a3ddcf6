"""The port's estimators (pycolmap_torch/estimators/) on outcomes, on the CPU.

The random streams of the port (``torch.Generator``) and of the reference
(``jax.random``) differ, so whole estimators are compared on outcomes
(ROADMAP.md): each test of tests/test_estimators.py (but alignment and rig
pose) runs on the port against ground truth at that file's thresholds, and
the fundamental, homography, uncalibrated two-view, absolute-pose and
triangulation estimators are cross-checked against the reference's on a
shared fixture: the same configuration, inlier counts within 2%.

The essential estimator and the calibrated two-view path are held to the
ground truth only. At 200 matches with 0.5 px noise their rotation error
depends on which sample wins: over the first eight streams of the
reference's own engine on its test's fixture it is 0.57-1.56 degrees (two
above its 1-degree threshold), over twelve of the port's 0.44-1.12
(tests/estimator_streams.py prints both). So their rotation is held to
the reference's threshold as the median over the port's first three
streams (seeds 0-2), every stream to the other thresholds.

Also: the option converters of convert.py, and the device rule (no device
given means the card, and a host without CUDA raises).
"""

import numpy as np
import pytest
import torch

from pycolmap_tpu import estimators as jest
from pycolmap_tpu.geometry import Rigid3d as JRigid3d
from pycolmap_tpu.geometry import Rotation3d as JRotation3d
from pycolmap_tpu.scene import Camera as JCamera
from pycolmap_torch import convert
from pycolmap_torch import estimators as test_
from pycolmap_torch.estimators import essential_matrix as tem
from pycolmap_torch.estimators import two_view_geometry as ttv
from pycolmap_torch.geometry import Rigid3d, Rotation3d
from pycolmap_torch.ops import solvers as ts
from pycolmap_torch.scene import Camera
from test_estimators import synth_two_view

C = ttv.TwoViewGeometryConfiguration
CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_camera(f=600.0, w=640, h=480):
    return Camera.create(1, "PINHOLE", f, w, h)


def _port_rigid(r):
    """The reference fixture's Rigid3d as the port's."""
    return Rigid3d(Rotation3d(np.asarray(r.rotation.quat)),
                   np.asarray(r.translation))


def _synth(**kw):
    _, x1, x2, rel, gt = synth_two_view(**kw)
    return make_camera(kw.get("f", 600.0)), x1, x2, _port_rigid(rel), gt


def _rot_err(a, b):
    return np.rad2deg(a.rotation.angle_to(b.rotation))


def _with_seeds(monkeypatch, seeds, fn):
    """fn() once per stream of the essential estimator's generator."""
    estimate = tem._engine.estimate
    out = []
    for s in seeds:
        monkeypatch.setattr(
            tem._engine, "estimate",
            lambda *a, seed=0, _s=s, **kw: estimate(*a, seed=_s, **kw))
        out.append(fn())
    monkeypatch.setattr(tem._engine, "estimate", estimate)
    return out


# ---------------------------------------------------------------------------
# tests/test_estimators.py on the port
# ---------------------------------------------------------------------------


class TestFundamental:
    def test_recovers_inliers(self):
        cam, x1, x2, rel, gt = _synth()
        res = test_.estimate_fundamental_matrix(x1, x2, device=CPU)
        assert res is not None
        assert (res["inliers"] & gt).sum() / gt.sum() > 0.9
        assert (res["inliers"] & ~gt).sum() < 0.05 * len(x1)

    def test_too_few_points(self):
        assert test_.estimate_fundamental_matrix(
            np.zeros((5, 2)), np.zeros((5, 2)), device=CPU) is None

    def test_deterministic(self):
        cam, x1, x2, rel, gt = _synth(seed=3)
        r1 = test_.estimate_fundamental_matrix(x1, x2, device=CPU)
        r2 = test_.estimate_fundamental_matrix(x1, x2, device=CPU)
        assert np.allclose(r1["F"], r2["F"])
        assert r1["num_inliers"] == r2["num_inliers"]


def test_essential_recovers_pose(monkeypatch):
    cam, x1, x2, rel, gt = _synth(outlier_ratio=0.2)
    runs = _with_seeds(monkeypatch, (0, 1, 2), lambda: test_.estimate_essential_matrix(
        x1, x2, cam, cam, device=CPU))
    errs = []
    for res in runs:
        assert res["num_inliers"] > 0.8 * gt.sum()
        pose = res["cam2_from_cam1"]
        errs.append(_rot_err(pose, rel))
        t_est = pose.translation / np.linalg.norm(pose.translation)
        t_true = rel.translation / np.linalg.norm(rel.translation)
        assert np.abs(t_est - t_true).max() < 0.08
    assert np.median(errs) < 1.0, errs


def test_essential_high_outlier_ratio():
    cam, x1, x2, rel, gt = _synth(outlier_ratio=0.6, seed=5)
    res = test_.estimate_essential_matrix(x1, x2, cam, cam, device=CPU)
    assert res is not None
    assert res["num_inliers"] > 0.8 * gt.sum()
    assert _rot_err(res["cam2_from_cam1"], rel) < 1.5


def test_homography_planar_scene():
    cam, x1, x2, rel, gt = _synth(planar=True, outlier_ratio=0.3)
    res = test_.estimate_homography_matrix(x1, x2, device=CPU)
    assert res is not None
    assert res["num_inliers"] > 0.85 * gt.sum()


def _pnp_fixture(n=100, n_out=30, noise=0.5, seed=0):
    rng = np.random.default_rng(seed)
    cam = make_camera()
    X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
    pose = Rigid3d(Rotation3d(np.array([0.2, -0.1, 0.4])),
                   np.array([0.3, -0.2, 0.5]))
    Xc = pose * X
    x = cam.img_from_cam(Xc[:, :2] / Xc[:, 2:]) + rng.normal(0, noise, (n, 2))
    idx = rng.choice(n, n_out, replace=False)
    x[idx] = rng.uniform(0, [cam.width, cam.height], (n_out, 2))
    return cam, x, X, pose


class TestAbsolutePose:
    def test_pnp(self):
        cam, x, X, pose = _pnp_fixture()
        res = test_.absolute_pose_estimation(x, X, cam, device=CPU,
                                             return_covariance=True)
        assert res is not None
        assert res["num_inliers"] >= 0.9 * 70
        est = res["cam_from_world"]
        assert _rot_err(est, pose) < 0.5
        assert np.abs(est.translation - pose.translation).max() < 0.05
        cov = res["covariance"]
        assert cov.shape == (6, 6) and np.all(np.diag(cov) > 0)

    def test_refinement_improves(self):
        rng = np.random.default_rng(1)
        cam = make_camera()
        n = 50
        X = rng.uniform(-2, 2, (n, 3)) + np.array([0, 0, 6.0])
        pose = Rigid3d(Rotation3d(np.array([0.1, 0.0, 0.2])),
                       np.array([0.1, 0.0, 0.3]))
        Xc = pose * X
        x = cam.img_from_cam(Xc[:, :2] / Xc[:, 2:])
        bad = Rigid3d(Rotation3d(np.array([0.13, 0.01, 0.22])),
                      pose.translation + 0.05)
        res = test_.pose_refinement(bad, x, X, np.ones(n, dtype=bool), cam,
                                    device=CPU)
        refined = res["cam_from_world"]
        assert (refined.rotation.angle_to(pose.rotation)
                < bad.rotation.angle_to(pose.rotation))
        assert np.abs(refined.translation - pose.translation).max() < 1e-3


def _track_fixture(M=6, seed=0):
    rng = np.random.default_rng(seed)
    cam = make_camera()
    X_true = np.array([0.5, -0.3, 8.0])
    poses, obs = [], []
    for i in range(M):
        pose = Rigid3d(Rotation3d(np.array([0.0, 0.15 * i, 0.0])),
                       np.array([1.0 * i - 2.5, 0.0, 0.0]))
        Xc = pose * X_true
        obs.append(cam.img_from_cam(Xc[None, :2] / Xc[2])[0]
                   + rng.normal(0, 0.3, 2))
        poses.append(pose)
    return cam, obs, poses, X_true


def test_triangulation_multiview():
    cam, obs, poses, X_true = _track_fixture()
    res = test_.estimate_triangulation(obs, poses, [cam] * 6, device=CPU)
    assert res is not None
    assert np.abs(res["point3D"] - X_true).max() < 0.05


class TestTwoViewGeometry:
    def test_calibrated_decision(self, monkeypatch):
        cam, x1, x2, rel, gt = _synth(outlier_ratio=0.2)

        def run():
            g = test_.estimate_calibrated_two_view_geometry(
                cam, x1, cam, x2, device=CPU)
            assert g.config == int(C.CALIBRATED)
            assert len(g.inlier_matches) > 0.8 * gt.sum()
            assert test_.estimate_two_view_geometry_pose(
                cam, x1, cam, x2, g, device=CPU)
            assert g.tri_angle > 0
            return _rot_err(g.cam2_from_cam1, rel)

        errs = _with_seeds(monkeypatch, (0, 1, 2), run)
        assert np.median(errs) < 1.0, errs

    def test_planar_decision(self):
        cam, x1, x2, rel, gt = _synth(planar=True, outlier_ratio=0.1)
        g = test_.estimate_calibrated_two_view_geometry(
            cam, x1, cam, x2, device=CPU)
        assert g.config in (int(C.PLANAR_OR_PANORAMIC), int(C.PLANAR),
                            int(C.CALIBRATED))
        # the pose of a planar geometry comes from H
        opts = test_.TwoViewGeometryOptions(compute_relative_pose=True)
        g = test_.estimate_two_view_geometry(cam, x1, cam, x2, options=opts,
                                             device=CPU)
        assert g.config == int(C.PLANAR) and g.cam2_from_cam1 is not None

    def test_degenerate(self):
        cam = make_camera()
        g = test_.estimate_calibrated_two_view_geometry(
            cam, np.zeros((5, 2)), cam, np.zeros((5, 2)), device=CPU)
        assert g.config == int(C.DEGENERATE)

    def test_multiple_models(self):
        """Two independently moving planes -> MULTIPLE with inliers of both
        motions (ref two_view_geometry.h:67-77)."""
        rng = np.random.default_rng(3)
        cam = make_camera()
        sets = []
        for k, rel in enumerate([
            Rigid3d(Rotation3d(np.array([0.02, 0.25, 0.0])),
                    np.array([0.8, 0.0, 0.0])),
            Rigid3d(Rotation3d(np.array([-0.3, -0.1, 0.2])),
                    np.array([-0.5, 0.6, 0.3])),
        ]):
            X = np.concatenate(
                [rng.uniform(-2, 2, (120, 2)), np.zeros((120, 1))], axis=1
            ) + np.array([2.5 * k - 1, 0, 6.0])
            x1 = cam.img_from_cam(X[:, :2] / X[:, 2:])
            Xc2 = rel * X
            sets.append((x1, cam.img_from_cam(Xc2[:, :2] / Xc2[:, 2:])))
        x1 = np.concatenate([s[0] for s in sets])
        x2 = np.concatenate([s[1] for s in sets])
        x1 += rng.normal(0, 0.3, x1.shape)
        x2 += rng.normal(0, 0.3, x2.shape)
        opts = test_.TwoViewGeometryOptions()
        opts.multiple_models = True
        opts.detect_watermark = False
        g = test_.estimate_calibrated_two_view_geometry(
            cam, x1, cam, x2, options=opts, device=CPU)
        assert g.config == int(C.MULTIPLE)
        assert len(g.inlier_matches) > 150
        opts.multiple_models = False
        g1 = test_.estimate_calibrated_two_view_geometry(
            cam, x1, cam, x2, options=opts, device=CPU)
        assert g1.config != int(C.MULTIPLE)


class TestEPnP:
    """The port's EPnP against ground truth (tests/test_estimators.py
    TestEPnP)."""

    def _random_problem(self, rng, n=20, noise=0.0):
        Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        if np.linalg.det(Q) < 0:
            Q[:, 0] *= -1
        t = rng.normal(size=3) * 0.5 + np.array([0, 0, 4.0])
        X = rng.uniform(-2, 2, (n, 3))
        pc = X @ Q.T + t
        pc[:, 2] = np.abs(pc[:, 2]) + 1.0
        X = (pc - t) @ Q
        x = pc[:, :2] / pc[:, 2:] + rng.normal(0, noise, (n, 2))
        return Q, t, torch.from_numpy(x.astype(np.float32)), \
            torch.from_numpy(X.astype(np.float32))

    @staticmethod
    def _rot_err_deg(q, R):
        from pycolmap_torch.ops import quaternion as qops

        Rh = qops.quat_to_matrix(q).numpy()
        c = (np.trace(Rh @ R.T) - 1) / 2
        return np.rad2deg(np.arccos(np.clip(c, -1, 1)))

    def test_epnp_exact(self):
        rng = np.random.default_rng(1)
        for _ in range(5):
            R, t, x, X = self._random_problem(rng)
            q, tt = ts.epnp(x, X)
            assert self._rot_err_deg(q, R) < 0.1
            assert np.linalg.norm(tt.numpy() - t) < 1e-3

    def test_epnp_beats_dlt_under_noise(self):
        rng = np.random.default_rng(2)
        e_ep, e_dlt = [], []
        for _ in range(20):
            R, t, x, X = self._random_problem(rng, noise=0.005)
            e_ep.append(self._rot_err_deg(ts.epnp(x, X)[0], R))
            e_dlt.append(self._rot_err_deg(ts.pnp_dlt(x[None], X[None])[0][0], R))
        assert np.median(e_ep) < np.median(e_dlt)

    def test_epnp_batched(self):
        rng = np.random.default_rng(3)
        probs = [self._random_problem(rng) for _ in range(4)]
        q, t = ts.epnp(torch.stack([p[2] for p in probs]),
                       torch.stack([p[3] for p in probs]))
        for b, (R, tb, _, _) in enumerate(probs):
            assert self._rot_err_deg(q[b], R) < 0.1
            assert np.linalg.norm(t[b].numpy() - tb) < 1e-3


# ---------------------------------------------------------------------------
# cross-checks against the reference on a shared fixture
# ---------------------------------------------------------------------------


def _within(a, b, rel=0.02):
    return abs(a - b) <= rel * max(a, b)


def test_cross_check_two_view_estimators():
    """F (general scene), H (a plane) and the uncalibrated two-view path,
    port vs reference: same configuration, inlier counts within 2%."""
    jcam, x1, x2, _, _ = synth_two_view(n=240, outlier_ratio=0.3, seed=7)
    cam = make_camera()
    want = jest.estimate_fundamental_matrix(x1, x2)
    got = test_.estimate_fundamental_matrix(x1, x2, device=CPU)
    assert _within(got["num_inliers"], want["num_inliers"])
    want = jest.estimate_two_view_geometry(jcam, x1, jcam, x2)
    got = test_.estimate_two_view_geometry(cam, x1, cam, x2, device=CPU)
    assert got.config == want.config == int(C.UNCALIBRATED)
    assert _within(len(got.inlier_matches), len(want.inlier_matches))
    _, x1, x2, _, _ = synth_two_view(n=240, outlier_ratio=0.3, seed=8,
                                     planar=True)
    want = jest.estimate_homography_matrix(x1, x2)
    got = test_.estimate_homography_matrix(x1, x2, device=CPU)
    assert _within(got["num_inliers"], want["num_inliers"])


def test_cross_check_pose_and_triangulation():
    cam, x, X, pose = _pnp_fixture(seed=4)
    jc = JCamera.create(1, "PINHOLE", 600.0, 640, 480)
    want = jest.absolute_pose_estimation(x, X, jc)
    got = test_.absolute_pose_estimation(x, X, cam, device=CPU)
    assert _within(got["num_inliers"], want["num_inliers"])
    jpose = JRigid3d(JRotation3d(np.asarray(pose.rotation.quat)),
                     pose.translation)
    assert _rot_err(got["cam_from_world"], pose) < 0.5
    assert np.rad2deg(want["cam_from_world"].rotation.angle_to(
        jpose.rotation)) < 0.5
    cam, obs, poses, X_true = _track_fixture(M=8, seed=5)
    obs[3] = obs[3] + 40.0  # one outlier view
    jposes = [JRigid3d(JRotation3d(np.asarray(p.rotation.quat)),
                       p.translation) for p in poses]
    want = jest.estimate_triangulation(obs, jposes, [jc] * 8)
    got = test_.estimate_triangulation(obs, poses, [cam] * 8, device=CPU)
    assert got["num_inliers"] == want["num_inliers"] == 7
    np.testing.assert_array_equal(got["inliers"], want["inliers"])
    assert np.abs(got["point3D"] - want["point3D"]).max() < 1e-3


# ---------------------------------------------------------------------------
# options and the device rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, convert_fn, mutate", [
    ("RANSACOptions", convert.ransac_options_from_dict,
     lambda o: setattr(o, "max_error", 2.5)),
    ("TwoViewGeometryOptions", convert.two_view_geometry_options_from_dict,
     lambda o: (setattr(o.ransac, "min_num_trials", 77),
                setattr(o, "max_H_inlier_ratio", 0.7))),
    ("AbsolutePoseEstimationOptions",
     convert.absolute_pose_estimation_options_from_dict,
     lambda o: (setattr(o.ransac, "confidence", 0.99),
                setattr(o, "estimate_focal_length", True))),
    ("AbsolutePoseRefinementOptions",
     convert.absolute_pose_refinement_options_from_dict,
     lambda o: setattr(o, "loss_function_scale", 2.0)),
    ("EstimateTriangulationOptions", convert.triangulation_options_from_dict,
     lambda o: (setattr(o, "min_tri_angle", 3.0),
                setattr(o.ransac, "max_error", 8.0))),
])
def test_options_round_trip(name, convert_fn, mutate):
    ref = getattr(jest, name)()
    assert getattr(test_, name)().todict() == ref.todict()  # defaults
    mutate(ref)
    port = convert_fn(ref.todict())
    assert type(port) is getattr(test_, name)
    assert port.todict() == ref.todict()


@pytest.mark.parametrize("entry", [
    "fundamental", "homography", "essential", "absolute_pose",
    "refine_pose", "triangulation", "two_view", "calibrated_two_view",
    "decomposition",
])
def test_default_device_needs_cuda(entry, monkeypatch):
    """With no device given an estimator runs on the card; on a host
    without CUDA it raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cam, x1, x2, _, _ = _synth(n=40)
    cam2, x, X, pose = _pnp_fixture(n=20, n_out=0)
    _, obs, poses, _ = _track_fixture()
    call = {
        "fundamental": lambda: test_.estimate_fundamental_matrix(x1, x2),
        "homography": lambda: test_.estimate_homography_matrix(x1, x2),
        "essential": lambda: test_.estimate_essential_matrix(x1, x2, cam, cam),
        "absolute_pose": lambda: test_.estimate_absolute_pose(x, X, cam2),
        "refine_pose": lambda: test_.refine_absolute_pose(
            pose, x, X, np.ones(20, bool), cam2),
        "triangulation": lambda: test_.estimate_triangulation(
            obs, poses, [cam] * 6),
        "two_view": lambda: test_.estimate_two_view_geometry(
            cam, x1, cam, x2),
        "calibrated_two_view": lambda: (
            test_.estimate_calibrated_two_view_geometry(cam, x1, cam, x2)),
        "decomposition": lambda: test_.homography_decomposition(
            np.eye(3), cam.calibration_matrix(), cam.calibration_matrix(),
            x1, x1),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
