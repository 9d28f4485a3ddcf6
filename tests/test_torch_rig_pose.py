"""The port's rig pose (pycolmap_torch/estimators/generalized_absolute_pose.py)
against the reference on the CPU.

- tests/test_breadth.py's two-camera rig, and a four-camera rig (front,
  back, left and right, 0.2 apart) with 30% gross outliers:
  ``rig_absolute_pose_estimation`` within 0.5 degrees and 0.05 of the true
  rig pose (test_breadth.py's bounds), the port's inliers the truth's, and
  on the four-camera rig the reference's too. The ``torch.Generator`` and
  ``jax.random`` streams differ, so the packages compare on outcomes;
- the share of minimal samples whose three observations share a camera,
  about 1/k^2 of the draws with k cameras;
- the Gauss-Newton refinement against the reference's (the same 15 steps
  from the same start) within 1e-4;
- the device rule.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pycolmap_torch as pt
from pycolmap_torch.estimators import generalized_absolute_pose as tgap
from pycolmap_tpu import geometry as jgeo
from pycolmap_tpu.estimators.generalized_absolute_pose import (
    rig_absolute_pose_estimation as j_rig,
)
from pycolmap_tpu.ops import quaternion as jq
from pycolmap_tpu.scene import Camera as JCamera

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _facing(fwd):
    """Rows of a camera rotation whose optical axis is `fwd`."""
    fwd = np.asarray(fwd, np.float64)
    up = np.array([0.0, -1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    return np.stack([right, np.cross(fwd, right), fwd])


def rig_case(num_cams, n, outlier_ratio, noise, seed, width=640, height=480,
             focal=500.0):
    """A rig of `num_cams` PINHOLE cameras (2: tests/test_breadth.py's,
    offset along x; 4: front, back, left and right, 0.1 from the rig
    origin), observation i in camera i % num_cams at a random pixel and
    depth 3-8, `noise` px of noise, `outlier_ratio` replaced by random
    pixels. Returns the true rig_from_world (xyzw quaternion, translation),
    pixels, world points, each observation's camera index, the cameras'
    (xyzw, translation) and the outlier mask."""
    rng = np.random.default_rng(seed)
    if num_cams == 2:
        cams = [(np.eye(3), np.array([-0.2, 0.0, 0.0])),
                (np.eye(3), np.array([0.2, 0.0, 0.0]))]
    else:
        dirs = [[0, 0, 1], [0, 0, -1], [1, 0, 0], [-1, 0, 0]]
        cams = [(_facing(d), -_facing(d) @ (0.1 * np.asarray(d, float)))
                for d in dirs]
    R_rw = jgeo.Rotation3d(np.array([0.1, -0.2, 0.05])).matrix()
    t_rw = np.array([0.3, 0.1, 1.0])
    cam_idx = np.arange(n) % num_cams
    xy = rng.uniform([0, 0], [width, height], (n, 2))
    depth = rng.uniform(3.0, 8.0, n)
    X_cam = np.stack([(xy[:, 0] - width / 2) / focal,
                      (xy[:, 1] - height / 2) / focal,
                      np.ones(n)], axis=1) * depth[:, None]
    X = np.zeros((n, 3))
    for k, (R, t) in enumerate(cams):
        sel = cam_idx == k
        X_rig = (X_cam[sel] - t) @ R
        X[sel] = (X_rig - t_rw) @ R_rw
    obs = xy + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outlier_ratio
    obs[bad] = rng.uniform([0, 0], [width, height], (int(bad.sum()), 2))
    cam_poses = [(jgeo.Rotation3d(R).quat, t) for R, t in cams]
    truth = (jgeo.Rotation3d(R_rw).quat, t_rw)
    return truth, obs, X, cam_idx, cam_poses, bad


def _run(pkg, case, focal=500.0, width=640, height=480, **kw):
    truth, obs, X, cam_idx, cam_poses, _ = case
    if pkg == "port":
        cam = pt.Camera.create(1, "PINHOLE", focal, width, height)
        extr = [pt.Rigid3d(pt.Rotation3d(q), t) for q, t in cam_poses]
        fn = pt.rig_absolute_pose_estimation
        kw = dict(kw, device=CPU)
    else:
        cam = JCamera.create(1, "PINHOLE", focal, width, height)
        extr = [jgeo.Rigid3d(jgeo.Rotation3d(q), t) for q, t in cam_poses]
        fn = j_rig
    res = fn(obs, X, [cam] * len(obs), [extr[k] for k in cam_idx], **kw)
    assert res is not None
    est = res["rig_from_world"]
    rot = np.rad2deg(est.rotation.angle_to(type(est.rotation)(truth[0])))
    trans = np.abs(est.translation - truth[1]).max()
    return res, rot, trans


@pytest.mark.parametrize("num_cams", [2, 4])
def test_rig_pose_matches_reference(num_cams):
    """The port within test_breadth.py's bounds of the truth, its inliers
    the true inliers; on the four-camera rig the reference too (its own
    test holds it on the two-camera rig; a reference call takes 6-16 s
    here)."""
    if num_cams == 2:
        case = rig_case(2, 120, 0.0, 0.3, 0)
    else:
        case = rig_case(4, 400, 0.3, 0.5, 1)
    bad = case[-1]
    stats = {}
    got, g_rot, g_trans = _run("port", case, stats=stats)
    assert g_rot < 0.5 and g_trans < 0.05
    if num_cams == 4:
        _, r_rot, r_trans = _run("reference", case)
        assert r_rot < 0.5 and r_trans < 0.05
    assert got["num_inliers"] == int(got["inliers"].sum())
    assert got["inliers"].sum() >= 0.95 * (~bad).sum()
    assert (got["inliers"] & bad).sum() <= 0.02 * bad.sum() + 1
    # about 1/k^2 of the draws are valid (one camera per sample)
    share = stats["valid_samples"] / stats["samples"]
    assert stats["samples"] >= 1024
    assert 0.6 / num_cams**2 < share < 1.6 / num_cams**2, share


def test_rig_refinement_matches_reference():
    """The 15 Gauss-Newton steps from one start (a pose 2 degrees and 0.05
    off) over the same inliers: the port's pose within 1e-4 of the
    reference's."""
    import jax

    truth, obs, X, cam_idx, cam_poses, bad = rig_case(4, 200, 0.2, 0.5, 3)
    cam = pt.Camera.create(1, "PINHOLE", 500.0, 640, 480)
    x = cam.cam_from_img(obs).astype(np.float32)
    q = np.asarray([cam_poses[k][0] for k in cam_idx])[:, [3, 0, 1, 2]]
    cq = q.astype(np.float32)
    ct = np.asarray([cam_poses[k][1] for k in cam_idx], np.float32)
    w = (~bad).astype(np.float32)
    start = jgeo.Rotation3d(np.array([0.02, 0.02, 0.0])) * jgeo.Rotation3d(
        truth[0])
    q0 = np.asarray(start.quat)[[3, 0, 1, 2]].astype(np.float32)
    t0 = (truth[1] + 0.05).astype(np.float32)
    Xf = X.astype(np.float32)
    got = tgap._refine_rig_gn(*(torch.from_numpy(a) for a in (
        q0, t0, x, Xf, cq, ct, w)))

    def residuals(params):  # the reference's, generalized_absolute_pose:117
        quat = jq.quat_boxplus(jnp.asarray(q0), params[:3])
        p_rig = (jq.quat_rotate(quat[None], jnp.asarray(Xf))
                 + params[3:6][None])
        p_cam = jq.quat_rotate(jnp.asarray(cq), p_rig) + jnp.asarray(ct)
        z = jnp.where(jnp.abs(p_cam[:, 2]) < 1e-8, 1e-8, p_cam[:, 2])
        proj = p_cam[:, :2] / z[:, None]
        return ((proj - jnp.asarray(x))
                * jnp.asarray(w)[:, None]).reshape(-1)

    params = jnp.concatenate([jnp.zeros(3), jnp.asarray(t0)])
    for _ in range(15):
        J = jax.jacfwd(residuals)(params)
        r = residuals(params)
        params = params - jnp.linalg.solve(J.T @ J + 1e-6 * jnp.eye(6),
                                           J.T @ r)
    ref_q = np.asarray(jq.quat_boxplus(jnp.asarray(q0), params[:3]))
    got_q = got[0].numpy()
    assert np.abs(got_q * np.sign(got_q[0] * ref_q[0]) - ref_q).max() < 1e-4
    assert np.abs(got[1].numpy() - np.asarray(params[3:6])).max() < 1e-4


def test_rig_pose_rejects_and_device_rule():
    case = rig_case(2, 20, 0.0, 0.3, 4)
    _, obs, X, cam_idx, cam_poses, _ = case
    cam = pt.Camera.create(1, "PINHOLE", 500.0, 640, 480)
    extr = [pt.Rigid3d(pt.Rotation3d(q), t) for q, t in cam_poses]
    per_obs = [extr[k] for k in cam_idx]
    # mismatched lengths and too few points give None, as the reference's
    assert pt.rig_absolute_pose_estimation(
        obs, X, [cam] * 3, per_obs, device=CPU) is None
    assert pt.rig_absolute_pose_estimation(
        obs[:2], X[:2], [cam] * 2, per_obs[:2], device=CPU) is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt.rig_absolute_pose_estimation(obs, X, [cam] * len(obs),
                                            per_obs)
