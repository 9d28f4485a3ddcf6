"""The port's pose-graph relaxation (pycolmap_torch/sfm/pose_graph.py)
against the reference on the CPU, on tests/test_pose_graph.py's inputs: the
float64 numpy functions within 1e-9 absolute, the batched retriangulation
(the port's DLT in f32 PyTorch, the reference's in f32 JAX) within 1e-4
relative on the points, with the same points kept and dropped. Models cross
between the packages as binary files."""

import numpy as np
import pytest
import torch

from pycolmap_tpu.scene import Reconstruction as JRec
from pycolmap_tpu.sfm import pose_graph as jpg
from pycolmap_torch.scene import Reconstruction
from pycolmap_torch.sfm import pose_graph as tpg

from test_pose_graph import _fold, _ring_rotations, _toy_reconstruction

ATOL = 1e-9


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_so3_helpers_match():
    rng = np.random.default_rng(0)
    w = rng.normal(0, 1.0, (50, 3))
    w[0] = 0.0
    w[1] = [np.pi - 1e-7, 0.0, 0.0]
    np.testing.assert_allclose(tpg._exp_so3(w), jpg._exp_so3(w), atol=ATOL)
    R = jpg._exp_so3(w)
    np.testing.assert_allclose(tpg._log_so3(R), jpg._log_so3(R), atol=ATOL)
    q = rng.normal(size=(20, 4))
    np.testing.assert_allclose(tpg._quat_wxyz_to_R(q), jpg._quat_wxyz_to_R(q),
                               atol=ATOL)


def _ring_edges(n, closures):
    edges = [(i, i + 1) for i in range(n - 1)]
    edges += [(i, i + 2) for i in range(n - 2)]
    return np.asarray(edges + closures)


@pytest.mark.parametrize("case", ["folded", "outliers"])
def test_rotation_averaging_matches(case):
    """test_pose_graph.py TestRotationAveraging's two inputs."""
    if case == "folded":
        n = 60
        R_true = _ring_rotations(n)
        R_init = _fold(R_true, total_deg=12.0)
        R_init[0] = R_true[0]
        edges = _ring_edges(n, [(0, n - 1), (1, n - 2)])
        R_rel = R_true[edges[:, 1]] @ np.swapaxes(R_true[edges[:, 0]], -1, -2)
    else:
        n = 30
        R_true = _ring_rotations(n)
        edges = _ring_edges(n, [])
        R_rel = R_true[edges[:, 1]] @ np.swapaxes(R_true[edges[:, 0]], -1, -2)
        bad = np.array([5, 20, 33])
        D = jpg._exp_so3(np.array([[np.pi / 2, 0, 0]] * 3))
        R_rel[bad] = D @ R_rel[bad]
        rng = np.random.default_rng(0)
        R_init = R_true @ jpg._exp_so3(rng.normal(0, 0.02, (n, 3)))
    got = tpg.rotation_averaging(R_init, edges, R_rel, num_iters=40)
    want = jpg.rotation_averaging(R_init, edges, R_rel, num_iters=40)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_position_solve_matches():
    """test_pose_graph.py TestPositionSolve's input."""
    n = 40
    R_true = _ring_rotations(n)
    phi = 2 * np.pi * np.arange(n) / n
    c_true = np.stack(
        [3 * np.cos(phi), 0.1 * np.sin(3 * phi), 3 * np.sin(phi)], axis=1)
    R_drift = _fold(R_true, 15.0)
    ang = np.deg2rad(15.0) * np.arange(n) / n
    c_drift = np.stack([3 * np.cos(phi + ang), c_true[:, 1],
                        3 * np.sin(phi + ang)], axis=1)
    S = np.swapaxes(R_true, -1, -2) @ R_drift
    disp_edges = np.asarray([(i, i + 1) for i in range(n - 1)])
    disp_vals = c_drift[disp_edges[:, 1]] - c_drift[disp_edges[:, 0]]
    dir_edges = np.asarray([(0, n - 1), (1, n - 2)])
    u = c_true[dir_edges[:, 1]] - c_true[dir_edges[:, 0]]
    u = u / np.linalg.norm(u, axis=1, keepdims=True)
    args = (c_drift, S, disp_edges, disp_vals, dir_edges, u)
    got = tpg.position_solve(*args, dir_weight=20.0)
    want = jpg.position_solve(*args, dir_weight=20.0)
    np.testing.assert_allclose(got, want, atol=ATOL)
    # no direction edges
    np.testing.assert_allclose(
        tpg.position_solve(*args[:4], dir_edges[:0], u[:0]),
        jpg.position_solve(*args[:4], dir_edges[:0], u[:0]), atol=ATOL)


def _both(tmp_path, jrec, name):
    """The reference model and the port's copy of it, read from one binary
    model."""
    path = tmp_path / name
    path.mkdir()
    jrec.write_binary(path)
    return JRec(path), Reconstruction(path)


def _pair_pose(rec_poses, pairs):
    """{(i, j): (wxyz, t)} of cam_j_from_cam_i under the given poses."""
    out = {}
    for i, j in pairs:
        rel = rec_poses[j] * rec_poses[i].inverse()
        q = rel.rotation.quat  # xyzw
        out[(i, j)] = (np.array([q[3], q[0], q[1], q[2]]),
                       np.asarray(rel.translation))
    return out


def _drifted(tmp_path):
    """test_pose_graph.py TestRelaxEndToEnd's scene: true pair poses, stored
    poses with accumulating yaw drift."""
    from pycolmap_tpu.geometry import Rigid3d as JRigid
    from pycolmap_tpu.geometry import Rotation3d as JRot

    jrec, _ = _toy_reconstruction(n_images=12, noise=0.0)
    true = {i: jrec.images[i].cam_from_world for i in jrec.reg_image_ids}
    ids = sorted(jrec.reg_image_ids)
    pairs = [(ids[a], ids[a + 1]) for a in range(len(ids) - 1)]
    pairs += [(ids[a], ids[a + 2]) for a in range(len(ids) - 2)]
    pairs += [(ids[0], ids[-1]), (ids[1], ids[-2])]
    pair_pose = _pair_pose(true, pairs)
    for k, i in enumerate(ids):
        ang = np.deg2rad(10.0) * k / len(ids)
        c, s = np.cos(ang), np.sin(ang)
        Ry = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
        R_old = true[i].rotation.matrix()
        c_old = -R_old.T @ np.asarray(true[i].translation)
        R_new = R_old @ Ry
        jrec.images[i].cam_from_world = JRigid(JRot(R_new),
                                               -R_new @ (Ry.T @ c_old))
    return _both(tmp_path, jrec, "drifted") + (pair_pose,)


def _points(rec):
    return {p: rec.points3D[p].xyz.copy() for p in rec.points3D}


def _assert_points_close(got, want):
    assert got.keys() == want.keys()
    scale = max(np.abs(np.stack(list(want.values()))).max(), 1.0)
    d = max(np.abs(got[p] - want[p]).max() for p in want)
    assert d <= 1e-4 * scale


def _assert_poses_close(trec, jrec):
    assert trec.reg_image_ids == jrec.reg_image_ids
    for i in jrec.reg_image_ids:
        np.testing.assert_allclose(trec.images[i].cam_from_world.matrix(),
                                   jrec.images[i].cam_from_world.matrix(),
                                   atol=ATOL)


def test_residuals_and_noop_match(tmp_path):
    """test_pose_graph.py TestFoldDetector: consistent pair poses give ~0
    residuals, and relax_pose_graph leaves the healthy model alone."""
    jrec, trec = _both(tmp_path, _toy_reconstruction(noise=0.0)[0], "toy")
    poses = {i: jrec.images[i].cam_from_world for i in jrec.reg_image_ids}
    pair_pose = _pair_pose(poses, [(i, i + 1) for i in range(1, 8)])
    got = tpg.pose_graph_residuals_deg(trec, pair_pose)
    want = jpg.pose_graph_residuals_deg(jrec, pair_pose)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert got.max() < 0.01
    assert not tpg.relax_pose_graph(trec, pair_pose, min_residual_deg=1.0,
                                    device="cpu")
    assert not jpg.relax_pose_graph(jrec, pair_pose, min_residual_deg=1.0)
    _assert_poses_close(trec, jrec)


def test_relax_pose_graph_matches(tmp_path):
    """TestRelaxEndToEnd in both packages: the same rewritten poses (float64
    numpy) and the same retriangulated points (f32 DLT)."""
    jrec, trec, pair_pose = _drifted(tmp_path)
    np.testing.assert_allclose(tpg.pose_graph_residuals_deg(trec, pair_pose),
                               jpg.pose_graph_residuals_deg(jrec, pair_pose),
                               atol=ATOL)
    assert tpg.relax_pose_graph(trec, pair_pose, min_residual_deg=1.0,
                                device="cpu")
    assert jpg.relax_pose_graph(jrec, pair_pose, min_residual_deg=1.0)
    _assert_poses_close(trec, jrec)
    assert tpg.pose_graph_residuals_deg(trec, pair_pose).max() < 0.5
    _assert_points_close(_points(trec), _points(jrec))


def test_retriangulate_all_matches(tmp_path):
    """On the toy scene with five points whose keypoints are projections of
    points behind every camera: both packages re-estimate the same points
    and drop the same five."""
    jrec, pts = _toy_reconstruction(noise=0.0)
    behind = np.array([0.0, 0.0, -10.0])
    rng = np.random.default_rng(3)
    for iid in jrec.reg_image_ids:
        img = jrec.images[iid]
        cam = jrec.cameras[img.camera_id]
        xy = img.points2D_xy.copy()
        for p in range(5):
            X = img.cam_from_world * (behind + rng.normal(0, 0.3, 3))[None]
            xy[p] = cam.img_from_cam(X[:, :2] / X[:, 2:])[0]
        img.set_keypoints(xy)
    jrec, trec = _both(tmp_path, jrec, "behind")
    pids = sorted(jrec.points3D)
    assert pids == sorted(trec.points3D)
    t_out = tpg.retriangulate_all(trec, device="cpu")
    j_out = jpg.retriangulate_all(jrec)
    assert t_out == j_out
    assert t_out == (len(pts) - 5, 5)
    assert sorted(trec.points3D) == sorted(jrec.points3D)
    _assert_points_close(_points(trec), _points(jrec))
    got = np.stack([trec.points3D[p].xyz for p in sorted(trec.points3D)])
    assert np.abs(got - pts[5:]).max() < 1e-3


def test_collect_edges_matches(tmp_path):
    jrec, trec, pair_pose = _drifted(tmp_path)
    index = {iid: k for k, iid in enumerate(trec.reg_image_ids)}
    pair_pose = dict(pair_pose)
    pair_pose[(99, 1)] = next(iter(pair_pose.values()))  # unregistered image
    got = tpg._collect_edges(trec, pair_pose, index)
    want = jpg._collect_edges(jrec, pair_pose, index)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=ATOL)
    empty = tpg._collect_edges(trec, {}, index)
    assert [a.shape for a in empty] == [(0, 2), (0, 3, 3), (0, 3)]


def test_relax_needs_three_images():
    rec = Reconstruction()
    assert not tpg.relax_pose_graph(rec, {}, device="cpu")
    assert tpg.retriangulate_all(rec, device="cpu") == (0, 0)
