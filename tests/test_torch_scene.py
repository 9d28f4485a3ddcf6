"""The port's scene layer vs the reference's on the CPU: model files and
databases written by one package and read by the other, the correspondence
graph, and camera projection. The model files are how a reconstruction
moves between the two packages, so they must be byte-identical; the
database is COLMAP's SQLite schema, read by both."""

import numpy as np
import pytest

from pycolmap_tpu.scene import Camera as JCamera
from pycolmap_tpu.scene import Database as JDatabase
from pycolmap_tpu.scene import Reconstruction as JRec
from pycolmap_tpu.sfm.database_cache import DatabaseCache as JCache
from pycolmap_torch.ops.camera_models import CAMERA_MODELS, MAX_PARAMS
from pycolmap_torch.scene import Camera, Database, Reconstruction
from pycolmap_torch.sfm.database_cache import DatabaseCache

from test_incremental_mapping import make_synthetic_database
from test_scene import build_synthetic_reconstruction

FILES = {"binary": ("cameras.bin", "images.bin", "points3D.bin"),
         "text": ("cameras.txt", "images.txt", "points3D.txt")}


def _write(rec, path, fmt):
    (rec.write_binary if fmt == "binary" else rec.write_text)(path)


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_model_files_are_byte_identical(tmp_path, fmt):
    """The reference writes, the port reads and writes again, the reference
    reads that: every file stays the same bytes."""
    ref = build_synthetic_reconstruction(num_images=5, num_points=60, seed=3)
    ref.deregister_image(3)  # unregistered images are not written
    _write(ref, tmp_path / "ref", fmt)
    port = Reconstruction(tmp_path / "ref")
    assert port.num_reg_images == 4 and port.num_points3D == 60
    port.check()
    _write(port, tmp_path / "port", fmt)
    back = JRec(tmp_path / "port")
    _write(back, tmp_path / "back", fmt)
    for name in FILES[fmt]:
        want = (tmp_path / "ref" / name).read_bytes()
        assert (tmp_path / "port" / name).read_bytes() == want, name
        assert (tmp_path / "back" / name).read_bytes() == want, name
    assert port.compute_mean_reprojection_error() == pytest.approx(
        back.compute_mean_reprojection_error(), rel=1e-12)


def test_model_statistics_and_filtering_match(tmp_path):
    ref = build_synthetic_reconstruction(num_images=4, num_points=80, seed=5)
    rng = np.random.default_rng(1)
    for pt in ref.points3D.values():  # some points far off their rays
        pt.xyz = pt.xyz + rng.normal(0, 0.02, 3) * (rng.uniform() < 0.3)
    ref.write_binary(tmp_path)
    port = Reconstruction(tmp_path)
    assert port.compute_mean_reprojection_error() == pytest.approx(
        ref.compute_mean_reprojection_error(), rel=1e-12)
    n_ref = ref.filter_points3D(2.0, 1.5)
    n_port = port.filter_points3D(2.0, 1.5)
    assert n_port == n_ref > 0
    assert sorted(port.points3D) == sorted(ref.points3D)
    port.check()


def _db(tmp_path):
    path = tmp_path / "db.db"
    make_synthetic_database(path, num_images=6, num_points=150)
    return path


def test_database_reads_are_equal(tmp_path):
    path = _db(tmp_path)
    jdb, tdb = JDatabase(path), Database(path)
    try:
        for a, b in zip(jdb.read_all_cameras(), tdb.read_all_cameras()):
            assert (a.camera_id, a.model, a.width, a.height) == (
                b.camera_id, b.model, b.width, b.height)
            np.testing.assert_array_equal(a.params, b.params)
        jimgs, timgs = jdb.read_all_images(), tdb.read_all_images()
        assert len(jimgs) == len(timgs) == 6
        for a, b in zip(jimgs, timgs):
            assert (a.image_id, a.name, a.camera_id) == (
                b.image_id, b.name, b.camera_id)
            np.testing.assert_array_equal(jdb.read_keypoints(a.image_id),
                                          tdb.read_keypoints(b.image_id))
            np.testing.assert_array_equal(jdb.read_descriptors(a.image_id),
                                          tdb.read_descriptors(b.image_id))
        assert jdb.num_verified_image_pairs == tdb.num_verified_image_pairs > 0
        ids = [i.image_id for i in jimgs]
        for i in ids:
            for j in ids:
                if i == j:
                    continue
                np.testing.assert_array_equal(jdb.read_matches(i, j),
                                              tdb.read_matches(i, j))
                a = jdb.read_two_view_geometry(i, j)
                b = tdb.read_two_view_geometry(i, j)
                assert (a is None) == (b is None)
                if a is None:
                    continue
                assert a.config == b.config
                np.testing.assert_array_equal(a.inlier_matches,
                                              b.inlier_matches)
                for m in ("E", "F", "H"):
                    ga, gb = getattr(a, m), getattr(b, m)
                    assert (ga is None) == (gb is None)
                    if ga is not None:
                        np.testing.assert_array_equal(ga, gb)
                np.testing.assert_array_equal(
                    a.cam2_from_cam1.rotation.quat,
                    b.cam2_from_cam1.rotation.quat)
                np.testing.assert_array_equal(a.cam2_from_cam1.translation,
                                              b.cam2_from_cam1.translation)
    finally:
        jdb.close()
        tdb.close()


def test_port_written_database_reads_back_in_the_reference(tmp_path):
    path = tmp_path / "port.db"
    cam = Camera.create(0, "SIMPLE_RADIAL", 500.0, 320, 240)
    db = Database(path)
    cid = db.write_camera(cam)
    from pycolmap_torch.scene import Image

    iid = db.write_image(Image(name="a.jpg", camera_id=cid))
    kps = np.random.default_rng(0).uniform(0, 300, (40, 4)).astype(np.float32)
    db.write_keypoints(iid, kps)
    db.close()
    jdb = JDatabase(path)
    try:
        np.testing.assert_array_equal(jdb.read_camera(cid).params, cam.params)
        assert jdb.read_image(iid).name == "a.jpg"
        np.testing.assert_allclose(jdb.read_keypoints(iid)[:, :2], kps[:, :2])
    finally:
        jdb.close()


def _caches(tmp_path):
    path = _db(tmp_path)
    return JCache.load(path), DatabaseCache.load(path)


def test_correspondence_graphs_are_equal(tmp_path):
    jc, tc = _caches(tmp_path)
    jg, tg = jc.correspondence_graph, tc.correspondence_graph
    for a, b in zip(jg.csr_arrays()[:4], tg.csr_arrays()[:4]):
        np.testing.assert_array_equal(a, b)
    assert jg.image_pairs() == tg.image_pairs()
    assert sorted(jc.pair_pose) == sorted(tc.pair_pose)
    for iid in jc.images:
        assert (jg.num_correspondences_for_image(iid)
                == tg.num_correspondences_for_image(iid))
        for k in range(0, jc.images[iid].num_points2D, 7):
            assert ([(c.image_id, c.point2D_idx)
                     for c in jg.find_correspondences(iid, k)]
                    == [(c.image_id, c.point2D_idx)
                        for c in tg.find_correspondences(iid, k)])


@pytest.mark.parametrize("transitivity", [1, 2, 3])
def test_transitive_correspondences_are_equal(tmp_path, transitivity):
    """The port's Python traversal against the reference's (its native
    C++ traversal where that library loads), as sets."""
    jc, tc = _caches(tmp_path)
    jg, tg = jc.correspondence_graph, tc.correspondence_graph
    n = 0
    for iid in jc.images:
        for k in range(0, jc.images[iid].num_points2D, 5):
            a = {(c.image_id, c.point2D_idx) for c in
                 jg.find_transitive_correspondences(iid, k, transitivity)}
            b = {(c.image_id, c.point2D_idx) for c in
                 tg.find_transitive_correspondences(iid, k, transitivity)}
            assert a == b
            n += len(a)
    assert n > 0


def _params(info, rng):
    p = np.zeros(info.num_params)
    for i in info.focal_idxs:
        p[i] = rng.uniform(400, 700)
    p[info.principal_idxs[0]] = 320.0
    p[info.principal_idxs[1]] = 240.0
    for i in info.extra_idxs:
        p[i] = rng.uniform(-0.05, 0.05)
    if info.name == "FOV":
        p[info.extra_idxs[0]] = 0.8
    return p


@pytest.mark.parametrize("info", CAMERA_MODELS, ids=lambda m: m.name)
def test_projection_matches(info):
    """img_from_cam and cam_from_img in float64, 1e-9 relative."""
    rng = np.random.default_rng(info.model_id)
    params = _params(info, rng)
    jcam = JCamera(1, info.name, 640, 480, params)
    tcam = Camera(1, info.name, 640, 480, params)
    uv = rng.uniform(-0.5, 0.5, (257, 2))
    got, ref = tcam.img_from_cam(uv), jcam.img_from_cam(uv)
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)
    np.testing.assert_allclose(tcam.cam_from_img(ref), jcam.cam_from_img(ref),
                               rtol=1e-9, atol=1e-12)
    # homogeneous input and a single point
    xyz = np.concatenate([uv * 3.0, np.full((257, 1), 3.0)], axis=1)
    np.testing.assert_allclose(tcam.img_from_cam(xyz), ref, rtol=1e-9)
    np.testing.assert_allclose(tcam.img_from_cam(uv[0]), ref[0], rtol=1e-9)
    assert len(tcam._padded_params()) == MAX_PARAMS
