"""The port's alignment (pycolmap_torch/estimators/alignment.py) against the
reference on the CPU.

- tests/test_estimators.py's cases of ``align_reconstruction_to_locations``
  (a Sim3 of scale 2 with one gross outlier, too few images, the typo
  alias), and the same at a 170 degree rotation, where a slip in the
  wxyz -> xyzw order shows;
- ``estimate_sim3d_robust`` against the reference's on outcomes (the
  inlier set, and scale, rotation and translation against the truth): the
  ``torch.Generator`` and ``jax.random`` streams differ;
- the one-shot Umeyama (float64 on the port, float32 on the reference)
  within 1e-4 of the reference's;
- ``align_reconstructions_via_points``'s observation pairs equal to the
  reference's dict walk, copied here;
- ``compare_reconstructions`` of the port against the reference's on one
  pair of models read by both packages, errors within 1e-4, in both modes;
- the device rule.
"""

import numpy as np
import pytest
import torch

import pycolmap_torch as pt
from pycolmap_torch.estimators import alignment as tal
from pycolmap_tpu import geometry as jgeo
from pycolmap_tpu.estimators import alignment as jal
from pycolmap_tpu.scene import Reconstruction as JRec

from test_scene import build_synthetic_reconstruction

CPU = "cpu"


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rot(axis, deg):
    axis = np.asarray(axis, np.float64) / np.linalg.norm(axis)
    a = np.deg2rad(deg)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(a) * K + (1 - np.cos(a)) * K @ K


def _rec_with_centers(rng, n_images=8):
    """tests/test_estimators.py's model: images at random centers."""
    rec = pt.Reconstruction()
    rec.add_camera(pt.Camera.create(1, "SIMPLE_PINHOLE", 500.0, 640, 480))
    centers = rng.uniform(-3, 3, (n_images, 3))
    for i, c in enumerate(centers):
        img = pt.Image(name=f"im{i}.jpg", camera_id=1, id=i + 1)
        img.cam_from_world = pt.Rigid3d(pt.Rotation3d(np.eye(3)), -c)
        img.registered = True
        rec.add_image(img)
    return rec, centers


@pytest.mark.parametrize("deg", [0.3 * 180 / np.pi, 170.0])
def test_align_to_locations_recovers_sim3(deg):
    """Scale 2, a turn about z (0.3 rad as the reference's test, then 170
    degrees about a skew axis), a shift, one gross outlier: every other
    center maps within 0.05."""
    rng = np.random.default_rng(0)
    rec, centers = _rec_with_centers(rng)
    R = _rot([0, 0, 1] if deg < 90 else [1, 2, 3], deg)
    locations = 2.0 * centers @ R.T + np.array([10.0, -5.0, 2.0])
    locations[3] += np.array([50.0, 0, 0])
    opts = pt.RANSACOptions()
    opts.max_error = 0.1
    names = [f"im{i}.jpg" for i in range(len(centers))]
    tform = pt.align_reconstruction_to_locations(rec, names, locations, 3,
                                                 opts, device=CPU)
    assert tform is not None
    err = np.linalg.norm(np.stack([tform * c for c in centers]) - locations,
                         axis=1)
    assert (err < 0.05).sum() >= 7 and err[3] > 1.0
    assert abs(tform.scale - 2.0) < 1e-4
    assert np.rad2deg(tform.rotation.angle_to(pt.Rotation3d(R))) < 1e-3


def test_align_to_locations_too_few():
    rng = np.random.default_rng(1)
    rec, centers = _rec_with_centers(rng, n_images=2)
    names = [f"im{i}.jpg" for i in range(2)]
    assert pt.align_reconstruction_to_locations(
        rec, names, centers, 3, pt.RANSACOptions(), device=CPU) is None
    with pytest.raises(ValueError):
        pt.align_reconstruction_to_locations(rec, names, centers, 2)


def test_reference_typo_alias():
    import pycolmap_torch.estimators as est

    assert (pt.align_reconstrution_to_locations
            is pt.align_reconstruction_to_locations)
    assert (est.align_reconstrution_to_locations
            is est.align_reconstruction_to_locations
            is tal.align_reconstruction_to_locations)


def test_estimate_sim3d_robust_matches_reference():
    """170 degrees, 30% gross outliers, 0.01 noise: the port's and the
    reference's inlier sets are the truth's, and both transforms are within
    1e-3 of it."""
    rng = np.random.default_rng(5)
    src = rng.uniform(-3, 3, (60, 3))
    R = _rot([1, -2, 0.5], 170.0)
    t = np.array([1.0, 2.0, -3.0])
    dst = 0.7 * src @ R.T + t + rng.normal(0, 0.003, (60, 3))
    bad = rng.random(60) < 0.3
    dst[bad] += rng.uniform(2, 5, (int(bad.sum()), 3))
    got, g_in = tal.estimate_sim3d_robust(src, dst, 0.05, device=CPU)
    ref, r_in = jal.estimate_sim3d_robust(src, dst, 0.05)
    np.testing.assert_array_equal(g_in, ~bad)
    np.testing.assert_array_equal(np.asarray(r_in), ~bad)
    for tf in (got, ref):
        assert abs(tf.scale - 0.7) < 1e-3
        assert np.rad2deg(tf.rotation.angle_to(
            type(tf.rotation)(R))) < 0.05
        assert np.abs(tf.translation - t).max() < 1e-2
    assert abs(got.scale - ref.scale) < 1e-4
    assert np.abs(got.rotation.matrix() - ref.rotation.matrix()).max() < 1e-4
    assert np.abs(got.translation - ref.translation).max() < 1e-4
    assert tal.estimate_sim3d_robust(src[:2], dst[:2], 0.05,
                                     device=CPU) == (None, None)


def test_one_shot_umeyama_matches_reference():
    """The float64 one-shot solve against the reference's float32 one,
    at 170 degrees."""
    rng = np.random.default_rng(6)
    src = rng.uniform(-3, 3, (20, 3))
    R = _rot([0.3, 1, -1], 170.0)
    dst = 1.3 * src @ R.T + np.array([0.5, -1.0, 4.0])
    got = tal._sim3_from_umeyama(src, dst)
    ref = jal._sim3_from_umeyama(src, dst)
    assert abs(got.scale - 1.3) < 1e-12
    assert np.abs(got.rotation.matrix() - R).max() < 1e-12
    assert np.abs(got.rotation.quat - ref.rotation.quat).max() < 1e-4
    assert np.abs(got.translation - ref.translation).max() < 1e-4
    assert abs(got.scale - ref.scale) < 1e-4


def _model_pair(tmp_path):
    """Model a (tests/test_scene.py's synthetic scene) and b: a under a
    Sim3 of 170 degrees, with 0.2-0.6 degree pose errors, 5e-4 point
    noise, one image and two points dropped. Both packages read both."""
    rng = np.random.default_rng(9)
    a = build_synthetic_reconstruction(num_images=6, num_points=80, seed=3)
    a.write_binary(tmp_path / "a")
    b = JRec(tmp_path / "a")
    b.transform(jgeo.Sim3d(1.7, jgeo.Rotation3d(_rot([1, 1, 0], 170.0)),
                           np.array([3.0, -1.0, 2.0])))
    for img in b.images.values():
        d = jgeo.Rotation3d(_rot(rng.normal(size=3), rng.uniform(0.2, 0.6)))
        img.cam_from_world = jgeo.Rigid3d(
            d * img.cam_from_world.rotation,
            img.cam_from_world.translation + rng.normal(0, 1e-3, 3))
    for pt3 in b.points3D.values():
        pt3.xyz = pt3.xyz + rng.normal(0, 5e-4, 3)
    b.deregister_image(6)
    for pid in (4, 17):
        b.delete_point3D(pid)
    b.write_binary(tmp_path / "b")
    return ((pt.Reconstruction(tmp_path / "a"),
             pt.Reconstruction(tmp_path / "b")),
            (JRec(tmp_path / "a"), JRec(tmp_path / "b")))


def _ref_pairs(src, tgt, min_common_observations=3):
    """The reference's (image name, point2D_idx) walk
    (pycolmap_tpu/estimators/alignment.py:146-167)."""
    src_obs = {}
    for pid, p in src.points3D.items():
        for el in p.track.elements:
            img = src.images.get(el.image_id)
            if img is not None:
                src_obs[(img.name, el.point2D_idx)] = pid
    pairs = {}
    for pid, p in tgt.points3D.items():
        for el in p.track.elements:
            img = tgt.images.get(el.image_id)
            if img is None:
                continue
            spid = src_obs.get((img.name, el.point2D_idx))
            if spid is not None:
                pairs[(spid, pid)] = pairs.get((spid, pid), 0) + 1
    return [k for k, c in pairs.items() if c >= min_common_observations]


def test_common_point_pairs_match_reference(tmp_path):
    (ta, tb), _ = _model_pair(tmp_path)
    for src, tgt in ((ta, tb), (tb, ta)):
        for m in (1, 3, 6):
            assert tal._common_point_pairs(src, tgt, m) == _ref_pairs(
                src, tgt, m)
    # a src point that shares an observation with an earlier one claims it
    tb.points3D[2].track.add_element(1, 1)
    assert tal._common_point_pairs(tb, ta, 1) == _ref_pairs(tb, ta, 1)


@pytest.mark.parametrize("mode", ["reprojection", "proj_center"])
def test_compare_reconstructions_matches_reference(tmp_path, mode):
    (ta, tb), (ja, jb) = _model_pair(tmp_path)
    got = pt.compare_reconstructions(ta, tb, mode, device=CPU)
    ref = jal.compare_reconstructions(ja, jb, mode)
    assert [e.image_name for e in got["errors"]] == [
        e.image_name for e in ref["errors"]]
    assert len(got["errors"]) == 5
    for g, r in zip(got["errors"], ref["errors"]):
        assert abs(g.rotation_error_deg - r.rotation_error_deg) < 1e-4
        assert abs(g.proj_center_error - r.proj_center_error) < 1e-4
        assert 0.05 < g.rotation_error_deg < 3.0
    tf, rf = got["rec2_from_rec1"], ref["rec2_from_rec1"]
    assert abs(tf.scale - rf.scale) < 1e-4
    assert np.abs(tf.translation - rf.translation).max() < 1e-4
    assert "ImageAlignmentError(image_name=" in repr(got["errors"][0])


def test_align_via_points_and_reprojections(tmp_path):
    (ta, tb), (ja, jb) = _model_pair(tmp_path)
    for fn in ("align_reconstructions_via_points",
               "align_reconstructions_via_reprojections"):
        got = getattr(pt, fn)(ta, tb, device=CPU)
        ref = getattr(jal, fn)(ja, jb)
        assert abs(got.scale - 1.7) < 1e-3 and abs(got.scale - ref.scale) < 1e-4
        assert np.abs(got.rotation.matrix()
                      - ref.rotation.matrix()).max() < 1e-4
    # too few common points: via_points gives None, via_reprojections falls
    # back to the projection centers
    empty = pt.Reconstruction()
    assert pt.align_reconstructions_via_points(ta, empty, device=CPU) is None
    for pid in list(tb.points3D):
        tb.delete_point3D(pid)
    got = pt.align_reconstructions_via_reprojections(ta, tb, device=CPU)
    assert got == pt.align_reconstructions_via_proj_centers(ta, tb)
    assert abs(got.scale - 1.7) < 0.05
    assert pt.align_reconstructions_via_proj_centers(ta, empty) is None


def test_device_rule():
    """No device means the card: without one, the robust Sim3 raises
    rather than falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has the card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tal.estimate_sim3d_robust(np.zeros((5, 3)), np.zeros((5, 3)), 0.1)
