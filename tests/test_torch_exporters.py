"""The port's exporters (pycolmap_torch/scene/exporters.py) write the same
bytes as the reference's: on tests/test_exporter_goldens.py's hand-built
reconstruction (and its goldens) and on a larger one made from a seed with
numpy (three camera models, unregistered images, tracks through several
images). Also the port's ``utils/timer.py``: ``Timer`` and ``trace``."""

import time

import numpy as np
import pytest

import pycolmap_tpu.geometry as jgeo
import pycolmap_tpu.scene as jscene
import pycolmap_torch.geometry as tgeo
import pycolmap_torch.scene as tscene
from pycolmap_tpu.scene import exporters as jexp
from pycolmap_torch.scene import exporters as texp
from pycolmap_torch.utils import timer
from test_exporter_goldens import (
    GOLDEN_BUNDLER,
    GOLDEN_CAM,
    GOLDEN_NVM,
    GOLDEN_VRML_IMAGES,
    GOLDEN_VRML_POINTS,
)


def golden_rec(scene, geo):
    """tests/test_exporter_goldens.py build_rec, in either package."""
    rec = scene.Reconstruction()
    cam = scene.Camera.create(1, "SIMPLE_RADIAL", 600.0, 640, 480)
    params = np.asarray(cam.params, dtype=np.float64).copy()
    params[3] = 0.0625
    cam.params = params
    rec.add_camera(cam)
    img = scene.Image(name="a.jpg", camera_id=1, id=1)
    img.cam_from_world = geo.Rigid3d(geo.Rotation3d(np.eye(3)),
                                     np.array([0.5, -0.25, 2.0]))
    img.set_keypoints(np.array([[100.5, 200.25]], dtype=np.float64))
    img.registered = True
    rec.add_image(img)
    img2 = scene.Image(name="b.jpg", camera_id=1, id=2)
    img2.registered = False
    rec.add_image(img2)
    track = scene.Track()
    track.add_element(1, 0)
    pid = rec.add_point3D(np.array([1.5, -2.5, 8.0]), track, color=(10, 20, 30))
    img.points2D_point3D_ids[0] = np.uint64(pid)
    return rec


def random_rec(scene, geo, seed=0):
    """Eight images over three cameras (SIMPLE_RADIAL, RADIAL, PINHOLE), two
    unregistered, 60 points seen by 2-5 images each."""
    rng = np.random.default_rng(seed)
    rec = scene.Reconstruction()
    for cid, (model, params) in enumerate(
            [("SIMPLE_RADIAL", [0.05]), ("RADIAL", [-0.02, 0.01]),
             ("PINHOLE", [])], start=1):
        cam = scene.Camera.create(cid, model, 500.0 + 50 * cid, 800, 600)
        p = np.asarray(cam.params, dtype=np.float64).copy()
        if params:
            p[-len(params):] = params
        cam.params = p
        rec.add_camera(cam)
    n_kp = 40
    for iid in range(1, 9):
        img = scene.Image(name=f"img{iid:02d}.png", camera_id=1 + iid % 3,
                          id=iid)
        img.cam_from_world = geo.Rigid3d(
            geo.Rotation3d(rng.normal(0, 0.2, 3)), rng.normal(0, 1, 3))
        img.set_keypoints(rng.uniform(0, 600, (n_kp, 2)))
        img.registered = iid not in (3, 7)
        rec.add_image(img)
    used = {iid: 0 for iid in range(1, 9)}
    for _ in range(60):
        track = scene.Track()
        for iid in rng.choice(np.arange(1, 9), rng.integers(2, 6),
                              replace=False):
            track.add_element(int(iid), used[int(iid)])
            used[int(iid)] += 1
        pid = rec.add_point3D(rng.normal(0, 3, 3), track,
                              color=tuple(int(c) for c in
                                          rng.integers(0, 256, 3)))
        for el in track.elements:
            rec.images[el.image_id].points2D_point3D_ids[el.point2D_idx] = \
                np.uint64(pid)
    return rec


def _export_all(exp, rec, out):
    out.mkdir()
    exp.export_NVM(rec, out / "model.nvm")
    exp.export_NVM(rec, out / "model_nodist.nvm", skip_distortion=True)
    exp.export_bundler(rec, out / "bundle.out", out / "list.txt")
    exp.export_CAM(rec, out / "cam")
    exp.export_VRML(rec, out / "images.wrl", out / "points.wrl",
                    image_scale=0.5, image_rgb=(0.2, 0.4, 0.6))
    return {p.relative_to(out): p.read_bytes()
            for p in sorted(out.rglob("*")) if p.is_file()}


@pytest.mark.parametrize("build", [golden_rec, random_rec])
def test_exports_are_byte_identical(build, tmp_path):
    want = _export_all(jexp, build(jscene, jgeo), tmp_path / "reference")
    got = _export_all(texp, build(tscene, tgeo), tmp_path / "port")
    assert sorted(got) == sorted(want) and len(got) >= 7
    for name in want:
        assert got[name] == want[name], name


def test_exports_match_the_goldens(tmp_path):
    files = _export_all(texp, golden_rec(tscene, tgeo), tmp_path / "port")
    from pathlib import Path

    assert files[Path("model.nvm")].decode() == GOLDEN_NVM
    assert files[Path("bundle.out")].decode() == GOLDEN_BUNDLER
    assert files[Path("list.txt")].decode() == "a.jpg\n"
    assert files[Path("cam/a.cam")].decode() == GOLDEN_CAM
    assert Path("cam/b.cam") not in files
    # the goldens' VRML is at the default colour
    texp.export_VRML(golden_rec(tscene, tgeo), tmp_path / "i.wrl",
                     tmp_path / "p.wrl", image_scale=0.5)
    assert (tmp_path / "i.wrl").read_text() == GOLDEN_VRML_IMAGES
    assert (tmp_path / "p.wrl").read_text() == GOLDEN_VRML_POINTS


def test_timer():
    t = timer.Timer()
    assert t.elapsed_seconds() == 0.0
    t.start()
    time.sleep(0.02)
    t.pause()
    paused = t.elapsed_seconds()
    assert paused >= 0.02
    time.sleep(0.02)
    assert t.elapsed_seconds() == paused  # paused: no time passes
    t.resume()
    time.sleep(0.01)
    assert t.elapsed_seconds() >= paused + 0.01
    assert t.elapsed_micro_seconds() >= 3e4
    assert abs(t.elapsed_minutes() * 60 - t.elapsed_seconds()) < 1e-3
    assert t.elapsed_hours() < 1.0
    t.reset()
    assert t.elapsed_seconds() == 0.0
    t.restart()
    assert t.elapsed_seconds() < 1.0


def test_trace_writes_a_profile(tmp_path):
    import torch

    with timer.trace(str(tmp_path / "tr")) as d:
        assert d == str(tmp_path / "tr")
        torch.ones(64).cumsum(0)
    files = list((tmp_path / "tr").glob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
