"""The port's image ingestion and feature extraction (pycolmap_torch/
pipeline/images.py and extract_features.py) against the reference on the
CPU.

- ``list_images`` and ``import_images`` on one tree of PNG, PGM and PPM
  files in sub-folders, in every camera mode and with the per-folder,
  per-image and camera-parameter options: the same names, cameras,
  parameters and image-to-camera map (both databases read back through
  the port's reader: they share COLMAP's schema);
- ``infer_camera_from_image`` of JPEGs with an EXIF focal length;
- PGM and PPM files read, sized and imported with Pillow's import blocked;
- ``extract_features`` of three 240x320 images, the third in a second call
  with ``max_image_size`` 256 (the device resize; the first two skipped as
  already extracted), keypoints paired with the reference's at
  tests/test_torch_sift.py's bounds (97% within 0.01 px, descriptors
  within one uint8 step).

The resize is ``F.interpolate(..., antialias=True)`` where the reference
calls ``jax.image.resize``: the same function, summed in another order
(within 3.1e-5 of 255 here). At a scale of 0.8 the filter's weights are
multiples of a tenth, so many exact values end in .5 and the uint8 rounding
takes either side: 24 of the 49,152 pixels differ by one level, and SIFT on
the two inputs pairs 92.5% of the keypoints. So the resize is held to the
reference's within one level on under 0.1% of the pixels, and the third
image's features to the reference pipeline's run on the port's resized
image (its ``_resize_to_max`` swapped for the port's), at the bounds above.
"""

import importlib
import sys

import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from pycolmap_tpu.features.sift import SiftExtractionOptions as JSiftOptions
from pycolmap_tpu.pipeline import images as jim
from pycolmap_torch import convert
from pycolmap_torch.pipeline import images as tim
from pycolmap_torch.scene import Database
from test_features import blob_image
from test_torch_sift import _pair

CPU = "cpu"
# the modules (each package's pipeline namespace binds the function's name)
j_ef = importlib.import_module("pycolmap_tpu.pipeline.extract_features")
t_ef = importlib.import_module("pycolmap_torch.pipeline.extract_features")


@pytest.fixture(autouse=True)
def _one_thread():
    """Many tiny CPU ops: one intra-op thread per worker."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _write_pnm(path, arr):
    magic = b"P5" if arr.ndim == 2 else b"P6"
    path.write_bytes(magic + b"\n# made by the test\n%d %d\n255\n"
                     % (arr.shape[1], arr.shape[0]) + arr.tobytes())


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Images of four sizes in the root and two sub-folders."""
    root = tmp_path_factory.mktemp("tree")
    rng = np.random.default_rng(0)
    (root / "a").mkdir()
    (root / "b" / "c").mkdir(parents=True)

    def u8(*shape):
        return rng.integers(0, 256, shape, dtype=np.uint8)

    PILImage.fromarray(u8(30, 40, 3)).save(root / "a" / "x.png")
    _write_pnm(root / "a" / "y.pgm", u8(20, 50))
    PILImage.fromarray(u8(48, 64)).save(root / "b" / "z.png")
    _write_pnm(root / "b" / "c" / "w.ppm", u8(21, 33, 3))
    _write_pnm(root / "top.ppm", u8(40, 30, 3))
    (root / "notes.txt").write_text("not an image")
    return root


def _db_state(path):
    db = Database(path)
    try:
        cams = {c.camera_id: (c.model_name, c.width, c.height,
                              tuple(np.round(c.params, 9)),
                              c.has_prior_focal_length)
                for c in db.read_all_cameras()}
        images = {im.name: im.camera_id for im in db.read_all_images()}
    finally:
        db.close()
    return cams, images


def test_list_images(tree):
    got = tim.list_images(tree)
    assert got == jim.list_images(tree)
    assert len(got) == 5 and "b/c/w.ppm" in got


MODES = {
    "auto": (0, {}),
    "single": (1, {}),
    "per_folder": (2, {}),
    "per_image": (3, {}),
    "option_per_folder": (0, {"single_camera_per_folder": True}),
    "option_per_image": (1, {"single_camera_per_image": True}),
    "params": (3, {"camera_model": "PINHOLE",
                   "camera_params": "100, 110, 20, 15",
                   "default_focal_length_factor": 2.0}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_import_images_matches_reference(tree, tmp_path, mode):
    camera_mode, kw = MODES[mode]
    jo = jim.ImageReaderOptions(**kw)
    to = convert.image_reader_options_from_dict(jo.todict())
    jim.import_images(tmp_path / "j.db", tree, camera_mode, None, jo)
    tim.import_images(tmp_path / "t.db", tree, camera_mode, None, to,
                      device=CPU)
    want, got = _db_state(tmp_path / "j.db"), _db_state(tmp_path / "t.db")
    assert got == want
    assert len(got[1]) == 5
    # importing again adds nothing
    tim.import_images(tmp_path / "t.db", tree, camera_mode, None, to,
                      device=CPU)
    assert _db_state(tmp_path / "t.db") == got


def test_reader_options_round_trip():
    ref = jim.ImageReaderOptions(
        camera_model="OPENCV", single_camera=True,
        single_camera_per_folder=True, single_camera_per_image=True,
        existing_camera_id=3, camera_params="1,2,3,4,5,6,7,8",
        default_focal_length_factor=1.5, mask_path="masks/")
    got = convert.image_reader_options_from_dict(ref.todict())
    assert got.todict() == ref.todict() != tim.ImageReaderOptions().todict()


def test_import_selected_names(tree, tmp_path):
    names = ["b/z.png", "top.ppm"]
    jim.import_images(tmp_path / "j.db", tree, 3, names)
    tim.import_images(tmp_path / "t.db", tree, 3, names, device=CPU)
    assert _db_state(tmp_path / "t.db") == _db_state(tmp_path / "j.db")


@pytest.mark.parametrize("tag", [0xA405, 0x920A])
def test_infer_camera_from_exif(tmp_path, tag):
    """FocalLengthIn35mmFilm (0xA405) or FocalLength (0x920A) -> pixels,
    and the prior flag set, as the reference."""
    path = tmp_path / "exif.jpg"
    exif = PILImage.Exif()
    exif[tag] = 50
    PILImage.fromarray(np.full((60, 80, 3), 128, np.uint8)).save(
        path, exif=exif)
    want = jim.infer_camera_from_image(path)
    got = tim.infer_camera_from_image(path)
    assert got.has_prior_focal_length and want.has_prior_focal_length
    np.testing.assert_array_equal(got.params, want.params)
    assert got.params[0] == pytest.approx(50 / 35 * 80)
    plain = tmp_path / "plain.jpg"
    PILImage.fromarray(np.full((60, 80), 9, np.uint8)).save(plain)
    got = tim.infer_camera_from_image(plain)
    assert not got.has_prior_focal_length
    np.testing.assert_array_equal(got.params,
                                  jim.infer_camera_from_image(plain).params)


def test_pnm_without_pillow(tree, tmp_path, monkeypatch):
    """PGM and PPM need no Pillow: read, sized (no EXIF, so the default
    focal length) and imported with ``import PIL`` failing."""
    pnm = ["a/y.pgm", "b/c/w.ppm", "top.ppm"]
    want_gray = {n: jim.read_image_gray_u8(tree / n) for n in pnm}
    want_cam = {n: jim.infer_camera_from_image(tree / n) for n in pnm}
    jim.import_images(tmp_path / "j.db", tree, 3, pnm)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError):
        tim.read_image_gray_u8(tree / "b" / "z.png")
    for n in pnm:
        np.testing.assert_array_equal(tim.read_image_gray_u8(tree / n),
                                      want_gray[n])
        cam = tim.infer_camera_from_image(tree / n)
        assert not cam.has_prior_focal_length
        np.testing.assert_array_equal(cam.params, want_cam[n].params)
    tim.import_images(tmp_path / "t.db", tree, 3, pnm, device=CPU)
    assert _db_state(tmp_path / "t.db") == _db_state(tmp_path / "j.db")


def _image(i):
    u8 = (blob_image(10 + i, H=240, W=320, n=120) * 255).round()
    return u8.astype(np.uint8)


def _read_features(db_path):
    d = Database(db_path)
    try:
        return {im.name: (d.read_keypoints(im.image_id),
                          d.read_descriptors(im.image_id))
                for im in d.read_all_images()}
    finally:
        d.close()


@pytest.fixture(scope="module")
def extracted(tmp_path_factory):
    """Both packages' extract_features on the same three images: two at
    default options, then the third with max_image_size 256; and the
    reference's run of the third on the port's resized image."""
    torch.set_num_threads(1)
    root = tmp_path_factory.mktemp("extract")
    imgs = root / "images"
    imgs.mkdir()
    for i in range(3):
        PILImage.fromarray(_image(i)).save(imgs / f"im{i}.png")
    jo = JSiftOptions()
    jo.max_num_features = 1000
    jo_small = JSiftOptions(max_num_features=1000, max_image_size=256)
    for tag, extract, conv, kw in (
            ("j", j_ef.extract_features, lambda o: o, {}),
            ("t", t_ef.extract_features,
             lambda o: convert.sift_options_from_dict(o.todict()),
             {"device": CPU})):
        db = root / f"{tag}.db"
        extract(db, imgs, image_names=["im0.png", "im1.png"],
                sift_options=conv(jo), **kw)
        extract(db, imgs, sift_options=conv(jo_small), **kw)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_ef, "_resize_to_max",
                   lambda img, size: t_ef._resize_to_max(img, size, CPU))
        j_ef.extract_features(root / "jr.db", imgs, image_names=["im2.png"],
                              sift_options=jo_small)
    return {tag: _read_features(root / f"{tag}.db")
            for tag in ("j", "t", "jr")}


@pytest.mark.parametrize("name", ["im0.png", "im1.png", "im2.png"])
def test_extract_features_matches_reference(extracted, name):
    ref = extracted["jr" if name == "im2.png" else "j"][name]
    (kr, dr), (kp, dp) = ref, extracted["t"][name]
    assert dp.dtype == np.uint8 and dr.dtype == np.uint8
    assert len(kr) > 20 and abs(len(kp) - len(kr)) <= 0.03 * len(kr) + 1
    p = _pair(kr, kp)
    ok = p >= 0
    assert ok.mean() >= 0.97, ok.mean()
    diff = np.abs(dp[p[ok]].astype(int) - dr[ok].astype(int))
    assert diff.max() <= 1


def test_resize_matches_reference(extracted):
    """The device resize against jax.image.resize's: the same shape and
    scale, within one level, on under 0.1% of the pixels; and im2's
    keypoints scaled back to the full resolution."""
    img = _image(2)
    want, s_want = j_ef._resize_to_max(img, 256)
    got, s_got = t_ef._resize_to_max(img, 256, CPU)
    assert got.dtype == np.uint8 and got.shape == want.shape == (192, 256)
    assert s_got == s_want == 1.25
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
    same, scale = t_ef._resize_to_max(img, 320, CPU)
    assert same is img and scale == 1.0
    k = extracted["t"]["im2.png"][0]
    assert 256 < k[:, 0].max() < 320


def test_default_device_needs_cuda(tree, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tim.import_images(tmp_path / "t.db", tree)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_ef.extract_features(tmp_path / "t.db", tree)
    assert not (tmp_path / "t.db").exists()
