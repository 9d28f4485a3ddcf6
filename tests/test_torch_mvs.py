"""The port's dense pipeline (pycolmap_torch/mvs, pycolmap_torch/pipeline/
images.py and mvs.py, plain versions on the CPU) against the reference's.

Files cross between the packages unchanged: depth and normal maps,
consistency graphs, fused.ply and its .vis, undistorted models. The
deterministic stages (workspace, filter, fusion, undistortion, readers)
must agree exactly or to f32 rounding; whole PatchMatch runs are compared
on outcomes, since the two packages draw their random candidates from
different generators (torch.Generator vs jax.random).
"""

import shutil

import jax.image
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image as PILImage

from pycolmap_tpu.mvs import consistency_graph as cg_ref
from pycolmap_tpu.mvs import controller as ctl_ref
from pycolmap_tpu.mvs import depth_map_io as io_ref
from pycolmap_tpu.mvs import fusion as fu_ref
from pycolmap_tpu.mvs.patch_match import PatchMatchOptions as PMO_ref
from pycolmap_tpu.mvs.workspace import MVSModel as Model_ref
from pycolmap_tpu.pipeline import images as im_ref
from pycolmap_tpu.pipeline.mvs import patch_match_stereo as pms_ref
from pycolmap_tpu.pipeline.mvs import stereo_fusion as sf_ref
from pycolmap_tpu.scene import Camera as Camera_ref
from pycolmap_tpu.scene import Reconstruction as Rec_ref
from pycolmap_torch import convert
from pycolmap_torch.mvs import consistency_graph as cg
from pycolmap_torch.mvs import controller as ctl
from pycolmap_torch.mvs import depth_map_io as io
from pycolmap_torch.mvs import fusion as fu
from pycolmap_torch.mvs.workspace import MVSModel
from pycolmap_torch.pipeline import images as im
from pycolmap_torch.pipeline import (
    PatchMatchOptions,
    StereoFusionOptions,
    UndistortCameraOptions,
    patch_match_stereo,
    stereo_fusion,
    undistort_images,
)
from pycolmap_torch.scene import Camera

from test_mvs import build_workspace
from test_torch_patch_match import _plane_depth


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, where every worker's thread pool would contend for
    the host's cores (a 20 s test took 21 minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """tests/test_mvs.py's workspace at 128x96: 4 rendered views of two
    planes, 100 ground-truth points seen by every view."""
    return build_workspace(tmp_path_factory.mktemp("ws"), num_images=4,
                           W=128, H=96)[0]


def test_depth_map_and_consistency_graph_files_match(tmp_path):
    rng = np.random.default_rng(0)
    for shape in ((20, 30), (20, 30, 3)):
        a = rng.normal(size=shape).astype(np.float32)
        io.write_mat(tmp_path / "port.bin", a)
        io_ref.write_mat(tmp_path / "ref.bin", a)
        assert (tmp_path / "port.bin").read_bytes() == \
            (tmp_path / "ref.bin").read_bytes()
        assert np.array_equal(io.read_mat(tmp_path / "ref.bin"), a)
        assert np.array_equal(io_ref.read_mat(tmp_path / "port.bin"), a)
    cons = rng.uniform(size=(3, 6, 8)) > 0.6
    cg.write_consistency_graph(tmp_path / "g_port.bin", cons)
    cg_ref.write_consistency_graph(tmp_path / "g_ref.bin", cons)
    assert (tmp_path / "g_port.bin").read_bytes() == \
        (tmp_path / "g_ref.bin").read_bytes()
    assert cg.read_consistency_graph(tmp_path / "g_ref.bin") == \
        cg_ref.read_consistency_graph(tmp_path / "g_port.bin")
    assert io.depth_map_path("w", "a.png", "geometric") == \
        io_ref.depth_map_path("w", "a.png", "geometric")


def test_workspace_ranges_and_sources(workspace):
    port, ref = MVSModel(workspace), Model_ref(workspace)
    assert list(port.images) == list(ref.images)
    for iid, m in ref.images.items():
        p = port.images[iid]
        assert (p.depth_min, p.depth_max) == (m.depth_min, m.depth_max)
        assert p.src_ids == m.src_ids and len(m.src_ids) == 3
        np.testing.assert_array_equal(p.K, m.K)
        np.testing.assert_array_equal(p.R, m.R)


def _synthetic_maps(ws, seed=0):
    """Ground-truth plane depths with 0.2% noise and holes, and the planes'
    normals (+ noise) in each camera, per image id."""
    rng = np.random.default_rng(seed)
    model = Model_ref(ws)
    depths, normals, costs = {}, {}, {}
    for iid, m in model.images.items():
        gt = _plane_depth(m, m.K, m.height, m.width)
        d = np.where(np.isfinite(gt), gt, 0.0)
        d *= 1 + 0.002 * rng.normal(size=d.shape)
        d[rng.uniform(size=d.shape) < 0.05] = 0.0
        depths[iid] = d.astype(np.float32)
        n = np.broadcast_to(-m.R[:, 2][None, None], d.shape + (3,))
        n = n + 0.05 * rng.normal(size=n.shape)
        normals[iid] = (n / np.linalg.norm(n, axis=-1, keepdims=True)
                        ).astype(np.float32)
        costs[iid] = rng.uniform(0, 1.5, d.shape).astype(np.float32)
    return model, depths, normals, costs


def test_filter_and_fusion_write_the_same_files(workspace, tmp_path):
    """Identical input maps give identical filtered maps, consistency
    graphs, fused.ply and fused.ply.vis."""
    wss = {}
    for tag in ("ref", "port"):
        wss[tag] = tmp_path / tag
        shutil.copytree(workspace, wss[tag])
        for sub in ("depth_maps", "normal_maps"):
            (wss[tag] / "stereo" / sub).mkdir(parents=True)
    model_ref, depths, normals, costs = _synthetic_maps(workspace)
    model = MVSModel(workspace)
    images = {iid: (None, m.K) for iid, m in model.images.items()}
    opts = PatchMatchOptions(write_consistency_graph=True)
    ctl_ref.geometric_consistency_filter(
        wss["ref"], model_ref, images, depths, costs,
        PMO_ref(write_consistency_graph=True))
    ctl.geometric_consistency_filter(
        wss["port"], model, images,
        {k: torch.from_numpy(v) for k, v in depths.items()},
        {k: torch.from_numpy(v) for k, v in costs.items()}, opts)
    for m in model.images.values():
        for path in (io.depth_map_path, cg.consistency_graph_path):
            got = path(wss["port"], m.name, "geometric").read_bytes()
            want = path(wss["ref"], m.name, "geometric").read_bytes()
            assert got == want, path
        kept = io.read_mat(io.depth_map_path(wss["port"], m.name, "geometric"))
        assert (kept > 0).mean() > 0.3
        for ws in wss.values():
            io.write_mat(io.normal_map_path(ws, m.name, "geometric"),
                         normals[m.image_id])
    fused = {"ref": sf_ref(wss["ref"] / "fused.ply", wss["ref"]),
             "port": stereo_fusion(wss["port"] / "fused.ply", wss["port"],
                                   device="cpu")}
    assert len(fused["port"][0]) > 1000
    for name in ("fused.ply", "fused.ply.vis"):
        assert (wss["port"] / name).read_bytes() == \
            (wss["ref"] / name).read_bytes(), name
    counts, flat = fu.read_fused_vis(wss["ref"] / "fused.ply.vis")
    counts_ref, flat_ref = fu_ref.read_fused_vis(wss["port"] / "fused.ply.vis")
    assert np.array_equal(counts, counts_ref) and np.array_equal(flat, flat_ref)


def _radial_camera(cam_cls):
    return cam_cls(1, "SIMPLE_RADIAL", 80, 60, [70.0, 40.0, 30.0, -0.08])


def test_undistort_camera_and_image():
    cam, cam_ref = _radial_camera(Camera), _radial_camera(Camera_ref)
    for blank in (0.0, 1.0):
        new = im.undistort_camera(cam, UndistortCameraOptions(blank_pixels=blank))
        new_ref = im_ref.undistort_camera(
            cam_ref, im_ref.UndistortCameraOptions(blank_pixels=blank))
        assert new.model == new_ref.model == "PINHOLE"
        np.testing.assert_allclose(new.params, new_ref.params, atol=1e-12,
                                   rtol=0)
    rng = np.random.default_rng(1)
    rgb = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    gray = rng.uniform(size=(60, 80)).astype(np.float32)
    u8 = im.undistort_image(rgb, cam, new, device="cpu")
    u8_ref = im_ref.undistort_image(rgb, cam_ref, new_ref)
    assert u8.dtype == np.uint8 and u8.shape == rgb.shape
    assert np.abs(u8.astype(int) - u8_ref.astype(int)).max() <= 1
    f = im.undistort_image(gray, cam, new, device="cpu")
    np.testing.assert_allclose(f, im_ref.undistort_image(gray, cam_ref,
                                                         new_ref), atol=1e-5)


def test_undistort_images_workspace(tmp_path):
    """Both packages undistort a SIMPLE_RADIAL model and its .ppm / .png
    images into a workspace: the same sparse model bytes, images within
    one uint8 step."""
    src = tmp_path / "in"
    (src / "images").mkdir(parents=True)
    rec = Rec_ref()
    rec.add_camera(_radial_camera(Camera_ref))
    rng = np.random.default_rng(2)
    from pycolmap_tpu.scene import Image as Image_ref

    for i, name in enumerate(("a.ppm", "b.png")):
        PILImage.fromarray(rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
                           ).save(src / "images" / name)
        img = Image_ref(name=name, camera_id=1, id=i + 1)
        img.registered = True
        rec.add_image(img)
    rec.write_binary(src)
    im_ref.undistort_images(tmp_path / "ref", src, src / "images")
    undistort_images(tmp_path / "port", src, src / "images", device="cpu")
    for f in ("cameras.bin", "images.bin", "points3D.bin"):
        assert (tmp_path / "port" / "sparse" / f).read_bytes() == \
            (tmp_path / "ref" / "sparse" / f).read_bytes()
    for name in ("a.ppm", "b.png"):
        got = im.read_image_rgb(tmp_path / "port" / "images" / name)
        want = im_ref.read_image_rgb(tmp_path / "ref" / "images" / name)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("mode", ["L", "RGB"])
def test_pnm_readers_and_writer_match_pillow(tmp_path, mode):
    rng = np.random.default_rng(3)
    shape = (37, 53) if mode == "L" else (37, 53, 3)
    arr = rng.integers(0, 256, shape, dtype=np.uint8)
    ext = ".pgm" if mode == "L" else ".ppm"
    PILImage.fromarray(arr).save(tmp_path / f"pil{ext}")
    im.write_image(tmp_path / f"port{ext}", arr)
    assert (tmp_path / f"port{ext}").read_bytes() == \
        (tmp_path / f"pil{ext}").read_bytes()
    # a header with a comment, as other writers emit
    head = b"P5" if mode == "L" else b"P6"
    (tmp_path / f"c{ext}").write_bytes(
        head + b"\n# comment\n53 37\n255\n" + arr.tobytes())
    for p in (tmp_path / f"pil{ext}", tmp_path / f"c{ext}"):
        assert np.array_equal(im.read_image_gray(p), im_ref.read_image_gray(p))
        assert np.array_equal(im.read_image_rgb(p), im_ref.read_image_rgb(p))
    assert np.array_equal(im._read_pnm(tmp_path / f"c{ext}"), arr)
    # maxval below 255: Pillow scales the samples to 0..255 (values above
    # maxval clip to it)
    for maxval in (1, 15, 254):
        p = tmp_path / f"m{maxval}{ext}"
        p.write_bytes(head + b"\n53 37\n%d\n" % maxval + arr.tobytes())
        with PILImage.open(p) as pil:
            want = np.asarray(pil)
        assert np.array_equal(im._read_pnm(p), want)
        assert np.array_equal(im.read_image_gray(p), im_ref.read_image_gray(p))
        assert np.array_equal(im.read_image_rgb(p), im_ref.read_image_rgb(p))


def test_resize_matches_jax_image_resize():
    rng = np.random.default_rng(4)
    img = rng.uniform(size=(50, 70)).astype(np.float32)
    for size in ((31, 43), (25, 35), (80, 100), (50, 40)):
        got = ctl.resize_bilinear(torch.from_numpy(img), size).numpy()
        want = np.asarray(jax.image.resize(jnp.asarray(img), size, "bilinear"))
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_options_from_reference_dicts():
    pm_opts = PMO_ref(window_radius=3, num_iterations=2, gpu_index="0")
    got = convert.patch_match_options_from_dict(pm_opts.todict())
    assert got.window_radius == 3 and got.num_iterations == 2
    assert not hasattr(got, "gpu_index")
    fo = fu_ref.StereoFusionOptions(max_reproj_error=1.5, check_num_images=7)
    got = convert.stereo_fusion_options_from_dict(fo.todict())
    assert got.todict() == StereoFusionOptions(
        max_reproj_error=1.5, check_num_images=7).todict()
    uo = im_ref.UndistortCameraOptions(max_scale=1.5, blank_pixels=0.5)
    got = convert.undistort_options_from_dict(uo.todict())
    assert got.todict() == uo.todict()


def _outcomes(ws):
    """Valid share and median relative error of view01's geometric map
    against the planes (tests/test_mvs.py's measure), and the fused count."""
    model = Model_ref(ws)
    m = [m for m in model.images.values() if m.name == "view01.png"][0]
    d = io.read_mat(io.depth_map_path(ws, m.name, "geometric"))
    gt = _plane_depth(m, m.K, *d.shape)
    valid = (d > 0) & np.isfinite(gt)
    return valid.mean(), float(np.median(np.abs(d[valid] - gt[valid])
                                         / gt[valid]))


def test_dense_pipeline_outcomes_match_reference(workspace, tmp_path):
    """patch_match_stereo + stereo_fusion on the 4-image 128x96 workspace,
    2 iterations, radius 2 / step 2. The reference run gives 40.0% valid
    geometric depth on view01 at a median relative error of 0.0020 and 706
    fused points (the port on its CPU path: 40.0%, 0.0019, 616; the
    generators differ). Tolerances: valid share within 0.1, error at most
    1.5x the reference's, at least 0.6x its fused points, fused points
    within 0.02 of the planes (tests/test_mvs.py)."""
    out = {}
    for tag, pms, sf, opts, kw in (
            ("ref", pms_ref, sf_ref, PMO_ref(), {}),
            ("port", patch_match_stereo, stereo_fusion, PatchMatchOptions(),
             dict(device="cpu"))):
        ws = tmp_path / tag
        shutil.copytree(workspace, ws)
        opts.num_iterations, opts.window_radius, opts.window_step = 2, 2, 2
        pms(ws, options=opts, **kw)
        xyz, _ = sf(ws / "fused.ply", ws, **kw)
        z_err = np.minimum(np.abs(xyz[:, 2] - 6.0), np.abs(xyz[:, 2] - 7.5))
        out[tag] = _outcomes(ws) + (len(xyz), float(np.median(z_err)))
    (v_ref, e_ref, n_ref, _), (v, e, n, z) = out["ref"], out["port"]
    assert abs(v - v_ref) <= 0.1 and v > 0.2, out
    assert e <= 1.5 * e_ref and e < 0.01, out
    assert n >= 0.6 * n_ref and z < 0.02, out
