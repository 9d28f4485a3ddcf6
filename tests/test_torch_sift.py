"""The port's SIFT (pycolmap_torch/features/sift.py, plain versions on the
CPU) vs the reference's, stage by stage on the same inputs, then whole.

Tolerances and why:
- blur, octave and upsampling: rtol 1e-5 (f32 products of the same banded
  matrices, summed in another order);
- detection: the same slots selected, positions within 1e-3 px (the 3x3
  subpixel solve divides by small determinants);
- orientations and descriptors on the same keypoints and gradients: angles
  within 1e-4 rad modulo 2 pi, descriptors within 1e-4 (atan2 and sqrt of
  f32 samples that differ in the last bits);
- whole images: keypoints are compared as sets, because a last-bit
  difference can move a keypoint across a threshold or the budget. At least
  97% of the reference's keypoints must have a port keypoint within
  0.01 px and 1e-3 in scale (the nearest in orientation is its pair), and
  the paired uint8-scale descriptors must agree within 1/512, one
  quantisation step.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycolmap_tpu.features import sift as jsift
from pycolmap_torch import convert
from pycolmap_torch.features import sift as tsift
from test_features import blob_image

S = 3


def _t(a):
    return torch.from_numpy(np.array(a))


def _wrap(a):
    return np.abs(np.angle(np.exp(1j * np.asarray(a, np.float64))))


def texture(seed, H, W, block):
    """bench.py make_u8's texture (blocks + noise) as floats, at any size."""
    r = np.random.default_rng(seed)
    base = r.normal(0.5, 0.15, (H // block, W // block))
    img = np.kron(base, np.ones((block, block))) + r.normal(0, 0.05, (H, W))
    return np.clip(img, 0, 1).astype(np.float32)


@pytest.fixture(scope="module")
def octave():
    """Octave 0 of a 96 x 128 texture at first_octave -1 (reference
    pyramid; ~135 detections under a budget of 256), its detections and its
    gradient volume."""
    img = texture(0, 96, 128, 8)
    delta = math.sqrt(jsift._SIGMA0**2 - 1.0)
    base = jsift._blur(jsift._upsample2(jnp.asarray(img)), delta)
    gauss = jsift._build_octave(base, S)
    dog = gauss[1:] - gauss[:-1]
    det = jsift._detect_octave(gauss, dog, S, 0.02 / 3, 10.0, 256)
    grad = np.asarray(jsift._octave_gradients(gauss))
    # the port's sampler reads the pair-interleaved [LHp, Wp, 2] volume
    return dict(img=img, base=np.asarray(base), gauss=np.asarray(gauss),
                det=[np.asarray(a) for a in det], grad=grad,
                grad_il=np.ascontiguousarray(np.moveaxis(grad, 0, -1)),
                delta=delta)


def test_blur_and_upsample(octave):
    img = octave["img"]
    for sigma in (0.8, 1.6, 2.5):
        want = np.asarray(jsift._blur(jnp.asarray(img), sigma))
        got = tsift._blur(_t(img), sigma).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    want = np.asarray(jsift._upsample2(jnp.asarray(img)))
    got = tsift._upsample2(_t(img)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # the border rows and columns, where the two resizers could differ
    for sl in (np.s_[0], np.s_[-1], np.s_[:, 0], np.s_[:, -1]):
        np.testing.assert_allclose(got[sl], want[sl], rtol=1e-6, atol=1e-7)


def test_build_octave(octave):
    got = tsift._build_octave(_t(octave["base"]), S).numpy()
    np.testing.assert_allclose(got, octave["gauss"], rtol=1e-5, atol=1e-6)
    want = np.asarray(jsift._band_matrix(37, jsift._gaussian_kernel1d(1.3),
                                         jnp.float32))
    got = tsift._band_matrix(37, tsift._gaussian_kernel1d(1.3)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-8)


def test_octave_gradients_interleaved(octave):
    """The port writes the reference's channel-major gradient volume
    interleaved, padding included, with the same values."""
    got = tsift._octave_gradients(_t(octave["gauss"])).numpy()
    np.testing.assert_allclose(got, octave["grad_il"], rtol=1e-6, atol=1e-7)


def test_detect_octave(octave):
    g = _t(octave["gauss"])
    x, y, lev, level_idx, scale, resp, mask = (
        a.numpy() for a in tsift._detect_octave(g, g[1:] - g[:-1], S,
                                                0.02 / 3, 10.0, 256))
    jx, jy, jlev, jli, jscale, jresp, jmask = octave["det"]
    assert np.array_equal(mask, jmask) and mask.sum() > 20
    m = mask
    np.testing.assert_allclose(x[m], jx[m], atol=1e-3)
    np.testing.assert_allclose(y[m], jy[m], atol=1e-3)
    np.testing.assert_allclose(lev[m], jlev[m], atol=1e-3)
    np.testing.assert_allclose(scale[m], jscale[m], atol=1e-3)
    np.testing.assert_allclose(resp[m], jresp[m], atol=1e-5)
    assert np.array_equal(level_idx[m], jli[m])


def _kp(octave):
    x, y, _lev, li, scale, _resp, mask = octave["det"]
    H, W = octave["gauss"].shape[1:]
    return dict(x=x, y=y, level_idx=li, scale_rel=scale, mask=mask, H=H, W=W)


def test_orientations_and_descriptors(octave):
    k = _kp(octave)
    args = (k["H"], k["W"], S, k["x"], k["y"], k["level_idx"], k["scale_rel"])
    jt, jm = jsift._orientations(jnp.asarray(octave["grad"]),
                                 *(jnp.asarray(a) if isinstance(a, np.ndarray)
                                   else a for a in args),
                                 jnp.asarray(k["mask"]), 2)
    tt, tm = tsift._orientations(_t(octave["grad_il"]),
                                 *(_t(a) if isinstance(a, np.ndarray) else a
                                   for a in args), _t(k["mask"]), 2)
    jt, jm, tt, tm = (np.asarray(a) for a in (jt, jm, tt, tm))
    assert np.array_equal(tm, jm) and tm[:, 0].sum() > 20
    assert _wrap(tt[tm] - jt[tm]).max() < 1e-4

    theta = jt[:, 0]
    for norm in (0, 1):
        want = np.asarray(jsift._descriptors(
            jnp.asarray(octave["grad"]), *(jnp.asarray(a) if isinstance(
                a, np.ndarray) else a for a in args), jnp.asarray(theta), norm))
        got = tsift._descriptors(
            _t(octave["grad_il"]), *(_t(a) if isinstance(a, np.ndarray) else a
                                  for a in args), _t(theta), norm).numpy()
        m = k["mask"]
        np.testing.assert_allclose(got[m], want[m], atol=1e-4)


def test_affine_shapes_and_affine_stages(octave):
    k = _kp(octave)
    args = (k["H"], k["W"], S, k["x"], k["y"], k["level_idx"], k["scale_rel"],
            k["mask"])
    jA, jok = jsift._affine_shapes(jnp.asarray(octave["grad"]),
                                   *(jnp.asarray(a) if isinstance(a, np.ndarray)
                                     else a for a in args))
    tA, tok = tsift._affine_shapes(_t(octave["grad_il"]),
                                   *(_t(a) if isinstance(a, np.ndarray) else a
                                     for a in args))
    jA, jok, tA, tok = (np.asarray(a) for a in (jA, jok, tA, tok))
    assert np.array_equal(tok, jok) and tok.sum() > 10
    np.testing.assert_allclose(tA[tok], jA[tok], atol=1e-4)

    base = args[:-1]
    jt, jm = jsift._orientations(
        jnp.asarray(octave["grad"]), *(jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in base), jnp.asarray(jok), 2,
        affine=jnp.asarray(jA))
    tt, tm = tsift._orientations(
        _t(octave["grad_il"]), *(_t(a) if isinstance(a, np.ndarray) else a
                              for a in base), _t(jok), 2, affine=_t(jA))
    jt, jm, tt, tm = (np.asarray(a) for a in (jt, jm, tt, tm))
    assert np.array_equal(tm, jm)
    assert _wrap(tt[tm] - jt[tm]).max() < 1e-4
    want = np.asarray(jsift._descriptors(
        jnp.asarray(octave["grad"]), *(jnp.asarray(a) if isinstance(
            a, np.ndarray) else a for a in base), jnp.asarray(jt[:, 0]), 0,
        affine=jnp.asarray(jA)))
    got = tsift._descriptors(
        _t(octave["grad_il"]), *(_t(a) if isinstance(a, np.ndarray) else a
                              for a in base), _t(jt[:, 0]), 0,
        affine=_t(jA)).numpy()
    np.testing.assert_allclose(got[jok], want[jok], atol=1e-4)


def _pair(ka, kb):
    """For each keypoint of ka, the index of its pair in kb (within 0.01 px
    and 1e-3 in scale, nearest in orientation), or -1."""
    out = -np.ones(len(ka), int)
    for n, k in enumerate(ka):
        c = np.nonzero((np.hypot(kb[:, 0] - k[0], kb[:, 1] - k[1]) < 0.01)
                       & (np.abs(kb[:, 2] - k[2]) < 1e-3))[0]
        if len(c):
            out[n] = c[np.argmin(_wrap(kb[c, 3] - k[3]))]
    return out


def assert_same_features(ref, port):
    (kr, dr), (kp, dp) = ref, port
    assert len(kr) > 20 and abs(len(kp) - len(kr)) <= 0.03 * len(kr) + 1
    p = _pair(kr, kp)
    ok = p >= 0
    assert ok.mean() >= 0.97, ok.mean()
    assert _wrap(kp[p[ok], 3] - kr[ok, 3]).max() < 1e-3
    assert np.abs(dp[p[ok]] - dr[ok]).max() <= 1 / 512 + 1e-7


OPTIONS = {
    "default": {},
    "affine": {"estimate_affine_shape": True},
    "upright": {"upright": True},
}


@pytest.mark.parametrize("name", list(OPTIONS))
def test_extract_matches_reference(name):
    jo = jsift.SiftExtractionOptions()
    jo.max_num_features = 1000
    for k, v in OPTIONS[name].items():
        setattr(jo, k, v)
    to = convert.sift_options_from_dict(jo.todict())
    img = blob_image(0)
    ref = jsift.Sift(jo).extract(img)
    port = tsift.Sift(to, device="cpu").extract(img)
    assert_same_features(ref, port)
    if name == "upright":
        assert np.all(port[0][:, 3] == 0.0)


def test_extract_batch_equals_single():
    s = tsift.Sift(device="cpu")
    imgs = [blob_image(seed) for seed in (3, 4)]
    imgs.append((blob_image(5) * 255).astype(np.uint8))
    for (k1, d1), (k2, d2) in zip([s.extract(im) for im in imgs],
                                  s.extract_batch(imgs)):
        np.testing.assert_array_equal(k1, k2)
        np.testing.assert_array_equal(d1, d2)
    with pytest.raises(ValueError):
        s.extract_batch([imgs[0], imgs[0][:50]])


def test_options_cross_by_value():
    jo = jsift.SiftExtractionOptions()
    jo.normalization = jsift.Normalization.L2
    jo.max_num_orientations = 3
    to = convert.sift_options_from_dict(jo.todict())
    assert to.normalization == tsift.Normalization.L2
    assert to.max_num_orientations == 3
    assert (to.num_threads, to.use_gpu, to.gpu_index) == (-1, True, "-1")
    for f in tsift.SiftExtractionOptions._field_names():
        assert getattr(to, f) == getattr(jo, f), f


@pytest.mark.parametrize("kind", ["extraction", "matching"])
def test_thread_and_gpu_selectors_round_trip(kind):
    """Both SIFT options take the reference's num_threads, use_gpu and
    gpu_index (accepted and unused, as the reference has them), and the
    reference's todict() crosses convert field for field."""
    from pycolmap_tpu.features import matcher as jmatch
    from pycolmap_torch.features import matcher as tmatch

    ref_cls, port_cls, conv = {
        "extraction": (jsift.SiftExtractionOptions,
                       tsift.SiftExtractionOptions,
                       convert.sift_options_from_dict),
        "matching": (jmatch.SiftMatchingOptions, tmatch.SiftMatchingOptions,
                     convert.matching_options_from_dict),
    }[kind]
    sel = dict(num_threads=4, use_gpu=False, gpu_index="0,1")
    built = port_cls(**sel)
    assert (built.num_threads, built.use_gpu, built.gpu_index) == \
        (4, False, "0,1")
    jo = ref_cls(**sel)
    want = jo.todict()
    got = conv(want).todict()
    assert set(port_cls._field_names()) == set(want)
    assert set(got) == set(want)
    for f, v in want.items():
        assert got[f] == v, f
    merged = port_cls()
    merged.mergedict(sel)
    assert merged.gpu_index == "0,1" and not merged.use_gpu


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsift.Sift()
    with pytest.raises(RuntimeError, match="CUDA"):
        tsift.extract_sift(blob_image(0, H=40, W=40))
