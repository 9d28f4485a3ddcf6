"""The port's matcher (pycolmap_torch/features/matcher.py, the plain path
on the CPU) gives the same match sets as the reference's on the same
descriptors: random unit descriptors with planted matches, uint8 input, the
cross check on and off, max_num_matches truncation, the batched entry
point, and SIFT features of an image and its 5-px shift. Match sets must be
equal: both build one f32 similarity matrix and apply the same checks, and
the planted and SIFT matches sit far from the ratio and distance limits.

Guided matching (``match_guided``) likewise, under F (the Sampson mask) and
H (the transfer mask), the cross check on and off: the planted matches sit
within 1 px of the geometry, the planted decoys (near-copies of another
view's descriptor at a point that breaks it) tens of pixels off, so the
mask and the threshold of 4 px part them the same way in both packages."""

import numpy as np
import pytest
import torch

from pycolmap_tpu.estimators.two_view_geometry import (
    TwoViewGeometry as JTwoViewGeometry,
)
from pycolmap_tpu.features import matcher as jm
from pycolmap_torch import convert
from pycolmap_torch.features import matcher as tm
from pycolmap_torch.estimators.two_view_geometry import (
    TwoViewGeometry,
    TwoViewGeometryConfiguration,
)
from pycolmap_torch.features.sift import Sift
from test_estimators import synth_two_view
from test_features import blob_image


def _pair(rng, n1, n2, noise=0.05):
    d1 = rng.normal(size=(n1, 128)).astype(np.float32)
    d2 = rng.normal(size=(n2, 128)).astype(np.float32)
    k = min(n1, n2) // 2
    if k:  # plant near-copies so real matches exist
        d2[:k] = d1[:k] + rng.normal(0, noise, (k, 128))
    return d1, d2


def _opts(**kw):
    jo = jm.SiftMatchingOptions()
    for k, v in kw.items():
        setattr(jo, k, v)
    return jo, convert.matching_options_from_dict(jo.todict())


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("sizes", [(300, 300), (50, 700), (600, 40)])
def test_random_descriptors(cross_check, sizes):
    rng = np.random.default_rng(sum(sizes) + cross_check)
    d1, d2 = _pair(rng, *sizes, noise=0.3)
    jo, to = _opts(cross_check=cross_check)
    want = jm.match_descriptors(d1, d2, jo)
    got = tm.match_descriptors(d1, d2, to, device="cpu")
    assert got.dtype == np.uint32 and len(want) > 10
    np.testing.assert_array_equal(got, want)


def test_uint8_and_truncation():
    rng = np.random.default_rng(3)
    d1, d2 = _pair(rng, 200, 260)
    u1, u2 = (np.clip(np.round(np.abs(d) / np.linalg.norm(d, axis=1,
                                                          keepdims=True)
                               * 512), 0, 255).astype(np.uint8)
              for d in (d1, d2))
    for kw in ({"max_ratio": 0.9}, {"max_num_matches": 17}):
        jo, to = _opts(**kw)
        want = jm.match_descriptors(u1, u2, jo)
        got = tm.match_descriptors(u1, u2, to, device="cpu")
        np.testing.assert_array_equal(got, want)
    assert len(got) == 17


def test_batch_matches_reference_and_single():
    rng = np.random.default_rng(5)
    pairs = [_pair(rng, n1, n2) for n1, n2 in
             [(50, 80), (300, 300), (40, 500), (80, 50), (0, 60), (260, 300)]]
    jo, to = _opts()
    want = jm.match_descriptors_batch(pairs, jo)
    got = tm.match_descriptors_batch(pairs, to, device="cpu")
    for (d1, d2), g, w in zip(pairs, got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
        np.testing.assert_array_equal(
            g, tm.match_descriptors(d1, d2, to, device="cpu"))


@pytest.fixture(scope="module")
def shifted_features():
    s = Sift(device="cpu")
    img = blob_image(2)
    return s.extract(img), s.extract(np.roll(img, 5, axis=1))


@pytest.mark.parametrize("cross_check", [True, False])
def test_sift_shifted_pair(shifted_features, cross_check):
    """tests/test_features.py's shift criterion on the port's own SIFT,
    and the reference's matcher on the same descriptors agrees."""
    (k1, d1), (k2, d2) = shifted_features
    jo, to = _opts(cross_check=cross_check)
    m = tm.match_descriptors(d1, d2, to, device="cpu")
    np.testing.assert_array_equal(m, jm.match_descriptors(d1, d2, jo))
    assert len(m) > 0.5 * min(len(k1), len(k2))
    dx = k2[m[:, 1], 0] - k1[m[:, 0], 0]
    assert (np.abs(dx - 5) < 1.5).mean() > 0.85


def _guided_case(model, seed):
    """Descriptors and points of a true geometry (F of synth_two_view's
    pose, or H a shift by (7, -4)): 250 planted matches, 60 decoys that
    break the geometry, and 100 unmatched rows on each side."""
    rng = np.random.default_rng(seed)
    cam, x1, x2, rel, _ = synth_two_view(n=250, outlier_ratio=0.0, seed=seed)
    if model == "F":
        K = cam.calibration_matrix()
        R, t = rel.rotation.matrix(), rel.translation
        tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]])
        G = np.linalg.inv(K).T @ tx @ R @ np.linalg.inv(K)
    else:
        G = np.array([[1.0, 0, 7], [0, 1, -4], [0, 0, 1]])
        x2 = x1 + [7.0, -4.0] + rng.normal(0, 0.3, x1.shape)
    n_extra = 100
    d1 = rng.normal(size=(250 + n_extra, 128)).astype(np.float32)
    d2 = rng.normal(size=(250 + n_extra, 128)).astype(np.float32)
    d2[:250] = d1[:250] + rng.normal(0, 0.05, (250, 128))
    p1 = np.concatenate([x1, rng.uniform(0, [640, 480], (n_extra, 2))])
    p2 = np.concatenate([x2, rng.uniform(0, [640, 480], (n_extra, 2))])
    # decoys: copies of view 1's rows 0..59 at random points of view 2
    d2[250:310] = d1[:60] + rng.normal(0, 0.01, (60, 128))
    return d1, d2, p1, p2, G.astype(np.float64)


def _geometry(cls, model, G):
    g = cls()
    C = TwoViewGeometryConfiguration
    if model == "F":
        g.config, g.F = int(C.UNCALIBRATED), G
    else:
        g.config, g.H = int(C.PLANAR), G
    return g


@pytest.mark.parametrize("cross_check", [True, False])
@pytest.mark.parametrize("model", ["F", "H"])
def test_match_guided_matches_reference(model, cross_check):
    d1, d2, p1, p2, G = _guided_case(model, seed=4)
    jo, to = _opts(cross_check=cross_check)
    want = jm.match_guided(d1, d2, p1, p2, _geometry(JTwoViewGeometry, model,
                                                     G), jo)
    got = tm.match_guided(d1, d2, p1, p2, _geometry(TwoViewGeometry, model, G),
                          to, device="cpu")
    assert got.dtype == np.uint32 and len(want) > 150
    np.testing.assert_array_equal(got, want)
    # the planted pairs kept; under H no decoy (a decoy can lie near an
    # epipolar line, never within 4 px of a point's shift)
    assert np.sum(got[:, 0] == got[:, 1]) >= 200
    if model == "H":
        assert np.all(got[:, 1] < 250)
    unguided = tm.match_descriptors(d1, d2, to, device="cpu")
    assert not np.array_equal(unguided, got)


def test_match_guided_without_geometry_matches_descriptors():
    d1, d2, p1, p2, _ = _guided_case("F", seed=5)
    jo, to = _opts()
    got = tm.match_guided(d1, d2, p1, p2, TwoViewGeometry(), to, device="cpu")
    np.testing.assert_array_equal(got, tm.match_descriptors(d1, d2, to,
                                                            device="cpu"))
    np.testing.assert_array_equal(
        got, jm.match_guided(d1, d2, p1, p2, JTwoViewGeometry(), jo))


def test_default_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    d = np.eye(4, 128, dtype=np.float32)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.match_descriptors(d, d)
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.match_descriptors_batch([(d, d)])
    with pytest.raises(RuntimeError, match="CUDA"):
        tm.match_guided(d, d, np.zeros((4, 2)), np.zeros((4, 2)),
                        TwoViewGeometry())
