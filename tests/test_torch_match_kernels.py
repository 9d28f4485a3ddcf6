"""The port's top-2 matcher kernel contract (pycolmap_torch/features/
match_kernels.py; CPU tensors take the plain version) vs the reference's
Pallas kernel ``_pallas_top2_impl`` run in interpret mode on the CPU.

``_pallas_top2_impl`` has no ``interpret`` argument, so the tests swap the
``pl`` module it reads for a proxy whose ``pallas_call`` passes
``interpret=True``; no file of the reference changes. Tolerances: 1e-6 on
similarities (unit vectors: 128-term dot products summed in another order
differ by a few 1e-8); indices must agree wherever the top-2 margin exceeds
1e-5, and exactly on planted duplicates (bit-identical columns tie, and the
lowest column wins in both)."""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pycolmap_tpu.features import pallas_kernels as jpk
from pycolmap_torch.features import match_kernels as tmk


@pytest.fixture
def interpret_pl(monkeypatch):
    proxy = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                     if not k.startswith("__")})
    proxy.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    monkeypatch.setattr(jpk, "pl", proxy)


def _unit(rng, n, d=128):
    a = rng.normal(size=(n, d)).astype(np.float32)
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _pad(a, m=256):
    n = -(-len(a) // m) * m
    return np.concatenate([a, np.zeros((n - len(a),) + a.shape[1:], a.dtype)])


def _check(got, want, rows=None):
    gb, gs, gi = (np.asarray(x) for x in got)
    wb, ws, wi = (np.asarray(x) for x in want)
    if rows is not None:
        gb, gs, gi, wb, ws, wi = (x[..., :rows] for x in (gb, gs, gi, wb, ws, wi))
    np.testing.assert_allclose(gb, wb, atol=1e-6)
    np.testing.assert_allclose(gs, ws, atol=1e-6)
    clear = (wb - ws) > 1e-5
    assert np.array_equal(gi[clear], wi[clear])
    assert clear.mean() > 0.5
    return gb, gs, gi


def test_single_matches_pallas(interpret_pl):
    """300 x 400 descriptors (n2 not a multiple of 256), rows padded with
    zero vectors; duplicated targets give ties."""
    rng = np.random.default_rng(0)
    d1 = _unit(rng, 300)
    d2 = _unit(rng, 400)
    d2[7] = d2[3]  # exact duplicate of column 3
    d1[5] = d2[3] + 0.01 * _unit(rng, 1)[0]
    d1[5] /= np.linalg.norm(d1[5])
    d1p, d2p = _pad(d1), _pad(d2)
    want = jpk._pallas_top2_impl(jnp.asarray(d1p), jnp.asarray(d2p),
                                 jnp.int32(400))
    tmk.reset_counts()
    got = tmk.top2(torch.from_numpy(d1p), torch.from_numpy(d2p), 400)
    gb, gs, gi = _check(got, want)
    assert gi[5] == 3 and gs[5] == gb[5]  # lowest column wins, second ties
    assert np.array_equal(gi[300:], np.asarray(want[2])[300:])  # zero rows
    assert tmk.LAUNCHES["top2"] == 0
    # match_top2 takes the unpadded rows and agrees
    mb, ms, mi = tmk.match_top2(torch.from_numpy(d1p), torch.from_numpy(d2p),
                                300, 400)
    np.testing.assert_array_equal(mi.numpy(), gi[:300])
    np.testing.assert_array_equal(mb.numpy(), gb[:300])


def test_batch_matches_pallas(interpret_pl):
    """A ragged batch: n2 = 300, 77, 1 (one valid column: second = -2) and
    0 (no valid column: best = second = -2, idx 0) in one [4, 512, 128]
    block, as the reference's vmapped pallas_top2_batch runs it."""
    rng = np.random.default_rng(1)
    B, N1, N2 = 4, 256, 512
    D1 = np.stack([_unit(rng, N1) for _ in range(B)])
    D2 = np.stack([_unit(rng, N2) for _ in range(B)])
    n2 = np.array([300, 77, 1, 0], np.int32)
    D2[0, 10:20] = D2[0, 0:10]  # duplicated blocks inside one pair
    want = jax.vmap(jpk._pallas_top2_impl)(jnp.asarray(D1), jnp.asarray(D2),
                                           jnp.asarray(n2))
    got = tmk.top2_batch(torch.from_numpy(D1), torch.from_numpy(D2),
                         torch.from_numpy(n2))
    gb, gs, gi = (np.asarray(x) for x in got)
    wb, ws, wi = (np.asarray(x) for x in want)
    _check((gb[:2], gs[:2], gi[:2]), (wb[:2], ws[:2], wi[:2]))
    np.testing.assert_allclose(gb[2:], wb[2:], atol=1e-6)
    assert np.all(gs[2] == -2.0) and np.array_equal(gi[2], wi[2])
    assert np.all(gb[3] == -2.0) and np.all(gs[3] == -2.0)
    assert np.all(gi[3] == 0) and np.array_equal(gi[3], wi[3])
    assert gi.dtype == np.int32


def test_batch_equals_single_calls():
    rng = np.random.default_rng(2)
    D1 = torch.from_numpy(np.stack([_unit(rng, 70) for _ in range(3)]))
    D2 = torch.from_numpy(np.stack([_unit(rng, 90) for _ in range(3)]))
    n2 = [90, 50, 13]
    bb, bs, bi = tmk.top2_batch(D1, D2, n2)
    for b in range(3):
        sb, ss, si = tmk.top2(D1[b], D2[b], n2[b])
        assert torch.equal(bi[b], si) and torch.equal(bb[b], sb)
        assert torch.equal(bs[b], ss)


def test_top2_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tmk.top2_batch(torch.zeros(2, 8, 128), torch.zeros(3, 8, 128), [8] * 2)
    with pytest.raises(ValueError):
        tmk.top2_batch(torch.zeros(1, 8, 128), torch.zeros(1, 8, 64), [8])
