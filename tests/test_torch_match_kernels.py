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


# ---------------------------------------------------------------------------
# the card kernel's design: its column split and merge, its 3xTF32 numerics
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, whose thread pools would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def split_case():
    """A ragged [4, 256, 512] batch: n2 = 300 (duplicated blocks, a row
    planted on a duplicated column), 77, 0 (no valid column) and 512 (all
    valid); the reference's vmapped Pallas kernel in interpret mode."""
    rng = np.random.default_rng(5)
    B, N1, N2 = 4, 256, 512
    D1 = np.stack([_unit(rng, N1) for _ in range(B)])
    D2 = np.stack([_unit(rng, N2) for _ in range(B)])
    D2[0, 200:210] = D2[0, 0:10]  # exact duplicates in different tiles
    D1[0, 3] = D2[0, 5]  # its best ties at columns 5 and 205
    D2[3, 400] = D2[3, 40]
    D1[3, 9] = D2[3, 40]
    n2 = np.array([300, 77, 0, 512], np.int32)
    proxy = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                     if not k.startswith("__")})
    proxy.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    real, jpk.pl = jpk.pl, proxy
    try:
        want = jax.vmap(jpk._pallas_top2_impl)(
            jnp.asarray(D1), jnp.asarray(D2), jnp.asarray(n2))
    finally:
        jpk.pl = real
    return D1, D2, n2, [np.asarray(w) for w in want]


def _merge(t, u):
    """Merge top-2 states (best, second, idx), lowest column on ties."""
    tb, ts, ti = t
    ub, us, ui = u
    u_wins = (ub > tb) | ((ub == tb) & (ui < ti))
    loser = torch.where(u_wins, tb, ub)
    return (torch.where(u_wins, ub, tb),
            torch.maximum(loser, torch.maximum(ts, us)),
            torch.where(u_wins, ui, ti))


def _top2_walk(d1, d2, n2, split):
    """The kernel's cut in plain PyTorch: per pair, the valid column tiles
    ceil(n2 / tmk.TOP2_BN) go to `split` shares (share s takes tiles s ctv /
    split up to (s + 1) ctv / split); each share's state starts at (-2, -2,
    0) and sees only its columns; the shares merge in order. Returns
    (best, second, idx) as top2_plain."""
    B, N1, _ = d1.shape
    N2 = d2.shape[1]
    out = []
    for b in range(B):
        nv = max(0, min(int(n2[b]), N2))
        ctv = -(-nv // tmk.TOP2_BN)
        state = (torch.full((N1,), -2.0, dtype=d1.dtype),
                 torch.full((N1,), -2.0, dtype=d1.dtype),
                 torch.zeros(N1, dtype=torch.int64))
        for s in range(split):
            c0 = s * ctv // split * tmk.TOP2_BN
            c1 = min((s + 1) * ctv // split * tmk.TOP2_BN, nv)
            share = (torch.full((N1,), -2.0, dtype=d1.dtype),
                     torch.full((N1,), -2.0, dtype=d1.dtype),
                     torch.zeros(N1, dtype=torch.int64))
            if c1 > c0:
                sim = d1[b] @ d2[b, c0:c1].T
                sb, si = sim.max(dim=1)  # the first maximal column
                ss = (sim.scatter(1, si[:, None], -torch.inf).amax(dim=1)
                      if c1 - c0 > 1 else torch.full_like(sb, -torch.inf))
                share = _merge(share, (sb, ss, si + c0))
            state = _merge(state, share)
        out.append(state)
    return (torch.stack([o[0] for o in out]), torch.stack([o[1] for o in out]),
            torch.stack([o[2] for o in out]).to(torch.int32))


@pytest.mark.parametrize("split", [1, 2, 3, 8])
def test_top2_walk_matches_pallas(split_case, split):
    """The kernel's cut (valid column tiles dealt to `split` shares, each
    share's state from (-2, -2, 0), merged in order) equals top2_plain
    exactly and the reference's Pallas kernel within 1e-6 (indices where
    the margin exceeds 1e-5, and on the planted ties)."""
    D1, D2, n2, want = split_case
    t1, t2 = torch.from_numpy(D1), torch.from_numpy(D2)
    walk = _top2_walk(t1, t2, torch.from_numpy(n2), split)
    plain = tmk.top2_plain(t1, t2, torch.from_numpy(n2))
    for w, p in zip(walk, plain):
        assert w.dtype == p.dtype and torch.equal(w, p)
    gb, gs, gi = (x.numpy() for x in walk)
    wb, ws, wi = want
    for b in (0, 1, 3):
        _check((gb[b], gs[b], gi[b]), (wb[b], ws[b], wi[b]))
    assert gi[0, 3] == wi[0, 3] == 5 and gs[0, 3] == gb[0, 3]
    assert gi[3, 9] == wi[3, 9] == 40 and gs[3, 9] == gb[3, 9]
    assert np.all(gb[2] == -2.0) and np.all(gs[2] == -2.0)
    assert np.all(gi[2] == 0) and np.array_equal(gi[2], wi[2])


def test_top2_split_fills_waves():
    """132 SMs: 8192^2 takes 2 shares (128 blocks); phase 8's pair of
    about 4,300 descriptors 7 (238 blocks), the padded batch of four 1."""
    assert tmk.top2_split(1, 8192, 8192, 132) == 2
    assert tmk.top2_split(1, 4300, 4300, 132) == 7
    assert tmk.top2_split(4, 8192, 8192, 132) == 1
    assert tmk.top2_split(1, 100, 30, 132) == 1


def _tf32_rna(x):
    """Round f32 to TF32, nearest with ties away from zero: the kernel's
    integer form of cvt.rna.tf32.f32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _round_f32(v, toward_zero):
    r = v.astype(np.float32)
    if toward_zero:
        over = np.abs(r.astype(np.float64)) > np.abs(v)
        r[over] = np.nextafter(r[over], np.float32(0))
    return r


@pytest.mark.parametrize("toward_zero", [False, True])
def test_3xtf32_split_error(toward_zero):
    """The kernel's numerics on unit vectors at D 128: each operand split
    once, hi = rna(x), lo = rna(x - hi); per 8-deep step the products
    lo.hi' + hi.lo' + hi.hi' (exact in the tensor cores) summed and rounded
    once to f32, to nearest or, as a truncating tensor core would, toward
    zero; the steps added into an f32 running sum. Over 1024 x 1024 pairs
    with 32 planted near-duplicates the error against float64 stays under
    5e-7, below the kernel's 1e-6 tolerance; a single TF32 product would
    be off by ~1e-4."""
    rng = np.random.default_rng(9)
    a = _unit(rng, 1024)
    b = _unit(rng, 1024)
    b[:32] = a[:32] + 1e-3 * _unit(rng, 32)
    b[:32] /= np.linalg.norm(b[:32], axis=1, keepdims=True)
    exact = a.astype(np.float64) @ b.astype(np.float64).T
    ah, bh = _tf32_rna(a), _tf32_rna(b)
    al, bl = _tf32_rna(a - ah), _tf32_rna(b - bh)
    f = [x.astype(np.float64) for x in (ah, al, bh, bl)]
    run = np.zeros(exact.shape, np.float32)
    for k in range(0, 128, 8):
        s = slice(k, k + 8)
        step = (f[1][:, s] @ f[2][:, s].T + f[0][:, s] @ f[3][:, s].T
                + f[0][:, s] @ f[2][:, s].T)
        run = run + _round_f32(step, toward_zero)
    err = np.abs(run - exact).max()
    assert err < 5e-7, err
    one_pass = np.abs(f[0] @ f[2].T - exact).max()
    assert one_pass > 1e-5  # why the split is needed
