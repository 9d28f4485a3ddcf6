"""The port's window sampler (pycolmap_torch/features/window_sampler.py) vs
the reference's Pallas sampler in interpret mode and its gather reference,
on the same numpy inputs on the CPU. CPU tensors take the kernel's plain
version (``sample_windows_plain``). The port's volume interleaves the
channels ([LHp, Wp, NC]); the tests build the reference's channel-major
volume and transpose it for the port. Tolerance: atol 2e-5, the
reference's own (tests/test_window_sampler.py): the Pallas sampler
contracts tent matrices in another summation order than a 4-tap bilinear
read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycolmap_tpu.features import window_sampler as jws
from pycolmap_torch.features import window_sampler as tws

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, where every worker's thread pool would contend for
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(rng, K, H=480, W=640, support=28.0, edge=False, nc=2):
    vol = rng.normal(size=(nc, H, W)).astype(np.float32)
    volp = np.asarray(jws.pad_volume(jnp.asarray(vol)))
    if edge:  # centres past the left/right borders: negative coordinates
        cx = rng.uniform(-10, W + 10, (K, 1, 1))
        cy = rng.uniform(1, H - 2, (K, 1, 1))
    else:
        cx = rng.uniform(support + 2, W - support - 2, (K, 1, 1))
        cy = rng.uniform(support + 2, H - support - 2, (K, 1, 1))
    off = rng.uniform(-support, support, (2, K, 16, 16))
    xs = (cx + off[0]).astype(np.float32)
    ys = np.clip(cy + off[1], 0.0, H - 1.001).astype(np.float32)
    return volp, ys, xs


def _jax(volp, ch0, ys, xs, wins):
    args = [jnp.asarray(a) for a in (volp, ch0, ys, xs)]
    out = jws.sample_windows(*args, *wins, interpret=True, bf16=False)
    ref = jws.sample_windows_reference(*args)
    return [np.asarray(a) for a in out], [np.asarray(a) for a in ref]


def _port(volp, ch0, ys, xs, wins):
    args = [torch.from_numpy(np.array(a)) for a in (volp, ch0, ys, xs)]
    out = tws.sample_windows(tws.interleave(args[0]), *args[1:], *wins)
    ref = tws.sample_windows_reference(*args)
    return [a.numpy() for a in out], [a.numpy() for a in ref]


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("K", [16, 13])  # 13: the reference pads to 16
def test_sample_windows_matches_pallas(edge, K):
    rng = np.random.default_rng(3 + K)
    volp, ys, xs = _case(rng, K, edge=edge)
    ch0 = np.zeros(K, np.int32)
    wins = jws.window_sizes(28.0)
    (j0, j1), (r0, r1) = _jax(volp, ch0, ys, xs, wins)
    tws.reset_counts()
    (t0, t1), (q0, q1) = _port(volp, ch0, ys, xs, wins)
    for got, want in ((t0, j0), (t1, j1), (t0, r0), (t1, r1), (q0, r0),
                      (q1, r1)):
        np.testing.assert_allclose(got, want, atol=ATOL)
    assert tws.LAUNCHES["window_sampler"] == 0  # CPU tensors: plain version


def test_channel_pairs_and_irregular_volume():
    """Per-keypoint channel bases (4 channels = 2 images x 2), and a
    3-channel volume whose pair (1, 2) overlaps the first."""
    rng = np.random.default_rng(5)
    for nc, bases in ((4, (0, 2)), (3, (0, 1))):
        K = 37
        volp, ys, xs = _case(rng, K, H=256, W=384, support=20.0, edge=True,
                             nc=nc)
        ch0 = np.asarray(bases, np.int32)[np.arange(K) % 2]
        wins = jws.window_sizes(20.0)
        (j0, j1), (r0, r1) = _jax(volp, ch0, ys, xs, wins)
        (t0, t1), (q0, q1) = _port(volp, ch0, ys, xs, wins)
        for got, want in ((t0, j0), (t1, j1), (q0, r0), (q1, r1)):
            np.testing.assert_allclose(got, want, atol=ATOL)


def test_kernel_contract_matches_pallas_kernel():
    """The kernel-level contract: the same origins and window coordinates
    into ``_sample_windows_pallas`` (interpret) and the port's
    ``sample_windows_kernel``, with samples left of and above the window
    (negative window coordinates) and -2.0 rows."""
    rng = np.random.default_rng(11)
    K, win_y, win_x = 16, 48, 256
    vol = rng.normal(size=(2, 512, 640)).astype(np.float32)
    ch0 = np.zeros(K, np.int32)
    y0 = (8 * rng.integers(0, (512 - win_y) // 8, K)).astype(np.int32)
    x0 = (128 * rng.integers(0, (640 - win_x) // 128 + 1, K)).astype(np.int32)
    wy = rng.uniform(-3, win_y + 2, (K, 256)).astype(np.float32)
    wx = rng.uniform(-3, win_x + 2, (K, 256)).astype(np.float32)
    wy[-2:] = -2.0
    wx[-2:] = -2.0
    want = np.asarray(jws._sample_windows_pallas(
        *(jnp.asarray(a) for a in (vol, ch0, y0, x0, wy, wx)), win_y, win_x,
        bf16=False, interpret=True))
    got = tws.sample_windows_kernel(
        *(torch.from_numpy(a) for a in (vol, ch0, y0, x0, wy, wx)), win_y,
        win_x).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert np.all(got[-2:] == 0.0)


def test_whole_volume_window_is_the_reference():
    """A support too large for any window samples the whole volume as one
    window; that equals the gather reference."""
    rng = np.random.default_rng(13)
    volp, ys, xs = _case(rng, 8, H=300, W=500, support=130.0, edge=True)
    assert jws.window_sizes(130.0) is None
    ch0 = np.zeros(8, np.int32)
    (t0, t1), (q0, q1) = _port(volp, ch0, ys, xs, volp.shape[1:])
    np.testing.assert_allclose(t0, q0, atol=ATOL)
    np.testing.assert_allclose(t1, q1, atol=ATOL)


@pytest.mark.parametrize("support", [5.0, 16.2, 28.0, 30.5, 60.0, 75.0,
                                     127.0, 300.0])
def test_window_sizes_and_padding(support):
    assert tws.window_sizes(support) == jws.window_sizes(support)
    for shape in ((2, 100, 130), (2, 264, 520), (3, 1000, 2560)):
        want = jws.pad_volume(jnp.zeros(shape, jnp.float32)).shape
        assert tuple(tws.pad_volume(torch.zeros(shape)).shape) == want


def test_negative_origins_floor():
    """Window origins floor (not truncate) negative minima before the
    clip, as the reference's integer // does."""
    vol = torch.from_numpy(
        np.random.default_rng(17).normal(size=(2, 256, 512)).astype(np.float32))
    ys = torch.full((1, 16, 16), -9.5)
    xs = torch.full((1, 16, 16), -130.5)
    ys[0, 0, 0], xs[0, 0, 0] = 0.25, 0.25
    a = tws.sample_windows(tws.interleave(vol),
                           torch.zeros(1, dtype=torch.int32), ys, xs, 48, 256)
    b = jws.sample_windows(jnp.asarray(vol.numpy()), jnp.zeros(1, jnp.int32),
                           jnp.asarray(ys.numpy()), jnp.asarray(xs.numpy()),
                           48, 256, interpret=True, bf16=False)
    assert float(a[0][0, 0, 0]) != 0.0
    for got, want in zip(a, b):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _block_origins(ys, xs, lhp, wp, win_y, win_x):
    """The kernel's in-block origin rule (csrc/window_sampler.cu) in numpy:
    the min over the block's samples, floorf, C's truncating division
    corrected to floor_div, clamp. [K, S] f32 -> (y0, x0) int32."""
    def floor_div(a, m):
        q = np.trunc(a / m).astype(np.int64)  # C's a / m
        r = a - q * m  # C's a % m, the sign of a
        return np.where((r != 0) & (a < 0), q - 1, q)

    def origin(v, m, hi):
        lo = np.floor(v.min(axis=1)).astype(np.int64)  # (int)floorf(min)
        return np.minimum(np.maximum(floor_div(lo, m) * m, 0), hi)

    return (origin(ys, 8, lhp - win_y).astype(np.int32),
            origin(xs, 128, wp - win_x).astype(np.int32))


def _origin_case(rng, kind, K=37):
    """Sample positions [K, 256] of one kind of window placement in a
    [256, 512] (padded) volume."""
    lhp, wp, (win_y, win_x) = 256, 512, (48, 256)
    c = {
        # centres left of / above the volume: negative minima
        "negative": (rng.uniform(-40, 5, K), rng.uniform(-300, 20, K)),
        # the four borders: origins clamped to 0 or LHp - win_y, Wp - win_x
        "borders": (np.array([2.0, 250.0])[np.arange(K) % 2],
                    np.array([3.0, 509.0])[(np.arange(K) // 2) % 2]),
        "interior": (rng.uniform(30, 220, K), rng.uniform(60, 450, K)),
    }[kind]
    off = rng.uniform(-18, 18, (2, K, 256))
    ys = (c[0][:, None] + off[0]).astype(np.float32)
    xs = (c[1][:, None] + off[1]).astype(np.float32)
    return ys, xs, lhp, wp, win_y, win_x


@pytest.mark.parametrize("kind", ["negative", "borders", "interior",
                                  "whole"])
def test_block_origin_rule_matches_wrapper(kind):
    """The kernel's origin rule equals the wrapper's (window_origins) bit
    for bit: negative origins, the four volume borders, K = 37 (no
    multiple of 8), and the whole-volume window (origin 0)."""
    rng = np.random.default_rng(19)
    ys, xs, lhp, wp, win_y, win_x = _origin_case(
        rng, "negative" if kind == "whole" else kind)
    if kind == "whole":
        win_y, win_x = lhp, wp
    want = tws.window_origins(torch.from_numpy(ys), torch.from_numpy(xs),
                              lhp, wp, win_y, win_x)
    got = _block_origins(ys, xs, lhp, wp, win_y, win_x)
    for w, g in zip(want, got):
        assert w.dtype == torch.int32
        np.testing.assert_array_equal(g, w.numpy())
    if kind == "whole":
        assert not got[0].any() and not got[1].any()
    if kind == "borders":
        assert set(got[0]) == {0, lhp - win_y}
        assert set(got[1]) == {0, wp - win_x}


@pytest.mark.parametrize("kind", ["negative", "borders", "interior"])
def test_interleaved_volume_matches_channel_major_pallas(kind):
    """The plain path on the interleaved volume (origins, then window
    coordinates) vs the reference's Pallas kernel in interpret mode on the
    channel-major volume at the same origins, K = 37; and vs the port's
    window-coordinate contract on the channel-major volume, exactly (the
    same arithmetic on the same values)."""
    rng = np.random.default_rng(23)
    ys, xs, lhp, wp, win_y, win_x = _origin_case(rng, kind)
    K = ys.shape[0]
    vol = rng.normal(size=(3, lhp, wp)).astype(np.float32)
    ch0 = (np.arange(K) % 2).astype(np.int32)  # pairs 0-1 and 1-2
    tv = torch.from_numpy(vol)
    v0, v1 = tws.sample_windows(tws.interleave(tv), torch.from_numpy(ch0),
                                torch.from_numpy(ys.reshape(K, 16, 16)),
                                torch.from_numpy(xs.reshape(K, 16, 16)),
                                win_y, win_x)
    got = torch.stack([v0.reshape(K, 256), v1.reshape(K, 256)], 1).numpy()
    y0, x0 = _block_origins(ys, xs, lhp, wp, win_y, win_x)
    wy = ys - y0[:, None].astype(np.float32)
    wx = xs - x0[:, None].astype(np.float32)
    # the Pallas kernel takes K in multiples of 8: pad as its wrapper does
    pad = lambda a, v: np.concatenate(  # noqa: E731
        [a, np.full((40 - K,) + a.shape[1:], v, a.dtype)])
    want = np.asarray(jws._sample_windows_pallas(
        *(jnp.asarray(a) for a in (vol, pad(ch0, 0), pad(y0, 0), pad(x0, 0),
                                   pad(wy, -2.0), pad(wx, -2.0))),
        win_y, win_x, bf16=False, interpret=True))[:K]
    np.testing.assert_allclose(got, want, atol=ATOL)
    contract = tws.sample_windows_kernel(
        tv, *(torch.from_numpy(a) for a in (ch0, y0, x0, wy, wx)), win_y,
        win_x).numpy()
    np.testing.assert_array_equal(got, contract)


def test_wrapper_refuses_bad_windows():
    """A window larger than the volume (its origin rule would leave the
    volume) and a grid that is not 256 samples raise."""
    vol = torch.zeros(256, 512, 2)
    ch0 = torch.zeros(3, dtype=torch.int32)
    ys = torch.zeros(3, 16, 16)
    with pytest.raises(ValueError):
        tws.sample_windows(vol, ch0, ys, ys, 264, 256)
    with pytest.raises(ValueError):
        tws.sample_windows(vol, ch0, ys, ys, 48, 640)
    with pytest.raises(ValueError):
        tws.sample_windows(vol, ch0, ys[:, :8], ys[:, :8], 48, 256)
