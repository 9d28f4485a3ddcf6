"""The port's gather probe (pycolmap_torch/scripts/proto_gather.py, its plain
versions on the CPU) against the TPU probe scripts/proto_pallas_gather.py.

The reference's five Pallas cases run in interpret mode: the probe module is
loaded by path and its ``pl`` replaced, in this file only, by a namespace
whose ``pallas_call`` is ``pallas_call(..., interpret=True)`` and records
its inputs. The port must give each case's Pallas output exactly, NaN for
NaN; edge indices (negative, out of range, the int32 extremes) are held to
the jnp ``ref`` form of each case at the probe's and at ragged shapes. The
bilinear baseline copy is held to the reference's ``_bilinear_gather``
within 1e-6 scaled (the same f32 expression, summed by another compiler).
"""

import functools
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from pycolmap_tpu.features.sift import _bilinear_gather
from pycolmap_torch.scripts import proto_gather as pg

ROOT = Path(__file__).resolve().parents[1]
# the reference's case function of each port kernel
CASES = {"take_along_last": "case_a", "take_rows": "case_b",
         "take_along_first": "case_b2", "take_2d": "case_c",
         "take_flat": "case_c2"}


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, whose thread pools would otherwise contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _InterpretPallas:
    """Stands in for the probe's ``pl``: every pallas_call runs in
    interpret mode and records the arrays it is called with."""

    def __init__(self):
        self.inputs = []

    def pallas_call(self, kernel, **kw):
        call = functools.partial(pl.pallas_call, interpret=True)(kernel, **kw)

        def run(*args):
            self.inputs.append([np.asarray(a) for a in args])
            return call(*args)

        return run

    def __getattr__(self, name):
        return getattr(pl, name)


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location(
        "proto_pallas_gather_interpret",
        ROOT / "scripts" / "proto_pallas_gather.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = _InterpretPallas()
    return mod


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def jnp_ref(name, src, *idx):
    """Each case's jnp ``ref`` form."""
    s = jnp.asarray(src)
    i = [jnp.asarray(a) for a in idx]
    if name == "take_along_last":
        out = jnp.take_along_axis(s, i[0], axis=-1)
    elif name == "take_rows":
        out = s[i[0], :]
    elif name == "take_along_first":
        out = jnp.take_along_axis(s, i[0], axis=0)
    elif name == "take_2d":
        out = s[i[0], i[1]]
    else:
        out = jnp.take(s, i[0])
    return torch.from_numpy(np.array(out))


def _same(got, ref):
    """Exactly equal, NaN where the other is NaN (and nowhere else)."""
    assert got.shape == ref.shape and got.dtype == ref.dtype
    nan = torch.isnan(ref)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], ref[~nan])


@pytest.mark.parametrize("name", pg.KERNELS)
def test_probe_case_matches_pallas_interpret(probe, name):
    """The Pallas kernel of each reference case, at its own inputs, and the
    port's wrapper (its plain version on the CPU) agree exactly."""
    np.random.seed(pg.KERNELS.index(name))
    probe.pl.inputs.clear()
    out, ref = getattr(probe, CASES[name])()
    (args,) = probe.pl.inputs
    src, *idx = _torch(args)
    got = pg.WRAPPERS[name](src, *idx)
    pallas = torch.from_numpy(np.array(out))
    assert pg.same_bits(got, pallas)
    assert pg.same_bits(got, torch.from_numpy(np.array(ref)))
    # the probe's shapes are the reference's
    title, s_shape, i_shapes = pg.PROBES[name]
    assert tuple(src.shape) == s_shape
    assert [tuple(i.shape) for i in idx] == list(i_shapes)


def test_sized_lane_gather_matches_take_along_axis():
    """bench_a_sized's lane gather ([1024, 512]) against
    jnp.take_along_axis."""
    src, idx = pg.make_inputs("take_along_last", pg.SIZED_SHAPE,
                              (pg.SIZED_SHAPE,), np.random.default_rng(16))
    got = pg.take_along_last(*_torch([src, *idx]))
    assert pg.same_bits(got, jnp_ref("take_along_last", src, *idx))


@pytest.mark.parametrize("shape", ["probe", "ragged"])
@pytest.mark.parametrize("name", pg.KERNELS)
def test_edge_indices_match_jnp(name, shape):
    """Negative, out-of-range and int32-extreme indices, at the probe's and
    the ragged shapes: wrap then NaN for take_along_axis / take, wrap then
    clamp for indexing."""
    s_shape, i_shapes = (pg.PROBES[name][1:] if shape == "probe"
                         else pg.RAGGED[name])
    rng = np.random.default_rng(100 + pg.KERNELS.index(name))
    src, idx = pg.make_inputs(name, s_shape, i_shapes, rng, edge=True)
    n = pg.index_extents(name, s_shape)
    assert all((i < -m).any() and (i >= m).any() and (i < 0).any()
               for i, m in zip(idx, n))
    got = pg.WRAPPERS[name](*_torch([src, *idx]))
    ref = jnp_ref(name, src, *idx)
    _same(got, ref)
    assert pg.same_bits(got, ref)
    fills = name in ("take_along_last", "take_along_first", "take_flat")
    assert bool(torch.isnan(got).any()) == fills


@pytest.mark.parametrize("name", pg.KERNELS)
def test_cpu_call_launches_no_kernel(name):
    """A CPU tensor takes the plain version: no launch, no plain-on-CUDA
    count, and the bound counts each distinct source element once."""
    pg.reset_counts()
    title, s_shape, i_shapes = pg.PROBES[name]
    src, idx = pg.to_device("cpu", *pg.make_inputs(
        name, s_shape, i_shapes, np.random.default_rng(5)))
    out = pg.WRAPPERS[name](src, *idx)
    assert pg.same_bits(out, pg.PLAIN[name](src, *idx))
    assert pg.same_bits(pg.library_call(name, src, *idx)(), out)
    assert pg.LAUNCHES == dict.fromkeys(pg.KERNELS, 0)
    assert pg.PLAIN_ON_CUDA == dict.fromkeys(pg.KERNELS, 0)
    b = pg.byte_bound(name, src, *idx)
    offs = pg.source_offsets(name, src, *idx)
    assert torch.equal(src.flatten()[offs].sort().values,
                       out.flatten().sort().values)
    assert b["bytes"] == 4 * (sum(i.numel() for i in idx) + out.numel()
                              + len(set(offs.tolist())))


def test_wrappers_refuse_what_the_kernel_does_not_take():
    src = torch.zeros(4, 5)
    with pytest.raises(ValueError):
        pg.take_along_last(src, torch.zeros(3, 5, dtype=torch.int32))
    with pytest.raises(ValueError):
        pg.take_rows(src, torch.zeros(3, dtype=torch.float32))
    with pytest.raises(ValueError):  # the kernel reads int32 indices only
        pg.take_rows(src, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        pg.take_along_first(src, torch.zeros(2, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        pg.take_2d(src, torch.zeros(3, dtype=torch.int32),
                   torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError):
        pg.take_flat(torch.zeros(0), torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("channels", [0, 2])
def test_bilinear_baseline_matches_reference(channels):
    """The probe's copy of _bilinear_gather, samples inside and outside the
    image, one channel plane or a [H, W, 2] volume."""
    rng = np.random.default_rng(7 + channels)
    H, W = 37, 53
    shape = (H, W, channels) if channels else (H, W)
    img = rng.random(shape, dtype=np.float32)
    ys = (rng.random((5, 9, 9)) * (H + 6) - 3).astype(np.float32)
    xs = (rng.random((5, 9, 9)) * (W + 6) - 3).astype(np.float32)
    got = pg.bilinear_gather(*_torch([img, ys, xs]))
    ref = torch.from_numpy(np.array(_bilinear_gather(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs))))
    assert got.shape == ref.shape
    outside = (ys < 0) | (ys > H - 1) | (xs < 0) | (xs > W - 1)
    assert outside.any() and (~outside).any()
    scale = max(float(ref.abs().max()), 1.0)
    assert float((got - ref).abs().max()) / scale < 1e-6


def test_grid_sample_yardstick_samples_the_same_points():
    """F.grid_sample, the baseline's library call, at the probe's
    normalization gives the copy's samples inside the image."""
    rng = np.random.default_rng(3)
    H, W = 41, 29
    vol = torch.from_numpy(rng.random((H, W, 2), dtype=np.float32))
    ys = torch.from_numpy((rng.random((4, 6, 6)) * (H - 2)).astype(np.float32))
    xs = torch.from_numpy((rng.random((4, 6, 6)) * (W - 2)).astype(np.float32))
    grid = torch.stack([xs / (W - 1) * 2 - 1, ys / (H - 1) * 2 - 1],
                       -1).reshape(1, 4, 36, 2)
    lib = pg.grid_sample_gather(vol.permute(2, 0, 1)[None].contiguous(), grid)
    ref = pg.bilinear_gather(vol, ys, xs)
    assert float((lib[0].permute(1, 2, 0).reshape(ref.shape) - ref).abs()
                 .max()) < 1e-4


@pytest.mark.parametrize("bench_only", [False, True])
def test_probe_needs_the_card(monkeypatch, bench_only):
    """The probe measures the card: on a host without CUDA it raises
    through resolve_device, before it measures anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    lines = []
    with pytest.raises(RuntimeError, match="CUDA"):
        pg.run(log=lines.append, bench_only=bench_only)
    assert lines == []
