"""Hopper gather probe: the five gather forms of the TPU probe as CUDA
kernels, checked and timed on the card.

Port of ``scripts/proto_pallas_gather.py``, which asks which gather forms a
Mosaic (Pallas TPU) kernel accepts and how fast they run. PatchMatch's cost
and the SIFT window sampler both bottleneck on gathers; on Hopper every form
compiles, so this probe measures the rate of each form against its byte
bound and against the PyTorch call that computes the same gather:

| kernel           | reference case       | computes          | library      |
|------------------|----------------------|-------------------|--------------|
| take_along_last  | case_a :66, and :164 | src[r, idx[r, c]] | torch.gather |
| take_rows        | case_b :85           | src[idx[i], :]    | index_select |
| take_along_first | case_b2 :104         | src[idx[r, c], c] | torch.gather |
| take_2d          | case_c :125          | src[yi, xi]       | indexing     |
| take_flat        | case_c2 :144         | src[idx] (1-D)    | torch.take   |

(:164 is bench_a_sized, case_a's gather at [1024, 512].)

Index rules, the jnp ``ref`` of each case: ``take_along_axis`` and ``take``
(take_along_last, take_along_first, take_flat) wrap an index in [-n, -1]
and give NaN for any other index outside [0, n); indexing (take_rows,
take_2d) wraps a negative index once, then clamps to [0, n - 1]. The
kernels (``csrc/gather_probe.cu``, one template) and the plain versions
follow them exactly and never read outside the source.

Each wrapper launches its kernel for a CUDA source and runs its plain
version for a CPU one; nothing falls back. ``LAUNCHES`` counts kernel
launches, ``PLAIN_ON_CUDA`` calls of a plain version on CUDA tensors (only
comparisons make those); ``reset_counts()`` zeroes both.

The probe also times the reference's two XLA baselines: its SIFT bilinear
gather (``bilinear_gather``, a copy of the reference's
``features/sift.py`` ``_bilinear_gather``, beside ``F.grid_sample``) and a
flat gather at that scale (take_flat, N 2,097,152 from 2,457,600).

Run on the card:  python -m pycolmap_torch.scripts.proto_gather [--bench-only]
"""

from __future__ import annotations

import sys

import numpy as np
import torch
import torch.nn.functional as F

from pycolmap_torch import resolve_device
from pycolmap_torch._timing import time_gpu
from pycolmap_torch.scripts import _cuda

KERNELS = ("take_along_last", "take_rows", "take_along_first", "take_2d",
           "take_flat")
# the kernel's Form enum (csrc/gather_probe.cu)
_FORMS = dict(zip(KERNELS, range(len(KERNELS))))
LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_ON_CUDA = dict.fromkeys(KERNELS, 0)

# H100 SXM published HBM3 rate (NVIDIA data sheet)
HBM_BYTES_PER_S = 3.35e12
_NAN = float("nan")
_I32_MAX = 2**31 - 1
SEED = 0


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_ON_CUDA[k] = 0


# ---------------------------------------------------------------------------
# index rules and plain versions


def _fill(idx, n):
    """take_along_axis / take: (the index wrapped from [-n, -1] and clamped
    into [0, n), whether it was in range; out of range reads NaN)."""
    i = idx.long()
    i = torch.where(i < 0, i + n, i)
    return i.clamp(0, n - 1), (i >= 0) & (i < n)


def _clamp(idx, n):
    """Indexing: the index wrapped once if negative, then clamped."""
    i = idx.long()
    return torch.where(i < 0, i + n, i).clamp(0, n - 1)


def _plain_call(name, src):
    if src.is_cuda:
        PLAIN_ON_CUDA[name] += 1


def take_along_last_plain(src, idx):
    """``jnp.take_along_axis(src, idx, axis=-1)``: src [R, N], idx [R, M]."""
    _plain_call("take_along_last", src)
    j, ok = _fill(idx, src.shape[1])
    return torch.where(ok, torch.gather(src, 1, j), _NAN)


def take_rows_plain(src, idx):
    """``src[idx, :]``: src [R, C], idx [M] -> [M, C]."""
    _plain_call("take_rows", src)
    return src[_clamp(idx, src.shape[0])]


def take_along_first_plain(src, idx):
    """``jnp.take_along_axis(src, idx, axis=0)``: src [R, C], idx [M, C]."""
    _plain_call("take_along_first", src)
    i, ok = _fill(idx, src.shape[0])
    return torch.where(ok, torch.gather(src, 0, i), _NAN)


def take_2d_plain(src, yi, xi):
    """``src[yi, xi]``: src [R, C], yi and xi of one shape."""
    _plain_call("take_2d", src)
    return src[_clamp(yi, src.shape[0]), _clamp(xi, src.shape[1])]


def take_flat_plain(src, idx):
    """``jnp.take(src, idx)``: src [N], idx of any shape."""
    _plain_call("take_flat", src)
    j, ok = _fill(idx, src.shape[0])
    return torch.where(ok, torch.take(src, j), _NAN)


PLAIN = dict(zip(KERNELS, (take_along_last_plain, take_rows_plain,
                           take_along_first_plain, take_2d_plain,
                           take_flat_plain)))


# ---------------------------------------------------------------------------
# wrappers


def _check(name, src, idxs, ndim, ok):
    bad_idx = [i.dtype for i in idxs if i.dtype != torch.int32]
    if (src.dim() != ndim or src.numel() == 0 or not ok or bad_idx
            or max(src.shape) > _I32_MAX):
        raise ValueError(
            f"{name}: source {tuple(src.shape)}, indices "
            f"{[tuple(i.shape) for i in idxs]} "
            f"{[i.dtype for i in idxs]}: shapes or types the gather does not "
            f"take")


def _launch(name, src, idx, idx2, out_shape, out_cols):
    rows, cols = (1, src.shape[0]) if src.dim() == 1 else src.shape
    out = torch.empty(out_shape, dtype=torch.float32, device=src.device)
    LAUNCHES[name] += 1
    _cuda.gather_probe(_FORMS[name], src, idx, idx2, rows, cols, out_cols, out)
    return out


def take_along_last(src, idx):
    """out[r, c] = src[r, idx[r, c]] (case_a): src [R, N] f32, idx [R, M]
    int32 -> [R, M]. CUDA tensors launch the kernel, CPU ones run
    :func:`take_along_last_plain`."""
    _check("take_along_last", src, [idx], 2,
           idx.dim() == 2 and idx.shape[0] == src.shape[0])
    if not src.is_cuda:
        return take_along_last_plain(src, idx)
    return _launch("take_along_last", src, idx, None, idx.shape,
                   max(idx.shape[1], 1))


def take_rows(src, idx):
    """out[i, :] = src[idx[i], :] (case_b): src [R, C] f32, idx [M] int32
    -> [M, C]."""
    _check("take_rows", src, [idx], 2, idx.dim() == 1)
    if not src.is_cuda:
        return take_rows_plain(src, idx)
    return _launch("take_rows", src, idx, None, (idx.shape[0], src.shape[1]),
                   src.shape[1])


def take_along_first(src, idx):
    """out[r, c] = src[idx[r, c], c] (case_b2): src [R, C] f32, idx [M, C]
    int32 -> [M, C]."""
    _check("take_along_first", src, [idx], 2,
           idx.dim() == 2 and idx.shape[1] == src.shape[1])
    if not src.is_cuda:
        return take_along_first_plain(src, idx)
    return _launch("take_along_first", src, idx, None, idx.shape,
                   src.shape[1])


def take_2d(src, yi, xi):
    """out = src[yi, xi] (case_c): src [R, C] f32, yi and xi int32 of one
    shape -> that shape."""
    _check("take_2d", src, [yi, xi], 2, yi.shape == xi.shape)
    if not src.is_cuda:
        return take_2d_plain(src, yi, xi)
    return _launch("take_2d", src, yi, xi, yi.shape, 1)


def take_flat(src, idx):
    """out = take(src, idx) (case_c2): src [N] f32, idx int32 of any shape
    -> that shape."""
    _check("take_flat", src, [idx], 1, True)
    if not src.is_cuda:
        return take_flat_plain(src, idx)
    return _launch("take_flat", src, idx, None, idx.shape, 1)


WRAPPERS = dict(zip(KERNELS, (take_along_last, take_rows, take_along_first,
                              take_2d, take_flat)))


def library_call(name, src, *idx):
    """One PyTorch call computing the same gather where every index is in
    [0, n) (the probe's inputs); the int64 indices it needs are made here,
    outside the call."""
    i64 = [i.long() for i in idx]
    if name == "take_along_last":
        return lambda: torch.gather(src, 1, i64[0])
    if name == "take_rows":
        return lambda: src.index_select(0, i64[0])
    if name == "take_along_first":
        return lambda: torch.gather(src, 0, i64[0])
    if name == "take_2d":
        return lambda: src[i64[0], i64[1]]
    return lambda: torch.take(src, i64[0])


LIBRARY = dict(zip(KERNELS, ("torch.gather", "index_select", "torch.gather",
                             "indexing src[yi, xi]", "torch.take")))


def same_bits(a, b) -> bool:
    """Equal shapes and equal f32 bit patterns (NaNs included)."""
    return (a.shape == b.shape and a.dtype == b.dtype == torch.float32
            and torch.equal(a.view(torch.int32), b.view(torch.int32)))


# ---------------------------------------------------------------------------
# the bound


def source_offsets(name, src, *idx):
    """Flat offsets of the source elements the gather reads (the NaN fills
    read none)."""
    if name == "take_along_last":
        R, N = src.shape
        j, ok = _fill(idx[0], N)
        rows = torch.arange(R, device=src.device)[:, None]
        return (rows * N + j)[ok]
    if name == "take_rows":
        C = src.shape[1]
        i = _clamp(idx[0], src.shape[0])
        return (i[:, None] * C + torch.arange(C, device=src.device)).flatten()
    if name == "take_along_first":
        C = src.shape[1]
        i, ok = _fill(idx[0], src.shape[0])
        return (i * C + torch.arange(C, device=src.device))[ok]
    if name == "take_2d":
        R, C = src.shape
        return (_clamp(idx[0], R) * C + _clamp(idx[1], C)).flatten()
    j, ok = _fill(idx[0], src.shape[0])
    return j[ok]


def byte_bound(name, src, *idx):
    """Bytes: each index read once, each output element written once and
    each distinct source element the indices reach read once; the bound is
    those bytes at the H100's 3.35 TB/s."""
    n_out = (idx[0].numel() * src.shape[1] if name == "take_rows"
             else idx[0].numel())
    touched = torch.unique(source_offsets(name, src, *idx)).numel()
    nbytes = (sum(i.numel() * i.element_size() for i in idx)
              + n_out * src.element_size() + touched * src.element_size())
    return dict(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bytes=nbytes, elements=n_out, source_touched=touched)


# ---------------------------------------------------------------------------
# the bilinear baseline


def bilinear_gather(img, ys, xs):
    """img [H, W] or [H, W, C]; ys / xs [...] float coordinates; zero
    outside. A copy of the reference's ``features/sift.py``
    ``_bilinear_gather``, the XLA baseline of its probe."""
    H, W = img.shape[0], img.shape[1]
    chan = img.dim() == 3
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = xs - x0
    dy = ys - y0
    x0i = x0.long()
    y0i = y0.long()
    if chan:
        dx = dx[..., None]
        dy = dy[..., None]

    def get(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        vals = img[yi.clamp(0, H - 1), xi.clamp(0, W - 1)]
        return torch.where(ok[..., None] if chan else ok, vals, 0.0)

    return (
        get(y0i, x0i) * (1 - dy) * (1 - dx)
        + get(y0i, x0i + 1) * (1 - dy) * dx
        + get(y0i + 1, x0i) * dy * (1 - dx)
        + get(y0i + 1, x0i + 1) * dy * dx
    )


def grid_sample_gather(vol_cf, grid):
    """``F.grid_sample`` of a channel-first volume [1, C, H, W] at
    normalized (x, y) samples [1, ...., 2], zero padding, corners aligned:
    the library call for :func:`bilinear_gather`."""
    return F.grid_sample(vol_cf, grid, mode="bilinear", padding_mode="zeros",
                         align_corners=True)


# ---------------------------------------------------------------------------
# the probe's inputs

# the reference's probe shapes: report name, source shape, index shapes
PROBES = {
    "take_along_last": ("A lane take_along_axis", (256, 512), ((256, 512),)),
    "take_rows": ("B row gather s[idx, :]", (512, 256), ((256,),)),
    "take_along_first": ("B2 take_along_axis axis=0", (512, 256),
                         ((512, 256),)),
    "take_2d": ("C 2-D s[yi, xi]", (256, 512), ((8, 128), (8, 128))),
    "take_flat": ("C2 flat 1-D take", (256 * 512,), ((1024,),)),
}
# ragged shapes for the checks: 203 x 317 sources (64,351 flat), index
# arrays of no round size
RAGGED = {
    "take_along_last": ((203, 317), ((203, 45),)),
    "take_rows": ((203, 317), ((77,),)),
    "take_along_first": ((203, 317), ((31, 317),)),
    "take_2d": ((203, 317), ((13, 7, 5), (13, 7, 5))),
    "take_flat": ((203 * 317,), ((999,),)),
}
# bench_a_sized's lane gather (Ksamp 2048 * 256) and bench_xla_gather_flat's
SIZED_SHAPE = (2048 * 256 // 512, 512)
FLAT_SRC, FLAT_N = 3840 * 640, 2048 * 256 * 4
# bench_xla_gather: a [3840, 640, 2] volume, K 2048 windows of 16 x 16
BILINEAR_VOL, BILINEAR_K, BILINEAR_G = (3840, 640, 2), 2048, 16


def index_extents(name, src_shape):
    """The extent n each index array of `name` ranges over."""
    if name in ("take_along_last", "take_flat"):
        return (src_shape[-1],)
    if name == "take_2d":
        return tuple(src_shape)
    return (src_shape[0],)


def make_inputs(name, src_shape, idx_shapes, rng, edge=False):
    """Seeded numpy inputs: an f32 source in [0, 1) and int32 indices in
    [0, n); with `edge`, indices in [-n, n) of which about a tenth are
    replaced by out-of-range values (beyond either end, and the int32
    extremes)."""
    src = rng.random(src_shape, dtype=np.float32)
    idx = []
    for shape, n in zip(idx_shapes, index_extents(name, src_shape)):
        if not edge:
            idx.append(rng.integers(0, n, shape, dtype=np.int32))
            continue
        i = rng.integers(-n, n, shape, dtype=np.int64)
        odd = np.array([-2**31, -n - 5, -n - 1, n, n + 1, n + 7, _I32_MAX])
        pick = rng.random(shape) < 0.1
        i[pick] = rng.choice(odd, int(pick.sum()))
        idx.append(i.astype(np.int32))
    return src, idx


def to_device(device, src, idx):
    return (torch.from_numpy(src).to(device),
            [torch.from_numpy(i).to(device) for i in idx])


# ---------------------------------------------------------------------------
# measurement (on the card only)


def check(name, src, idx):
    """Kernel against plain version on the same card tensors, bit for bit;
    returns the kernel's output. Raises on a mismatch."""
    got = WRAPPERS[name](src, *idx)
    ref = PLAIN[name](src, *idx)
    torch.cuda.synchronize()
    if not same_bits(got, ref):
        bad = int((got.view(torch.int32) != ref.view(torch.int32)).sum()) \
            if got.shape == ref.shape else -1
        raise AssertionError(
            f"{name}: kernel differs from plain at {bad} of {ref.numel()} "
            f"elements (source {tuple(src.shape)})")
    return got


def measure(name, src, idx):
    """Check, then time kernel, plain version and library call at these
    inputs (indices in range). Returns a record with the byte bound and the
    kernel's rates."""
    got = check(name, src, idx)
    lib = library_call(name, src, *idx)
    lib_same = same_bits(lib(), got)
    rec = dict(shape=dict(source=list(src.shape),
                          indices=[list(i.shape) for i in idx]),
               max_abs_err=0.0,
               ms=time_gpu(lambda: WRAPPERS[name](src, *idx)),
               plain_ms=time_gpu(lambda: PLAIN[name](src, *idx)),
               library=LIBRARY[name], library_equal=lib_same,
               library_ms=time_gpu(lib), **byte_bound(name, src, *idx))
    rec["g_elems_per_s"] = rec["elements"] / rec["ms"] / 1e6
    rec["gb_per_s"] = rec["bytes"] / rec["ms"] / 1e6
    return rec


def timing_line(rec):
    return (f"  kernel {rec['ms']:.4f} ms ({rec['g_elems_per_s']:.2f} G "
            f"elems/s, {rec['gb_per_s']:.1f} GB/s), plain "
            f"{rec['plain_ms']:.4f} ms, {rec['library']} "
            f"{rec['library_ms']:.4f} ms, bound {rec['bound_ms']:.3g} ms "
            f"({rec['bytes'] / 1e6:.3f} MB)")


def bench_bilinear(device, rng):
    """The reference's XLA baseline at its shapes: the bilinear gather copy
    and F.grid_sample at the same samples."""
    LH, W, C = BILINEAR_VOL
    K, G = BILINEAR_K, BILINEAR_G
    vol = torch.from_numpy(rng.random((LH, W, C), dtype=np.float32)).to(device)
    ys = torch.from_numpy((rng.random((K, G, G)) * (LH - 2)).astype(
        np.float32)).to(device)
    xs = torch.from_numpy((rng.random((K, G, G)) * (W - 2)).astype(
        np.float32)).to(device)
    vol_cf = vol.permute(2, 0, 1)[None].contiguous()
    grid = torch.stack([xs / (W - 1) * 2 - 1, ys / (LH - 1) * 2 - 1],
                       -1).reshape(1, K, G * G, 2)
    ref = bilinear_gather(vol, ys, xs)
    lib = grid_sample_gather(vol_cf, grid)[0].permute(1, 2, 0)
    diff = float((lib.reshape(ref.shape) - ref).abs().max())
    return dict(shape=dict(volume=[LH, W, C], samples=[K, G, G]),
                ms=time_gpu(lambda: bilinear_gather(vol, ys, xs)),
                grid_sample_ms=time_gpu(
                    lambda: grid_sample_gather(vol_cf, grid)),
                grid_sample_max_abs_diff=diff)


def run(log=print, bench_only=False):
    """Check and time every form on the card and print the report: per
    case "COMPILES, correct=...", then its times; then the lane gather at
    bench_a_sized's size, the bilinear baseline and the flat gather at its
    scale. `bench_only`, the reference's ``--bench-only``, skips the five
    cases. Returns {key: record}; a case that failed has ``correct`` False
    and its error."""
    device = resolve_device()
    log(f"device: {torch.cuda.get_device_name(device)}")
    rng = np.random.default_rng(SEED)
    out = {}
    if not bench_only:
        for name, (title, s_shape, i_shapes) in PROBES.items():
            try:
                src, idx = to_device(device, *make_inputs(
                    name, s_shape, i_shapes, rng))
                rec = measure(name, src, idx)
                log(f"[{title}] COMPILES, correct=True")
                log(timing_line(rec))
                out[name] = dict(rec, correct=True)
            except (AssertionError, RuntimeError, ValueError) as e:
                msg = str(e).split("\n")[0][:160]
                log(f"[{title}] FAILED: {type(e).__name__}: {msg}")
                out[name] = dict(correct=False, error=msg)
    src, idx = to_device(device, *make_inputs(
        "take_along_last", SIZED_SHAPE, (SIZED_SHAPE,), rng))
    out["take_along_last sized"] = rec = measure("take_along_last", src, idx)
    log(f"  lane-gather {SIZED_SHAPE}: {rec['ms']:.4f} ms "
        f"({rec['g_elems_per_s']:.2f} G elems/s)")
    log(timing_line(rec))
    out["bilinear"] = rec = bench_bilinear(device, rng)
    log(f"  bilinear gather K={BILINEAR_K} G={BILINEAR_G}x{BILINEAR_G} 2ch: "
        f"{rec['ms']:.4f} ms; F.grid_sample {rec['grid_sample_ms']:.4f} ms "
        f"(max |difference| {rec['grid_sample_max_abs_diff']:.2e})")
    src, idx = to_device(device, *make_inputs(
        "take_flat", (FLAT_SRC,), ((FLAT_N,),), rng))
    out["take_flat sized"] = rec = measure("take_flat", src, idx)
    log(f"  flat 1-D gather N={FLAT_N}: {rec['ms']:.4f} ms "
        f"({rec['gb_per_s']:.1f} GB/s)")
    log(timing_line(rec))
    return out


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    out = run(bench_only="--bench-only" in argv)
    return 0 if all(r.get("correct", True) for r in out.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
