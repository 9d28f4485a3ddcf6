"""Bilinear window sampling of a pair-interleaved volume, with its CUDA
kernel.

Port of ``pycolmap_tpu/features/window_sampler.py``. The SIFT orientation,
descriptor and affine-shape stages sample the gradient volume at 256
rotated-grid positions per keypoint. All samples of one keypoint lie in a
small window (the support is ~6 scale units), so each keypoint gets a window
origin and a bilinear tap outside its window counts zero.

The port's volume is ``[LHp, Wp, NC]``: the channels of a pixel adjacent, so
that the kernel reads a tap of a channel pair with one 8-byte load (the
reference's is channel-major ``[NC, LHp, Wp]``; :func:`interleave` converts).

| function               | role                                           |
|------------------------|------------------------------------------------|
| sample_windows         | the reference's wrapper (:191) and its kernel  |
|                        | in one: CUDA tensors launch                    |
|                        | ``csrc/window_sampler.cu`` once, CPU tensors   |
|                        | run ``sample_windows_plain``                   |
| sample_windows_plain   | the kernel's plain version: the wrapper's      |
|                        | origin rule (``window_origins``), then the     |
|                        | window-coordinate sampling                     |
| sample_windows_kernel  | the reference kernel's contract               |
|                        | (``_sample_windows_pallas`` :105: origins and  |
|                        | window coordinates given, channel-major        |
|                        | volume), on CPU tensors only                   |
| sample_windows_reference | whole-volume gather (reference :231)         |

The kernel samples in f32. The reference's bf16 operand option
(``_bf16_default``) only halves passes on the TPU's matrix unit; a gather
has none, so the port has no such option.

``LAUNCHES`` counts kernel launches; ``PLAIN_ON_CUDA`` counts calls of the
plain version on CUDA tensors (only ``chip_smoke.py``'s comparisons make
those). ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from pycolmap_torch.features import _cuda

S = 256  # samples per keypoint: SIFT's 16 x 16 grid

LAUNCHES = {"window_sampler": 0}
PLAIN_ON_CUDA = {"window_sampler": 0}


def reset_counts() -> None:
    LAUNCHES["window_sampler"] = 0
    PLAIN_ON_CUDA["window_sampler"] = 0


def _round_up(n, m):
    return ((n + m - 1) // m) * m


def padded_shape(lh: int, w: int):
    """The sampler's volume plane (LHp, Wp) for [lh, w] planes: rows to a
    multiple of 8 and >= 256, cols to a multiple of 128 and >= 512 (the
    largest window). Zero padding keeps zero-outside bilinear semantics."""
    return max(_round_up(lh, 8), 256), max(_round_up(w, 128), 512)


def pad_volume(grad2: torch.Tensor) -> torch.Tensor:
    """Zero-pad a [NC, LH, W] channel-major volume to
    :func:`padded_shape` (the reference's layout)."""
    _, lh, w = grad2.shape
    lhp, wp = padded_shape(lh, w)
    if lhp == lh and wp == w:
        return grad2
    return F.pad(grad2, (0, wp - w, 0, lhp - lh))


def interleave(vol: torch.Tensor) -> torch.Tensor:
    """[NC, LHp, Wp] channel-major -> the sampler's [LHp, Wp, NC]."""
    return vol.permute(1, 2, 0).contiguous()


def window_sizes(support_px: float):
    """Static window shape (win_y, win_x) for a given max |sample -
    keypoint| in pixels, or None if the support exceeds the largest
    window (callers then sample the whole volume as one window)."""
    spread = int(np.ceil(2 * support_px + 2))  # + bilinear footprint
    win_y = max(_round_up(spread + 8, 8), 16)  # y0 is floor-8-aligned
    if win_y > 256:
        return None
    # x0 is floor-128-aligned: allowed spread = win_x - 129
    for win_x in (256, 384, 512):
        if spread <= win_x - 129:
            return (win_y, win_x)
    return None


def sample_windows_plain(vol, ch0, ys, xs, win_y, win_x):
    """The kernel's arithmetic in PyTorch: :func:`window_origins`, then the
    bilinear samples of channels ch0 and ch0 + 1 at window coordinates
    ys - y0, xs - x0 (exact in f32), a tap outside the window counting zero.
    Arguments and result as :func:`sample_windows`, in the dtype of vol."""
    if vol.is_cuda:
        PLAIN_ON_CUDA["window_sampler"] += 1
    K, G, _ = ys.shape
    ysf, xsf = ys.reshape(K, -1), xs.reshape(K, -1)
    y0, x0 = window_origins(ysf, xsf, vol.shape[0], vol.shape[1], win_y,
                            win_x)
    wy = ysf - y0[:, None].to(ysf.dtype)
    wx = xsf - x0[:, None].to(xsf.dtype)
    out = _sample_at_windows(vol, ch0, y0, x0, wy, wx, win_y, win_x)
    return out[:, 0].reshape(K, G, G), out[:, 1].reshape(K, G, G)


def window_origins(ys, xs, lhp, wp, win_y, win_x):
    """The reference wrapper's window origins of [K, ...] sample positions:
    floor of the smallest coordinate, floor-divided to a multiple of 8 rows
    / 128 columns, clamped so the window lies inside the [lhp, wp] volume.
    Returns (y0, x0) [K] int32."""
    K = ys.shape[0]
    y_min = torch.floor(ys.reshape(K, -1).amin(dim=1)).to(torch.int32)
    x_min = torch.floor(xs.reshape(K, -1).amin(dim=1)).to(torch.int32)
    # floor division: origins left of or above the volume are negative
    y0 = (torch.div(y_min, 8, rounding_mode="floor") * 8).clamp(0, lhp - win_y)
    x0 = (torch.div(x_min, 128, rounding_mode="floor") * 128).clamp(
        0, wp - win_x)
    return y0, x0


def _sample_at_windows(vol, ch0, y0, x0, wy, wx, win_y, win_x):
    """[K, 2, S] bilinear samples of channels ch0 and ch0 + 1 of the
    [LHp, Wp, NC] volume at (y0 + wy, x0 + wx), each tap outside the window
    (or the volume, or a channel pair outside it) counting zero."""
    LHp, Wp, NC = vol.shape
    fy, fx = torch.floor(wy), torch.floor(wx)
    dy, dx = wy - fy, wx - fx
    iy, ix = fy.long(), fx.long()
    c0 = ch0.long()[:, None]
    c_ok = (c0 >= 0) & (c0 + 1 < NC)
    c0 = c0.clamp(0, max(NC - 2, 0))
    flat = vol.reshape(LHp * Wp, NC)
    oy, ox = y0.long()[:, None], x0.long()[:, None]
    out0 = torch.zeros_like(wy)
    out1 = torch.zeros_like(wy)
    for ty in (0, 1):
        for tx in (0, 1):
            ry, rx = iy + ty, ix + tx
            gy, gx = oy + ry, ox + rx
            ok = (c_ok & (ry >= 0) & (ry < win_y) & (rx >= 0) & (rx < win_x)
                  & (gy >= 0) & (gy < LHp) & (gx >= 0) & (gx < Wp))
            w = (dy if ty else 1 - dy) * (dx if tx else 1 - dx)
            off = gy.clamp(0, LHp - 1) * Wp + gx.clamp(0, Wp - 1)
            out0 = out0 + torch.where(ok, flat[off, c0], 0.0) * w
            out1 = out1 + torch.where(ok, flat[off, c0 + 1], 0.0) * w
    return torch.stack([out0, out1], dim=1)


def sample_windows_kernel(vol, ch0, y0, x0, wy, wx, win_y, win_x):
    """The reference kernel's contract on CPU tensors: vol [NC, LHp, Wp]
    f32 (channel-major); ch0/y0/x0 [K] int32; wy/wx [K, 256] f32 in window
    coordinates. Returns [K, 2, 256] f32 (``_sample_windows_pallas``; K need
    not be a multiple of 8). On the card the origins are the kernel's own:
    :func:`sample_windows` launches it."""
    K = ch0.shape[0]
    if vol.dim() != 3 or wy.shape != (K, S) or wx.shape != (K, S):
        raise ValueError(f"sampler shapes: vol {tuple(vol.shape)}, "
                         f"wy {tuple(wy.shape)}, wx {tuple(wx.shape)}, K {K}")
    if vol.is_cuda:
        raise ValueError("sample_windows_kernel takes CPU tensors; on the "
                         "card call sample_windows")
    return _sample_at_windows(vol.permute(1, 2, 0), ch0, y0, x0, wy, wx,
                              win_y, win_x)


def sample_windows(vol, ch0, ys, xs, win_y, win_x):
    """Bilinear-sample a pair-interleaved volume at per-keypoint grid
    positions.

    vol: [LHp, Wp, NC] f32, zero-padded to :func:`padded_shape`; ch0: [K]
    int32 first channel of each keypoint's pair; ys/xs: [K, G, G] f32
    sample coordinates in the [LHp, Wp] planes (G * G = 256). All samples of
    one keypoint must lie in a (win_y - 9, win_x - 129) box (see
    :func:`window_sizes`); win = (LHp, Wp) takes the whole volume.

    Returns (v0, v1): two [K, G, G] sampled channel planes. On the card one
    kernel launch computes the origins and both planes.
    """
    K, G, _ = ys.shape
    if (vol.dim() != 3 or G * G != S or xs.shape != ys.shape
            or ch0.shape != (K,) or not 2 <= win_y <= vol.shape[0]
            or not 2 <= win_x <= vol.shape[1]):
        raise ValueError(f"sampler shapes: vol {tuple(vol.shape)}, ys "
                         f"{tuple(ys.shape)}, xs {tuple(xs.shape)}, ch0 "
                         f"{tuple(ch0.shape)}, window {win_y}x{win_x}")
    if not vol.is_cuda:
        return sample_windows_plain(vol, ch0, ys, xs, win_y, win_x)
    out = torch.empty((2, K, G, G), device=vol.device)
    LAUNCHES["window_sampler"] += 1
    # the launcher takes dense f32 operands only (it raises on another
    # dtype): the kernel indexes vol as [LHp, Wp, NC]
    _cuda.sample_windows(vol.contiguous(), ch0.to(torch.int32).contiguous(),
                         ys.contiguous(), xs.contiguous(), win_y, win_x, out)
    return out[0], out[1]


def sample_windows_reference(vol, ch0, ys, xs):
    """Whole-volume bilinear gather with the same semantics (reference
    :231): (v0, v1) sampled from channels ch0 and ch0 + 1, zero outside."""
    c = ch0.long()[:, None, None]
    return _bilinear_plane(vol, c, ys, xs), _bilinear_plane(vol, c + 1, ys, xs)


def _bilinear_plane(vol, c, ys, xs):
    """Bilinear sample vol[c] at (ys, xs), zero outside; c broadcasts
    against ys."""
    H, W = vol.shape[1], vol.shape[2]
    x0 = torch.floor(xs)
    y0 = torch.floor(ys)
    dx = xs - x0
    dy = ys - y0
    x0i = x0.long()
    y0i = y0.long()

    def get(yi, xi):
        ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        return torch.where(ok, vol[c, yi.clamp(0, H - 1), xi.clamp(0, W - 1)],
                           0.0)

    return (
        get(y0i, x0i) * (1 - dy) * (1 - dx)
        + get(y0i, x0i + 1) * (1 - dy) * dx
        + get(y0i + 1, x0i) * dy * (1 - dx)
        + get(y0i + 1, x0i + 1) * dy * dx
    )
