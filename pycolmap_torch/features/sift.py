"""SIFT feature extraction in PyTorch, sampling through the CUDA window
sampler on the card.

Port of ``pycolmap_tpu/features/sift.py`` (ref: pycolmap/feature/sift.h:
31-118, pipeline/extract_features.h:64-139). Contract as ``Sift.extract``:
a grayscale array in; keypoints Nx4 [x, y, scale, orientation] and
descriptors Nx128 float (uint8-quantised, /512) out.

Design, as the twin's, with fixed shapes per image size:
- Gaussian pyramid: separable blurs as two banded matrix products per level
  (edge-renormalised bands, full f32: PyTorch's default
  ``allow_tf32=False`` for matmul);
- DoG extrema: separable 3x3x3 max/min via rolls, one closed-form 3x3
  subpixel solve, the edge test;
- a per-octave keypoint budget by scale (exact ``torch.topk``, ties in index
  order: the twin's ``approx_max_k`` is exact on its CPU path too);
- orientation histograms and 4x4x8 descriptors from a fixed 16x16 sample
  grid per keypoint, sampled by ``window_sampler.sample_windows``: the CUDA
  kernel for CUDA tensors, its plain version for CPU tensors;
- L1_ROOT / L2 normalisation, uint8 quantisation on the device.

The twin's persistent executable cache (``_cached_extract``) is TPU compile
machinery; PyTorch runs eagerly, so the port has none. An extract makes no
host sync until its results are fetched.
"""

from __future__ import annotations

import enum
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from pycolmap_torch import resolve_device
from pycolmap_torch.features import window_sampler as ws
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


class Normalization(enum.IntEnum):
    L1_ROOT = 0
    L2 = 1


@options_dataclass
class SiftExtractionOptions(BaseOptions):
    """Defaults mirror reference SiftExtractionOptions (extract_features.h:64-139)."""

    max_image_size: int = 3200
    max_num_features: int = 8192
    first_octave: int = -1
    num_octaves: int = 4
    octave_resolution: int = 3
    peak_threshold: float = 0.02 / 3
    edge_threshold: float = 10.0
    estimate_affine_shape: bool = False
    upright: bool = False
    darkness_adaptivity: bool = False
    domain_size_pooling: bool = False
    dsp_min_scale: float = 1.0 / 6
    dsp_max_scale: float = 3.0
    dsp_num_scales: int = 10
    normalization: Normalization = Normalization.L1_ROOT
    max_num_orientations: int = 2
    # accepted and unused, as the reference accepts them: the entry points
    # take ``device``
    num_threads: int = -1
    use_gpu: bool = True
    gpu_index: str = "-1"


_SIGMA0 = 1.6  # base blur of octave level 0
_SIGMA_N = 0.5  # nominal blur of the input image
_ORI_BINS = 36
_DESC_SPATIAL = 4  # 4x4 descriptor bins
_DESC_ORI = 8
_GRID = 16  # sample grid per side for orientation/descriptor


def _gaussian_kernel1d(sigma: float):
    radius = max(int(math.ceil(4.0 * sigma)), 1)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _band_matrix(n: int, k: np.ndarray, dtype=torch.float32, device=None):
    """Banded Toeplitz [n, n] from symmetric taps k, each row renormalised
    to sum 1 (so the edges come close to replicate padding)."""
    r = (len(k) - 1) // 2
    i = torch.arange(n, device=device)
    off = i[None, :] - i[:, None]
    taps = torch.as_tensor(k, device=device).to(dtype)
    B = torch.where(off.abs() <= r, taps[(off + r).clamp(0, 2 * r)], 0.0)
    return B / torch.sum(B, dim=1, keepdim=True)


@functools.lru_cache(maxsize=64)
def _bands(n: int, sigmas: tuple, dtype, device) -> torch.Tensor:
    """[len(sigmas), n, n] blur bands, cached per size and device: they are
    constants of the image size (``_build_octave`` builds them anew on every
    call in the twin)."""
    return torch.stack([_band_matrix(n, _gaussian_kernel1d(s), dtype, device)
                        for s in sigmas])


def _blur(img, sigma: float):
    """Separable Gaussian blur of [..., H, W] via two banded products."""
    if sigma < 1e-6:
        return img
    H, W = img.shape[-2], img.shape[-1]
    BW = _bands(W, (sigma,), img.dtype, img.device)[0]
    BH = _bands(H, (sigma,), img.dtype, img.device)[0]
    return torch.matmul(BH, torch.matmul(img, BW))


def _upsample2(img):
    """2x bilinear upsampling with half-pixel centres (jax.image.resize's
    "bilinear"; the border rows reproduce the edge pixels in both)."""
    h, w = img.shape
    return F.interpolate(img[None, None], size=(2 * h, 2 * w),
                         mode="bilinear", align_corners=False)[0, 0]


def _downsample2(img):
    return img[::2, ::2]


def _build_octave(base, S: int):
    """base: level-0 Gaussian of the octave. Returns gauss [S+3, H, W],
    every level blurred directly from the base (Gaussian semigroup), so both
    separable passes are one batched product each."""
    H, W = base.shape
    deltas = tuple(
        math.sqrt(max((_SIGMA0 * 2.0 ** (s / S)) ** 2 - _SIGMA0**2, 1e-8))
        for s in range(1, S + 3)
    )
    BW = _bands(W, deltas, base.dtype, base.device)
    BH = _bands(H, deltas, base.dtype, base.device)
    out = torch.matmul(BH, torch.matmul(base, BW))  # [S+2, H, W]
    return torch.cat([base[None], out])


def _top_k(x, k: int):
    """Exact top-k of a 1-D tensor, descending, equal values in index
    order (torch.topk leaves the order of ties unspecified)."""
    vals, idx = torch.topk(x, k)
    order = torch.argsort(idx)
    vals, idx = vals[order], idx[order]
    order = torch.argsort(vals, descending=True, stable=True)
    return vals[order], idx[order]


def _detect_octave(gauss, dog, S: int, peak_threshold, edge_threshold,
                   max_kps: int):
    """One octave: detect + refine extrema.

    Returns (x, y, lev_sel, level_idx, scale_sel, response, mask), each
    [max_kps], in octave coordinates, ordered by scale (largest first)."""
    L, H, W = dog.shape

    # 3D extremum test, separable shift-max/min; roll wrap-around only
    # touches border rows/cols/levels, all excluded below
    def _nb(a, op):
        for ax in (0, 1, 2):
            a = op(a, op(torch.roll(a, 1, dims=ax), torch.roll(a, -1, dims=ax)))
        return a

    mx = _nb(dog, torch.maximum)
    mn = _nb(dog, torch.minimum)
    is_ext = ((dog >= mx) | (dog <= mn)) & (torch.abs(dog) > 0.8 * peak_threshold)
    dev = dog.device
    lev = torch.arange(L, device=dev)[:, None, None]
    row = torch.arange(H, device=dev)[None, :, None]
    col = torch.arange(W, device=dev)[None, None, :]
    border = 4
    interior = ((lev >= 1) & (lev <= S) & (row >= border) & (row < H - border)
                & (col >= border) & (col < W - border))
    is_ext = is_ext & interior

    def shift(a, dl, dr, dc):
        return torch.roll(a, shifts=(-dl, -dr, -dc), dims=(0, 1, 2))

    d = dog
    gl = 0.5 * (shift(d, 1, 0, 0) - shift(d, -1, 0, 0))
    gr = 0.5 * (shift(d, 0, 1, 0) - shift(d, 0, -1, 0))
    gc = 0.5 * (shift(d, 0, 0, 1) - shift(d, 0, 0, -1))
    hll = shift(d, 1, 0, 0) + shift(d, -1, 0, 0) - 2 * d
    hrr = shift(d, 0, 1, 0) + shift(d, 0, -1, 0) - 2 * d
    hcc = shift(d, 0, 0, 1) + shift(d, 0, 0, -1) - 2 * d
    hlr = 0.25 * (shift(d, 1, 1, 0) + shift(d, -1, -1, 0)
                  - shift(d, 1, -1, 0) - shift(d, -1, 1, 0))
    hlc = 0.25 * (shift(d, 1, 0, 1) + shift(d, -1, 0, -1)
                  - shift(d, 1, 0, -1) - shift(d, -1, 0, 1))
    hrc = 0.25 * (shift(d, 0, 1, 1) + shift(d, 0, -1, -1)
                  - shift(d, 0, 1, -1) - shift(d, 0, -1, 1))

    # closed-form solve of the symmetric 3x3 H x = -g (level, row, col)
    a, b_, c_ = hll + 1e-6, hlr, hlc
    d2, e_ = hrr + 1e-6, hrc
    f_ = hcc + 1e-6
    A = d2 * f_ - e_ * e_
    B = c_ * e_ - b_ * f_
    C = b_ * e_ - c_ * d2
    D = a * f_ - c_ * c_
    E = b_ * c_ - a * e_
    Fm = a * d2 - b_ * b_
    det = a * A + b_ * B + c_ * C
    det = torch.where(torch.abs(det) < 1e-12, 1e-12, det)
    off_l = torch.clamp(-(A * gl + B * gr + C * gc) / det, -0.5, 0.5)
    off_r = torch.clamp(-(B * gl + D * gr + E * gc) / det, -0.5, 0.5)
    off_c = torch.clamp(-(C * gl + E * gr + Fm * gc) / det, -0.5, 0.5)
    refined = d + 0.5 * (gl * off_l + gr * off_r + gc * off_c)

    # edge response on the spatial 2x2 Hessian
    tr = hrr + hcc
    det = hrr * hcc - hrc * hrc
    r = edge_threshold
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    valid = is_ext & edge_ok & (torch.abs(refined) > peak_threshold)

    # per-octave top-K by scale: COLMAP keeps the largest scales
    lev_f = lev.to(d.dtype) + off_l
    scale_rel = _SIGMA0 * (2.0 ** (lev_f / S))  # in octave pixel units
    sel_key = torch.where(valid, scale_rel, -math.inf).reshape(-1)
    topv, topi = _top_k(sel_key, max_kps)
    mask = torch.isfinite(topv) & (topv > 0)

    li = topi // (H * W)
    ri = (topi % (H * W)) // W
    ci = topi % W
    x = ci.to(d.dtype) + off_c.reshape(-1)[topi]
    y = ri.to(d.dtype) + off_r.reshape(-1)[topi]
    lev_sel = li.to(d.dtype) + off_l.reshape(-1)[topi]
    resp = refined.reshape(-1)[topi]
    scale_sel = _SIGMA0 * (2.0 ** (lev_sel / S))
    level_idx = torch.clamp(torch.round(lev_sel).to(torch.int32), 1, S)
    return x, y, lev_sel, level_idx, scale_sel, resp, mask


def _octave_gradients(gauss):
    """Central-difference gradients as the pair-interleaved volume
    [LHp, Wp, 2] the window sampler reads, written once into the padded
    volume (only the padding is zeroed besides). Magnitude and angle are
    taken at the sampled points."""
    L, H, W = gauss.shape
    lhp, wp = ws.padded_shape(L * H, W)
    vol = gauss.new_empty((lhp, wp, 2))
    vol[L * H:].zero_()
    vol[:L * H, W:].zero_()
    grad = vol[:L * H, :W].view(L, H, W, 2)
    torch.mul(torch.roll(gauss, -1, dims=2) - torch.roll(gauss, 1, dims=2),
              0.5, out=grad[..., 0])
    torch.mul(torch.roll(gauss, -1, dims=1) - torch.roll(gauss, 1, dims=1),
              0.5, out=grad[..., 1])
    return vol


def _max_scale_rel(S: int) -> float:
    """Static bound on scale_rel: lev_sel <= S + 0.5 (see _detect_octave)."""
    return _SIGMA0 * 2.0 ** ((S + 0.5) / S)


def _sample_grad(grad2, H, W, level_idx, sy, sx, support_px: float):
    """(gx, gy) at per-keypoint grid positions of the flat volume.

    sy is clamped inside the keypoint's level so the bilinear footprint
    never crosses into the next level. support_px (a static bound on
    |sample - keypoint|) sizes the window; a support too large for any
    window samples the whole volume as one window."""
    ys = torch.clamp(sy, 0.0, H - 1.001) + level_idx[:, None, None].to(sy.dtype) * H
    ch0 = torch.zeros(level_idx.shape, dtype=torch.int32, device=sy.device)
    wins = ws.window_sizes(support_px) or tuple(grad2.shape[:2])
    return ws.sample_windows(grad2, ch0, ys, sx, *wins)


def _grid(device, dtype=torch.float32):
    G = _GRID
    u = (torch.arange(G, device=device, dtype=dtype) + 0.5) / G * 2.0 - 1.0
    return torch.meshgrid(u, u, indexing="xy")  # uu varies along columns


def _affine_offsets(A, uu, vv):
    """A [K, 2, 2] applied to the grid: (A00 u + A01 v, A10 u + A11 v)."""
    ox = A[:, 0, 0, None, None] * uu[None] + A[:, 0, 1, None, None] * vv[None]
    oy = A[:, 1, 0, None, None] * uu[None] + A[:, 1, 1, None, None] * vv[None]
    return ox, oy


def _to_frame(T, g0, g1):
    """Image gradients into a patch frame: g_p = T^T g."""
    gx = T[:, 0, 0, None, None] * g0 + T[:, 1, 0, None, None] * g1
    gy = T[:, 0, 1, None, None] * g0 + T[:, 1, 1, None, None] * g1
    return gx, gy


def _orientations(grad2, H, W, S, x, y, level_idx, scale_rel, mask,
                  max_num_orientations, affine=None):
    """36-bin Gaussian-weighted orientation histogram per keypoint.

    affine: optional [K, 2, 2] shape matrices; sampling and gradients move
    to the affine-normalised frame. Returns (orients [K, O], ori_mask)."""
    K = x.shape[0]
    win_factor = 1.5
    radius = 3.0 * win_factor * scale_rel  # [K]
    support = 3.0 * win_factor * _max_scale_rel(S) * (2.45 if affine is not None else 1.0)
    uu, vv = _grid(x.device, x.dtype)
    if affine is None:
        ox, oy = uu[None], vv[None]
    else:
        ox, oy = _affine_offsets(affine, uu, vv)
    sx = x[:, None, None] + radius[:, None, None] * ox
    sy = y[:, None, None] + radius[:, None, None] * oy

    g0, g1 = _sample_grad(grad2, H, W, level_idx, sy, sx, support)
    if affine is not None:
        g0, g1 = _to_frame(affine, g0, g1)
    m = torch.sqrt(g0**2 + g1**2 + 1e-12)
    a = torch.atan2(g1, g0)
    dist2 = uu**2 + vv**2
    w = torch.exp(-dist2 / (2 * (2.0 / 3.0) ** 2))  # sigma = 1.5σ over radius 4.5σ
    wm = m * w[None]
    # soft-assign to 36 bins
    bins = (a / (2 * math.pi) + 0.5) * _ORI_BINS  # [K, G, G] in [0, 36)
    b0 = torch.floor(bins - 0.5)
    frac = bins - 0.5 - b0
    b0i = torch.remainder(b0.long(), _ORI_BINS)
    b1i = torch.remainder(b0i + 1, _ORI_BINS)
    hist = torch.zeros((K, _ORI_BINS), dtype=x.dtype, device=x.device)
    hist.scatter_add_(1, b0i.reshape(K, -1), (wm * (1 - frac)).reshape(K, -1))
    hist.scatter_add_(1, b1i.reshape(K, -1), (wm * frac).reshape(K, -1))
    # smooth histogram (6 passes of [1/3, 1/3, 1/3], as in VLFeat)
    for _ in range(6):
        hist = (torch.roll(hist, 1, dims=1) + hist + torch.roll(hist, -1, dims=1)) / 3.0
    left = torch.roll(hist, 1, dims=1)
    right = torch.roll(hist, -1, dims=1)
    hmax = torch.amax(hist, dim=1, keepdim=True)
    is_peak = (hist > left) & (hist > right) & (hist >= 0.8 * hmax)
    peak_val = torch.where(is_peak, hist, -math.inf)
    top_vals, top_bins = torch.topk(peak_val, max_num_orientations, dim=1)
    ori_mask = torch.isfinite(top_vals) & mask[:, None]
    # parabolic interpolation
    hl = torch.gather(hist, 1, torch.remainder(top_bins - 1, _ORI_BINS))
    hc = torch.gather(hist, 1, top_bins)
    hr = torch.gather(hist, 1, torch.remainder(top_bins + 1, _ORI_BINS))
    denom = hl - 2 * hc + hr
    di = torch.where(torch.abs(denom) > 1e-12, 0.5 * (hl - hr) / denom, 0.0)
    bin_f = top_bins.to(x.dtype) + di
    theta = (bin_f + 0.5) / _ORI_BINS * 2 * math.pi - math.pi
    return theta, ori_mask


def _affine_shapes(grad2, H, W, S, x, y, level_idx, scale_rel, mask,
                   num_iters: int = 5):
    """Second-moment affine shape adaptation (VLFeat covdet semantics):
    A <- A mu^{-1/2}, normalised to det(A) = 1, over num_iters steps.
    Returns (A [K, 2, 2], ok [K]); ok marks finite shapes of anisotropy
    <= 6 (the upstream rejection threshold)."""
    uu, vv = _grid(x.device, x.dtype)
    w = torch.exp(-(uu**2 + vv**2) / (2 * (2.0 / 3.0) ** 2))
    radius = 3.0 * 1.5 * scale_rel  # same window as orientation estimation
    support = 3.0 * 1.5 * _max_scale_rel(S) * 2.45  # A cond-gated at 6
    K = x.shape[0]
    A = torch.eye(2, dtype=x.dtype, device=x.device).expand(K, 2, 2)
    for _ in range(num_iters):
        ox, oy = _affine_offsets(A, uu, vv)
        sx = x[:, None, None] + radius[:, None, None] * ox
        sy = y[:, None, None] + radius[:, None, None] * oy
        g0, g1 = _sample_grad(grad2, H, W, level_idx, sy, sx, support)
        # warped-patch gradients: d/du I(x + r A u) ~ A^T g
        gx, gy = _to_frame(A, g0, g1)
        Mxx = torch.sum(w * gx * gx, dim=(1, 2))
        Mxy = torch.sum(w * gx * gy, dim=(1, 2))
        Myy = torch.sum(w * gy * gy, dim=(1, 2))
        tr = Mxx + Myy
        det = torch.clamp(Mxx * Myy - Mxy * Mxy, min=1e-20)
        # inverse square root of the 2x2 SPD M (closed form), det-normalised
        sdet = torch.sqrt(det)
        s = torch.sqrt(torch.clamp(tr + 2 * sdet, min=1e-20))
        w00 = (Myy + sdet) / s
        w01 = -Mxy / s
        w11 = (Mxx + sdet) / s
        n = torch.sqrt(torch.clamp(w00 * w11 - w01 * w01, min=1e-20))
        Wm = torch.stack([torch.stack([w00 / n, w01 / n], -1),
                          torch.stack([w01 / n, w11 / n], -1)], -2)
        A_new = torch.matmul(A, Wm)
        good = torch.isfinite(A_new).flatten(1).all(dim=1) & (tr > 1e-12)
        A = torch.where(good[:, None, None], A_new, A)
    # condition of A: singular-value ratio via the eigenvalues of A^T A
    AtA_tr = torch.sum(A * A, dim=(1, 2))
    AtA_det = (A[:, 0, 0] * A[:, 1, 1] - A[:, 0, 1] * A[:, 1, 0]) ** 2
    disc = torch.sqrt(torch.clamp(AtA_tr**2 - 4 * AtA_det, min=0.0))
    cond = torch.sqrt((AtA_tr + disc) / torch.clamp(AtA_tr - disc, min=1e-20))
    ok = mask & torch.isfinite(A).flatten(1).all(dim=1) & (cond <= 6.0)
    return A, ok


def _precompute_descriptor_weights():
    """Constant spatial bilinear weights from the 16x16 grid to 4x4 bins."""
    G = _GRID
    D = _DESC_SPATIAL
    u = (np.arange(G) + 0.5) / G * D - D / 2  # sample positions in bins
    W = np.zeros((G * G, D * D), dtype=np.float32)
    for i in range(G):
        for j in range(G):
            # bilinear weight to each bin center (-1.5, -0.5, .5, 1.5)
            for bi in range(D):
                for bj in range(D):
                    cy = bi - (D - 1) / 2
                    cx = bj - (D - 1) / 2
                    wy = max(0.0, 1.0 - abs(u[i] - cy))
                    wx = max(0.0, 1.0 - abs(u[j] - cx))
                    W[i * G + j, bi * D + bj] = wy * wx
    # Gaussian window over the descriptor support
    sigma = D / 2.0
    g = np.exp(-(u[None, :] ** 2 + u[:, None] ** 2) / (2 * sigma**2))
    return W * g.reshape(-1, 1).astype(np.float32)


_DESC_W = _precompute_descriptor_weights()  # [256, 16]


@functools.lru_cache(maxsize=8)
def _desc_weights(dtype, device) -> torch.Tensor:
    return torch.as_tensor(_DESC_W, device=device).to(dtype)


def _frame_matrix(theta, affine=None):
    """Per-keypoint 2x2 patch->image sampling frame T = A @ R(theta)."""
    c = torch.cos(theta)
    s = torch.sin(theta)
    R = torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)
    if affine is None:
        return R
    return torch.matmul(affine, R)


def _l2_normalize(desc):
    return desc / torch.clamp(torch.linalg.norm(desc, dim=1, keepdim=True),
                              min=1e-12)


def _descriptors(grad2, H, W, S, x, y, level_idx, scale_rel, theta,
                 normalization, affine=None, support_scale: float = 1.0):
    """Fixed-grid SIFT descriptors, one per keypoint-orientation: x, y,
    scale_rel, theta [K]; affine optional [K, 2, 2]; support_scale bounds
    an extra scaling of scale_rel by the caller (domain-size pooling).
    Returns [K, 128]."""
    K = x.shape[0]
    mag_factor = 3.0  # bin width = 3 * sigma
    half = _DESC_SPATIAL / 2 * mag_factor * scale_rel  # support half-width
    support = (
        _DESC_SPATIAL / 2 * mag_factor * _max_scale_rel(S) * support_scale
        * math.sqrt(2.0)  # rotated grid corners
        * (2.45 if affine is not None else 1.0)
    )
    uu, vv = _grid(x.device, x.dtype)
    T = _frame_matrix(theta, affine)  # [K, 2, 2]
    ox, oy = _affine_offsets(T, uu, vv)
    sx = x[:, None, None] + half[:, None, None] * ox
    sy = y[:, None, None] + half[:, None, None] * oy

    g0, g1 = _sample_grad(grad2, H, W, level_idx, sy, sx, support)
    gpx, gpy = _to_frame(T, g0, g1)
    m = torch.sqrt(gpx**2 + gpy**2 + 1e-12)
    a = torch.atan2(gpy, gpx)
    obin = torch.remainder(a / (2 * math.pi) * _DESC_ORI, _DESC_ORI)
    b0 = torch.floor(obin)
    frac = obin - b0
    b0i = torch.remainder(b0.long(), _DESC_ORI)
    b1i = torch.remainder(b0i + 1, _DESC_ORI)
    # per-orientation-bin weights [K, S, 8] (b0 != b1: one add per slot),
    # then the spatial binning as one [K, 8, S] x [S, 16] product
    m_f = m.reshape(K, -1)
    ow = torch.zeros((K, m_f.shape[1], _DESC_ORI), dtype=x.dtype, device=x.device)
    ow.scatter_add_(2, b0i.reshape(K, -1, 1), ((1 - frac).reshape(K, -1) * m_f)[..., None])
    ow.scatter_add_(2, b1i.reshape(K, -1, 1), (frac.reshape(K, -1) * m_f)[..., None])
    desc = torch.matmul(ow.transpose(1, 2), _desc_weights(x.dtype, x.device))
    desc = desc.transpose(1, 2).reshape(K, -1)  # [K, 16 spatial x 8 ori]
    # normalise: L2 -> clamp 0.2 -> renormalise
    desc = torch.clamp(_l2_normalize(desc), max=0.2)
    if normalization == int(Normalization.L1_ROOT):
        desc = desc / torch.clamp(torch.sum(desc, dim=1, keepdim=True), min=1e-12)
        return torch.sqrt(desc)
    return _l2_normalize(desc)


def _extract_core(
    image, height, width, num_octaves, S, first_octave, per_octave_kps,
    max_num_orientations, normalization, upright, peak_threshold,
    edge_threshold, dsp_scales=(), affine_shape=False,
):
    """Full SIFT for one image tensor (uint8 or float in [0, 1]). Returns
    per-slot (x, y, scale, orientation, descriptors uint8 [N, 128], mask)
    over all octaves' padded budgets."""
    img = image.to(torch.float32)
    if image.dtype == torch.uint8:
        img = img * (1.0 / 255.0)

    # base image at first octave
    if first_octave < 0:
        base = _upsample2(img)
        base_sigma = 2.0 * _SIGMA_N
    else:
        base = img
        base_sigma = _SIGMA_N
    delta = math.sqrt(max(_SIGMA0**2 - base_sigma**2, 0.01))
    base = _blur(base, delta)

    all_out = []
    octave_scale = 2.0 ** first_octave
    for o in range(num_octaves):
        gauss = _build_octave(base, S)
        dog = gauss[1:] - gauss[:-1]
        # keypoint budgets decay with the octave's pixel count
        oct_budget = max(256, per_octave_kps >> o)
        x, y, _lev, level_idx, scale_rel, _resp, mask = _detect_octave(
            gauss, dog, S, peak_threshold, edge_threshold, oct_budget
        )
        oh, ow = gauss.shape[1], gauss.shape[2]
        grad = _octave_gradients(gauss)  # [LHp, Wp, 2]
        A = None
        if affine_shape:
            A, mask = _affine_shapes(grad, oh, ow, S, x, y, level_idx,
                                     scale_rel, mask)
        if upright:
            theta = torch.zeros((x.shape[0], 1), dtype=x.dtype, device=x.device)
            ori_mask = mask[:, None]
        else:
            theta, ori_mask = _orientations(
                grad, oh, ow, S, x, y, level_idx, scale_rel, mask,
                max_num_orientations, affine=A,
            )
        O = theta.shape[1]
        Nk = x.shape[0]
        # one row per keypoint-orientation, orientation-major: every first
        # orientation (valid-first by construction), then the extra
        # orientations of the top half of the keypoints only (highest
        # scale, the ones COLMAP keeps under budget pressure)
        take = (Nk >> 1) // max(O - 1, 1)

        def per_kp(a):  # [Nk, ...] -> [Nk + (O-1) take, ...]
            return torch.cat([a] + [a[:take]] * (O - 1))

        def per_ori(a):  # [Nk, O] -> [Nk + (O-1) take]
            return torch.cat([a[:, 0]] + [a[:take, k] for k in range(1, O)])

        xe, ye, le, se = (per_kp(t) for t in (x, y, level_idx, scale_rel))
        th = per_ori(theta)
        me = per_ori(ori_mask)
        Ae = per_kp(A) if A is not None else None
        if dsp_scales:
            # domain-size pooling: average descriptors over scaled supports,
            # then renormalise
            fmax = max(dsp_scales)
            acc = None
            for f in dsp_scales:
                d = _descriptors(grad, oh, ow, S, xe, ye, le, se * f, th,
                                 normalization, affine=Ae, support_scale=fmax)
                acc = d if acc is None else acc + d
            desc = _l2_normalize(acc / len(dsp_scales))
            if normalization == int(Normalization.L1_ROOT):
                desc = desc * desc  # undo sqrt before re-normalising in L1
                desc = desc / torch.clamp(torch.sum(desc, dim=1, keepdim=True),
                                          min=1e-12)
                desc = torch.sqrt(desc)
        else:
            desc = _descriptors(grad, oh, ow, S, xe, ye, le, se, th,
                                normalization, affine=Ae)
        all_out.append((xe * octave_scale, ye * octave_scale,
                        se * octave_scale, th, desc, me))
        base = _downsample2(gauss[S])
        octave_scale *= 2.0

    kp_x, kp_y, kp_s, kp_t, descs, masks = (
        torch.cat([a[i] for a in all_out]) for i in range(6))
    # uint8 descriptors are the reference's storage format (/512 on read)
    descs_u8 = torch.clamp(torch.round(descs * 512.0), 0, 255).to(torch.uint8)
    return kp_x, kp_y, kp_s, kp_t, descs_u8, masks


class Sift:
    """In-memory SIFT extractor (API parity: feature/sift.h class Sift).

    Runs on the card unless ``device="cpu"`` is given (the plain versions
    of every kernel)."""

    def __init__(self, options: SiftExtractionOptions = None, device=None):
        self.options = options if options is not None else SiftExtractionOptions()
        self.device = resolve_device(device)

    @staticmethod
    def _to_gray_float(image: np.ndarray) -> np.ndarray:
        img = np.asarray(image)
        if img.ndim == 3:
            img = img.mean(axis=2)
        if img.dtype == np.uint8:
            img = img.astype(np.float32) / 255.0
        else:
            img = img.astype(np.float32)
            if img.max() > 2.0:  # 0..255 float input
                img = img / 255.0
        return img

    @staticmethod
    def _to_device_input(image: np.ndarray) -> np.ndarray:
        """Grayscale uint8 stays raw (normalised on the device, a 4x
        smaller upload); everything else goes through the float path."""
        img = np.asarray(image)
        if img.ndim == 2 and img.dtype == np.uint8:
            return img
        if img.ndim == 3 and img.dtype == np.uint8:
            return (
                img.astype(np.uint16).sum(axis=2) // img.shape[2]
            ).astype(np.uint8)
        return Sift._to_gray_float(image)

    def _static_params(self, h: int, w: int):
        opts = self.options
        max_dim = max(h, w) * (2 if opts.first_octave < 0 else 1)
        num_octaves = min(opts.num_octaves, max(1, int(math.log2(max_dim)) - 3))
        per_octave = max(256, opts.max_num_features // max(num_octaves, 1))
        if opts.domain_size_pooling:
            dsp_scales = tuple(
                float(v) for v in np.linspace(
                    opts.dsp_min_scale, opts.dsp_max_scale,
                    max(2, min(opts.dsp_num_scales, 10)),
                )
            )
        else:
            dsp_scales = ()
        return (
            h, w, num_octaves, opts.octave_resolution, opts.first_octave,
            per_octave, opts.max_num_orientations,
            int(opts.normalization), opts.upright,
            float(opts.peak_threshold), float(opts.edge_threshold),
            dsp_scales, bool(opts.estimate_affine_shape),
        )

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(img)).to(self.device)

    def _postprocess(self, kp_x, kp_y, kp_s, kp_t, descs, mask):
        kps = np.stack([kp_x, kp_y, kp_s, kp_t], axis=1)[mask]
        descs = descs[mask].astype(np.float32) / 512.0  # u8 -> ref float scale
        # global budget: keep largest-scale features (COLMAP semantics)
        if len(kps) > self.options.max_num_features:
            order = np.argsort(-kps[:, 2], kind="stable")[
                : self.options.max_num_features
            ]
            order = np.sort(order)
            kps = kps[order]
            descs = descs[order]
        return kps.astype(np.float32), descs.astype(np.float32)

    def _fetch(self, out):
        return self._postprocess(*(t.cpu().numpy() for t in out))

    def extract(self, image: np.ndarray):
        """image: HxW uint8 or float (0..1 or 0..255 float also accepted).

        Returns (keypoints Nx4 [x, y, scale, orientation], descriptors
        Nx128 float32)."""
        img = self._to_device_input(image)
        out = _extract_core(self._upload(img), *self._static_params(*img.shape))
        return self._fetch(out)

    def extract_batch(self, images):
        """Extract same-size images: every upload first, then every
        extract, one fetch at the end, so the device runs the extracts back
        to back while the host enqueues them. Returns a list of
        (keypoints Nx4, descriptors Nx128)."""
        if not images:
            return []
        grays = [self._to_device_input(im) for im in images]
        h, w = grays[0].shape
        for g in grays:
            if g.shape != (h, w):
                raise ValueError("extract_batch requires same-size images")
        params = self._static_params(h, w)
        uploaded = [self._upload(g) for g in grays]
        outs = [_extract_core(t, *params) for t in uploaded]
        return [self._fetch(out) for out in outs]


def extract_sift(image, options: SiftExtractionOptions = None, device=None):
    """Functional one-shot API."""
    return Sift(options, device).extract(image)
