"""Brute-force descriptor matching with ratio and cross checks, and guided
matching.

Port of ``pycolmap_tpu/features/matcher.py``. Distances follow COLMAP's
convention: the angular distance acos(<d1, d2>) between L2-normalised SIFT
descriptors, so the max_distance / max_ratio defaults carry over.

On the card ``match_descriptors`` and ``match_descriptors_batch`` run the
fused top-2 kernel (``match_kernels.top2_batch``): once per pair or shape
bucket, twice with the cross check. With ``device="cpu"`` they run
``_match_kernel``, the reference's plain path: one materialised similarity
matrix. ``match_guided`` (ref: match_features.h guided_matching) is the
reference's jitted XLA function, no Pallas kernel, as plain PyTorch on
either device: the similarity matrix masked by the two-view geometry's
residual, then the same checks.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.features import match_kernels as mk
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class SiftMatchingOptions(BaseOptions):
    """Defaults mirror the reference (match_features.h:71-99)."""

    max_ratio: float = 0.8
    max_distance: float = 0.7
    cross_check: bool = True
    max_num_matches: int = 32768
    guided_matching: bool = False
    # accepted and unused, as the reference accepts them: the entry points
    # take ``device``
    num_threads: int = -1
    use_gpu: bool = True
    gpu_index: str = "-1"


def _pad_rows(a, m):
    n = a.shape[0]
    n_pad = ((n + m - 1) // m) * m
    if n_pad == n:
        return a, n
    pad = np.zeros((n_pad - n,) + a.shape[1:], dtype=a.dtype)
    return np.concatenate([a, pad], axis=0), n


def _to_unit_float(desc) -> np.ndarray:
    desc = np.asarray(desc)
    if desc.dtype == np.uint8:
        desc = desc.astype(np.float32) / 512.0
    desc = desc.astype(np.float32)
    norms = np.linalg.norm(desc, axis=1, keepdims=True)
    return desc / np.maximum(norms, 1e-12)


def _dist(sim):
    return torch.arccos(torch.clamp(sim, -1.0, 1.0))


def _match_kernel(d1, d2, n1, n2, max_ratio, max_distance, cross_check):
    """The plain path. d1 [B, N1p, D], d2 [B, N2p, D] unit-norm f32;
    n1/n2 [B] valid rows. Returns idx2 [B, N1p] int64 (-1 = no match)."""
    B, N1p, _ = d1.shape
    N2p = d2.shape[1]
    sim = torch.matmul(d1, d2.transpose(1, 2))  # [B, N1p, N2p]
    rows = torch.arange(N1p, device=d1.device)
    cols = torch.arange(N2p, device=d1.device)
    valid = ((rows[None, :, None] < n1[:, None, None])
             & (cols[None, None, :] < n2[:, None, None]))
    sim = torch.where(valid, sim, -2.0)
    best_sim, best = sim.max(dim=2)  # top-1 and its first column
    second_sim = sim.scatter(2, best[..., None], -2.0).amax(dim=2)
    best_dist = _dist(best_sim)
    ok = (best_dist <= max_distance) & (best_dist <= max_ratio * _dist(second_sim))
    if cross_check:
        rev_best = sim.argmax(dim=1)  # best row for each column
        ok &= torch.gather(rev_best, 1, best) == rows[None]
    ok &= rows[None] < n1[:, None]
    return torch.where(ok, best, -1)


def _checks(best, second, idx, rev_idx, n1, options):
    """Ratio, distance and cross checks on the kernel's top-2 ([B, N1]);
    rev_idx [B, N2] from the reverse pass or None. Returns idx2 (-1 = no
    match)."""
    best_dist = _dist(best)
    ok = (best > -1.5) & (best_dist <= options.max_distance)
    ok &= best_dist <= options.max_ratio * _dist(second)
    idx = idx.long()
    if rev_idx is not None:
        safe = idx.clamp(0, rev_idx.shape[1] - 1)
        rows = torch.arange(idx.shape[1], device=idx.device)
        ok &= torch.gather(rev_idx.long(), 1, safe) == rows[None]
    ok &= torch.arange(idx.shape[1], device=idx.device)[None] < n1[:, None]
    return torch.where(ok, idx, -1)


def _matches(idx2, max_num_matches):
    rows = np.nonzero(idx2 >= 0)[0]
    matches = np.stack([rows, idx2[rows]], axis=1).astype(np.uint32)
    return matches[:max_num_matches]


def match_descriptors(descriptors1, descriptors2,
                      options: SiftMatchingOptions = None, device=None):
    """Brute-force match. descriptors: [N, 128] float (unit norm) or uint8
    (COLMAP 512-scaled). Returns matches [M, 2] uint32."""
    if options is None:
        options = SiftMatchingOptions()
    dev = resolve_device(device)
    d1 = _to_unit_float(descriptors1)
    d2 = _to_unit_float(descriptors2)
    if len(d1) == 0 or len(d2) == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    n1, n2 = len(d1), len(d2)
    if dev.type == "cuda":
        t1 = torch.from_numpy(d1).to(dev)
        t2 = torch.from_numpy(d2).to(dev)
        best, second, idx = mk.match_top2(t1, t2, n1, n2)
        rev = None
        if options.cross_check:
            rev = mk.match_top2(t2, t1, n2, n1)[2][None]
        idx2 = _checks(best[None], second[None], idx[None], rev,
                       torch.tensor([n1], device=dev), options)[0]
    else:
        d1p, _ = _pad_rows(d1, 256)
        d2p, _ = _pad_rows(d2, 256)
        idx2 = _match_kernel(
            torch.from_numpy(d1p)[None], torch.from_numpy(d2p)[None],
            torch.tensor([n1]), torch.tensor([n2]), options.max_ratio,
            options.max_distance, options.cross_check,
        )[0, :n1]
    return _matches(idx2.cpu().numpy(), options.max_num_matches)


def match_descriptors_batch(pairs, options: SiftMatchingOptions = None,
                            device=None):
    """Match a block of descriptor pairs: one batched call per shape bucket
    (two with the cross check on the card).

    pairs: list of (descriptors1, descriptors2). Returns a list of matches
    [M, 2] uint32 aligned with the input. Pairs are grouped by pow2-padded
    (N1, N2) buckets, as in the reference.
    """
    if options is None:
        options = SiftMatchingOptions()
    dev = resolve_device(device)
    out = [np.zeros((0, 2), dtype=np.uint32)] * len(pairs)
    groups = defaultdict(list)
    for i, (a, b) in enumerate(pairs):
        d1 = _to_unit_float(a)
        d2 = _to_unit_float(b)
        if len(d1) == 0 or len(d2) == 0:
            continue
        n1p = max(256, 1 << (len(d1) - 1).bit_length())
        n2p = max(256, 1 << (len(d2) - 1).bit_length())
        groups[(n1p, n2p)].append((i, d1, d2))

    for (n1p, n2p), items in groups.items():
        B = len(items)
        D1 = np.zeros((B, n1p, 128), np.float32)
        D2 = np.zeros((B, n2p, 128), np.float32)
        for k, (_i, d1, d2) in enumerate(items):
            D1[k, : len(d1)] = d1
            D2[k, : len(d2)] = d2
        n1s = torch.tensor([len(it[1]) for it in items], device=dev)
        n2s = torch.tensor([len(it[2]) for it in items], device=dev)
        T1 = torch.from_numpy(D1).to(dev)
        T2 = torch.from_numpy(D2).to(dev)
        if dev.type == "cuda":
            best, second, idx = mk.top2_batch(T1, T2, n2s)
            rev = None
            if options.cross_check:
                rev = mk.top2_batch(T2, T1, n1s)[2]
            idx2_all = _checks(best, second, idx, rev, n1s, options)
        else:
            idx2_all = _match_kernel(T1, T2, n1s, n2s, options.max_ratio,
                                     options.max_distance, options.cross_check)
        idx2_all = idx2_all.cpu().numpy()
        for k, (i, d1, _d2) in enumerate(items):
            out[i] = _matches(idx2_all[k, : len(d1)], options.max_num_matches)
    return out


def _guided_match(d1, d2, x1, x2, G, max_ratio, max_distance, max_residual,
                  cross_check, model):
    """Distance matrix masked by a two-view geometry's residual, then
    matched. d1 [N1, D], d2 [N2, D] unit f32; x1 [N1, 2], x2 [N2, 2] pixels;
    G [3, 3]. model: 'epipolar' (G = E or F; squared Sampson) or
    'homography' (G = H; squared transfer error). Returns idx2 [N1]
    (-1 = no match)."""
    sim = torch.matmul(d1, d2.T)  # [N1, N2]
    p1 = torch.cat([x1, torch.ones_like(x1[:, :1])], dim=1)  # [N1, 3]
    Gp1 = p1 @ G.T  # rows G x1
    if model == "epipolar":
        p2 = torch.cat([x2, torch.ones_like(x2[:, :1])], dim=1)
        Gtp2 = p2 @ G  # rows G^T x2
        num = ((p2 @ (G @ p1.T)) ** 2).T  # [N1, N2]
        den = (Gp1[:, 0:1] ** 2 + Gp1[:, 1:2] ** 2
               + (Gtp2[:, 0:1] ** 2 + Gtp2[:, 1:2] ** 2).T)
        residual = num / torch.clamp(den, min=1e-12)
    else:
        w = Gp1[:, 2:3]
        proj = Gp1[:, :2] / torch.where(torch.abs(w) < 1e-8, 1.0, w)
        dx = proj[:, 0:1] - x2[None, :, 0]
        dy = proj[:, 1:2] - x2[None, :, 1]
        residual = dx * dx + dy * dy
    sim = torch.where(residual <= max_residual, sim, -2.0)

    best_sim, best = sim.max(dim=1)  # top-1 and its first column
    second_sim = sim.scatter(1, best[:, None], -2.0).amax(dim=1)
    best_dist = _dist(best_sim)
    ok = (best_sim > -1.5) & (best_dist <= max_distance)
    ok &= best_dist <= max_ratio * _dist(second_sim)
    if cross_check:
        rev_best = sim.argmax(dim=0)  # best row for each column
        ok &= rev_best[best] == torch.arange(len(d1), device=d1.device)
    return torch.where(ok, best, -1)


def match_guided(
    descriptors1, descriptors2, points2D1, points2D2, two_view_geometry,
    options: SiftMatchingOptions = None, max_error: float = 4.0, device=None,
):
    """Guided matching constrained by an estimated two-view geometry.

    Uses F (pixel-space Sampson) or H (pixel transfer) depending on the
    geometry's config (upstream SiftMatchGuided). Runs on ``device``
    (default: the card). Returns matches [M, 2] uint32."""
    # imported here: the estimators import this package's options
    from pycolmap_torch.estimators.two_view_geometry import (
        TwoViewGeometryConfiguration as C,
    )

    if options is None:
        options = SiftMatchingOptions()
    dev = resolve_device(device)
    cfg = two_view_geometry.config
    if cfg in (int(C.PLANAR), int(C.PANORAMIC), int(C.PLANAR_OR_PANORAMIC)):
        G = two_view_geometry.H
        model = "homography"
    else:
        G = two_view_geometry.F if two_view_geometry.F is not None else two_view_geometry.E
        model = "epipolar"
    if G is None:
        return match_descriptors(descriptors1, descriptors2, options, dev)
    d1 = _to_unit_float(descriptors1)
    d2 = _to_unit_float(descriptors2)
    if len(d1) == 0 or len(d2) == 0:
        return np.zeros((0, 2), dtype=np.uint32)
    x1 = np.asarray(points2D1, dtype=np.float32).reshape(-1, 2)
    x2 = np.asarray(points2D2, dtype=np.float32).reshape(-1, 2)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)

    idx2 = _guided_match(
        t(d1), t(d2), t(x1), t(x2), t(G), options.max_ratio,
        options.max_distance, np.float32(max_error ** 2), options.cross_check,
        model,
    ).cpu().numpy()
    rows = np.nonzero(idx2 >= 0)[0]
    return np.stack([rows, idx2[rows]], axis=1).astype(np.uint32)
