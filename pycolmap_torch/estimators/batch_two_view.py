"""Pair-parallel two-view verification.

Port of ``pycolmap_tpu/estimators/batch_two_view.py`` (SURVEY.md §2c P1),
plain PyTorch on the entry point's device: the reference is one jitted XLA
program, no Pallas kernel. E, F and H are estimated for a whole block of
image pairs at once: hypotheses for every pair x every model are drawn,
solved and scored as single tensors, then each model is refit once on its
best hypothesis's inliers (kept when it has at least as many). The per-pair
path (estimators/two_view_geometry.py) keeps COLMAP's adaptive trial
counts; this one spends a fixed budget per pair: 1,024 8-point F and 4-point
H hypotheses, and 128 5-point samples for E (up to 1,280 hypotheses).

As the reference: one normalized threshold per block (the mean of the
pairs'), the same configuration arbitration and watermark test, and the
relative pose recovered per pair from block-local indices. Unlike it, the
block is not padded to powers of two in pairs or matches and no executable
is cached: those exist for the TPU's compiles. Draws: one
``torch.Generator`` seeded 0 on the device draws F's, E's and H's samples
in that order (each sample the m smallest of N uniform keys, padding keyed
out), so the same block gives the same draws; its stream differs from
``jax.random``'s. Hypotheses are scored in chunks over K when a block is
large (a bound on B x K x N), which changes no draw and no score.
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.two_view_geometry import (
    TwoViewGeometry,
    TwoViewGeometryConfiguration,
    TwoViewGeometryOptions,
    _detect_watermark,
    estimate_two_view_geometry_pose,
)
from pycolmap_torch.ops import solvers

NUM_CHUNK = 1024  # hypotheses per model per pair
NUM_E_SAMPLES = 128  # 5pt minimal samples per pair (each yields <= 10 E's)
# elements of one [B, K, N] residual slab; more hypotheses are scored in
# chunks over K (the einsums below hold three times this in temporaries)
SCORE_ELEMS = 1 << 25


def _sample_idx(gen, mask, m, k):
    """[B, k, m] sample indices: the m smallest of N uniform keys per row,
    padding rows (mask 0) keyed out."""
    B, N = mask.shape
    u = torch.rand((B, k, N), generator=gen, device=mask.device)
    u = u + (1.0 - mask[:, None, :]) * 1e6
    return torch.topk(u, m, dim=-1, largest=False).indices


def _gather(x, idx):
    """x [B, N, 2], idx [B, K, m] -> [B, K, m, 2]."""
    return x[torch.arange(x.shape[0], device=x.device)[:, None, None], idx]


def _sampson(F, x1, x2):
    """F [B, K, 3, 3]; x [B, N, 2] -> [B, K, N] squared Sampson error."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], dim=-1)
    p2 = torch.cat([x2, ones], dim=-1)
    Fx1 = torch.einsum("bkij,bnj->bkni", F, p1)
    Ftx2 = torch.einsum("bkji,bnj->bkni", F, p2)
    x2Fx1 = torch.einsum("bni,bkni->bkn", p2, Fx1)
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return x2Fx1**2 / torch.clamp(den, min=1e-12)


def _transfer(H, x1, x2):
    """H [B, K, 3, 3]; x [B, N, 2] -> [B, K, N] squared transfer error."""
    p1 = torch.cat([x1, torch.ones_like(x1[..., :1])], dim=-1)
    Hx1 = torch.einsum("bkij,bnj->bkni", H, p1)
    w = Hx1[..., 2]
    bad = torch.abs(w) < 1e-8
    proj = Hx1[..., :2] / torch.where(bad, 1.0, w)[..., None]
    err = torch.sum((proj - x2[:, None]) ** 2, dim=-1)
    return torch.where(bad, 1e12, err)


def _best(models, valid, resid, x1, x2, mask, thr_sq):
    """The best hypothesis per pair by the reference's score (inlier count,
    then the capped residual sum; the first on ties). models [B, K, 3, 3],
    valid [B, K] or None. Returns (model [B, 3, 3], inlier count [B],
    inlier mask [B, N])."""
    B, K = models.shape[:2]
    rows = torch.arange(B, device=models.device)
    kc = max(1, min(K, SCORE_ELEMS // max(B * x1.shape[1], 1)))
    best = None
    for k0 in range(0, K, kc):
        r = resid(models[:, k0:k0 + kc], x1, x2)
        if valid is not None:
            r = torch.where(valid[:, k0:k0 + kc, None], r, torch.inf)
        r = torch.where(mask[:, None, :] > 0, r, torch.inf)
        num_inl = torch.sum(r <= thr_sq, dim=-1)
        capped = torch.sum(torch.clamp(r, max=thr_sq), dim=-1)
        score = torch.where(torch.isfinite(capped),
                            num_inl.float() - capped / (capped + 1.0),
                            -torch.inf)
        s, i = score.max(dim=1)  # the first maximum
        cand = (s, i + k0, num_inl[rows, i], r[rows, i])
        if best is None:
            best = cand
        else:  # an earlier chunk keeps a tie
            take = s > best[0]
            best = tuple(torch.where(take.view(-1, *([1] * (c.dim() - 1))), c, b)
                         for c, b in zip(cand, best))
    _, idx, num_inl, r_best = best
    return models[rows, idx], num_inl, (r_best <= thr_sq) & (mask > 0)


def _local_opt(model, num_inl, inl, refit, resid, x1, x2, mask, thr_sq):
    """Refit on the inliers; kept where it has at least as many."""
    m_r = refit(x1, x2, inl.to(x1.dtype))
    r = resid(m_r[:, None], x1, x2)[:, 0]
    inl_r = (r <= thr_sq) & (mask > 0)
    n_r = torch.sum(inl_r, dim=-1)
    use = n_r >= num_inl
    return (torch.where(use[:, None, None], m_r, model),
            torch.maximum(n_r, num_inl),
            torch.where(use[:, None], inl_r, inl))


def _verify_block(gen, x1_px, x2_px, x1_n, x2_n, mask, thr_px_sq, thr_norm_sq):
    """x*_px pixel coords [B, N, 2]; x*_n normalized; mask [B, N]. Returns
    per pair the best (model, inlier count, inlier mask) of E, F and H."""
    B = x1_px.shape[0]
    # F: 8-point hypotheses on pixel coordinates
    idx = _sample_idx(gen, mask, 8, NUM_CHUNK)
    F_h = solvers.fundamental_8pt(_gather(x1_px, idx), _gather(x2_px, idx))
    F = _local_opt(*_best(F_h, None, _sampson, x1_px, x2_px, mask, thr_px_sq),
                   solvers.fundamental_8pt, _sampson, x1_px, x2_px, mask,
                   thr_px_sq)
    # E: Nistér 5-point samples on normalized coordinates (the reference's
    # LORANSAC minimal solver, estimators/essential_matrix.h:48-52); each
    # yields up to 10 matrices, invalid roots are left out of the scoring
    idx = _sample_idx(gen, mask, 5, NUM_E_SAMPLES)
    E_h, E_valid = solvers.essential_5pt(
        _gather(x1_n, idx).reshape(B * NUM_E_SAMPLES, 5, 2),
        _gather(x2_n, idx).reshape(B * NUM_E_SAMPLES, 5, 2))
    E = _local_opt(
        *_best(E_h.reshape(B, NUM_E_SAMPLES * 10, 3, 3),
               E_valid.reshape(B, NUM_E_SAMPLES * 10), _sampson, x1_n, x2_n,
               mask, thr_norm_sq),
        solvers.essential_8pt, _sampson, x1_n, x2_n, mask, thr_norm_sq)
    # H: 4-point hypotheses on pixel coordinates
    idx = _sample_idx(gen, mask, 4, NUM_CHUNK)
    H_h = solvers.homography_dlt(_gather(x1_px, idx), _gather(x2_px, idx))
    H = _local_opt(*_best(H_h, None, _transfer, x1_px, x2_px, mask, thr_px_sq),
                   solvers.homography_dlt, _transfer, x1_px, x2_px, mask,
                   thr_px_sq)
    return E, F, H


def verify_pairs_batch(pair_data, options: TwoViewGeometryOptions = None,
                       device=None):
    """Verify a block of pairs in one batched estimate on ``device``
    (default: the card).

    pair_data: list of dicts with keys x1_px, x2_px (pixel coords of the
    matched keypoints), cam1, cam2, matches (for inlier index mapping).
    Returns a list of TwoViewGeometry.
    """
    if options is None:
        options = TwoViewGeometryOptions()
    device = resolve_device(device)
    B = len(pair_data)
    if B == 0:
        return []
    # at least one minimal sample's rows (pairs shorter than that are
    # degenerate: their padding is keyed out of every sample but the last)
    N = max(max(len(p["x1_px"]) for p in pair_data), 8)
    x1_px = np.zeros((B, N, 2), dtype=np.float32)
    x2_px = np.zeros((B, N, 2), dtype=np.float32)
    x1_n = np.zeros((B, N, 2), dtype=np.float32)
    x2_n = np.zeros((B, N, 2), dtype=np.float32)
    mask = np.zeros((B, N), dtype=np.float32)
    thr_norm = np.zeros(B, dtype=np.float32)
    for b, p in enumerate(pair_data):
        n = len(p["x1_px"])
        x1_px[b, :n] = p["x1_px"]
        x2_px[b, :n] = p["x2_px"]
        x1_n[b, :n] = p["cam1"].cam_from_img(p["x1_px"])
        x2_n[b, :n] = p["cam2"].cam_from_img(p["x2_px"])
        mask[b, :n] = 1.0
        thr_norm[b] = 0.5 * (
            options.ransac.max_error / p["cam1"].mean_focal_length()
            + options.ransac.max_error / p["cam2"].mean_focal_length()
        )
    # single normalized threshold per block (the reference's: the mean)
    thr_norm_sq = float(np.float32(np.mean(thr_norm) ** 2))

    def dev(a):
        return torch.from_numpy(a).to(device)

    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    blocks = _verify_block(
        gen, dev(x1_px), dev(x2_px), dev(x1_n), dev(x2_n), dev(mask),
        float(np.float32(options.ransac.max_error**2)), thr_norm_sq)
    (E, E_ninl, E_inl), (F, F_ninl, F_inl), (H, H_ninl, H_inl) = [
        [t.cpu().numpy() for t in m] for m in blocks]

    out = []
    C = TwoViewGeometryConfiguration
    for b, p in enumerate(pair_data):
        n = len(p["x1_px"])
        g = TwoViewGeometry()
        e_n, f_n, h_n = int(E_ninl[b]), int(F_ninl[b]), int(H_ninl[b])
        if max(e_n, f_n, h_n) < options.min_num_inliers:
            g.config = int(C.DEGENERATE)
            out.append(g)
            continue
        best_inl = max(e_n, f_n)
        if e_n >= options.min_num_inliers and e_n >= options.min_E_F_inlier_ratio * f_n:
            g.config = int(C.CALIBRATED)
            mask_b = E_inl[b, :n]
        elif f_n >= options.min_num_inliers:
            g.config = int(C.UNCALIBRATED)
            mask_b = F_inl[b, :n]
        else:
            g.config = int(C.PLANAR_OR_PANORAMIC)
            mask_b = H_inl[b, :n]
        if (
            g.config in (int(C.CALIBRATED), int(C.UNCALIBRATED))
            and h_n > options.max_H_inlier_ratio * best_inl
        ):
            g.config = int(C.PLANAR_OR_PANORAMIC)
        g.E = E[b].astype(np.float64)
        g.F = F[b].astype(np.float64)
        g.H = H[b].astype(np.float64)
        if options.detect_watermark and _detect_watermark(
            p["x1_px"], p["x2_px"], mask_b, p["cam1"], p["cam2"], options
        ):
            g.config = int(C.WATERMARK)
        g.inlier_matches = p["matches"][mask_b].astype(np.uint32)
        if options.compute_relative_pose and g.config not in (
            int(C.DEGENERATE), int(C.UNDEFINED), int(C.WATERMARK)
        ):
            # recover cam2_from_cam1 (ref two_view_geometry.h:153-160) from
            # the matched coordinates alone: block-local indices, the pose
            # copied back
            idx = np.nonzero(mask_b)[0].astype(np.uint32)
            g_tmp = TwoViewGeometry()
            g_tmp.config = g.config
            g_tmp.E, g_tmp.F, g_tmp.H = g.E, g.F, g.H
            g_tmp.inlier_matches = np.stack([idx, idx], axis=1)
            if estimate_two_view_geometry_pose(
                p["cam1"], p["x1_px"], p["cam2"], p["x2_px"], g_tmp,
                device=device,
            ):
                g.cam2_from_cam1 = g_tmp.cam2_from_cam1
                g.tri_angle = getattr(g_tmp, "tri_angle", 0.0)
                g.config = g_tmp.config
        out.append(g)
    return out
