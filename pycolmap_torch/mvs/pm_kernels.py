"""PatchMatch per-view window costs, with their CUDA kernel.

Port of ``pycolmap_tpu/mvs/pm_kernels.py``. For one candidate plane field
(depth [H, W], unit normal [3, H, W] in the reference camera frame) and each
source view k, every pixel's window offsets are warped into the source
through the plane-induced homography
``m = R_k r_q + t_k (n . r_q) / (d (n . r_p))``, sampled bilinearly, and
folded into a bilateral-weighted NCC against the reference window:
``1 - clip(ncc, -1, 1)``, or 2.0 where under 20% of the window weight
landed inside the source. The window sums are taken about the reference
window's mean ``a`` and the view's first valid sample ``b``:
``covar = (sum w (ref_q - a)(s - b) + b sum w (ref_q - a)) / W`` and
``var = sum w (s - b)^2 / W - (sum w (s - b) / W)^2`` over the valid
samples equal the reference's ``sum w ref s / W - ref_mean src_mean`` and
``sum w s^2 / W - src_mean^2`` up to its 1e-9 weight floor, without their
cancellation in f32 (up to 5e-4 in the cost of a flat window). With ``geom`` the forward-backward reprojection
error against the source depth map is added (``geom_w * min(err,
geom_max_cost)``).

| function            | role                                              |
|---------------------|---------------------------------------------------|
| pm_view_params      | the reference's ``_pm_view_params``               |
|                     | (patch_match.py:133): one [32] f32 row per view   |
| pm_view_costs       | the kernel's contract (reference                  |
|                     | ``pm_view_costs_pallas`` :364): CUDA tensors      |
|                     | launch ``csrc/pm_cost.cu``, CPU tensors run       |
|                     | ``pm_view_costs_plain``                           |
| pm_view_costs_plain | the kernel's plain version                        |

With ``parity`` (0 or 1) only the pixels with ``(y + x) % 2 == parity`` are
evaluated and the others get 2.0, the invalid cost: a red/black step keeps
a candidate's cost only at the pixels of its colour. ``None`` (the
reference's contract) evaluates every pixel.

The TPU kernel reads each source through a per-tile VMEM band (placed by
``band_origins``) and marks samples outside the band invalid; the port
samples the whole source, so it has no band, no 8x128 padding and no band
origins. It samples in exact f32 (the reference's ``pack_pairs`` bf16 pair
packing only halves TPU lane gathers).

``LAUNCHES`` counts kernel launches, full-field (``pm_cost``) and parity
(``pm_cost_parity``) apart; ``PLAIN_ON_CUDA`` counts calls of the plain
version on CUDA tensors (only ``chip_smoke.py``'s comparisons make those).
``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import torch

from pycolmap_torch.features.window_sampler import _bilinear_plane
from pycolmap_torch.mvs import _cuda

# view-parameter row layout (f32): R row-major 9, t 3, Ks fx fy cx cy,
# Kr fx fy cx cy, sigma_color, geom_w, geom_max_cost, Ks_inv fx fy cx cy
_P_R = 0
_P_T = 9
_P_KSF = 12  # fx, fy, cx, cy
_P_KRF = 16  # fx, fy, cx, cy (reference intrinsics)
_P_SIGMA = 20
_P_GEOMW = 21
_P_GEOMMAX = 22
_P_KSI = 23  # Ks^-1: 1/fx, 1/fy, -cx/fx, -cy/fy
_P_LEN = 32

LAUNCHES = {"pm_cost": 0, "pm_cost_parity": 0}
PLAIN_ON_CUDA = {"pm_cost": 0}


def reset_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    PLAIN_ON_CUDA["pm_cost"] = 0


def pm_view_params(R_rel, t_rel, Ks_all, Kr, sigma_color, geom_w,
                   geom_max_cost) -> torch.Tensor:
    """Pack per-view scalars into [K, 32] f32 rows (the reference's
    ``_pm_view_params`` layout). R_rel [K, 3, 3], t_rel [K, 3], Ks_all
    [K, 3, 3], Kr [3, 3] tensors; the scalars are floats."""
    K = R_rel.shape[0]
    dev = R_rel.device
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=dev)  # noqa: E731
    R_rel, t_rel, Ks_all, Kr = (f32(a) for a in (R_rel, t_rel, Ks_all, Kr))
    fx, fy = Ks_all[:, 0, 0], Ks_all[:, 1, 1]
    cx, cy = Ks_all[:, 0, 2], Ks_all[:, 1, 2]
    kr_row = torch.stack([Kr[0, 0], Kr[1, 1], Kr[0, 2], Kr[1, 2]])
    scal = torch.stack([f32(sigma_color), f32(geom_w), f32(geom_max_cost)])
    return torch.cat(
        [
            R_rel.reshape(K, 9),
            t_rel,
            torch.stack([fx, fy, cx, cy], dim=1),
            kr_row.expand(K, 4),
            scal.expand(K, 3),
            torch.stack([1.0 / fx, 1.0 / fy, -cx / fx, -cy / fy], dim=1),
            torch.zeros((K, 5), device=dev),
        ],
        dim=1,
    )


def _check(srcs, src_depths, w_off, wr_off, depth, normal, stats, params,
           offs, geom, parity):
    K, H, W = srcs.shape
    nw = w_off.shape[0]
    shapes = {"srcs": (srcs, (K, H, W)), "w_off": (w_off, (nw, H, W)),
              "wr_off": (wr_off, (nw, H, W)), "depth": (depth, (H, W)),
              "normal": (normal, (3, H, W)), "stats": (stats, (3, H, W)),
              "params": (params, (K, _P_LEN)), "offs": (offs, (nw, 2))}
    if geom:
        if src_depths is None:
            raise ValueError("geom=True needs src_depths")
        shapes["src_depths"] = (src_depths, (K, H, W))
    bad = {k: tuple(t.shape) for k, (t, s) in shapes.items()
           if tuple(t.shape) != s}
    if bad or H < 2 or W < 2:
        raise ValueError(f"pm_view_costs shapes: {bad} (K {K}, H {H}, W {W}, "
                         f"nw {nw})")
    if parity not in (None, 0, 1):
        raise ValueError(f"pm_view_costs parity must be None, 0 or 1, got "
                         f"{parity!r}")


def pm_view_costs_plain(srcs, src_depths, w_off, wr_off, depth, normal,
                        stats, params, offs, geom=False, parity=None):
    """The kernel's arithmetic in PyTorch, one window offset at a time over
    [K, H, W] planes, in the dtype of ``srcs``. In f32 it is the kernel's
    arithmetic operation for operation (the kernel is built without fused
    multiply-adds). Arguments as :func:`pm_view_costs`; with a parity it
    evaluates every pixel and keeps the active ones."""
    if srcs.is_cuda:
        PLAIN_ON_CUDA["pm_cost"] += 1
    K, H, W = srcs.shape
    dt, dev = srcs.dtype, srcs.device
    P = params.to(dt)
    col = lambda j: P[:, j, None, None]  # noqa: E731  [K, 1, 1]
    R = [col(_P_R + i) for i in range(9)]
    t = [col(_P_T + i) for i in range(3)]
    ksfx, ksfy, kscx, kscy = (col(_P_KSF + i) for i in range(4))
    krfx, krfy, krcx, krcy = (P[0, _P_KRF + i] for i in range(4))
    py, px = torch.meshgrid(torch.arange(H, device=dev, dtype=dt) + 0.5,
                            torch.arange(W, device=dev, dtype=dt) + 0.5,
                            indexing="ij")
    rpx = (px - krcx) / krfx
    rpy = (py - krcy) / krfy
    d = depth.to(dt)
    n0, n1, n2 = normal.to(dt)
    ndotr = n0 * rpx + n1 * rpy + n2
    denom = d * torch.where(ndotr.abs() < 1e-6, -1e-6, ndotr)

    # window sums of the reference about its window mean a and of the
    # samples about b, each view's first valid sample in offset order, so
    # that the f32 kernel loses no digits to sum w s^2 / W - mean^2
    w_sum, a, ref_var = stats.to(dt)
    zero = torch.zeros((K, H, W), dtype=dt, device=dev)
    s_sum, s2_sum, rs_sum, r_sum, wv_sum = zero, zero, zero, zero, zero + 1e-9
    b = zero
    have = torch.zeros((K, H, W), dtype=torch.bool, device=dev)
    src = srcs.to(dt)
    views = torch.arange(K, device=dev)[:, None, None]
    for i, (dy, dx) in enumerate(offs.tolist()):
        rqx = (px + dx - krcx) / krfx
        rqy = (py + dy - krcy) / krfy
        ndotq = n0 * rqx + n1 * rqy + n2
        scale = ndotq / denom
        m0 = R[0] * rqx + R[1] * rqy + R[2] + t[0] * scale
        m1 = R[3] * rqx + R[4] * rqy + R[5] + t[1] * scale
        m2 = R[6] * rqx + R[7] * rqy + R[8] + t[2] * scale
        z = torch.where(m2.abs() < 1e-9, 1e-9, m2)
        us = ksfx * (m0 / z) + kscx - 0.5
        vs = ksfy * (m1 / z) + kscy - 0.5
        ok = (us >= 0) & (us < W - 1) & (vs >= 0) & (vs < H - 1) & (m2 > 0)
        s = torch.where(ok, _bilinear_plane(src, views, vs, us), 0.0)
        b = torch.where(ok & ~have, s, b)
        have = have | ok
        sc = s - b
        okf = ok.to(dt)
        wk = w_off[i].to(dt) * okf
        rk = (wr_off[i].to(dt) - a * w_off[i].to(dt)) * okf  # w (ref_q - a)
        s_sum = s_sum + wk * sc
        s2_sum = s2_sum + wk * sc * sc
        rs_sum = rs_sum + rk * sc
        r_sum = r_sum + rk
        wv_sum = wv_sum + wk

    src_mean = s_sum / wv_sum  # minus b
    src_var = torch.clamp(s2_sum / wv_sum - src_mean * src_mean, min=1e-6)
    covar = (rs_sum + b * r_sum) / wv_sum
    ncc = covar / torch.sqrt(ref_var * src_var)
    cost = 1.0 - torch.clamp(ncc, -1.0, 1.0)
    cost = torch.where(wv_sum > 0.2 * w_sum, cost, 2.0)
    if not geom:
        return _keep_parity(cost, parity)

    # forward-backward reprojection error at the center pixel
    geom_w, geom_max = col(_P_GEOMW), col(_P_GEOMMAX)
    ksi_fx, ksi_fy, ksi_cx, ksi_cy = (col(_P_KSI + i) for i in range(4))
    scale_c = 1.0 / torch.clamp(d, min=1e-9)
    c0 = R[0] * rpx + R[1] * rpy + R[2] + t[0] * scale_c
    c1 = R[3] * rpx + R[4] * rpy + R[5] + t[1] * scale_c
    c2 = R[6] * rpx + R[7] * rpy + R[8] + t[2] * scale_c
    zc = torch.where(c2.abs() < 1e-9, 1e-9, c2)
    uc = ksfx * (c0 / zc) + kscx
    vc = ksfy * (c1 / zc) + kscy
    okc = ((uc - 0.5 >= 0) & (uc - 0.5 < W - 1) & (vc - 0.5 >= 0)
           & (vc - 0.5 < H - 1) & (c2 > 0))
    ds = torch.where(okc, _bilinear_plane(src_depths.to(dt), views, vc - 0.5,
                                          uc - 0.5), 0.0)
    bx = ksi_fx * uc + ksi_cx
    by = ksi_fy * vc + ksi_cy
    d0 = ds * bx - t[0]
    d1 = ds * by - t[1]
    d2 = ds - t[2]
    Xr0 = R[0] * d0 + R[3] * d1 + R[6] * d2
    Xr1 = R[1] * d0 + R[4] * d1 + R[7] * d2
    Xr2 = R[2] * d0 + R[5] * d1 + R[8] * d2
    zr = torch.where(Xr2 < 1e-9, 1e-9, Xr2)
    ur = krfx * (Xr0 / zr) + krcx
    vr = krfy * (Xr1 / zr) + krcy
    err = torch.sqrt((ur - px) ** 2 + (vr - py) ** 2)
    okg = okc & (ds > 0) & (Xr2 > 0)
    return _keep_parity(cost + geom_w * torch.where(
        okg, torch.minimum(err, geom_max), geom_max), parity)


def _keep_parity(cost, parity):
    """cost [K, H, W] at the pixels with (y + x) % 2 == parity, 2.0 at the
    others; every pixel for parity None."""
    if parity is None:
        return cost
    H, W = cost.shape[1:]
    dev = cost.device
    active = (torch.arange(H, device=dev)[:, None]
              + torch.arange(W, device=dev)[None, :]) % 2 == parity
    return torch.where(active, cost, 2.0)


def pm_view_costs(srcs, src_depths, w_off, wr_off, depth, normal, stats,
                  params, offs, geom=False, parity=None):
    """Per-view PatchMatch window costs of one candidate plane field.

    srcs [K, H, W] f32 source images (resampled to the reference's size);
    src_depths [K, H, W] source depth maps (geom) or None; w_off [nw, H, W]
    bilateral window weights (spatial x color) and wr_off [nw, H, W] =
    w_off * ref_off (weight times the shifted reference); depth [H, W];
    normal [3, H, W]; stats [3, H, W] (w_sum, ref_mean, ref_var); params
    [K, 32] view rows (:func:`pm_view_params`); offs [nw, 2] f32 window
    offsets (dy, dx); parity None, 0 or 1 (see the module). Returns cost
    [K, H, W] f32."""
    _check(srcs, src_depths, w_off, wr_off, depth, normal, stats, params,
           offs, geom, parity)
    if not srcs.is_cuda:
        return pm_view_costs_plain(srcs, src_depths, w_off, wr_off, depth,
                                   normal, stats, params, offs, geom, parity)
    out = torch.empty(srcs.shape, device=srcs.device)
    c = lambda a: a.float().contiguous()  # noqa: E731
    LAUNCHES["pm_cost" if parity is None else "pm_cost_parity"] += 1
    _cuda.pm_view_costs(c(srcs), c(src_depths) if geom else None, c(w_off),
                        c(wr_off), c(depth), c(normal), c(stats), c(params),
                        c(offs), bool(geom), parity, out)
    return out
