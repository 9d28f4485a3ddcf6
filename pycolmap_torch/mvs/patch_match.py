"""PatchMatch multi-view stereo for one reference image.

Port of ``pycolmap_tpu/mvs/patch_match.py`` (reference: pipeline/mvs.h
:94-180; upstream colmap/mvs/patch_match_cuda). The design is the
reference's:

- red/black checkerboard propagation updates half of all pixels per step as
  one tensor op;
- each candidate plane (4 propagated neighbour planes, perturbed depth,
  perturbed normal, random plane) is scored against all pixels and all
  source views at once, by the window-cost kernel (``pm_kernels``): 8 cost
  evaluations per step, the first refreshing the current plane's;
- per-view costs are aggregated by per-pixel view-selection weights
  ``w_k = exp(-c_k^2 / (2 sigma_v^2))`` refreshed from the current plane
  every step;
- the geometric pass adds ``geom_w * min(fwd-bwd reprojection error,
  geom_max_cost)`` against the source depth maps.

Plane parameterization: depth d along the pixel ray + unit normal n in the
reference camera frame; the plane-induced warp into source view k is
``q_s ~ K_s (R_k r_q + t_k (n . r_q) / (d (n . r_p)))``, ``r = K_r^-1 q``.

The step loop is plain PyTorch on the caller's device; on a CUDA device
every cost evaluation launches ``csrc/pm_cost.cu``. A candidate's cost is
kept only at the pixels of the step's colour, so its evaluation covers
only those (the kernel's parity launch); the per-step refresh of the
current plane's costs covers every pixel. Random draws come from
the caller's ``torch.Generator`` (the reference's ``jax.random`` keys have
no counterpart), and the random depth candidates are drawn per pixel, as
upstream and the reference's XLA path draw them: the reference's per-tile
draw only keeps a tile's footprint inside its TPU source band.
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch.mvs.pm_kernels import pm_view_costs, pm_view_params
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class PatchMatchOptions(BaseOptions):
    """Mirrors reference PatchMatchOptions (pipeline/mvs.h:94-180). The
    reference's ``gpu_index`` is the entry point's ``device`` argument."""

    max_image_size: int = -1
    depth_min: float = -1.0
    depth_max: float = -1.0
    window_radius: int = 5
    window_step: int = 2
    sigma_spatial: float = -1.0
    sigma_color: float = 0.2
    num_samples: int = 15
    ncc_sigma: float = 0.6
    min_triangulation_angle: float = 1.0
    incident_angle_sigma: float = 0.9
    num_iterations: int = 5
    geom_consistency: bool = True
    geom_consistency_regularizer: float = 0.3
    geom_consistency_max_cost: float = 3.0
    filter: bool = True
    filter_min_ncc: float = 0.1
    filter_min_triangulation_angle: float = 3.0
    filter_min_num_consistent: int = 2
    filter_geom_consistency_max_cost: float = 1.0
    cache_size: float = 32.0
    allow_missing_files: bool = False
    write_consistency_graph: bool = False


_VIEW_SIGMA = 0.3  # view-selection weight bandwidth on NCC cost (in [0, 2])


def _window_offsets(radius: int, step: int):
    r = np.arange(-radius, radius + 1, step)
    dy, dx = np.meshgrid(r, r, indexing="ij")
    return np.stack([dy.ravel(), dx.ravel()], axis=1)  # [nw, 2]


def window_stats(ref, offsets, window_radius, sigma_color):
    """The bilateral window planes of the reference image (loop-invariant):
    ref_off [nw, H, W] (the shifted reference), w_off [nw, H, W] (spatial x
    color weights), w_sum, ref_mean, ref_var [H, W]. Shifts wrap at the
    border, as the reference's ``jnp.roll`` planes do."""
    sg = (max(window_radius, 1) / 1.5) ** 2
    ref_off = torch.stack(
        [torch.roll(ref, (-int(dy), -int(dx)), dims=(0, 1)) for dy, dx in offsets]
    )
    w_spatial = torch.as_tensor(
        np.exp(-(offsets[:, 0] ** 2 + offsets[:, 1] ** 2) / (2 * sg)).astype(
            np.float32),
        device=ref.device,
    )
    w_off = (torch.exp(-torch.abs(ref_off - ref[None]) / sigma_color)
             * w_spatial[:, None, None])
    w_sum = torch.sum(w_off, dim=0)
    ref_mean = torch.sum(w_off * ref_off, dim=0) / w_sum
    ref_var = torch.clamp(
        torch.sum(w_off * ref_off**2, dim=0) / w_sum - ref_mean**2, min=1e-6)
    return ref_off, w_off, w_sum, ref_mean, ref_var


def _random_normals(gen, shape, rays):
    """Random unit normals facing the camera (n . ray < 0)."""
    v = torch.randn((3,) + shape, generator=gen, device=rays.device)
    v = v / torch.clamp(torch.sqrt(torch.sum(v * v, dim=0)), min=1e-9)
    dot = torch.sum(v * rays, dim=0)
    return torch.where(dot[None] > 0, -v, v)


def _uniform(gen, shape, lo, hi, device):
    return torch.rand(shape, generator=gen, device=device) * (hi - lo) + lo


def patch_match_kernel(
    generator, ref, srcs, rays, Ks_all, R_rel, t_rel,
    depth0, normal0, depth_min, depth_max,
    sigma_color, ncc_sigma,
    num_iterations, window_radius, window_step,
    geom_consistency=False, Kr=None, src_depths=None,
    geom_w=0.3, geom_max_cost=3.0,
):
    """Run PatchMatch for one reference image.

    All tensors on one device: ref [H, W]; srcs [K, H, W]; rays [3, H, W]
    (K_r^-1 pixel rays); Ks_all [K, 3, 3] source calibrations; R_rel
    [K, 3, 3], t_rel [K, 3]; depth0 [H, W]; normal0 [3, H, W]; Kr [3, 3] the
    reference's pinhole calibration (required: the cost kernel computes the
    offset rays from it). With geom_consistency: src_depths [K, H, W]
    photometric depth maps of the sources. generator: a ``torch.Generator``
    on the tensors' device, the source of every random draw. ``ncc_sigma``
    is accepted for the reference's signature and unused, as there.
    Returns (depth, normal [3, H, W], cost [H, W]).
    """
    if Kr is None:
        raise ValueError("patch_match_kernel needs the reference calibration Kr")
    H, W = ref.shape
    dev = ref.device
    depth_min, depth_max = float(depth_min), float(depth_max)
    offsets = _window_offsets(window_radius, window_step)
    parity = (torch.arange(H, device=dev)[:, None]
              + torch.arange(W, device=dev)[None, :]) % 2

    ref_off, w_off, w_sum, ref_mean, ref_var = window_stats(
        ref, offsets, window_radius, sigma_color)
    wr_off = w_off * ref_off
    del ref_off
    stats = torch.stack([w_sum, ref_mean, ref_var])
    params = pm_view_params(R_rel, t_rel, Ks_all, Kr, sigma_color, geom_w,
                            geom_max_cost)
    offs = torch.as_tensor(offsets, dtype=torch.float32, device=dev)

    def view_costs(depth, normal, parity=None):
        return pm_view_costs(srcs, src_depths, w_off, wr_off, depth, normal,
                             stats, params, offs, geom=geom_consistency,
                             parity=parity)

    def agg_cost(costs, vw):
        """Per-pixel view-weighted aggregation."""
        return torch.sum(vw * costs, dim=0) / torch.clamp(
            torch.sum(vw, dim=0), min=1e-9)

    def neighbor_plane_depth(depth, normal, dy, dx):
        """Depth induced at each pixel by the (dy, dx)-neighbour's plane."""
        d_n = torch.roll(depth, (dy, dx), dims=(0, 1))
        n_n = torch.roll(normal, (dy, dx), dims=(1, 2))
        ray_n = torch.roll(rays, (dy, dx), dims=(1, 2))
        num = d_n * torch.sum(n_n * ray_n, dim=0)
        den = torch.sum(n_n * rays, dim=0)
        d = num / torch.where(den.abs() < 1e-6, -1e-6, den)
        return torch.clamp(d, depth_min, depth_max), n_n

    def try_candidate(state, cand, color, vw):
        depth, normal, cost = state
        d_c, n_c = cand
        c_c = agg_cost(view_costs(d_c, n_c, color), vw)
        better = (c_c < cost) & (parity == color)
        return (
            torch.where(better, d_c, depth),
            torch.where(better[None], n_c, normal),
            torch.where(better, c_c, cost),
        )

    depth, normal = depth0, normal0
    cost = torch.zeros((H, W), device=dev)
    for step in range(2 * num_iterations):
        color = step % 2
        # refresh per-pixel view-selection weights from the current plane,
        # and re-aggregate its cost under them so comparisons are consistent
        cv = view_costs(depth, normal)
        vw = torch.exp(-(cv * cv) / (2 * _VIEW_SIGMA**2))
        state = (depth, normal, agg_cost(cv, vw))
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            state = try_candidate(
                state, neighbor_plane_depth(state[0], state[1], dy, dx),
                color, vw)
        pert = _uniform(generator, (H, W), -0.1, 0.1, dev)
        state = try_candidate(
            state,
            (torch.clamp(state[0] * (1 + pert), depth_min, depth_max), state[1]),
            color, vw)
        dn = 0.3 * torch.randn((3, H, W), generator=generator, device=dev)
        n_p = state[1] + dn
        n_p = n_p / torch.clamp(torch.sqrt(torch.sum(n_p * n_p, dim=0)),
                                min=1e-9)
        n_p = torch.where(torch.sum(n_p * rays, dim=0)[None] > 0, -n_p, n_p)
        state = try_candidate(state, (state[0], n_p), color, vw)
        d_r = _uniform(generator, (H, W), depth_min, depth_max, dev)
        state = try_candidate(
            state, (d_r, _random_normals(generator, (H, W), rays)), color, vw)
        depth, normal, cost = state
    return depth, normal, cost
