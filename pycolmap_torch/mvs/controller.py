"""PatchMatch stereo controller: photometric + geometric passes.

Port of ``pycolmap_tpu/mvs/controller.py`` (ref: pipeline/mvs.h:21-41
patch_match_stereo semantics). A photometric pass for every image, then,
when ``geom_consistency``, a second PatchMatch pass whose cost adds the
forward-backward reprojection-error term against the photometric depth maps
of the source views, initialized from the image's own photometric result
(upstream patch_match_controller.cc ProcessProblem). Optional count-based
filtering and consistency-graph output follow.

Host preparation is the reference's, initial depths included (a numpy
``default_rng(image_id)`` draw per 8x128 tile plus per-pixel jitter), so
both packages start from the same ``depth0``. The PatchMatch passes and the
cross-view consistency checks (float64, as the reference's numpy) run on
the entry point's device; the maps stay there between the passes.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from pycolmap_torch import resolve_device
from pycolmap_torch.mvs.consistency_graph import (
    consistency_graph_path,
    write_consistency_graph,
)
from pycolmap_torch.mvs.depth_map_io import (
    depth_map_path,
    normal_map_path,
    write_mat,
)
from pycolmap_torch.mvs.patch_match import PatchMatchOptions, patch_match_kernel
from pycolmap_torch.mvs.workspace import MVSModel, pixel_rays, rotate, rotate_t
from pycolmap_torch.utils import logging as _logging


def resize_bilinear(img, size):
    """[H, W] -> size (h, w), bilinear with half-pixel centers and, when
    shrinking, a triangle filter widened by the scale (the reference's
    ``jax.image.resize(..., "bilinear")``, which antialiases)."""
    return F.interpolate(img[None, None], size=tuple(size), mode="bilinear",
                         align_corners=False, antialias=True)[0, 0]


def _prepare_image_data(model, iid, image_dir, max_size, device):
    # imported here: the pipeline package imports this module
    from pycolmap_torch.pipeline.images import read_image_gray

    m = model.images[iid]
    img = torch.from_numpy(read_image_gray(Path(image_dir) / m.name)).to(device)
    if max_size > 0 and max(img.shape) > max_size:
        scale = max_size / max(img.shape)
        nh, nw = int(img.shape[0] * scale), int(img.shape[1] * scale)
        img = resize_bilinear(img, (nh, nw))
    K = m.K.copy()
    K[0] *= img.shape[1] / m.width
    K[1] *= img.shape[0] / m.height
    return img, K


def _image_problem(model, images, iid):
    """Per-reference-image geometry: sources, relative poses, rays."""
    m = model.images[iid]
    ref_img, Kr = images[iid]
    dev = ref_img.device
    H, W = ref_img.shape
    srcs, Ks_all, R_rel, t_rel = [], [], [], []
    for sid in m.src_ids:
        s = model.images[sid]
        src_img, Ksrc = images[sid]
        if src_img.shape != ref_img.shape:
            src_img = resize_bilinear(src_img, (H, W))
        srcs.append(src_img)
        Ks_all.append(Ksrc)
        Rr = s.R @ m.R.T
        R_rel.append(Rr)
        t_rel.append(s.t - Rr @ m.t)
    f32 = lambda a: torch.as_tensor(np.stack(a).astype(np.float32), device=dev)  # noqa: E731
    rays = pixel_rays(Kr, H, W, dev).float()
    return (m, ref_img, Kr, torch.stack(srcs), f32(Ks_all), f32(R_rel),
            f32(t_rel), rays)


def patch_match_stereo(
    workspace_path,
    workspace_format: str = "COLMAP",
    pmvs_option_name: str = "option-all",
    options: PatchMatchOptions = None,
    device=None,
    timings: dict = None,
):
    """Compute photometric + geometric depth/normal maps for all images.

    Runs on ``device`` (default: the card). Given a ``timings`` dict, fills
    in the wall seconds of the ``photometric`` and ``geometric`` passes and
    the ``filter`` (each ends in host writes of its maps)."""
    if options is None:
        options = PatchMatchOptions()
    device = resolve_device(device)
    log = _logging.get_logger()
    workspace_path = Path(workspace_path)
    image_dir = workspace_path / "images"
    for sub in ("stereo/depth_maps", "stereo/normal_maps"):
        (workspace_path / sub).mkdir(parents=True, exist_ok=True)

    model = MVSModel(workspace_path)
    images = {}
    for iid in model.images:
        images[iid] = _prepare_image_data(model, iid, image_dir,
                                          options.max_image_size, device)

    def run_pass(kind, photo_depths=None, photo_normals=None):
        results = {}
        for iid, m0 in model.images.items():
            if not m0.src_ids:
                continue
            (m, ref_img, Kr, srcs, Ks_all, R_rel, t_rel, rays) = _image_problem(
                model, images, iid)
            H, W = ref_img.shape
            d_min = options.depth_min if options.depth_min > 0 else m.depth_min
            d_max = options.depth_max if options.depth_max > 0 else m.depth_max
            if d_max <= d_min:
                d_min, d_max = 0.1, 100.0

            geom = kind == "geometric"
            if geom:
                depth0 = photo_depths[iid]
                normal0 = photo_normals[iid]
                zeros = torch.zeros((H, W), device=device)
                src_depths = torch.stack(
                    [photo_depths.get(sid, zeros) for sid in m.src_ids])
                extra = dict(
                    geom_consistency=True,
                    src_depths=src_depths,
                    geom_w=options.geom_consistency_regularizer,
                    geom_max_cost=options.geom_consistency_max_cost,
                )
            else:
                rng = np.random.default_rng(iid)
                # one depth draw per 8x128 tile + per-pixel jitter (the
                # reference's draw, kept so both packages start alike)
                base = rng.uniform(d_min, d_max, (-(-H // 8), -(-W // 128)))
                d0 = np.repeat(np.repeat(base, 8, 0), 128, 1)[:H, :W]
                d0 = np.clip(
                    d0 * rng.uniform(0.9, 1.1, (H, W)), d_min, d_max
                ).astype(np.float32)
                depth0 = torch.from_numpy(d0).to(device)
                normal0 = -rays / torch.clamp(
                    torch.linalg.vector_norm(rays, dim=0), min=1e-9)
                extra = {}

            gen = torch.Generator(device=device).manual_seed(iid)
            results[iid] = patch_match_kernel(
                gen, ref_img, srcs, rays, Ks_all, R_rel, t_rel,
                depth0, normal0, d_min, d_max,
                options.sigma_color, options.ncc_sigma,
                int(options.num_iterations), int(options.window_radius),
                int(options.window_step),
                Kr=torch.as_tensor(Kr.astype(np.float32), device=device),
                **extra,
            )
            depth, normal, _ = (r.cpu().numpy() for r in results[iid])
            write_mat(depth_map_path(workspace_path, m.name, kind), depth)
            write_mat(normal_map_path(workspace_path, m.name, kind),
                      normal.transpose(1, 2, 0))
            log.info(f"patch_match[{kind}] {m.name}: "
                     f"{np.mean(depth > 0) * 100:.0f}% valid depth")
        return results

    t0 = time.perf_counter()
    photo = run_pass("photometric")
    t1 = time.perf_counter()
    if timings is not None:
        timings["photometric"] = t1 - t0
    if not options.geom_consistency:
        if options.filter:
            for iid, (depth, normal, cost) in photo.items():
                m = model.images[iid]
                bad = cost > (1.0 - options.filter_min_ncc)
                write_mat(
                    depth_map_path(workspace_path, m.name, "photometric"),
                    torch.where(bad, 0.0, depth).cpu().numpy(),
                )
        if timings is not None:
            timings["filter"] = time.perf_counter() - t1
        return

    photo_depths = {iid: r[0] for iid, r in photo.items()}
    photo_normals = {iid: r[1] for iid, r in photo.items()}
    geo = run_pass("geometric", photo_depths, photo_normals)
    t2 = time.perf_counter()
    geometric_consistency_filter(
        workspace_path, model, images,
        {iid: r[0] for iid, r in geo.items()},
        {iid: r[2] for iid, r in geo.items()},
        options,
    )
    if timings is not None:
        timings.update(geometric=t2 - t1, filter=time.perf_counter() - t2)


def geometric_consistency_filter(
    workspace_path, model, images, depths, costs, options
):
    """Cross-view depth-agreement filter on the geometric maps + optional
    consistency-graph output (upstream PatchMatch::Run filtering). The maps
    are tensors (or arrays) on one device; the checks run there in
    float64."""
    for iid, m in model.images.items():
        if iid not in depths:
            continue
        d_ref = torch.as_tensor(depths[iid])
        dev = d_ref.device
        t64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
        H, W = d_ref.shape
        _, Kr = images[iid]
        X_cam = pixel_rays(Kr, H, W, dev) * d_ref[None]
        # to world
        X_w = rotate_t(t64(m.R), X_cam - t64(m.t)[:, None, None])
        consistent = torch.zeros((len(m.src_ids), H, W), dtype=torch.bool,
                                 device=dev)
        for si, sid in enumerate(m.src_ids):
            if sid not in depths:
                continue
            s = model.images[sid]
            _, Ksrc = images[sid]
            Xs = rotate(t64(s.R), X_w) + t64(s.t)[:, None, None]
            z = Xs[2]
            zc = torch.clamp(z, min=1e-9)
            fx, fy, cx, cy = (float(Ksrc[i, j]) for i, j in
                              ((0, 0), (1, 1), (0, 2), (1, 2)))
            u = fx * Xs[0] / zc + cx
            v = fy * Xs[1] / zc + cy
            ui = torch.round(u - 0.5).long()
            vi = torch.round(v - 0.5).long()
            d_sid = torch.as_tensor(depths[sid], device=dev)
            hs, ws = d_sid.shape
            ok = (z > 0) & (ui >= 0) & (ui < ws) & (vi >= 0) & (vi < hs)
            d_src = torch.where(
                ok, d_sid[vi.clamp(0, hs - 1), ui.clamp(0, ws - 1)].double(),
                0.0)
            rel_err = torch.abs(d_src - z) / zc
            consistent[si] = ok & (d_src > 0) & (rel_err < 0.01)
        if options.write_consistency_graph:
            write_consistency_graph(
                consistency_graph_path(workspace_path, m.name, "geometric"),
                consistent.cpu().numpy(),
            )
        if options.filter:
            keep = consistent.sum(dim=0) >= options.filter_min_num_consistent
            if iid in costs:
                # final cost includes the geom term; bound it accordingly
                max_cost = (1.0 - options.filter_min_ncc) + (
                    options.geom_consistency_regularizer
                    * options.geom_consistency_max_cost
                )
                keep &= torch.as_tensor(costs[iid], device=dev) <= max_cost
            d_geo = torch.where(keep, d_ref, 0.0)
            write_mat(depth_map_path(workspace_path, m.name, "geometric"),
                      d_geo.cpu().numpy())
