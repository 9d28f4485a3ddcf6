"""Stereo fusion: consistent depth-map pixels -> dense colored point cloud.

Port of ``pycolmap_tpu/mvs/fusion.py`` (API parity: pycolmap/pipeline/mvs.h
:43-90 ``stereo_fusion``, StereoFusionOptions :193-243). Every pixel's
backprojection is checked against all source depth maps at once
(reprojection, depth and normal agreement), and duplicate surface samples
are merged by voxel hashing at a resolution tied to scene scale.

The per-image, per-source checks run in float64 on the entry point's
device. The voxel dedup, the PLY writer and the ``fused.ply.vis``
visibility file are the reference's numpy on the host, so the two packages
write the same files. Like the reference, ``.vis`` lists image ids where
COLMAP lists image indices (ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.mvs.depth_map_io import depth_map_path, normal_map_path, read_mat
from pycolmap_torch.mvs.workspace import MVSModel, rotate, rotate_t
from pycolmap_torch.utils import logging as _logging
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class StereoFusionOptions(BaseOptions):
    """Mirrors reference StereoFusionOptions (pipeline/mvs.h:193-243)."""

    mask_path: str = ""
    num_threads: int = -1
    max_image_size: int = -1
    min_num_pixels: int = 5
    max_num_pixels: int = 10000
    max_traversal_depth: int = 100
    max_reproj_error: float = 2.0
    max_depth_error: float = 0.01
    max_normal_error: float = 10.0
    check_num_images: int = 50
    use_cache: bool = False
    cache_size: float = 32.0
    bounding_box: tuple = None


def _rays(K, H, W, device):
    """The reference's fusion rays: (x + 0.5 - cx) / fx from an f32 pixel
    grid, in float64. [3, H, W]."""
    yy, xx = torch.meshgrid(torch.arange(H, device=device, dtype=torch.float32),
                            torch.arange(W, device=device, dtype=torch.float32),
                            indexing="ij")
    xx = (xx + 0.5).double()
    yy = (yy + 0.5).double()
    fx, fy, cx, cy = (float(K[i, j]) for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
    return torch.stack([(xx - cx) / fx, (yy - cy) / fy,
                        torch.ones_like(xx)]), xx, yy


def _image_points(m, K, d_ref, sources, normals, options):
    """One image's consistency checks on d_ref's device. sources: (sid,
    MVSImage, K, depth map tensor) per source. Returns X_w [3, H, W] and
    (sid, consistent [H, W]) per checked source."""
    dev = d_ref.device
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)  # noqa: E731
    H, W = d_ref.shape
    rays, xx, yy = _rays(K, H, W, dev)
    X_cam = rays * d_ref[None]
    X_w = rotate_t(t64(m.R), X_cam - t64(m.t)[:, None, None])
    cos_max_normal = np.cos(np.deg2rad(options.max_normal_error))
    n_ref = normals.get(m.image_id)
    src_flags = []
    for sid, s, Ksrc, d_sid in sources:
        fx, fy, cx, cy = (float(Ksrc[i, j])
                          for i, j in ((0, 0), (1, 1), (0, 2), (1, 2)))
        Xs = rotate(t64(s.R), X_w) + t64(s.t)[:, None, None]
        z = Xs[2]
        zc = torch.clamp(z, min=1e-9)
        u = fx * Xs[0] / zc + cx
        v = fy * Xs[1] / zc + cy
        ui = torch.round(u - 0.5).long()
        vi = torch.round(v - 0.5).long()
        hs, ws = d_sid.shape
        ok = (z > 0) & (ui >= 0) & (ui < ws) & (vi >= 0) & (vi < hs)
        uis = ui.clamp(0, ws - 1)
        vis = vi.clamp(0, hs - 1)
        d_src = torch.where(ok, d_sid[vis, uis].double(), 0.0)
        rel = torch.abs(d_src - z) / zc
        consistent = ok & (d_src > 0) & (rel < options.max_depth_error)
        # reprojection check (ref StereoFusionOptions::max_reproj_error):
        # the source pixel's own 3D point must land within the threshold of
        # the reference pixel it is supporting
        if bool(consistent.any()):
            rays_s = torch.stack([(uis.double() + 0.5 - cx) / fx,
                                  (vis.double() + 0.5 - cy) / fy,
                                  torch.ones_like(u)])
            Xs_pt = rays_s * d_src[None]
            Xw_s = rotate_t(t64(s.R), Xs_pt - t64(s.t)[:, None, None])
            Xr = rotate(t64(m.R), Xw_s) + t64(m.t)[:, None, None]
            zr = torch.clamp(Xr[2], min=1e-9)
            ur = float(K[0, 0]) * Xr[0] / zr + float(K[0, 2])
            vr = float(K[1, 1]) * Xr[1] / zr + float(K[1, 2])
            reproj = torch.hypot(ur - xx, vr - yy)
            consistent &= reproj < options.max_reproj_error
            # normal agreement (ref max_normal_error), when both views carry
            # normal maps (camera-frame -> world via R^T)
            n_src = normals.get(sid)
            if n_ref is not None and n_src is not None:
                n_ref_w = rotate_t(t64(m.R), n_ref)
                n_src_w = rotate_t(t64(s.R), n_src[:, vis, uis])
                cosang = (n_ref_w[0] * n_src_w[0] + n_ref_w[1] * n_src_w[1]
                          + n_ref_w[2] * n_src_w[2])
                consistent &= cosang > cos_max_normal
        src_flags.append((sid, consistent))
    return X_w, src_flags


def stereo_fusion(
    output_path,
    workspace_path,
    workspace_format: str = "COLMAP",
    pmvs_option_name: str = "option-all",
    input_type: str = "geometric",
    options: StereoFusionOptions = None,
    device=None,
):
    """Fuse depth maps into a dense PLY point cloud. Returns (xyz, rgb).
    The consistency checks run on ``device`` (default: the card)."""
    # imported here: the pipeline package imports this module
    from pycolmap_torch.pipeline.images import read_image_rgb

    if options is None:
        options = StereoFusionOptions()
    device = resolve_device(device)
    log = _logging.get_logger()
    workspace_path = Path(workspace_path)
    model = MVSModel(workspace_path)

    depths = {}
    normals = {}  # [3, H, W] float64 tensors on the device
    colors = {}
    Ks = {}
    for iid, m in model.images.items():
        p = depth_map_path(workspace_path, m.name, input_type)
        if not p.exists():
            p = depth_map_path(workspace_path, m.name, "photometric")
            if not p.exists():
                continue
        depths[iid] = torch.from_numpy(read_mat(p).copy()).to(device)
        np_path = normal_map_path(workspace_path, m.name, input_type)
        if not np_path.exists():
            np_path = normal_map_path(workspace_path, m.name, "photometric")
        if np_path.exists():
            normals[iid] = torch.from_numpy(
                read_mat(np_path).transpose(2, 0, 1).astype(np.float64)
            ).to(device)
        img_file = workspace_path / "images" / m.name
        rgb = read_image_rgb(img_file) if img_file.exists() else None
        h, w = depths[iid].shape
        if rgb is not None and rgb.shape[:2] != (h, w):
            from PIL import Image as PILImage

            rgb = np.asarray(
                PILImage.fromarray(rgb).resize((w, h), PILImage.BILINEAR)
            )
        colors[iid] = rgb
        K = m.K.copy()
        K[0] *= w / m.width
        K[1] *= h / m.height
        Ks[iid] = K

    fused_xyz = []
    fused_rgb = []
    fused_normal = []
    fused_vis_counts = []
    fused_vis_flat = []
    min_consistent = max(options.min_num_pixels // 2, 2)
    for iid, m in model.images.items():
        if iid not in depths:
            continue
        d_ref = depths[iid]
        valid = d_ref > 0
        if not bool(valid.any()):
            continue
        sources = [(sid, model.images[sid], Ks[sid], depths[sid])
                   for sid in m.src_ids[: options.check_num_images]
                   if sid in depths]
        X_w, src_flags = _image_points(m, Ks[iid], d_ref, sources, normals,
                                       options)
        num_consistent = sum(
            (flag.to(torch.int32) for _, flag in src_flags),
            torch.zeros_like(d_ref, dtype=torch.int32))
        keep_t = valid & (num_consistent >= min_consistent)
        if not bool(keep_t.any()):
            continue
        keep = keep_t.cpu().numpy()
        pts = X_w[:, keep_t].T.cpu().numpy()
        # per-point visibility (ref image + consistent sources): the
        # reference's fused.ply.vis payload
        vis_ids = np.array([iid] + [sid for sid, _ in src_flags], np.uint32)
        vis_mask = torch.stack(
            [torch.ones(int(keep.sum()), dtype=torch.bool, device=device)]
            + [flag[keep_t] for _, flag in src_flags]
        ).T.cpu().numpy()  # [P, 1 + S], row-major nonzero groups ids per point
        fused_vis_counts.append(vis_mask.sum(axis=1).astype(np.uint32))
        fused_vis_flat.append(vis_ids[np.nonzero(vis_mask)[1]])
        if colors[iid] is not None:
            cols = colors[iid][keep]
        else:
            cols = np.full((len(pts), 3), 128, dtype=np.uint8)
        if iid in normals:
            # [N, 3] in camera frame, as the f32 map holds it
            n_cam = normals[iid][:, keep_t].T.float().cpu().numpy()
            n_w = n_cam @ m.R  # R^T n
        else:
            # fall back to the (negated) viewing ray
            n_w = -(pts - (-(m.R.T @ m.t))[None, :])
            n_w /= np.maximum(np.linalg.norm(n_w, axis=1, keepdims=True), 1e-9)
        fused_xyz.append(pts)
        fused_rgb.append(cols)
        fused_normal.append(n_w)

    if not fused_xyz:
        xyz = np.zeros((0, 3))
        rgb = np.zeros((0, 3), dtype=np.uint8)
        nrm = np.zeros((0, 3))
        vis_counts = np.zeros(0, np.uint32)
        vis_flat = np.zeros(0, np.uint32)
    else:
        xyz = np.concatenate(fused_xyz)
        rgb = np.concatenate(fused_rgb)
        nrm = np.concatenate(fused_normal)
        vis_counts = np.concatenate(fused_vis_counts)
        vis_flat = np.concatenate(fused_vis_flat)
        # voxel dedup at scene-adaptive resolution
        if len(xyz):
            span = np.percentile(xyz, 95, axis=0) - np.percentile(xyz, 5, axis=0)
            voxel = max(float(np.max(span)) / 2048.0, 1e-6)
            keys = np.floor(xyz / voxel).astype(np.int64)
            _, idx = np.unique(keys, axis=0, return_index=True)
            xyz = xyz[idx]
            rgb = rgb[idx]
            nrm = nrm[idx]
            vis_counts, vis_flat = _select_vis(vis_counts, vis_flat, idx)

    _write_ply(output_path, xyz, rgb, nrm)
    write_fused_vis(str(output_path) + ".vis", vis_counts, vis_flat)
    log.info(f"stereo_fusion: {len(xyz)} fused points -> {output_path}")
    return xyz, rgb


def _cumsum0(a):
    """[0, a0, a0+a1, ...] with int64 accumulation."""
    out = np.zeros(len(a) + 1, np.int64)
    np.cumsum(a, dtype=np.int64, out=out[1:])
    return out


def _select_vis(counts, flat, idx):
    """Subset ragged per-point visibility lists to the selected points."""
    offsets = _cumsum0(counts)
    cnts = counts[idx].astype(np.int64)
    total = int(cnts.sum())
    # ragged gather: each output block = its source start + 0..cnt-1
    block_base = np.repeat(offsets[idx], cnts)
    within = np.arange(total) - np.repeat(_cumsum0(cnts)[:-1], cnts)
    return cnts.astype(np.uint32), flat[block_base + within]


def write_fused_vis(path, counts, flat):
    """COLMAP fused.ply.vis: uint64 N, then per point uint32 count followed
    by that many uint32 image ids (ref mvs/fusion.cc WritePointsVisibility)."""
    counts = np.asarray(counts, np.uint32)
    flat = np.asarray(flat, np.uint32)
    n = len(counts)
    buf = np.empty(n + len(flat), np.uint32)
    # interleave: each point's count sits before its ids
    out_start = _cumsum0(counts)[:-1] + np.arange(n)
    buf[out_start] = counts
    mask = np.ones(len(buf), bool)
    mask[out_start] = False
    buf[mask] = flat
    with open(path, "wb") as f:
        f.write(np.uint64(n).tobytes())
        f.write(buf.astype("<u4").tobytes())


_VIS_STRIDE = 256  # chain steps per jump table entry in read_fused_vis


def read_fused_vis(path):
    """Read fused.ply.vis -> (counts uint32 [N], flat uint32 ids).

    The counts are self-delimiting: the count of point i+1 sits at
    p(i+1) = p(i) + 1 + buf[p(i)]. Every word gets that successor at once,
    a jump table of ``_VIS_STRIDE`` successors is built by pointer doubling,
    the chain from word 0 is walked in strides on it, and the words between
    strides are filled in for all strides at once."""
    raw = np.fromfile(path, dtype=np.uint8)
    n = int(np.frombuffer(raw[:8].tobytes(), dtype="<u8")[0])
    buf = np.frombuffer(raw[8:].tobytes(), dtype="<u4")
    L = len(buf)
    if n == 0:
        return np.zeros(0, np.uint32), buf.copy()
    # successor of every word read as a count; L is an absorbing end
    nxt = np.empty(L + 1, np.int64)
    nxt[:L] = np.arange(1, L + 1, dtype=np.int64) + buf
    nxt[L] = L
    np.minimum(nxt, L, out=nxt)
    jump = nxt
    for _ in range(int(np.log2(_VIS_STRIDE))):
        jump = jump[jump]
    heads = np.empty(-(-n // _VIS_STRIDE), np.int64)
    p = 0
    for j in range(len(heads)):
        heads[j] = p
        p = jump[p]
    pos = np.empty((len(heads), _VIS_STRIDE), np.int64)
    pos[:, 0] = heads
    for t in range(1, _VIS_STRIDE):
        pos[:, t] = nxt[pos[:, t - 1]]
    starts = pos.reshape(-1)[:n]
    if starts[-1] >= L or starts[-1] + 1 + int(buf[starts[-1]]) > L:
        raise ValueError(f"{path}: malformed visibility file (the counts of "
                         f"{n} points run past its end)")
    counts = buf[starts].copy()
    mask = np.ones(L, bool)
    mask[starts] = False
    return counts, buf[mask]


def _write_ply(path, xyz, rgb, normals=None):
    """COLMAP-style fused PLY: position + normal + color per vertex."""
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(xyz)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "property uchar red\nproperty uchar green\nproperty uchar blue\n"
            "end_header\n"
        )
        f.write(header.encode("ascii"))
        if normals is None:
            normals = np.zeros_like(xyz)
        rec = np.empty(
            len(xyz),
            dtype=np.dtype(
                [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                 ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                 ("r", "u1"), ("g", "u1"), ("b", "u1")]
            ),
        )
        rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
        rec["nx"], rec["ny"], rec["nz"] = (
            normals[:, 0], normals[:, 1], normals[:, 2],
        )
        rec["r"], rec["g"], rec["b"] = rgb[:, 0], rgb[:, 1], rgb[:, 2]
        f.write(rec.tobytes())
