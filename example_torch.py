"""End-to-end example on pycolmap_torch, the PyTorch/CUDA port: the flow of
example.py (extract -> match -> map -> summary, optionally dense) on the
card.

With no --image_path it renders a synthetic scene first: two textured
planes seen from an arc of cameras (the scene of the integration tests),
written as .ppm files, which the port reads without Pillow. Point it at
your own images with --image_path to run on real data. Everything runs on
the CUDA card unless --device cpu is given.

    python3 example_torch.py [--image_path DIR] [--output_path DIR]
                             [--num_images 6] [--device cpu] [--dense]
"""

import argparse
import tempfile
from pathlib import Path

import numpy as np

import pycolmap_torch as pycolmap
from pycolmap_torch.pipeline.images import write_image


def _texture(rng, cells=(8, 16, 32, 64, 128)):
    """Multi-octave periodic value noise: one random grid per octave."""
    return [(rng.normal(size=(c, c)), c ** -0.5) for c in cells]


def _sample(texture, u, v):
    """Bilinear sum of the octaves at world coordinates (u, v), in [0, 1]."""
    out = np.zeros(u.shape)
    for grid, amp in texture:
        c = grid.shape[0]
        tu, tv = (u * 0.18 + 0.5) * c, (v * 0.18 + 0.5) * c
        x0, y0 = np.floor(tu), np.floor(tv)
        fx, fy = tu - x0, tv - y0
        x0, y0 = x0.astype(np.int64) % c, y0.astype(np.int64) % c
        x1, y1 = (x0 + 1) % c, (y0 + 1) % c
        out += amp * (grid[y0, x0] * (1 - fy) * (1 - fx)
                      + grid[y0, x1] * (1 - fy) * fx
                      + grid[y1, x0] * fy * (1 - fx) + grid[y1, x1] * fy * fx)
    return np.clip(0.5 + 0.2 * out, 0.0, 1.0)


def render_scene(out_dir, num_images=6, W=512, H=384, seed=0):
    """Two fronto-facing planes (z = 6 left of x = 0.15, z = 7.5 right of
    it) seen by a pinhole camera (f = 450) from an arc of 0.7 rad around a
    target between them. Writes view00.ppm ... and returns the true poses."""
    rng = np.random.default_rng(seed)
    f = 450.0
    textures = [_texture(rng), _texture(rng)]
    target = np.array([0.0, 0.0, 6.5])
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    d_cam = np.stack([(xx + 0.5 - W / 2) / f, (yy + 0.5 - H / 2) / f,
                      np.ones_like(xx)], axis=-1)
    out_dir.mkdir(parents=True, exist_ok=True)
    poses = []
    for i in range(num_images):
        theta = -0.35 + i * (0.7 / max(num_images - 1, 1))
        center = target + 6.5 * np.array(
            [np.sin(theta), 0.10 * np.sin(2 * theta), -np.cos(theta)])
        fwd = (target - center) / np.linalg.norm(target - center)
        right = np.cross([0.0, -1.0, 0.0], fwd)
        right /= np.linalg.norm(right)
        R_wc = np.stack([right, np.cross(fwd, right), fwd])
        poses.append(pycolmap.Rigid3d(pycolmap.Rotation3d(R_wc),
                                      -R_wc @ center))
        d_world = d_cam @ R_wc  # rays in the world frame
        img = np.full((H, W), 0.5)
        depth = np.full((H, W), np.inf)
        for k, z0 in enumerate((6.0, 7.5)):
            with np.errstate(divide="ignore", invalid="ignore"):
                t = (z0 - center[2]) / d_world[..., 2]
            px = center[0] + t * d_world[..., 0]
            py = center[1] + t * d_world[..., 1]
            own = (px < 0.15) if k == 0 else (px >= 0.15)
            sel = (t > 0.1) & np.isfinite(t) & own & (t < depth)
            img[sel] = _sample(textures[k], px[sel], py[sel])
            depth[sel] = t[sel]
        write_image(out_dir / f"view{i:02d}.ppm",
                    (img * 255).round().astype(np.uint8))
    return poses


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--image_path", type=str, default="")
    parser.add_argument("--output_path", type=str, default="")
    parser.add_argument("--num_images", type=int, default=6)
    parser.add_argument("--device", type=str, default=None,
                        help="cuda (the default) or cpu")
    parser.add_argument("--dense", action="store_true",
                        help="run undistortion + patch-match + fusion")
    args = parser.parse_args()

    output_path = Path(args.output_path or tempfile.mkdtemp(prefix="sfm_"))
    output_path.mkdir(parents=True, exist_ok=True)

    if args.image_path:
        image_path = Path(args.image_path)
    else:
        image_path = output_path / "images"
        print(f"Rendering synthetic scene -> {image_path}")
        render_scene(image_path, num_images=args.num_images)

    database_path = output_path / "database.db"
    sparse_path = output_path / "sparse"

    print("Extracting features...")
    pycolmap.extract_features(database_path, image_path, device=args.device)

    print("Matching exhaustively...")
    pycolmap.match_exhaustive(database_path, device=args.device)

    print("Running incremental mapping...")
    options = pycolmap.IncrementalPipelineOptions()
    options.min_model_size = 4
    options.mapper.init_min_num_inliers = 30
    options.mapper.abs_pose_min_num_inliers = 15
    options.mapper.init_min_tri_angle = 4.0
    maps = pycolmap.incremental_mapping(
        database_path, image_path, sparse_path, options, device=args.device
    )
    for idx, rec in maps.items():
        print(f"model #{idx}:")
        print(rec.summary())

    if args.dense and maps:
        dense_path = output_path / "dense"
        print("Undistorting...")
        pycolmap.undistort_images(dense_path, sparse_path / "0", image_path,
                                  device=args.device)
        print("PatchMatch stereo...")
        pycolmap.patch_match_stereo(dense_path, device=args.device)
        print("Fusing...")
        pycolmap.stereo_fusion(dense_path / "fused.ply", dense_path,
                               device=args.device)

    print(f"Done. Outputs in {output_path}")


if __name__ == "__main__":
    main()
