"""Reconstruction exporters: NVM, Bundler, CAM, VRML.

Port of ``pycolmap_tpu/scene/exporters.py``; the files are byte-identical
to the reference's. API parity: pycolmap/scene/reconstruction.h:260-360
(export_NVM, export_CAM, export_bundler, export_VRML; PLY lives on
Reconstruction itself). Formats follow the upstream writers
(colmap/scene/reconstruction_io).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def export_NVM(reconstruction, path, skip_distortion: bool = False):
    """VisualSFM NVM format (upstream ExportNVM).

    NVM expects SIMPLE_RADIAL-style intrinsics: f, k. Cameras with other
    models are exported with k=0 when skip_distortion is False only if
    compatible, matching upstream behavior loosely.
    """
    rec = reconstruction
    lines = ["NVM_V3", ""]
    reg = [i for i in sorted(rec.images) if rec.images[i].registered]
    lines.append(str(len(reg)))
    image_row = {}
    for row, iid in enumerate(reg):
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        f = cam.mean_focal_length()
        k = 0.0
        if not skip_distortion and cam.model in ("SIMPLE_RADIAL", "RADIAL"):
            k = -cam.params[3]  # NVM uses inverted sign convention
        q = img.cam_from_world.rotation.quat  # xyzw
        c = img.projection_center()
        lines.append(
            f"{img.name} {f} {q[3]} {q[0]} {q[1]} {q[2]} "
            f"{c[0]} {c[1]} {c[2]} {k} 0"
        )
        image_row[iid] = row
    lines.append("")
    lines.append(str(rec.num_points3D))
    for pid, pt in rec.points3D.items():
        els = [el for el in pt.track.elements if el.image_id in image_row]
        track = " ".join(
            f"{image_row[el.image_id]} {el.point2D_idx} "
            f"{rec.images[el.image_id].points2D_xy[el.point2D_idx][0]} "
            f"{rec.images[el.image_id].points2D_xy[el.point2D_idx][1]}"
            for el in els
        )
        lines.append(
            f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]} "
            f"{pt.color[0]} {pt.color[1]} {pt.color[2]} {len(els)} {track}"
        )
    Path(path).write_text("\n".join(lines) + "\n")


def export_bundler(reconstruction, path, list_path):
    """Bundler .out + image list (upstream ExportBundler)."""
    rec = reconstruction
    reg = [i for i in sorted(rec.images) if rec.images[i].registered]
    lines = ["# Bundle file v0.3", f"{len(reg)} {rec.num_points3D}"]
    image_row = {}
    names = []
    for row, iid in enumerate(reg):
        img = rec.images[iid]
        cam = rec.cameras[img.camera_id]
        names.append(img.name)
        image_row[iid] = row
        f = cam.mean_focal_length()
        k1 = k2 = 0.0
        if cam.model == "SIMPLE_RADIAL":
            k1 = cam.params[3]
        elif cam.model == "RADIAL":
            k1, k2 = cam.params[3], cam.params[4]
        # Bundler convention: camera looks down -z; flip y and z rows
        R = img.cam_from_world.rotation.matrix()
        t = img.cam_from_world.translation
        F = np.diag([1.0, -1.0, -1.0])
        Rb = F @ R + 0.0  # + 0.0 normalizes IEEE -0.0 so text is canonical
        tb = F @ t + 0.0
        lines.append(f"{f} {k1} {k2}")
        for r in range(3):
            lines.append(f"{Rb[r,0]} {Rb[r,1]} {Rb[r,2]}")
        lines.append(f"{tb[0]} {tb[1]} {tb[2]}")
    for pid, pt in rec.points3D.items():
        lines.append(f"{pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]}")
        lines.append(f"{pt.color[0]} {pt.color[1]} {pt.color[2]}")
        els = [el for el in pt.track.elements if el.image_id in image_row]
        track = []
        for el in els:
            img = rec.images[el.image_id]
            cam = rec.cameras[img.camera_id]
            xy = img.points2D_xy[el.point2D_idx]
            # bundler: origin at image center, y up
            bx = xy[0] - cam.width / 2.0
            by = cam.height / 2.0 - xy[1]
            track.append(f"{image_row[el.image_id]} {el.point2D_idx} {bx} {by}")
        lines.append(f"{len(els)} " + " ".join(track))
    Path(path).write_text("\n".join(lines) + "\n")
    Path(list_path).write_text("\n".join(names) + "\n")


def export_CAM(reconstruction, output_dir):
    """Per-image .cam files (upstream ExportCam): extrinsics + intrinsics."""
    rec = reconstruction
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    for iid in sorted(rec.images):
        img = rec.images[iid]
        if not img.registered:
            continue
        cam = rec.cameras[img.camera_id]
        R = img.cam_from_world.rotation.matrix()
        t = img.cam_from_world.translation
        flen = cam.mean_focal_length() / max(cam.width, cam.height)
        k1 = k2 = 0.0
        if cam.model == "SIMPLE_RADIAL":
            k1 = cam.params[3]
        elif cam.model == "RADIAL":
            k1, k2 = cam.params[3], cam.params[4]
        paspect = cam.focal_length_y / cam.focal_length_x
        ppx = cam.principal_point_x / cam.width
        ppy = cam.principal_point_y / cam.height
        name = Path(img.name).stem + ".cam"
        with open(output_dir / name, "w") as fzz:
            fzz.write(
                f"{t[0]} {t[1]} {t[2]} "
                f"{R[0,0]} {R[0,1]} {R[0,2]} {R[1,0]} {R[1,1]} {R[1,2]} "
                f"{R[2,0]} {R[2,1]} {R[2,2]}\n"
            )
            fzz.write(f"{flen} {k1} {k2} {paspect} {ppx} {ppy}\n")


def export_VRML(
    reconstruction, images_path, points3D_path, image_scale=1.0,
    image_rgb=(1.0, 0.1, 0.1),
):
    """VRML camera frusta + point cloud (upstream ExportVRML)."""
    rec = reconstruction
    with open(images_path, "w") as f:
        for iid in sorted(rec.images):
            img = rec.images[iid]
            if not img.registered:
                continue
            inv = img.cam_from_world.inverse()
            R = inv.rotation.matrix()
            c = inv.translation
            s = image_scale
            corners = np.array(
                [[-s, -s, 2 * s], [s, -s, 2 * s], [s, s, 2 * s], [-s, s, 2 * s]]
            )
            pts = [c] + [R @ p + c for p in corners]
            f.write("Shape{\n appearance Appearance {\n")
            f.write(
                f"  material Material {{ diffuseColor {image_rgb[0]} "
                f"{image_rgb[1]} {image_rgb[2]} }} }}\n"
            )
            f.write(" geometry IndexedFaceSet {\n  coord Coordinate { point [\n")
            for p in pts:
                f.write(f"   {p[0]} {p[1]} {p[2]}\n")
            f.write("  ] }\n  coordIndex [\n")
            f.write("   0, 1, 2, -1\n   0, 2, 3, -1\n   0, 3, 4, -1\n   0, 4, 1, -1\n")
            f.write("  ]\n }\n}\n")
    with open(points3D_path, "w") as f:
        f.write("#VRML V2.0 utf8\nShape{ geometry PointSet {\n")
        f.write(" coord Coordinate { point [\n")
        for pt in rec.points3D.values():
            f.write(f"  {pt.xyz[0]} {pt.xyz[1]} {pt.xyz[2]}\n")
        f.write(" ] }\n color Color { color [\n")
        for pt in rec.points3D.values():
            f.write(
                f"  {pt.color[0]/255:.4f} {pt.color[1]/255:.4f} {pt.color[2]/255:.4f}\n"
            )
        f.write(" ] } } }\n")
