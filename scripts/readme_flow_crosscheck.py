"""Cross-check the README flow's rotations between pycolmap_tpu and
pycolmap_torch on the CPU.

Renders the five 320x240 images of tests/test_torch_match_features.py,
runs each package's flow (extract_features -> match_exhaustive ->
incremental_mapping with that test's options), then crosses the stages:
each package's mapper on the other's database, the port's verification on
the reference's features, and each pair whose verified matches differ
moved alone into the reference's database. It prints, per run, the
median rotation error after the reference's
``compare_reconstructions(..., "proj_center")``, and for the matches that
differ their Sampson distance to the true geometry and to each package's
essential matrix.

    JAX_PLATFORMS=cpu python scripts/readme_flow_crosscheck.py OUT_DIR

It takes about five minutes on a few CPU cores.
"""

import json
import shutil
import sqlite3
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

import pycolmap_torch as pt  # noqa: E402
import pycolmap_tpu as jt  # noqa: E402
from pycolmap_tpu.estimators import compare_reconstructions  # noqa: E402
from test_full_pipeline import render_scene  # noqa: E402


def options(mod):
    o = mod.IncrementalPipelineOptions()
    o.min_model_size = 4
    o.extract_colors = False
    o.min_num_matches = 15
    o.mapper.init_min_num_inliers = 30
    o.mapper.abs_pose_min_num_inliers = 15
    o.mapper.init_min_tri_angle = 4.0
    return o


def extract_and_match(pkg, db, images):
    mod = jt if pkg == "ref" else pt
    kw = {} if pkg == "ref" else {"device": "cpu"}
    so = mod.SiftExtractionOptions()
    so.max_num_features = 1200
    mod.extract_features(db, images, sift_options=so, **kw)
    mod.match_exhaustive(db, **kw)


def rematch(pkg, src, db):
    """A copy of `src` with its matches verified again by `pkg`."""
    shutil.copy(src, db)
    con = sqlite3.connect(db)
    con.execute("DELETE FROM matches")
    con.execute("DELETE FROM two_view_geometries")
    con.commit()
    con.close()
    (jt.match_exhaustive(db) if pkg == "ref"
     else pt.match_exhaustive(db, device="cpu"))


def map_and_judge(pkg, db, images, out, gt):
    if pkg == "ref":
        jt.incremental_mapping(db, images, out, options(jt))
    else:
        pt.incremental_mapping(db, images, out, options(pt), device="cpu")
    rec = jt.Reconstruction(out / "0")
    res = compare_reconstructions(rec, gt, alignment_error="proj_center")
    rots = [e.rotation_error_deg for e in res["errors"]]
    cam = next(iter(rec.cameras.values()))
    return dict(registered=rec.num_reg_images, points=rec.num_points3D,
                reproj_px=rec.compute_mean_reprojection_error(),
                params=[float(p) for p in cam.params],
                median_rot_deg=float(np.median(rots)),
                rot_deg=[float(r) for r in rots])


def geometries(db):
    con = sqlite3.connect(db)
    out = {}
    for pid, rows, cols, data, E in con.execute(
            "SELECT pair_id, rows, cols, data, E FROM two_view_geometries"):
        m = np.frombuffer(data, np.uint32).reshape(rows, cols)
        out[pid] = (m, np.frombuffer(E, np.float64).reshape(3, 3), rows,
                    cols, data)
    con.close()
    return out


def swap_pair(src, donor, db, pid):
    shutil.copy(src, db)
    _, _, rows, cols, data = geometries(donor)[pid]
    con = sqlite3.connect(db)
    con.execute("UPDATE two_view_geometries SET rows=?, cols=?, data=? "
                "WHERE pair_id=?", (rows, cols, data, pid))
    con.commit()
    con.close()


def keypoints(db, image_id):
    con = sqlite3.connect(db)
    r, c, d = con.execute("SELECT rows, cols, data FROM keypoints WHERE "
                          "image_id=?", (image_id,)).fetchone()
    con.close()
    return np.frombuffer(d, np.float32).reshape(r, c)[:, :2].astype(float)


def sampson_px2(E, K, a, b):
    Ki = np.linalg.inv(K)
    x1, x2 = Ki @ np.r_[a, 1.0], Ki @ np.r_[b, 1.0]
    Ex1, Etx2 = E @ x1, E.T @ x2
    return float((x2 @ E @ x1) ** 2 / (Ex1[0] ** 2 + Ex1[1] ** 2
                                        + Etx2[0] ** 2 + Etx2[1] ** 2)
                 * K[0, 0] ** 2)


def main(out):
    torch.set_num_threads(2)
    out = Path(out)
    images = out / "images"
    poses, cam = render_scene(images, num_images=5, W=320, H=240)
    gt = jt.Reconstruction()
    gt.add_camera(cam)
    for i, pose in enumerate(poses):
        img = jt.Image(id=i + 1, name=f"view{i:02d}.png",
                       camera_id=cam.camera_id)
        img.cam_from_world = pose
        img.registered = True
        gt.add_image(img)
    report = {}
    db = {pkg: out / f"{pkg}.db" for pkg in ("ref", "port")}
    for pkg in ("ref", "port"):
        extract_and_match(pkg, db[pkg], images)
        report[f"{pkg} flow"] = map_and_judge(pkg, db[pkg], images,
                                              out / f"{pkg}_flow", gt)
    report["ref mapper on port db"] = map_and_judge(
        "ref", db["port"], images, out / "ref_on_port", gt)
    report["port mapper on ref db"] = map_and_judge(
        "port", db["ref"], images, out / "port_on_ref", gt)
    mixed = out / "ref_features_port_verification.db"
    rematch("port", db["ref"], mixed)
    for pkg in ("ref", "port"):
        report[f"{pkg} mapper, ref features + port verification"] = \
            map_and_judge(pkg, mixed, images, out / f"{pkg}_on_mixed", gt)
    g_ref, g_mix = geometries(db["ref"]), geometries(mixed)
    K = cam.calibration_matrix()
    for pid in sorted(g_ref):
        a = set(map(tuple, g_ref[pid][0]))
        b = set(map(tuple, g_mix[pid][0]))
        if a == b:
            continue
        i1, i2 = (int(v) for v in jt.pair_id_to_image_pair(pid))
        k1, k2 = keypoints(db["ref"], i1), keypoints(db["ref"], i2)
        true_E = (poses[i2 - 1] * poses[i1 - 1].inverse()).essential_matrix()
        diff = [dict(match=[int(m[0]), int(m[1])], only_in=tag,
                     xy1=k1[m[0]].tolist(), xy2=k2[m[1]].tolist(),
                     sampson_px2_true=sampson_px2(true_E, K, k1[m[0]],
                                                  k2[m[1]]),
                     sampson_px2_ref_E=sampson_px2(g_ref[pid][1], K,
                                                   k1[m[0]], k2[m[1]]),
                     sampson_px2_port_E=sampson_px2(g_mix[pid][1], K,
                                                    k1[m[0]], k2[m[1]]))
                for tag, s in (("port", b - a), ("ref", a - b)) for m in s]
        swapped = out / f"swap_{i1}_{i2}.db"
        swap_pair(db["ref"], mixed, swapped, pid)
        report[f"pair ({i1}, {i2}): {len(a)} / {len(b)} inliers"] = dict(
            differing=diff, port_mapper_with_port_pair=map_and_judge(
                "port", swapped, images, out / f"swap_{i1}_{i2}", gt))
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main(sys.argv[1])
