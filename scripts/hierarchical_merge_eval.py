"""Evaluate hierarchical mapping's merge on chip_smoke.py phase 24's scene.

    python scripts/hierarchical_merge_eval.py run OUT    # on the card
    python scripts/hierarchical_merge_eval.py eval OUT   # anywhere

``run`` writes phase 24's 90-image / 12,000-point sequential database and
maps it with ``hierarchical_mapping`` in 3 parts (overlap 6) on the card,
keeping the part models and the truth under OUT. ``eval`` re-merges the
part models two ways on the CPU, by the common images' projection centers
(the JAX package's merge) and by the common 3D points (the port's), and
prints for each part and each merge: registered images, mean reprojection
error, rotation errors after the similarity of the projection centers
(``pose_errors``, as phase 24 checks), after the rotation that best maps
the model's orientations onto the truth's, and between neighbouring
images (gauge-free), and the center errors.
"""

import copy
import sys
from pathlib import Path
from unittest import mock

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import pycolmap_torch as pt  # noqa: E402
from pycolmap_torch.estimators import alignment  # noqa: E402
from pycolmap_torch.parallel import graph_partition as gp  # noqa: E402


def run(out):
    from pycolmap_torch import _cuda_build

    _cuda_build.libs()
    out.mkdir(parents=True, exist_ok=True)
    gt = cs.write_sequential_database(out / "db.db", cs.HIER_IMAGES,
                                      cs.HIER_POINTS, cs.HIER_NOISE)[0]
    gt.write_binary(out / "gt")
    pt.hierarchical_mapping(out / "db.db", out, out / "hier", cs.HIER_PARTS,
                            cs.HIER_OVERLAP, options=cs.mapping_options(),
                            device="cuda")


def _angle(D):
    return np.degrees(np.arccos(np.clip((np.trace(D) - 1) / 2, -1, 1)))


def evaluate(rec, gt, tag):
    truth = {im.name: im for im in gt.images.values()}
    ims = sorted((rec.images[i] for i in rec.reg_image_ids),
                 key=lambda im: im.name)
    R = {im.name: im.cam_from_world.rotation.matrix() for im in ims}
    Rt = {im.name: truth[im.name].cam_from_world.rotation.matrix()
          for im in ims}
    neighbour = [_angle((R[a.name] @ R[b.name].T)
                        @ (Rt[a.name] @ Rt[b.name].T).T)
                 for a, b in zip(ims, ims[1:])]
    U, _, Vt = np.linalg.svd(sum(Rt[n].T @ R[n] for n in R))
    A = U @ np.diag([1, 1, np.linalg.det(U @ Vt)]) @ Vt
    oriented = [_angle(A.T @ Rt[n].T @ R[n]) for n in R]
    rot, ctr = cs.pose_errors(rec, gt)
    print(f"{tag}: {rec.num_reg_images} registered, "
          f"{rec.compute_mean_reprojection_error():.3f} px; rotation "
          f"(center similarity) median {np.median(rot):.3f} max "
          f"{rot.max():.3f}; (orientation-aligned) median "
          f"{np.median(oriented):.3f} max {max(oriented):.3f}; neighbours "
          f"median {np.median(neighbour):.4f} max {max(neighbour):.4f}; "
          f"centers median {np.median(ctr):.4f} max {ctr.max():.4f}")


def evaluate_all(out):
    gt = pt.Reconstruction(out / "gt")
    parts = []
    for part in sorted((out / "hier").glob("part*")):
        recs = [pt.Reconstruction(m) for m in sorted(part.iterdir())]
        best = max(recs, key=lambda r: r.num_reg_images)
        evaluate(best, gt, part.name)
        parts.append(best)
    parts.sort(key=lambda r: -r.num_reg_images)
    by_points = alignment.align_reconstructions_via_points
    for tag, align in (("merged by centers", lambda *a, **k: None),
                       ("merged by points", by_points)):
        base = copy.deepcopy(parts[0])
        pending = [copy.deepcopy(p) for p in parts[1:]]
        with mock.patch.object(alignment, "align_reconstructions_via_points",
                               align):
            progress = True
            while pending and progress:
                progress = False
                for sub in list(pending):
                    if gp.merge_reconstructions(base, sub, device="cpu"):
                        pending.remove(sub)
                        progress = True
        evaluate(base, gt, tag)


if __name__ == "__main__":
    mode, out = sys.argv[1], Path(sys.argv[2])
    run(out) if mode == "run" else evaluate_all(out)
