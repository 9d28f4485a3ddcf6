"""How much an LO-RANSAC outcome depends on its random stream, in the JAX
package and in the port, on the CPU. Not a test (pytest does not collect
it): run it from the repository root,

    python tests/estimator_streams.py

It prints, per stream (the engine's seed):

1. the essential estimator's rotation error against the truth on
   tests/test_estimators.py's fixture (200 matches, 20% outliers, 0.5 px
   noise): the reference for seeds 0-7, the port for seeds 0-11;
2. on the CPU SIFT matches of an image and its 5-px shift (chip_smoke.py
   phase 8's first pair, at run_sift's 960x1280), the homography
   estimator's inliers and how far H moves the image corners off the
   shift, at the default 4-px threshold: the reference for seeds 0-3, the
   port for seeds 0-5; then the weighted DLT of the port's seed-0 inliers
   (the LO refit) with its inlier count.

The reference's essential estimator takes ~35 s a stream here; the whole
script about 6 minutes.
"""

import copy
import sys
from pathlib import Path

import numpy as np
import torch

import jax

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]
jax.config.update("jax_platforms", "cpu")

import chip_smoke  # noqa: E402
from pycolmap_tpu.estimators import essential_matrix as jem  # noqa: E402
from pycolmap_tpu.estimators import homography_matrix as jhm  # noqa: E402
from pycolmap_tpu.ops import epipolar as jep  # noqa: E402
from pycolmap_torch.estimators import essential_matrix as tem  # noqa: E402
from pycolmap_torch.estimators import homography_matrix as thm  # noqa: E402
from pycolmap_torch.features import matcher as tmatch  # noqa: E402
from pycolmap_torch.features.sift import Sift  # noqa: E402
from pycolmap_torch.geometry import Rotation3d  # noqa: E402
from pycolmap_torch.ops import epipolar as tep  # noqa: E402
from pycolmap_torch.ops import solvers  # noqa: E402
from test_estimators import synth_two_view  # noqa: E402

CPU = torch.device("cpu")


def _rot_err(quat_wxyz, rel):
    q = np.asarray(quat_wxyz, np.float64)
    R = Rotation3d(np.array([q[1], q[2], q[3], q[0]]))
    return float(np.rad2deg(R.angle_to(Rotation3d(rel.rotation.quat))))


def essential_streams():
    cam, x1, x2, rel, _ = synth_two_view(outlier_ratio=0.2)
    opts = copy.deepcopy(jem.RANSACOptions())
    opts.max_error = 4.0 / cam.mean_focal_length()
    xn1 = np.asarray(cam.cam_from_img(x1), np.float32)
    xn2 = np.asarray(cam.cam_from_img(x2), np.float32)
    ref = []
    for seed in range(8):
        rep = jem._engine.estimate(opts, xn1, xn2, seed=seed)
        q = jep.pose_from_essential(
            jax.numpy.asarray(rep.model, jax.numpy.float32), xn1, xn2,
            rep.inlier_mask)[0]
        ref.append(_rot_err(q, rel))
    port = []
    topts = tem.RANSACOptions(max_error=opts.max_error)
    for seed in range(12):
        rep = tem._engine.estimate(topts, xn1, xn2, device=CPU, seed=seed)
        q = tep.pose_from_essential(
            torch.from_numpy(rep.model), torch.from_numpy(xn1),
            torch.from_numpy(xn2), torch.from_numpy(rep.inlier_mask))[0]
        port.append(_rot_err(q.numpy(), rel))
    print("essential rotation error, degrees, reference seeds 0-7:",
          np.round(ref, 3).tolist())
    print("essential rotation error, degrees, port seeds 0-11:",
          np.round(port, 3).tolist())


def homography_streams():
    img = chip_smoke.make_u8(0)
    sift = Sift(device="cpu")
    k1, d1 = sift.extract(img)
    k2, d2 = sift.extract(np.roll(img, 5, axis=1))
    m = tmatch.match_descriptors(d1, d2, device="cpu")
    x1 = k1[m[:, 0], :2].astype(np.float32)
    x2 = k2[m[:, 1], :2].astype(np.float32)
    corners = np.array([[0, 0, 1], [chip_smoke.SIFT_W, 0, 1],
                        [0, chip_smoke.SIFT_H, 1],
                        [chip_smoke.SIFT_W, chip_smoke.SIFT_H, 1]], float)

    def corner_err(H):
        p = corners @ np.asarray(H, np.float64).T
        return round(float(np.abs(p[:, :2] / p[:, 2:] - corners[:, :2]
                                  - [5.0, 0.0]).max()), 3)

    print(f"{len(m)} CPU SIFT matches of the 5-px-shifted pair")
    ref = [jhm._engine.estimate(jhm.RANSACOptions(), x1, x2, seed=s)
           for s in range(4)]
    print("homography (inliers, corner error px), reference seeds 0-3:",
          [(r.support_num_inliers, corner_err(r.model)) for r in ref])
    port = [thm._engine.estimate(thm.RANSACOptions(), x1, x2, device=CPU,
                                 seed=s) for s in range(6)]
    print("homography (inliers, corner error px), port seeds 0-5:",
          [(r.support_num_inliers, corner_err(r.model)) for r in port])
    t1, t2 = torch.from_numpy(x1), torch.from_numpy(x2)
    H = solvers.homography_dlt(
        t1[None], t2[None],
        torch.from_numpy(port[0].inlier_mask.astype(np.float32))[None])[0]
    res = thm._transfer_batched(H[None, None], t1, t2)[0, 0]
    print("DLT of the port's seed-0 inliers: inliers",
          int((res <= 16.0).sum()), "corner error px", corner_err(H.numpy()))


if __name__ == "__main__":
    torch.set_num_threads(4)
    essential_streams()
    homography_streams()
