"""The port's PatchMatch loop (pycolmap_torch/mvs/patch_match.py, plain
versions on the CPU) against the reference's, on outcomes.

The port draws its random candidates from a ``torch.Generator``, the
reference from ``jax.random`` keys, so the two runs try different planes
and are compared on what they reach (cost, depth error against ground
truth), not bit for bit. The port draws its random depths per pixel, as the
reference's XLA path (its CPU path) does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pycolmap_tpu.mvs import controller as ctl_ref
from pycolmap_tpu.mvs import patch_match as pm_ref
from pycolmap_tpu.mvs.workspace import MVSModel
from pycolmap_torch.mvs import patch_match as pm

from test_mvs import build_workspace
from test_pm_kernels import _scene


@pytest.fixture(autouse=True)
def _one_thread():
    """One PyTorch intra-op thread per test: the suite runs test files in
    parallel workers, where every worker's thread pool would contend for
    the host's cores (a 20 s test took 21 minutes so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))


def test_zero_motion_scene_keeps_low_cost():
    """The reference's test_patch_match_kernel_pallas_end_to_end scene:
    identity-pose sources equal to the reference keep a low interior
    cost."""
    H, W, K = 40, 60, 2
    ref, _, rays, Kmat, _, _ = _scene(H, W, K)
    depth0 = np.full((H, W), 5.0, np.float32)
    normal0 = -rays / np.linalg.norm(rays, axis=0)
    depth, normal, cost = pm.patch_match_kernel(
        torch.Generator().manual_seed(0), _t(ref), _t(np.stack([ref] * K)),
        _t(rays), _t(np.stack([Kmat] * K)), _t(np.stack([np.eye(3)] * K)),
        torch.zeros(K, 3), _t(depth0), _t(normal0), 1.0, 10.0, 0.2, 0.6,
        1, 2, 2, Kr=_t(Kmat))
    assert depth.shape == (H, W) and normal.shape == (3, H, W)
    assert np.median(cost.numpy()[4:-4, 4:-4]) < 0.5


def _plane_depth(m, K, H, W):
    """Ground-truth depth of build_workspace's two planes (z = 6 owns
    x < 0.15, z = 7.5 the rest) through calibration K of image m."""
    R_cw = m.R.T
    c = -m.R.T @ m.t
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack([(xx + 0.5 - K[0, 2]) / K[0, 0],
                     (yy + 0.5 - K[1, 2]) / K[1, 1], np.ones_like(xx)],
                    -1) @ R_cw.T
    gt = np.full((H, W), np.nan)
    for z0, left in ((6.0, True), (7.5, False)):
        t = (z0 - c[2]) / dirs[..., 2]
        px = c[0] + t * dirs[..., 0]
        sel = ((px < 0.15) if left else (px >= 0.15)) & (t > 0)
        gt[sel] = t[sel]
    return gt


def test_two_plane_depth_error_within_reference(tmp_path):
    """Photometric PatchMatch of build_workspace's center view from the
    reference controller's inputs and initial depths: the port's median
    relative depth error is within 1.5x the reference's."""
    ws, _, _ = build_workspace(tmp_path, num_images=4, W=128, H=96)
    model = MVSModel(ws)
    images = {iid: ctl_ref._prepare_image_data(model, iid, ws / "images", -1)
              for iid in model.images}
    images = {k: (v[0].astype(np.float32), v[1]) for k, v in images.items()}
    iid = 2  # view01
    m, ref, Kr, srcs, Ks, R_rel, t_rel, rays = ctl_ref._image_problem(
        model, images, iid)
    H, W = ref.shape
    rng = np.random.default_rng(iid)
    base = rng.uniform(m.depth_min, m.depth_max, (-(-H // 8), -(-W // 128)))
    depth0 = np.clip(np.repeat(np.repeat(base, 8, 0), 128, 1)[:H, :W]
                     * rng.uniform(0.9, 1.1, (H, W)), m.depth_min,
                     m.depth_max).astype(np.float32)
    normal0 = (-rays / np.linalg.norm(rays, axis=0)).astype(np.float32)
    args = (ref, srcs, rays, Ks, R_rel, t_rel, depth0, normal0)
    iters, radius, step = 3, 2, 2

    d_ref, _, _ = pm_ref.patch_match_kernel(
        jax.random.PRNGKey(iid), *(jnp.asarray(a) for a in args),
        jnp.float32(m.depth_min), jnp.float32(m.depth_max),
        jnp.float32(0.2), jnp.float32(0.6), iters, radius, step,
        Kr=jnp.asarray(Kr.astype(np.float32)), pallas=False)
    d_port, _, _ = pm.patch_match_kernel(
        torch.Generator().manual_seed(iid), *(_t(a) for a in args),
        m.depth_min, m.depth_max, 0.2, 0.6, iters, radius, step, Kr=_t(Kr))

    gt = _plane_depth(m, Kr, H, W)
    ok = np.isfinite(gt)
    errs = [np.median(np.abs(np.asarray(d)[ok] - gt[ok]) / gt[ok])
            for d in (d_ref, d_port.numpy())]
    assert errs[0] < 0.1, errs  # 0.064 after three iterations
    assert errs[1] <= 1.5 * errs[0], errs
