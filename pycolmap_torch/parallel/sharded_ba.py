"""Distributed bundle adjustment over a shard mesh.

Port of ``pycolmap_tpu/parallel/sharded_ba.py``. The solver in
``sfm/ba_kernels.py`` shards the point axis: each shard owns a contiguous
slice of every bucket's point columns (a point and all its observations
live in one column), eliminates its own points, and the reduced camera
system is summed over the shards (``ShardMesh.reduce``), where the
reference's XLA inserts ``psum``s. Distributed solves go through the
public path: ``solve_bundle(problem, options, mesh=...)`` or
``options.devices``.

``shard_bundle_problem`` returns the padded problem as host tensors: the
solver places each shard's bucket columns on its device itself, as the
reference's solver re-bucketizes from host arrays.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from pycolmap_torch.parallel.device_ctx import ShardMesh
from pycolmap_torch.sfm.bundle_adjustment import BundleProblem


def make_obs_mesh(devices=None, group=None) -> ShardMesh:
    """A ShardMesh over ``devices`` (None: every local card; a host
    without CUDA raises, as ``resolve_device`` does) and an optional
    process group."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_obs_mesh() takes every local card and this host has "
                "none; pass devices=['cpu', ...] for CPU shards")
        devices = [torch.device("cuda", k)
                   for k in range(torch.cuda.device_count())]
    return ShardMesh(devices, group=group)


def pad_observations(problem: BundleProblem, multiple: int) -> BundleProblem:
    """Pad the observation axis to a multiple with masked-out rows."""
    m = problem.num_obs
    m_pad = ((m + multiple - 1) // multiple) * multiple
    if m_pad == m:
        return problem
    pad = m_pad - m

    def pad_arr(a):
        a = torch.as_tensor(a)
        return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])

    return problem._replace(
        obs_image_idx=pad_arr(problem.obs_image_idx),
        obs_camera_idx=pad_arr(problem.obs_camera_idx),
        obs_point_idx=pad_arr(problem.obs_point_idx),
        obs_xy=pad_arr(problem.obs_xy),
        obs_mask=pad_arr(problem.obs_mask),
    )


def shard_bundle_problem(problem: BundleProblem,
                         mesh: ShardMesh) -> BundleProblem:
    """The problem padded to a multiple of the mesh's shard count, as host
    tensors: the solver places each shard's point columns itself."""
    return pad_observations(problem, mesh.size)


def dryrun_multichip(n_devices: int) -> dict:
    """``solve_bundle`` on an ``n_devices``-shard mesh of the C3 problem
    (128 images / 100k points / 6 observations a point, intrinsics
    refined), then two chained ``ResidentBundleSolver`` solves on the same
    mesh. With fewer cards than shards the shards cycle over the cards
    there are; a host without CUDA raises. Returns the costs and seconds
    of the three solves; raises RuntimeError where a cost is not finite or
    the chained solve does not start where the first ended."""
    from pycolmap_torch.parallel.synthetic import make_synthetic_bundle
    from pycolmap_torch.sfm.bundle_adjustment import (
        BundleAdjustmentOptions,
        solve_bundle,
    )
    from pycolmap_torch.sfm.resident import ResidentBundleSolver

    if not torch.cuda.is_available():
        raise RuntimeError("dryrun_multichip needs a CUDA card")
    count = torch.cuda.device_count()
    mesh = make_obs_mesh([f"cuda:{k % count}" for k in range(n_devices)])
    problem = make_synthetic_bundle(
        num_images=128, num_points=100_000, obs_per_point=6,
        refine_intrinsics=True,
    )
    options = BundleAdjustmentOptions()
    options.max_num_iterations = 2
    options.print_summary = False
    out = {}
    t0 = time.perf_counter()
    _, summary = solve_bundle(problem, options, cg_iters=5, mesh=mesh)
    out["solve_bundle"] = dict(initial_cost=summary.initial_cost,
                               final_cost=summary.final_cost,
                               s=time.perf_counter() - t0)
    if not np.isfinite(summary.final_cost):
        raise RuntimeError(f"dryrun_multichip: solve_bundle gave {summary}")

    # the resident path: the shards' point planes stay on their devices
    # across chained re-solves
    t0 = time.perf_counter()
    solver = ResidentBundleSolver(problem, options, cg_iters=5, mesh=mesh)
    s1 = solver.solve()
    s2 = solver.solve()
    fetched = solver.fetch_problem()
    out["resident"] = dict(first=s1._asdict(), second=s2._asdict(),
                           s=time.perf_counter() - t0)
    if not (np.isfinite(s2.final_cost)
            and s2.initial_cost <= s1.final_cost * 1.01
            and bool(torch.isfinite(fetched.points).all())):
        raise RuntimeError(f"dryrun_multichip: chained solves {s1}, {s2}")
    return out
