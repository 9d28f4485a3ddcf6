"""One rank of the two-process sharded BA test (tests/test_torch_distributed.py).

Usage: python tests/torch_ba_worker.py OUT_DIR RANK WORLD PORT

Joins a gloo process group at 127.0.0.1:PORT and solves the bundle that
the test builds from the same seed with ``solve_bundle(..., mesh=...)``
twice: holding one CPU shard of a mesh over the group, then two. Writes
each solve's summary, quaternions, translations and points to
OUT_DIR/ba<SHARDS>_rank<RANK>.npz (SHARDS over all ranks). Pins one
intra-op thread, as the test does, so the ranks' float sums run in one
order.
"""

import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from pycolmap_torch.parallel.device_ctx import ShardMesh  # noqa: E402
from pycolmap_torch.parallel.distributed import (  # noqa: E402
    barrier,
    init_distributed,
)
from pycolmap_torch.parallel.synthetic import (  # noqa: E402
    make_synthetic_bundle,
)
from pycolmap_torch.sfm.bundle_adjustment import (  # noqa: E402
    BundleAdjustmentOptions,
    solve_bundle,
)

SYN = dict(num_images=16, num_points=1536, obs_per_point=4, pose_noise=0.05,
           point_noise=0.1, refine_intrinsics=True, seed=0)
ITERS, CG_ITERS = 4, 10


def solve(mesh):
    options = BundleAdjustmentOptions()
    options.max_num_iterations = ITERS
    options.print_summary = False
    return solve_bundle(make_synthetic_bundle(**SYN), options,
                        cg_iters=CG_ITERS, mesh=mesh)


def main():
    out, rank, world, port = (Path(sys.argv[1]), int(sys.argv[2]),
                              int(sys.argv[3]), int(sys.argv[4]))
    torch.set_num_threads(1)
    got = init_distributed(f"127.0.0.1:{port}", world, rank, backend="gloo",
                           timeout_s=60.0)
    if got != (rank, world):
        raise RuntimeError(f"rank {rank}: joined as {got}")
    import torch.distributed as dist

    try:
        for local in (1, 2):
            mesh = ShardMesh(["cpu"] * local, group=dist.group.WORLD)
            problem, s = solve(mesh)
            np.savez(out / f"ba{mesh.size}_rank{rank}.npz",
                     summary=np.array([s.initial_cost, s.final_cost,
                                       s.num_iterations], np.float64),
                     cam_quat=problem.cam_quat.numpy(),
                     cam_trans=problem.cam_trans.numpy(),
                     points=problem.points.numpy())
        barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
