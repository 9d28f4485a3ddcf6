"""Camera-row sharding: the block-cyclic camera assignment and a CG on a
dense reduced camera system whose rows and state are sharded.

Port of ``pycolmap_tpu/parallel/camera_sharding.py``. The point-sharded
solver (``sfm/ba_kernels.py``) keeps the camera system whole on every
shard; this module keeps the level-2 building block of the reference's
two-level Schur design: the camera-side state (S's rows, the CG vectors,
the diagonal preconditioner) row-sharded over a :class:`ShardMesh`, so a
shard holds O(I / shards) of it. Each CG iteration gathers x (the
reference's ``all_gather``) and sums two scalars over the shards (its
``psum``s). No solver of the port calls it: the reference's production
path does not either.

Block-cyclic assignment keeps neighbouring cameras, which share points and
so couple in S, on different shards.
"""

from __future__ import annotations

import numpy as np
import torch

from pycolmap_torch.parallel.device_ctx import ShardMesh


def assign_cameras_block_cyclic(num_cameras: int, num_shards: int,
                                block: int = 8) -> np.ndarray:
    """[num_cameras] shard index per camera, block-cyclic with `block`."""
    blocks = (num_cameras + block - 1) // block
    shard_of_block = np.arange(blocks) % num_shards
    return np.repeat(shard_of_block, block)[:num_cameras]


def shard_rows(arr, mesh: ShardMesh) -> list:
    """Row-shard [I, ...] camera-major state over the mesh: I padded with
    zero rows to a multiple of ``mesh.size``, and this process's shards'
    row blocks, each on its shard's device."""
    arr = torch.as_tensor(np.asarray(arr))
    n = mesh.size
    rows = -(-arr.shape[0] // n)
    pad = rows * n - arr.shape[0]
    if pad:
        arr = torch.cat([arr, arr.new_zeros((pad,) + tuple(arr.shape[1:]))])
    return [arr[mesh.shard_index(k) * rows:(mesh.shard_index(k) + 1) * rows]
            .to(d) for k, d in enumerate(mesh.devices)]


def two_level_schur_solve(S, rhs, mesh: ShardMesh, cg_iters: int = 64,
                          eta: float = 1e-6) -> np.ndarray:
    """CG on a dense reduced camera system with row-sharded state.

    S [D, D], rhs [D]. S's rows, the diagonal preconditioner and every CG
    vector are row-sharded over the mesh (D padded to a multiple of the
    shard count, identity rows on the padding). Each iteration gathers x
    (a zero-filled full vector summed over the shards) for each shard's
    row block times x, and sums the two CG scalars over the shards; the
    stop test reads only those sums, so every rank takes the same branch.
    Returns x [D] as float32 numpy, the same on every rank.
    """
    n = mesh.size
    D = S.shape[0]
    D_pad = -(-D // n) * n
    S_p = np.zeros((D_pad, D_pad), np.float32)
    S_p[:D, :D] = np.asarray(S, np.float32)
    # identity rows on padding keep the system non-singular
    for k in range(D, D_pad):
        S_p[k, k] = 1.0
    rhs_p = np.zeros(D_pad, np.float32)
    rhs_p[:D] = np.asarray(rhs, np.float32)
    S_l = shard_rows(S_p, mesh)  # [D_pad / n, D_pad] each
    rhs_l = shard_rows(rhs_p, mesh)
    r = D_pad // n
    starts = [mesh.shard_index(k) * r for k in range(mesh.local_size)]
    dev0 = mesh.devices[0]

    pre_l = []
    for S_loc, c0 in zip(S_l, starts):
        diag = torch.diagonal(S_loc[:, c0:c0 + r])
        pre_l.append(1.0 / torch.where(torch.abs(diag) < 1e-12,
                                       torch.ones_like(diag), diag))

    def gather(x_l):
        """The full vector from every shard's block: this process's blocks
        in a zero-filled vector, summed over the group."""
        full = torch.zeros(D_pad, device=dev0)
        for x, c0 in zip(x_l, starts):
            full[c0:c0 + r] = x.to(dev0)
        return mesh.reduce([full])

    def dot(a_l, b_l):
        return mesh.reduce([torch.sum(a * b) for a, b in zip(a_l, b_l)])

    x_l = [torch.zeros_like(b) for b in rhs_l]
    r_l = list(rhs_l)
    p_l = [pre * b for pre, b in zip(pre_l, rhs_l)]
    rz = rz0 = dot(r_l, p_l)
    it = 0
    while it < cg_iters and bool(rz > eta * eta * rz0):
        p_full = gather(p_l)
        Ap_l = [S_loc @ p_full.to(S_loc.device) for S_loc in S_l]
        pAp = dot(p_l, Ap_l)
        alpha = rz / torch.where(torch.abs(pAp) < 1e-20,
                                 torch.full_like(pAp, 1e-20), pAp)
        x_l = [x + alpha.to(x.device) * p for x, p in zip(x_l, p_l)]
        r_l = [q - alpha.to(q.device) * Ap for q, Ap in zip(r_l, Ap_l)]
        z_l = [pre * q for pre, q in zip(pre_l, r_l)]
        rz_new = dot(r_l, z_l)
        beta = rz_new / torch.where(torch.abs(rz) < 1e-20,
                                    torch.full_like(rz, 1e-20), rz)
        p_l = [z + beta.to(z.device) * p for z, p in zip(z_l, p_l)]
        rz = rz_new
        it += 1
    return gather(x_l).cpu().numpy()[:D]
