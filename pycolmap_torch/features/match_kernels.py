"""Fused descriptor similarity + running top-2, with its CUDA kernel.

Port of ``pycolmap_tpu/features/pallas_kernels.py`` (the module holds no
Pallas, hence the new name). The brute-force matcher needs, per query row,
the best and second-best similarity over the target descriptors and the
best column. The kernel (``csrc/top2.cu``) folds each tile of the
similarity product into running (best, second, argbest) registers, so the
N1 x N2 matrix never reaches device memory; the plain version
(:func:`top2_plain`) materialises it.

Semantics (reference pallas_kernels.py:39-60): columns >= n2 read -2.0; on
equal maxima the lowest column wins; ``second`` is the largest similarity of
any other column, so an exact duplicate of the best gives second == best.

On the card one launch covers the batch: each pair's rows are cut into
tiles of ``TOP2_BM`` and each row tile's valid column tiles (``TOP2_BN``
wide) into ``top2_split`` shares, one block each; the last block of a row
tile merges the shares' states in order.

``LAUNCHES`` counts kernel launches; ``PLAIN_ON_CUDA`` counts calls of the
plain version on CUDA tensors (only ``chip_smoke.py``'s comparisons make
those). ``reset_counts()`` zeroes both.
"""

from __future__ import annotations

import torch

from pycolmap_torch.features import _cuda

LAUNCHES = {"top2": 0}
PLAIN_ON_CUDA = {"top2": 0}
TOP2_BM = 128  # rows per block (csrc/top2.cu BM)
TOP2_BN = 128  # columns per tile (BN)
TOP2_MAX_D = 160  # kMaxD: the staged rows of d1 fill shared memory
_tickets = {}  # per device: the row tiles' tickets, 0 between launches


def reset_counts() -> None:
    LAUNCHES["top2"] = 0
    PLAIN_ON_CUDA["top2"] = 0


def top2_plain(d1, d2, n2):
    """The kernel's function in PyTorch: d1 [B, N1, D], d2 [B, N2, D],
    n2 [B]. Returns (best, second [B, N1], idx [B, N1] int32)."""
    if d1.is_cuda:
        PLAIN_ON_CUDA["top2"] += 1
    B, N1, _ = d1.shape
    N2 = d2.shape[1]
    if N2 == 0:
        fill = torch.full((B, N1), -2.0, dtype=d1.dtype, device=d1.device)
        return fill, fill.clone(), torch.zeros((B, N1), dtype=torch.int32,
                                               device=d1.device)
    sim = torch.matmul(d1, d2.transpose(1, 2))
    col = torch.arange(N2, device=d1.device)
    n2 = torch.as_tensor(n2, device=d1.device).reshape(B, 1, 1)
    sim = torch.where(col < n2, sim, -2.0)
    best, idx = sim.max(dim=2)  # the first maximal column
    second = sim.scatter(2, idx[..., None], -2.0).amax(dim=2)
    return best, second, idx.to(torch.int32)


def top2_split(B, N1, N2, sms):
    """Column shares per row tile: the count that fills whole waves of
    `sms` blocks best, with each block's staging of its rows of d1 costed
    as half a column tile (the smallest count on a tie)."""
    row_tiles = B * -(-N1 // TOP2_BM)
    col_tiles = max(1, -(-N2 // TOP2_BN))
    return min(range(1, col_tiles + 1),
               key=lambda s: (-(-row_tiles * s // sms)
                              * (-(-col_tiles // s) + 0.5), s))


def top2_batch(d1, d2, n2):
    """d1 [B, N1, D], d2 [B, N2, D] f32 (unit-norm descriptors, D a
    multiple of 4 on the card), n2 [B] int valid columns per pair. Returns
    (best [B, N1], second [B, N1], idx [B, N1] int32). CUDA tensors launch
    the kernel once for the whole batch (D at most TOP2_MAX_D); CPU tensors
    run the plain version.
    """
    if d1.dim() != 3 or d2.dim() != 3 or d1.shape[0] != d2.shape[0] \
            or d1.shape[2] != d2.shape[2]:
        raise ValueError(f"top2 shapes: d1 {tuple(d1.shape)}, "
                         f"d2 {tuple(d2.shape)}")
    B, N1, D = d1.shape
    n2 = torch.as_tensor(n2, dtype=torch.int32, device=d1.device).reshape(B)
    if not d1.is_cuda:
        return top2_plain(d1, d2, n2)
    if D % 4 or not 4 <= D <= TOP2_MAX_D:
        raise ValueError(f"top2 kernel needs D % 4 == 0 and 4 <= D <= "
                         f"{TOP2_MAX_D}, got D = {D}")
    dev = d1.device
    best = torch.empty((B, N1), device=dev)
    second = torch.empty((B, N1), device=dev)
    idx = torch.empty((B, N1), dtype=torch.int32, device=dev)
    if B == 0 or N1 == 0:
        return best, second, idx
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    split = top2_split(B, N1, d2.shape[1], sms)
    part = torch.empty(3 * split * B * N1 if split > 1 else 1, device=dev)
    n_tickets = B * -(-N1 // TOP2_BM)
    tickets = _tickets.get(dev)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = _tickets[dev] = torch.zeros(n_tickets, dtype=torch.int32,
                                              device=dev)
    LAUNCHES["top2"] += 1
    _cuda.top2(d1.contiguous(), d2.contiguous(), n2.contiguous(), split,
               best, second, idx, part, tickets)
    return best, second, idx


def top2(d1, d2, n2):
    """One pair: d1 [N1, D], d2 [N2, D], n2 int. Returns (best [N1],
    second [N1], idx [N1] int32)."""
    best, second, idx = top2_batch(d1[None], d2[None], [int(n2)])
    return best[0], second[0], idx[0]


def match_top2(d1, d2, n1: int, n2: int):
    """The first n1 rows of top2 of d1 against the first n2 rows of d2
    (reference ``match_top2`` :128; the kernel masks ragged edges itself, so
    no tile padding). Returns (best [n1], second [n1], idx [n1])."""
    return top2(d1[:n1], d2[:n2], n2)
