"""The shard mesh of point-sharded bundle adjustment, and the default-mesh
resolution of the public pipeline.

Port of ``pycolmap_tpu/parallel/device_ctx.py``. The reference's mesh is a
1-D ``jax.sharding.Mesh`` over ``("obs",)``; its counterpart here is
:class:`ShardMesh`: this process's shards in order, as ``torch.device``s
(repeats allowed: two shards on ``cuda:0`` stand in for the reference's
virtual devices, four ``cpu`` shards serve the tests), and an optional
``torch.distributed`` process group whose every rank holds as many shards.
Where XLA inserts a ``psum``, the solver calls :meth:`ShardMesh.reduce`.

``resolve_mesh`` turns an options value (``"auto"``, ``"none"``, a shard
count, or a mesh) into the mesh a BA solve uses, with the reference's
rules; ``"auto"``, the default everywhere:
- a default mesh set by :func:`set_default_mesh` wins;
- else, with an initialized WORLD group of more than one rank, one shard
  per rank, on the card the entry point names (this rank's current card
  where it names none);
- else, where the entry point names one card (``"cuda:1"``), no mesh:
  that card alone;
- else every local card, where there are more than one;
- else (one card, or the CPU) no mesh.
The reference's entry points have no ``device``; the named-card rule is
the port's, so that a solve asked for one card runs on it on a host of
several.
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import torch
import torch.distributed as dist

from pycolmap_torch import resolve_device

_default_mesh = None


class ShardMesh:
    """Point shards of a BA solve: this process's devices and a group.

    devices: this process's shards in order (strings or ``torch.device``;
    a CUDA device without an index means the current card). group: a
    ``torch.distributed`` process group, or None for one process; every
    rank holds ``len(devices)`` shards, and rank r's shard k is the mesh's
    shard ``r * len(devices) + k``.
    """

    def __init__(self, devices: Sequence, group=None):
        devs = []
        for d in devices:
            d = resolve_device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a ShardMesh needs at least one device")
        self.devices = tuple(devs)
        self.group = group

    @property
    def local_size(self) -> int:
        return len(self.devices)

    @property
    def rank(self) -> int:
        """This process's index in the group (0 without one)."""
        return 0 if self.group is None else dist.get_rank(self.group)

    @property
    def num_processes(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)

    @property
    def size(self) -> int:
        """Shards over all ranks."""
        return self.local_size * self.num_processes

    def shard_index(self, k: int) -> int:
        """The mesh index of this process's k-th shard."""
        return self.rank * self.local_size + k

    def key(self) -> tuple:
        """The mesh by content (devices, group ranks, shape), for caches: a
        new mesh of the same layout shares their entries, a dead mesh's
        reused ``id()`` never does."""
        ranks = (None if self.group is None
                 else tuple(dist.get_process_group_ranks(self.group)))
        return (tuple(str(d) for d in self.devices), ranks,
                (self.num_processes, self.local_size))

    def reduce(self, parts):
        """Sum one partial per local shard: a tensor each, or a tuple of
        tensors each. The local partials are added on the first local
        device in shard order, then summed over the group by one
        ``all_reduce`` (a tuple's tensors travel in one flat buffer).
        Returns what one partial is, on ``devices[0]``, equal on every
        rank."""
        single = torch.is_tensor(parts[0])
        rows = [(p,) if single else tuple(p) for p in parts]
        dev = self.devices[0]
        out = [t.to(dev) for t in rows[0]]
        for row in rows[1:]:
            out = [a + b.to(dev) for a, b in zip(out, row)]
        if self.group is not None:
            flat = torch.cat([t.reshape(-1) for t in out])
            dist.all_reduce(flat, group=self.group)
            out = [c.view_as(t) for c, t in
                   zip(flat.split([t.numel() for t in out]), out)]
        return out[0] if single else tuple(out)

    # a mesh is a handle: options that hold one copy by reference
    def __copy__(self):
        return self

    def __deepcopy__(self, memo):
        return self


def set_default_mesh(mesh) -> None:
    """Install a process-global default mesh (None clears it).

    Anything the pipeline solves after this call uses `mesh` wherever an
    options object says ``devices="auto"``.
    """
    global _default_mesh
    _default_mesh = mesh


def get_default_mesh():
    return _default_mesh


def _local_mesh(n: Optional[int] = None):
    count = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n is not None:
        if n > count:
            raise ValueError(
                f"devices={n} requested but only {count} available")
        count = n
    if count <= 1:
        return None
    return ShardMesh([torch.device("cuda", k) for k in range(count)])


def resolve_mesh(spec: Union[str, int, None, ShardMesh] = "auto",
                 device=None):
    """Resolve a ``devices`` option value to a ShardMesh or None (one
    device).

    spec:
      - ShardMesh       -> itself
      - "none"/"off"/"single"/"0"/"1"/0/1/None -> None
      - int n > 1       -> one shard on each of the first n local cards
                           (ValueError where there are fewer)
      - "auto"/-1       -> the default mesh if set; else one shard per rank
                           of an initialized WORLD group of more than one
                           rank; else None where `device` names one card;
                           else every local card where there are more than
                           one; else None

    device: the entry point's device; on the CPU (``"cpu"``, or None on a
    host without CUDA) ``"auto"`` resolves to the default mesh or None. A
    card with an index (``"cuda:1"``) is the rank's shard in a group, and
    no mesh without one.
    """
    if isinstance(spec, ShardMesh):
        return spec
    if spec is None:
        return None
    if isinstance(spec, str):
        s = spec.lower()
        if s in ("none", "off", "single", "0", "1"):
            return None
        spec = -1 if s == "auto" else int(s)
    if spec == -1:
        if _default_mesh is not None:
            return _default_mesh
        want = None if device is None else resolve_device(device)
        if (want is None and not torch.cuda.is_available()) or (
                want is not None and want.type == "cpu"):
            return None
        named = want is not None and want.index is not None
        if dist.is_available() and dist.is_initialized() \
                and dist.get_world_size() > 1:
            return ShardMesh(
                [want if named
                 else torch.device("cuda", torch.cuda.current_device())],
                group=dist.group.WORLD)
        return None if named else _local_mesh()
    if spec in (0, 1):
        return None
    return _local_mesh(int(spec))


def mesh_device(mesh, device=None) -> torch.device:
    """The device of a solve's camera system: the mesh's first device, or
    the resolved ``device`` without a mesh. A ``device`` that a mesh's
    devices disagree with (another type, or another index where it names
    one) raises ValueError."""
    if mesh is None:
        return resolve_device(device)
    if device is not None:
        want = resolve_device(device)
        for d in mesh.devices:
            if d.type != want.type or (want.index is not None
                                       and d.index != want.index):
                raise ValueError(f"device {want} disagrees with the mesh's "
                                 f"device {d}")
    return mesh.devices[0]
