"""Multi-process distribution: process init, work partitioning, database
shards and their merge.

Port of ``pycolmap_tpu/parallel/distributed.py``. The cross-process layer:

- ``init_distributed``: a ``torch.distributed`` process group (NCCL on
  cards, gloo for CPU processes or several processes on one card); a
  ShardMesh over it shards BA across the processes;
- deterministic partitioning of images (data-parallel extraction) and of
  image pairs (pair-parallel matching and verification);
- database shards and their merge: each process extracts or matches into
  its own SQLite shard (one writer per file: SQLite has no cross-host
  locking), then the shards merge into the database the mapper reads.
  The merged database holds what one process's run over the same inputs
  writes.

One process makes the calls no-ops or identity partitions, so the same
launch script runs anywhere.
"""

from __future__ import annotations

import datetime
import os
from pathlib import Path

import torch
import torch.distributed as dist

from pycolmap_torch.scene import Database, DatabaseTransaction


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    backend: str | None = None,
    timeout_s: float = 300.0,
):
    """Join a ``torch.distributed`` process group (a no-op for one
    process). Returns (process_id, num_processes).

    The arguments default to torchrun's environment: ``MASTER_ADDR`` /
    ``MASTER_PORT`` for ``coordinator_address`` ("host:port"),
    ``WORLD_SIZE`` and ``RANK``. backend None is ``"nccl"`` (a host without
    CUDA raises); pass ``"gloo"`` for CPU processes or for several
    processes on one card (NCCL refuses two ranks on one device). A
    collective that waits longer than ``timeout_s`` fails instead of
    hanging. A process already in a group returns its rank and size.
    """
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    num = num_processes or int(os.environ.get("WORLD_SIZE", "1"))
    if num <= 1:
        return 0, 1
    if backend is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: the NCCL backend needs CUDA and this host "
                "has none; pass backend='gloo' for CPU processes")
        backend = "nccl"
    address = coordinator_address or (
        f"{os.environ.get('MASTER_ADDR', '127.0.0.1')}:"
        f"{os.environ['MASTER_PORT']}")
    rank = (process_id if process_id is not None
            else int(os.environ.get("RANK", "0")))
    dist.init_process_group(
        backend, init_method=f"tcp://{address}", world_size=num, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_rank(), dist.get_world_size()


def barrier() -> None:
    """Wait for every process of the default group (a no-op without one);
    the reference's ``sync_global_devices``."""
    if dist.is_initialized():
        dist.barrier()


def partition_round_robin(items, num_shards: int, shard_idx: int):
    """Deterministic round-robin shard of a sequence (order-preserving)."""
    if num_shards <= 1:
        return list(items)
    return [x for k, x in enumerate(items) if k % num_shards == shard_idx]


def partition_pairs(pairs, num_shards: int, shard_idx: int):
    """Shard an image-pair list, balancing by position.

    Pair lists from the pairing strategies are roughly cost-uniform, so
    round-robin keeps per-shard work balanced without a cost model.
    """
    return partition_round_robin(pairs, num_shards, shard_idx)


def shard_database_path(database_path, shard_idx: int) -> Path:
    """Canonical per-process shard path: <db>.shard<k>."""
    p = Path(database_path)
    return p.with_name(p.name + f".shard{shard_idx}")


_BLOB_COLUMNS = "rows, cols, data"


def _merge_tables(database_path, shard_paths, tables):
    """Copy every row of `tables` ((name, columns)) from each shard into
    the canonical database, a shard's row replacing an equal key."""
    dst = Database(database_path)
    try:
        with DatabaseTransaction(dst):
            for sp in shard_paths:
                src = Database(sp)
                try:
                    for name, columns in tables:
                        rows = src._conn.execute(
                            f"SELECT {columns} FROM {name}").fetchall()
                        marks = ", ".join("?" * len(columns.split(",")))
                        dst._conn.executemany(
                            f"INSERT OR REPLACE INTO {name} VALUES ({marks})",
                            rows)
                finally:
                    src.close()
    finally:
        dst.close()


def merge_feature_shards(database_path, shard_paths):
    """Merge per-process keypoint / descriptor shards into the canonical
    database.

    Image and camera rows must already exist in the canonical database
    (written by import_images before sharding); shards contribute only the
    feature blobs of the images their process extracted.
    """
    columns = f"image_id, {_BLOB_COLUMNS}"
    _merge_tables(database_path, shard_paths,
                  (("keypoints", columns), ("descriptors", columns)))


def merge_match_shards(database_path, shard_paths):
    """Merge per-process matches / two_view_geometries shards."""
    _merge_tables(database_path, shard_paths, (
        ("matches", f"pair_id, {_BLOB_COLUMNS}"),
        ("two_view_geometries",
         f"pair_id, {_BLOB_COLUMNS}, config, F, E, H, qvec, tvec")))


def make_feature_shard(database_path, shard_idx: int) -> Path:
    """Create an empty shard database carrying the canonical image and
    camera rows (so shard writers can resolve image ids without touching
    the main database)."""
    shard = shard_database_path(database_path, shard_idx)
    if shard.exists():
        shard.unlink()
    src = Database(database_path)
    dst = Database(shard)
    try:
        with DatabaseTransaction(dst):
            for cam in src.read_all_cameras():
                dst.write_camera(cam, use_camera_id=True)
            for img in src.read_all_images():
                dst.write_image(img, use_image_id=True)
    finally:
        src.close()
        dst.close()
    return shard


def extract_features_sharded(
    database_path,
    image_path,
    process_id: int = 0,
    num_processes: int = 1,
    device=None,
    **extract_kwargs,
):
    """Data-parallel extraction: this process extracts its share of the
    images into <db>.shard<k>. Run on every process, then
    ``merge_feature_shards`` on one. One process: plain
    ``extract_features`` into the main database. Runs on ``device``
    (default: the card)."""
    from pycolmap_torch.pipeline.extract_features import extract_features

    if num_processes <= 1:
        return extract_features(database_path, image_path, device=device,
                                **extract_kwargs)

    # images must be imported once (idempotent) before sharding
    db = Database(database_path)
    try:
        names = sorted(img.name for img in db.read_all_images())
    finally:
        db.close()
    mine = partition_round_robin(names, num_processes, process_id)
    shard = make_feature_shard(database_path, process_id)
    return extract_features(shard, image_path, image_names=mine,
                            device=device, **extract_kwargs)


def match_exhaustive_sharded(
    database_path,
    process_id: int = 0,
    num_processes: int = 1,
    sift_options=None,
    verification_options=None,
    device=None,
):
    """Pair-parallel matching: this process matches and verifies its
    share of the exhaustive pair list, reading features from the canonical
    database and writing matches and two-view geometries into
    <db>.shard<k>. Run on every process, then ``merge_match_shards`` on
    one. Runs on ``device`` (default: the card)."""
    from pycolmap_torch import resolve_device
    from pycolmap_torch.estimators.two_view_geometry import (
        TwoViewGeometryOptions,
    )
    from pycolmap_torch.features.matcher import SiftMatchingOptions
    from pycolmap_torch.pipeline.match_features import (
        _match_and_verify_pairs,
        match_exhaustive,
    )

    if num_processes <= 1:
        return match_exhaustive(database_path, device=device)

    device = resolve_device(device)
    db = Database(database_path)
    try:
        image_ids = sorted(img.image_id for img in db.read_all_images())
        pairs = [
            (i, j) for k, i in enumerate(image_ids) for j in image_ids[k + 1:]
        ]
        mine = partition_pairs(pairs, num_processes, process_id)
        shard = shard_database_path(database_path, process_id)
        if shard.exists():
            shard.unlink()
        out = Database(shard)
        try:
            return _match_and_verify_pairs(
                db,
                mine,
                sift_options or SiftMatchingOptions(),
                verification_options or TwoViewGeometryOptions(),
                device,
                db_out=out,
            )
        finally:
            out.close()
    finally:
        db.close()
