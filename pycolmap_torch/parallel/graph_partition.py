"""Partitioned correspondence graph + hierarchical mapping.

Port of ``pycolmap_tpu/parallel/graph_partition.py`` (upstream
colmap/controllers/hierarchical_pipeline: cluster the scene, reconstruct
sub-models independently, then merge via similarity transforms):

- :func:`partition_images` — deterministic, connectivity-aware balanced
  partitioning of the image set over the pair graph (greedy weighted BFS
  growth from spread-out seeds; edge weight = correspondence count);
- :func:`expand_with_overlap` — add each partition's strongest-connected
  boundary images so neighboring sub-models share registered images (the
  merge anchors; analog of upstream SceneClustering image_overlap);
- :func:`merge_reconstructions` — Sim3 alignment of a sub-model onto the
  base (robust Umeyama on the common 3D points, on ``device``; on the
  common images' projection centers where the reference always aligns)
  followed by image/point union with track-claim dedup;
- :func:`hierarchical_mapping` — the driver: partition -> one
  ``incremental_mapping`` per partition on ``device`` -> merge.

The partitioning and the unions are host Python and numpy, the reference's
code, so the partitions are the reference's.
"""

from __future__ import annotations

import copy
import heapq
import time
from collections import defaultdict
from pathlib import Path

import numpy as np

from pycolmap_torch import resolve_device
from pycolmap_torch.scene.point2d import INVALID_POINT3D_ID


def partition_images(pair_counts: dict, image_ids, num_parts: int):
    """Balanced connectivity partitioning.

    pair_counts: {(id1, id2): num_correspondences}; image_ids: all images
    (including isolated ones). Returns a list of num_parts sorted id lists,
    covering every image exactly once, sizes within +-1 of balance where
    connectivity allows.
    """
    image_ids = sorted(image_ids)
    if num_parts <= 1 or len(image_ids) <= num_parts:
        return [list(image_ids)] + [[] for _ in range(num_parts - 1)]
    adj = defaultdict(dict)
    for (a, b), w in pair_counts.items():
        if w > 0:
            adj[a][b] = adj[a].get(b, 0) + int(w)
            adj[b][a] = adj[b].get(a, 0) + int(w)

    degree = {i: sum(adj[i].values()) for i in image_ids}
    cap = int(np.ceil(len(image_ids) / num_parts))

    # seeds: highest-degree image, then k-center farthest-point seeding by
    # BFS hop distance over the pair graph (direct-adjacency "least
    # connected" picks near neighbors on chain graphs and interleaves the
    # partitions)
    def bfs_dist(sources):
        from collections import deque

        dist = {s: 0 for s in sources}
        q = deque(sources)
        while q:
            u = q.popleft()
            for v in adj[u]:
                if v not in dist:
                    dist[v] = dist[u] + 1
                    q.append(v)
        return dist

    seeds = [max(image_ids, key=lambda i: (degree.get(i, 0), -i))]
    while len(seeds) < num_parts:
        dist = bfs_dist(seeds)
        cands = [i for i in image_ids if i not in seeds]
        # farthest from every existing seed (disconnected images farthest);
        # ties -> higher degree, then lower id
        seeds.append(
            max(
                cands,
                key=lambda i: (
                    dist.get(i, float("inf")), degree.get(i, 0), -i
                ),
            )
        )

    assign = {}
    parts = [[] for _ in range(num_parts)]
    # connection strength of every unassigned image to every part
    conn = [defaultdict(int) for _ in range(num_parts)]
    for k, s in enumerate(seeds):
        assign[s] = k
        parts[k].append(s)
        for n, w in adj[s].items():
            conn[k][n] += w

    # lazy-deletion heap of (-connection, image, part) candidates: O(E log E)
    # instead of rescanning every (unassigned, part) pair per assignment
    # (O(N^2 * parts) pure Python — minutes of host time at C5 scale)
    unassigned = {i for i in image_ids if i not in assign}
    heap = []
    for k in range(num_parts):
        for n, w in conn[k].items():
            if n in unassigned:
                heap.append((-w, n, k))
    heapq.heapify(heap)
    while unassigned and heap:
        negc, i, k = heapq.heappop(heap)
        if i not in unassigned or len(parts[k]) >= cap:
            continue
        if -negc != conn[k].get(i, 0):
            continue  # stale entry; the fresh value has its own entry
        assign[i] = k
        parts[k].append(i)
        unassigned.discard(i)
        for n, w in adj[i].items():
            if n not in assign:
                conn[k][n] += w
                heapq.heappush(heap, (-conn[k][n], n, k))
    # leftovers: disconnected images, or images whose connected parts all
    # filled up — spread over the least-loaded open parts
    for i in sorted(unassigned):
        k = min(
            (k for k in range(num_parts) if len(parts[k]) < cap),
            key=lambda k: (len(parts[k]), k),
        )
        assign[i] = k
        parts[k].append(i)
    return [sorted(p) for p in parts]


def expand_with_overlap(parts, pair_counts: dict, overlap: int = 10):
    """Add each partition's `overlap` strongest-connected outside images
    (shared images anchor the sub-model merges)."""
    adj = defaultdict(dict)
    for (a, b), w in pair_counts.items():
        adj[a][b] = adj[a].get(b, 0) + int(w)
        adj[b][a] = adj[b].get(a, 0) + int(w)
    out = []
    for part in parts:
        inside = set(part)
        strength = defaultdict(int)
        for i in part:
            for n, w in adj[i].items():
                if n not in inside:
                    strength[n] += w
        extra = sorted(strength, key=lambda n: (-strength[n], n))[:overlap]
        out.append(sorted(inside | set(extra)))
    return out


def merge_reconstructions(base, other, max_center_error: float = None,
                          min_common: int = 3, device=None) -> bool:
    """Align `other` onto `base` via common registered images and union the
    models (upstream Reconstruction::Merge semantics; image ids agree —
    both sub-models come from one database). The Sim3 comes from the
    sub-models' common 3D points (``align_reconstructions_via_points``),
    or from the common images' projection centers where fewer than three
    points are shared; its robust estimate runs on `device` (None = the
    card).

    Returns False (base untouched) when too few common images or alignment
    fails; True on success.
    """
    from pycolmap_torch.estimators.alignment import (
        align_reconstructions_via_points,
        estimate_sim3d_robust,
    )
    from pycolmap_torch.scene.track import Track

    common = [
        iid
        for iid, img in other.images.items()
        if img.registered
        and iid in base.images
        and base.images[iid].registered
    ]
    if len(common) < min_common:
        return False
    # points fix all seven degrees of freedom; the centers of a path that
    # runs nearly straight leave its roll loose (the reference aligns by
    # centers only: 1.8 degrees at a junction of chip_smoke.py phase 24)
    tform = align_reconstructions_via_points(other, base, device=device)
    if tform is None:
        src = np.stack([other.images[i].projection_center() for i in common])
        dst = np.stack([base.images[i].projection_center() for i in common])
        if max_center_error is None:
            # scale-free default: 5% of the base model's camera-center spread
            max_center_error = max(float(np.std(dst)) * 0.05, 1e-6)
        tform, _inliers = estimate_sim3d_robust(
            src, dst, max_error=max_center_error, device=device
        )
    if tform is None:
        return False
    other = copy.deepcopy(other)
    other.transform(tform)

    # add missing cameras / images
    for cam_id, cam in other.cameras.items():
        if cam_id not in base.cameras:
            base.add_camera(cam)
    for iid, img in other.images.items():
        if not img.registered:
            continue
        if iid not in base.images:
            # a database-backed image may still defer its keypoints: read
            # them now, so the merged model holds them itself
            img.points2D_xy
            img2 = copy.deepcopy(img)
            # the copy carries the OTHER model's point3D ids — meaningless
            # (and colliding) in base; links are re-established by
            # add_point3D for the merged points below
            img2.points2D_point3D_ids[:] = np.uint64(INVALID_POINT3D_ID)
            img2.num_points3D = 0
            img2.link_epoch += 1
            base.add_image(img2)
            base.register_image(iid)
        elif not base.images[iid].registered:
            bimg = base.images[iid]
            bimg.cam_from_world = img.cam_from_world
            base.register_image(iid)

    # add points whose tracks are not already claimed in base
    for pid, pt in other.points3D.items():
        elems = [
            el for el in pt.track.elements
            if el.image_id in base.images and base.images[el.image_id].registered
        ]
        if len(elems) < 2:
            continue
        claimed = any(
            base.images[el.image_id].points2D_point3D_ids[el.point2D_idx]
            != np.uint64(INVALID_POINT3D_ID)
            for el in elems
        )
        if claimed:
            continue
        base.add_point3D(pt.xyz, Track(list(elems)), color=pt.color)
    return True


def hierarchical_mapping(
    database_path,
    image_path,
    output_path,
    num_partitions: int = 2,
    overlap: int = 10,
    options=None,
    device=None,
    cg_bf16=None,
    timings: dict = None,
    dense_schur_max_d=None,
):
    """Partition the scene, map each partition independently, merge.

    Each partition is one ``incremental_mapping`` on `device` (None = the
    card) with ``cg_bf16`` and ``dense_schur_max_d``; the merges' robust
    Sim3 runs there too. Returns
    {model_idx: Reconstruction} like incremental_mapping; model 0 is the
    merged reconstruction. Given a ``timings`` dict, fills in ``partition``
    and ``merge`` seconds and ``parts``: per partition its ``images``,
    ``registered``, ``seconds`` and ``incremental_mapping``'s timings.
    """
    from pycolmap_torch.pipeline.sfm import (
        IncrementalPipelineOptions,
        incremental_mapping,
    )
    from pycolmap_torch.scene import Database
    from pycolmap_torch.scene.database import pair_id_to_image_pair

    device = resolve_device(device)
    t0 = time.perf_counter()
    db = Database(database_path)
    try:
        id2name = {
            img.image_id: img.name for img in db.read_all_images()
        }
        pair_counts = {}
        for pid, n in db._conn.execute(
            "SELECT pair_id, rows FROM two_view_geometries"
        ):
            if not n:
                continue
            pair_counts[pair_id_to_image_pair(pid)] = n
    finally:
        db.close()

    parts = partition_images(pair_counts, id2name.keys(), num_partitions)
    parts = expand_with_overlap(parts, pair_counts, overlap=overlap)
    part_timings = []
    if timings is not None:
        timings["partition"] = time.perf_counter() - t0
        timings["parts"] = part_timings

    submodels = []
    out_root = Path(output_path)
    for k, part in enumerate(parts):
        if len(part) < 3:
            continue
        opts = (
            copy.deepcopy(options) if options is not None
            else IncrementalPipelineOptions()
        )
        opts.image_names = [id2name[i] for i in part]
        split = {}
        t_part = time.perf_counter()
        recs = incremental_mapping(
            database_path, image_path, out_root / f"part{k}", opts,
            device=device, cg_bf16=cg_bf16, timings=split,
            dense_schur_max_d=dense_schur_max_d,
        )
        best = (max(recs.values(), key=lambda r: r.num_reg_images)
                if recs else None)
        part_timings.append(dict(
            images=len(part),
            registered=best.num_reg_images if best is not None else 0,
            seconds=time.perf_counter() - t_part, timings=split))
        if best is not None:
            submodels.append(best)

    if not submodels:
        return {}
    t_merge = time.perf_counter()
    submodels.sort(key=lambda r: -r.num_reg_images)
    base = submodels[0]
    pending = submodels[1:]
    # merge greedily by shared-registered-image count until no progress
    progress = True
    while pending and progress:
        progress = False
        for sub in list(pending):
            if merge_reconstructions(base, sub, device=device):
                pending.remove(sub)
                progress = True
    if timings is not None:
        timings["merge"] = time.perf_counter() - t_merge
    (out_root / "0").mkdir(parents=True, exist_ok=True)
    base.write(out_root / "0")
    out = {0: base}
    for k, sub in enumerate(pending, start=1):
        (out_root / str(k)).mkdir(parents=True, exist_ok=True)
        sub.write(out_root / str(k))
        out[k] = sub
    return out
