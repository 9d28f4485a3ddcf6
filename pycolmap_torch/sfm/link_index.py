"""Flat keypoint->point3D link lookup over the correspondence-graph nodes.

Upstream COLMAP answers "is this correspondence triangulated?" through
per-keypoint Point2D objects inside the CorrespondenceGraph hot loops
(colmap/sfm/incremental_mapper FindNextImages / RegisterNextImage,
reached via pipeline/sfm.h:46-93). Here the graph is CSR arrays over global
node ids (scene/correspondence_graph.py), so the same question for ALL edges
of an image is one numpy gather into a flat ``[total_nodes] int64`` array —
IF that array is kept in sync with the Reconstruction.

LinkIndex maintains that array incrementally: each Image bumps a
``link_epoch`` counter on every link mutation, and ``refresh()`` recopies
only the per-image segments whose epoch changed. A full refresh is
O(total keypoints); the steady-state cost per mapper step is O(keypoints of
images touched since the last call).
"""

from __future__ import annotations

import numpy as np


class LinkIndex:
    """flat_pid[node] = point3D id linked to the node's keypoint (-1 = none);
    reg_flag[image_id] = image registered in this reconstruction."""

    def __init__(self, correspondence_graph, reconstruction):
        self.rec = reconstruction
        indptr, adj, node_image, node_idx, base = correspondence_graph.csr_arrays()
        self.indptr = indptr
        self.adj = adj
        self.node_image = node_image
        self.node_idx = node_idx
        self.base = base
        total = len(node_image)
        self._flat_pid = np.full(total, -1, dtype=np.int64)
        self._epochs: dict[int, int] = {}
        max_iid = max(base) if base else 0
        self._reg_flag = np.zeros(max_iid + 1, dtype=bool)
        # per-node count of linked correspondents, maintained by diffing
        # link changes against the applied state: next-image scoring reads
        # vis_count[node] > 0 instead of expanding the node's edge list
        # (O(keypoints) instead of O(edges) per candidate)
        self.vis_count = np.zeros(total, dtype=np.int32)
        self._applied_linked = np.zeros(total, dtype=bool)

    def refresh(self):
        """Returns (flat_pid [total_nodes] int64, reg_flag [max_iid+1] bool),
        up to date with the reconstruction."""
        rec = self.rec
        flat = self._flat_pid
        for iid, b in self.base.items():
            img = rec.images.get(iid)
            if img is None:
                continue
            self._reg_flag[iid] = img.registered
            ep = img.link_epoch
            if self._epochs.get(iid) == ep:
                continue
            self._epochs[iid] = ep
            ids = img.points2D_point3D_ids
            # uint64 view as int64: INVALID (2^64-1) becomes exactly -1
            seg = slice(b, b + len(ids))
            flat[seg] = ids.view(np.int64)
            # propagate linked-state deltas into neighbors' vis counts
            new_linked = flat[seg] >= 0
            old_linked = self._applied_linked[seg]
            changed = np.nonzero(new_linked != old_linked)[0]
            if len(changed):
                nodes = changed + b
                starts = self.indptr[nodes]
                lens = self.indptr[nodes + 1] - starts
                sign = np.where(new_linked[changed], 1, -1).astype(np.int32)
                total_e = int(lens.sum())
                if total_e:
                    base_off = np.repeat(
                        starts - (np.cumsum(lens) - lens), lens
                    )
                    tgt = self.adj[np.arange(total_e) + base_off]
                    np.add.at(
                        self.vis_count, tgt, np.repeat(sign, lens)
                    )
                self._applied_linked[seg] = new_linked
        return flat, self._reg_flag

    def image_edges(self, image_id: int, num_points2D: int):
        """CSR slice of one image's correspondence edges as raw node ids.

        Returns (local_indptr [n+1], nodes [E]): keypoint k's edges are
        nodes[local_indptr[k]:local_indptr[k+1]].
        """
        b = self.base[image_id]
        lo = self.indptr[b]
        hi = self.indptr[b + num_points2D]
        return self.indptr[b : b + num_points2D + 1] - lo, self.adj[lo:hi]
