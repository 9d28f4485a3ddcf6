"""Correspondence graph over all image pairs, CSR array layout.

API parity: pycolmap/scene/correspondence_graph.h:19-109 (add_image,
add_correspondences, finalize, find_correspondences, transitive extraction,
per-image statistics). The reference stores per-keypoint C++ vectors; here the
whole graph is three flat numpy arrays (CSR), which load directly onto device
for the batched triangulator and keep memory contiguous for 1000+-image
scenes (SURVEY.md §2c P5).

Node addressing: node = image_base[image_id] + point2D_idx.

Port of ``pycolmap_tpu/scene/correspondence_graph.py``. As in the
reference, the transitive traversal runs in native C++ when the port's
library builds (``pycolmap_torch/native``), and otherwise in the Python loop
that the reference names its reference behaviour.
"""

from __future__ import annotations

import numpy as np


class Correspondence:
    __slots__ = ("image_id", "point2D_idx")

    def __init__(self, image_id: int, point2D_idx: int):
        self.image_id = int(image_id)
        self.point2D_idx = int(point2D_idx)

    def __eq__(self, other):
        return (
            self.image_id == other.image_id
            and self.point2D_idx == other.point2D_idx
        )

    def __repr__(self):
        return f"Correspondence({self.image_id}, {self.point2D_idx})"


class CorrespondenceGraph:
    def __init__(self):
        self._num_points2D: dict[int, int] = {}
        self._pair_edges: list[tuple[int, int, np.ndarray]] = []
        self._pair_counts: dict[tuple[int, int], int] = {}
        self._finalized = False
        # CSR (built in finalize)
        self._base: dict[int, int] = {}
        self._node_image: np.ndarray | None = None
        self._node_idx: np.ndarray | None = None
        self._indptr: np.ndarray | None = None
        self._adj: np.ndarray | None = None
        self._num_corrs_per_image: dict[int, int] = {}
        self._num_obs_per_image: dict[int, int] = {}

    # -- construction --------------------------------------------------------
    def add_image(self, image_id: int, num_points2D: int):
        self._num_points2D[int(image_id)] = int(num_points2D)

    def exists_image(self, image_id: int) -> bool:
        return image_id in self._num_points2D

    @property
    def num_images(self) -> int:
        return len(self._num_points2D)

    @property
    def num_image_pairs(self) -> int:
        return len(self._pair_counts)

    def num_points2D_for_image(self, image_id: int) -> int:
        return self._num_points2D[image_id]

    def add_correspondences(self, image_id1: int, image_id2: int, matches):
        """matches: Nx2 int array of (point2D_idx1, point2D_idx2)."""
        m = np.asarray(matches, dtype=np.int64).reshape(-1, 2)
        if image_id1 == image_id2 or len(m) == 0:
            return
        # drop out-of-range and duplicate-target matches (defensive, mirrors
        # upstream duplicate filtering)
        n1 = self._num_points2D[image_id1]
        n2 = self._num_points2D[image_id2]
        ok = (m[:, 0] >= 0) & (m[:, 0] < n1) & (m[:, 1] >= 0) & (m[:, 1] < n2)
        m = m[ok]
        key = (min(image_id1, image_id2), max(image_id1, image_id2))
        if image_id1 > image_id2:
            m = m[:, ::-1]
        self._pair_edges.append((key[0], key[1], m))
        self._pair_counts[key] = self._pair_counts.get(key, 0) + len(m)

    def num_correspondences_between_images(self, image_id1: int, image_id2: int) -> int:
        key = (min(image_id1, image_id2), max(image_id1, image_id2))
        return self._pair_counts.get(key, 0)

    def image_pairs(self):
        """dict (id1,id2) -> num correspondences."""
        return dict(self._pair_counts)

    def finalize(self):
        """Build the CSR adjacency (ref: correspondence_graph.h:58)."""
        image_ids = sorted(self._num_points2D)
        self._base = {}
        total = 0
        for iid in image_ids:
            self._base[iid] = total
            total += self._num_points2D[iid]
        self._node_image = np.zeros(total, dtype=np.int32)
        self._node_idx = np.zeros(total, dtype=np.int32)
        for iid in image_ids:
            b = self._base[iid]
            n = self._num_points2D[iid]
            self._node_image[b : b + n] = iid
            self._node_idx[b : b + n] = np.arange(n)

        if self._pair_edges:
            srcs = []
            dsts = []
            for id1, id2, m in self._pair_edges:
                a = self._base[id1] + m[:, 0]
                b = self._base[id2] + m[:, 1]
                srcs.append(a)
                dsts.append(b)
            src = np.concatenate(srcs)
            dst = np.concatenate(dsts)
            # symmetric edges
            all_src = np.concatenate([src, dst])
            all_dst = np.concatenate([dst, src])
            order = np.argsort(all_src, kind="stable")
            all_src = all_src[order]
            all_dst = all_dst[order]
            counts = np.bincount(all_src, minlength=total)
            self._indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
            self._adj = all_dst.astype(np.int64)
        else:
            self._indptr = np.zeros(total + 1, dtype=np.int64)
            self._adj = np.zeros(0, dtype=np.int64)

        # per-image stats
        for iid in image_ids:
            b = self._base[iid]
            n = self._num_points2D[iid]
            deg = self._indptr[b + 1 : b + n + 1] - self._indptr[b : b + n]
            self._num_corrs_per_image[iid] = int(deg.sum())
            self._num_obs_per_image[iid] = int(np.count_nonzero(deg))
        self._finalized = True
        # free builder storage
        self._pair_edges = []

    # -- queries -------------------------------------------------------------
    def _node(self, image_id: int, point2D_idx: int) -> int:
        return self._base[image_id] + point2D_idx

    def has_correspondences(self, image_id: int, point2D_idx: int) -> bool:
        n = self._node(image_id, point2D_idx)
        return self._indptr[n + 1] > self._indptr[n]

    def degree(self, image_id: int, point2D_idx: int) -> int:
        n = self._node(image_id, point2D_idx)
        return int(self._indptr[n + 1] - self._indptr[n])

    def find_correspondences(self, image_id: int, point2D_idx: int):
        """List of Correspondence for one keypoint."""
        n = self._node(image_id, point2D_idx)
        nodes = self._adj[self._indptr[n] : self._indptr[n + 1]]
        return [
            Correspondence(self._node_image[k], self._node_idx[k]) for k in nodes
        ]

    def find_correspondences_arrays(self, image_id: int, point2D_idx: int):
        """(image_ids, point2D_idxs) arrays for one keypoint — no objects."""
        n = self._node(image_id, point2D_idx)
        nodes = self._adj[self._indptr[n] : self._indptr[n + 1]]
        return self._node_image[nodes], self._node_idx[nodes]

    def _get_traversal(self):
        """Lazily build the native (C++) traversal over the CSR arrays;
        None when the library is unavailable."""
        if getattr(self, "_traversal", None) is None:
            from pycolmap_torch.native import GraphTraversal, get_lib

            if get_lib() is not None:
                self._traversal = GraphTraversal(self._indptr, self._adj)
            else:
                self._traversal = False  # toolchain unavailable
        return self._traversal or None

    def find_transitive_correspondences(
        self, image_id: int, point2D_idx: int, transitivity: int
    ):
        """BFS up to `transitivity` hops (ref: correspondence_graph.h:76-77).

        Uses the native C++ traversal (pycolmap_torch/native) when
        available; the Python loop below is the fallback and reference
        behaviour.
        """
        start = self._node(image_id, point2D_idx)
        trav = self._get_traversal()
        if trav is not None:
            nodes = trav.bfs_transitive(start, transitivity)
            return [
                Correspondence(self._node_image[k], self._node_idx[k])
                for k in nodes
            ]
        seen = {start}
        frontier = [start]
        out = []
        for _ in range(transitivity):
            next_frontier = []
            for n in frontier:
                for k in self._adj[self._indptr[n] : self._indptr[n + 1]]:
                    k = int(k)
                    if k not in seen:
                        seen.add(k)
                        next_frontier.append(k)
                        out.append(k)
            if not next_frontier:
                break
            frontier = next_frontier
        return [
            Correspondence(self._node_image[k], self._node_idx[k]) for k in out
        ]

    def num_correspondences_for_image(self, image_id: int) -> int:
        return self._num_corrs_per_image.get(image_id, 0)

    def num_observations_for_image(self, image_id: int) -> int:
        """#keypoints with at least one correspondence."""
        return self._num_obs_per_image.get(image_id, 0)

    def image_correspondences(self, image_id: int):
        """All correspondences of one image, batched.

        Returns (local_indptr [n+1], corr_images [E], corr_idxs [E]) where
        keypoint k's correspondences are rows local_indptr[k]:local_indptr[k+1].
        One slice instead of n per-keypoint queries — the host-side mapper
        loops (next-image scoring, 2D-3D gathering) consume these as numpy
        vector ops.
        """
        b = self._base[image_id]
        n = self._num_points2D[image_id]
        lo = self._indptr[b]
        hi = self._indptr[b + n]
        nodes = self._adj[lo:hi]
        local_indptr = self._indptr[b : b + n + 1] - lo
        return local_indptr, self._node_image[nodes], self._node_idx[nodes]

    # -- device export -------------------------------------------------------
    def csr_arrays(self):
        """(indptr, adj, node_image, node_idx, base dict) for device kernels."""
        return self._indptr, self._adj, self._node_image, self._node_idx, dict(self._base)

    def __repr__(self):
        return (
            f"CorrespondenceGraph(num_images={self.num_images}, "
            f"num_image_pairs={self.num_image_pairs})"
        )
