"""Incremental triangulator: create/continue/merge/complete/retriangulate tracks.

API parity: pycolmap/sfm/incremental_triangulator.h (object API :81-90,
options :16-72). The reference triangulates one keypoint at a time; here all
candidate tracks of an image are flattened into padded [B, V] view tensors
and triangulated in one batch (DLT + cheirality + angular-error inlier test
+ one reweighted refit) — the batched analog of upstream Create/Continue
semantics.

Port of ``pycolmap_tpu/sfm/incremental_triangulator.py``. The batch runs in
PyTorch on the triangulator's device (the card unless ``device="cpu"``); the
bookkeeping around it is the reference's host numpy. The reference pads the
batch to 4x steps and caches its executable to bound TPU compiles; here the
batch has the candidates' own size. As in the reference, track completion
and merging expand their candidates in native C++ when the port's library
builds (``pycolmap_torch/native``), and otherwise in numpy
(:func:`complete_candidates_numpy`, :func:`merge_pairs_numpy`).
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.ops import solvers
from pycolmap_torch.scene.point2d import INVALID_POINT3D_ID
from pycolmap_torch.scene.track import Track, TrackElement
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class IncrementalTriangulatorOptions(BaseOptions):
    """Defaults mirror reference options (incremental_triangulator.h:16-72)."""

    max_transitivity: int = 1
    create_max_angle_error: float = 2.0  # degrees
    continue_max_angle_error: float = 2.0
    merge_max_reproj_error: float = 4.0  # pixels
    complete_max_reproj_error: float = 4.0
    complete_max_transitivity: int = 5
    re_max_angle_error: float = 5.0
    re_min_ratio: float = 0.2
    re_max_trials: int = 1
    min_angle: float = 1.5
    ignore_two_view_tracks: bool = True
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    max_extra_param: float = 1.0


MAX_TRACK_VIEWS = 16  # padded views per candidate track in the batched kernel


def _triangulate_batch(proj, x_norm, centers, view_mask, max_angle_err_rad,
                       min_tri_angle_rad):
    """Batched robust triangulation.

    proj [B, V, 3, 4]; x_norm [B, V, 2]; centers [B, V, 3];
    view_mask [B, V] (1 = real view); f32 tensors on one device. Returns
    (X [B, 3], inlier [B, V] bool, ok [B] bool).
    """
    X = solvers.triangulate_dlt(proj, x_norm, view_mask)
    obs = torch.cat([x_norm, torch.ones_like(x_norm[..., :1])], dim=-1)
    obs = obs / torch.clamp(torch.linalg.norm(obs, dim=-1, keepdim=True),
                            min=1e-12)

    def eval_views(X):
        Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
        p = torch.einsum("bvij,bj->bvi", proj, Xh)
        front = p[..., 2] > 1e-6
        # angular error between observed and predicted rays
        pred = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                               min=1e-12)
        cosang = torch.sum(pred * obs, dim=-1)
        ang_err = torch.arccos(torch.clamp(cosang, -1.0, 1.0))
        return front & (ang_err <= max_angle_err_rad) & (view_mask > 0)

    inlier1 = eval_views(X)
    # refit with inliers
    X2 = solvers.triangulate_dlt(proj, x_norm, inlier1.to(proj.dtype))
    use_refit = torch.sum(inlier1, dim=-1) >= 2
    X = torch.where(use_refit[:, None], X2, X)
    inlier = eval_views(X)

    # max pairwise triangulation angle among inlier views
    rays = centers - X[:, None, :]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True),
                              min=1e-12)
    cos_pair = torch.einsum("bvi,bwi->bvw", rays, rays)
    pair_ok = inlier[:, :, None] & inlier[:, None, :]
    ang = torch.arccos(torch.clamp(cos_pair, -1.0, 1.0))
    ang = torch.where(pair_ok, ang, torch.zeros_like(ang))
    max_ang = torch.amax(ang, dim=(1, 2))

    ok = (torch.sum(inlier, dim=-1) >= 2) & (max_ang >= min_tri_angle_rad)
    return X, inlier, ok


def _edge_targets(indptr, adj, src_nodes):
    """(row, target) of every edge of the source nodes, in source then edge
    order; row indexes src_nodes."""
    starts = indptr[src_nodes]
    lens = indptr[src_nodes + 1] - starts
    total = int(lens.sum())
    row = np.repeat(np.arange(len(src_nodes)), lens)
    base = np.repeat(starts - (np.cumsum(lens) - lens), lens)
    return row, adj[np.arange(total) + base]


def complete_candidates_numpy(indptr, adj, node_image, flat_pid, reg_flag,
                              src_nodes):
    """Track-completion candidates, numpy twin of graph_ops.cc
    ``expand_complete_candidates``: (target nodes, source pids) for every
    edge of the source nodes whose target keypoint is unlinked and whose
    image is registered, one per target (the first in edge order), sorted
    by target."""
    row, tgt = _edge_targets(indptr, adj, src_nodes)
    cand_pid = flat_pid[src_nodes][row]
    ok = (flat_pid[tgt] < 0) & (reg_flag[node_image[tgt]] != 0)
    tgt, cand_pid = tgt[ok], cand_pid[ok]
    if len(tgt) == 0:
        return tgt, cand_pid
    order = np.argsort(tgt, kind="stable")
    tgt, cand_pid = tgt[order], cand_pid[order]
    firsts = np.diff(tgt, prepend=tgt[0] - 1) != 0
    return tgt[firsts], cand_pid[firsts]


def merge_pairs_numpy(indptr, adj, flat_pid, src_nodes):
    """Merge candidates, numpy twin of graph_ops.cc ``expand_merge_pairs``:
    the sorted unique packed (min_pid << 32 | max_pid) codes of the source
    nodes' edges joining two different points."""
    row, tgt = _edge_targets(indptr, adj, src_nodes)
    spid = flat_pid[src_nodes][row]
    tpid = flat_pid[tgt]
    ok = (tpid >= 0) & (tpid != spid)
    a = np.minimum(spid[ok], tpid[ok])
    b = np.maximum(spid[ok], tpid[ok])
    return np.unique(a << np.int64(32) | b)


class IncrementalTriangulator:
    """Operates on a Reconstruction + CorrespondenceGraph (ref object API)."""

    def __init__(self, correspondence_graph, reconstruction,
                 options: IncrementalTriangulatorOptions = None,
                 link_index=None, device=None):
        """device: where the batched triangulation runs; None = the card
        (raises on a host without CUDA), or ``"cpu"``."""
        self.device = resolve_device(device)
        self.graph = correspondence_graph
        self.reconstruction = reconstruction
        self.options = options if options is not None else IncrementalTriangulatorOptions()
        if link_index is None:
            from pycolmap_torch.sfm.link_index import LinkIndex

            link_index = LinkIndex(correspondence_graph, reconstruction)
        self.link_index = link_index
        self._cam_cache = {}
        self._merge_trials = defaultdict(int)
        self._re_num_trials = defaultdict(int)
        # memoization: skip merge re-tests for pairs whose track lengths are
        # unchanged (the correspondence graph is static, so a pair's merge
        # test can only change when one of its tracks does)
        self._merge_tested = {}
        # per-pid track length at last completion / merge candidate pass —
        # bounds the CSR expansions to changed points (a dense graph
        # expands ~degree x observations rows otherwise, every call)
        self._completed_len = {}
        self._merge_len = {}

    def _changed_pid_mask(self, memo: dict):
        """(sorted pid table [P], changed-at-this-length mask [P])."""
        rec = self.reconstruction
        P = len(rec.points3D)
        if P == 0:
            return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
        pid_arr = np.fromiter(rec.points3D.keys(), np.int64, P)
        lens = np.fromiter(
            (pt.track.length() for pt in rec.points3D.values()), np.int64, P
        )
        prev = np.fromiter(
            (memo.get(int(p), -1) for p in pid_arr), np.int64, P
        )
        order = np.argsort(pid_arr)
        return pid_arr[order], (lens != prev)[order]

    def _update_len_memo(self, memo: dict, sel_set=None):
        for pid, pt in self.reconstruction.points3D.items():
            if sel_set is None or pid in sel_set:
                memo[pid] = pt.track.length()

    # -- helpers -------------------------------------------------------------
    def _camera_ok(self, camera) -> bool:
        o = self.options
        return not camera.has_bogus_params(
            o.min_focal_length_ratio, o.max_focal_length_ratio, o.max_extra_param
        )

    def _norm_xy(self, image_id, point2D_idx):
        """Normalized camera coords of a keypoint (cached per image)."""
        key = image_id
        if key not in self._cam_cache:
            img = self.reconstruction.images[image_id]
            cam = self.reconstruction.cameras[img.camera_id]
            self._cam_cache[key] = np.asarray(
                cam.cam_from_img(img.points2D_xy), dtype=np.float32
            ) if img.num_points2D else np.zeros((0, 2), dtype=np.float32)
        return self._cam_cache[key][point2D_idx]

    def clear_cache(self):
        self._cam_cache.clear()

    # -- main entry: triangulate all keypoints of one image ------------------
    def triangulate_image(self, image_id: int) -> int:
        """Create/continue tracks for every keypoint of the image
        (upstream TriangulateImage). Returns #completed observations."""
        rec = self.reconstruction
        img = rec.images[image_id]
        if not img.registered:
            return 0
        cam = rec.cameras[img.camera_id]
        if not self._camera_ok(cam):
            return 0
        opts = self.options
        num_tris = 0

        # pass 1: classify keypoints -> continuations vs creations.
        # Vectorized: one CSR slice for the whole image + one mask pass per
        # registered image, then a cheap loop over only the active keypoints.
        continue_obs = []  # (point2D_idx, first_pid, all_pids)
        create_cands = []  # (point2D_idx, [(image_id2, point2D_idx2), ...])
        p3d_ids = img.points2D_point3D_ids
        lix = self.link_index
        flat_pid, reg_flag = lix.refresh()
        indptr, nodes = lix.image_edges(image_id, img.num_points2D)
        cimgs = lix.node_image[nodes]
        cidxs = lix.node_idx[nodes]
        E = len(cimgs)
        if E:
            reg_edges = reg_flag[cimgs]
            pid_edges = np.where(reg_edges, flat_pid[nodes], -1)
            cs_link = np.concatenate([[0], np.cumsum(pid_edges >= 0)])
            cs_reg = np.concatenate([[0], np.cumsum(reg_edges)])
            for idx in range(img.num_points2D):
                if p3d_ids[idx] != np.uint64(INVALID_POINT3D_ID):
                    continue
                lo, hi = indptr[idx], indptr[idx + 1]
                if lo == hi or cs_reg[hi] == cs_reg[lo]:
                    continue
                if cs_link[hi] > cs_link[lo]:
                    seg = pid_edges[lo:hi]
                    pids_here = sorted(set(int(p) for p in seg[seg >= 0]))
                    continue_obs.append((idx, pids_here[0], pids_here))
                else:
                    seg_m = reg_edges[lo:hi]
                    reg_views = list(
                        zip(
                            cimgs[lo:hi][seg_m].tolist(),
                            cidxs[lo:hi][seg_m].tolist(),
                        )
                    )
                    create_cands.append((idx, reg_views))

        # pass 2: continuations — check angular error, then add observation
        for idx, pid, all_pids in continue_obs:
            pt = rec.points3D.get(pid)
            if pt is None:
                continue
            ang = self._angular_error(image_id, idx, pt.xyz)
            if ang <= np.deg2rad(opts.continue_max_angle_error):
                rec.add_observation(pid, TrackElement(image_id, idx))
                num_tris += 1
                # merge opportunity when multiple distinct points linked
                for other_pid in all_pids[1:]:
                    if other_pid in rec.points3D and pid in rec.points3D:
                        pid = self._try_merge(pid, other_pid) or pid

        # pass 3: creations — batched robust triangulation
        if create_cands:
            num_tris += self._create_tracks_batched(image_id, create_cands)
        return num_tris

    def _angular_error(self, image_id, point2D_idx, xyz) -> float:
        rec = self.reconstruction
        img = rec.images[image_id]
        p_cam = img.cam_from_world * np.asarray(xyz)
        n = np.linalg.norm(p_cam)
        if n < 1e-12 or p_cam[2] <= 0:
            return np.pi
        pred = p_cam / n
        obs = np.append(self._norm_xy(image_id, point2D_idx), 1.0)
        obs = obs / np.linalg.norm(obs)
        return float(np.arccos(np.clip(np.dot(pred, obs), -1, 1)))

    def _create_tracks_batched(self, image_id, create_cands) -> int:
        rec = self.reconstruction
        opts = self.options
        V = MAX_TRACK_VIEWS
        B = len(create_cands)
        proj = np.zeros((B, V, 3, 4), dtype=np.float32)
        x_norm = np.zeros((B, V, 2), dtype=np.float32)
        centers = np.zeros((B, V, 3), dtype=np.float32)
        view_mask = np.zeros((B, V), dtype=np.float32)
        track_views = []

        mat_cache = {}
        center_cache = {}

        def image_mats(iid):
            if iid not in mat_cache:
                t = rec.images[iid].cam_from_world
                mat_cache[iid] = t.matrix().astype(np.float32)
                center_cache[iid] = t.inverse().translation.astype(np.float32)
            return mat_cache[iid], center_cache[iid]

        for b, (idx, reg_views) in enumerate(create_cands):
            views = [(image_id, idx)] + reg_views
            views = views[:V]
            track_views.append(views)
            for v, (iid, kidx) in enumerate(views):
                m, c = image_mats(iid)
                proj[b, v] = m
                centers[b, v] = c
                x_norm[b, v] = self._norm_xy(iid, kidx)
                view_mask[b, v] = 1.0

        def put(a):
            return torch.from_numpy(a).to(self.device)

        X, inlier, ok = _triangulate_batch(
            put(proj), put(x_norm), put(centers), put(view_mask),
            float(np.float32(np.deg2rad(opts.create_max_angle_error))),
            float(np.float32(np.deg2rad(opts.min_angle))),
        )
        X, inlier, ok = (t.cpu().numpy() for t in (X, inlier, ok))

        num = 0
        for b in range(len(create_cands)):
            if not ok[b]:
                continue
            views = track_views[b]
            els = [
                TrackElement(iid, kidx)
                for v, (iid, kidx) in enumerate(views)
                if inlier[b, v]
            ]
            if len(els) < 2:
                continue
            if opts.ignore_two_view_tracks and len(els) == 2:
                continue
            # keypoints may have been claimed by a merge earlier in this loop
            els = [
                el
                for el in els
                if rec.images[el.image_id].points2D_point3D_ids[el.point2D_idx]
                == np.uint64(INVALID_POINT3D_ID)
            ]
            if len(els) < 2:
                continue
            rec.add_point3D(X[b].astype(np.float64), Track(els))
            num += len(els)
        return num

    # -- merge / complete ----------------------------------------------------
    def _try_merge(self, pid1, pid2):
        """Merge two points if the merged point reprojects well everywhere
        (upstream Merge). Returns new id or None."""
        rec = self.reconstruction
        if pid1 == pid2 or pid1 not in rec.points3D or pid2 not in rec.points3D:
            return None
        p1 = rec.points3D[pid1]
        p2 = rec.points3D[pid2]
        n1, n2 = p1.track.length(), p2.track.length()
        merged = (n1 * p1.xyz + n2 * p2.xyz) / (n1 + n2)
        thr = self.options.merge_max_reproj_error
        for pt in (p1, p2):
            for el in pt.track.elements:
                img = rec.images[el.image_id]
                cam = rec.cameras[img.camera_id]
                p_cam = img.cam_from_world * merged
                if p_cam[2] <= 0:
                    return None
                proj = cam.img_from_cam(p_cam[None, :2] / p_cam[2])[0]
                err = np.linalg.norm(proj - img.points2D_xy[el.point2D_idx])
                if err > thr:
                    return None
        # perform merge
        new_id = rec.merge_points3D(pid1, pid2)
        return new_id

    def merge_tracks(self, point3D_ids=None) -> int:
        """Merge pass over given (or all) points via shared correspondences
        (upstream MergeAllTracks). Returns #merged observations.

        Vectorized: candidate pairs come from one CSR expansion over the
        LinkIndex (edges whose two endpoints link different points); the
        merged-point reprojection test runs as one image-major batch over
        all pairs' observations. Chained merges resolve across repeat
        rounds (merged points get new ids and re-enter as candidates)."""
        rec = self.reconstruction
        opts = self.options
        lix = self.link_index
        thr = opts.merge_max_reproj_error
        sel_set = None
        if point3D_ids is not None:
            sel_set = set(int(p) for p in point3D_ids)
            if not sel_set:
                return 0
        num = 0
        for _round in range(64):  # chained-merge rounds; exits when stable
            pairs = self._merge_candidate_pairs(sel_set)
            if len(pairs) == 0:
                break
            ok_pairs = self._batched_merge_test(pairs, thr)
            applied = 0
            for a, b in ok_pairs:
                if a in rec.points3D and b in rec.points3D:
                    new_id = rec.merge_points3D(a, b)
                    num += rec.points3D[new_id].track.length()
                    if sel_set is not None:
                        sel_set.discard(a)
                        sel_set.discard(b)
                        sel_set.add(new_id)
                    applied += 1
            if applied == 0:
                break
        return num

    def _merge_candidate_pairs(self, sel_set):
        """Unique (pid_a, pid_b) pairs joined by a correspondence edge, both
        alive, skipping pairs already tested at these track lengths."""
        rec = self.reconstruction
        lix = self.link_index
        flat_pid, reg_flag = lix.refresh()
        src_mask = flat_pid >= 0
        if sel_set is not None:
            sel_arr = np.fromiter(sel_set, dtype=np.int64, count=len(sel_set))
            sel_arr.sort()
            pos = np.searchsorted(sel_arr, flat_pid)
            pos_safe = np.minimum(pos, len(sel_arr) - 1)
            src_mask &= sel_arr[pos_safe] == flat_pid
        # expand only points whose tracks changed since the last merge pass
        memo_tab, memo_changed = self._changed_pid_mask(self._merge_len)
        if len(memo_tab):
            mpos = np.searchsorted(memo_tab, flat_pid)
            mpos_safe = np.minimum(mpos, len(memo_tab) - 1)
            known = memo_tab[mpos_safe] == flat_pid
            src_mask &= known & memo_changed[mpos_safe]
        src_nodes = np.nonzero(src_mask)[0]
        self._update_len_memo(self._merge_len, sel_set)
        if len(src_nodes) == 0:
            return []
        trav = self.graph._get_traversal()
        if trav is not None:
            codes = trav.expand_merge_pairs(flat_pid, src_nodes)
        else:
            codes = merge_pairs_numpy(lix.indptr, lix.adj, flat_pid,
                                      src_nodes)
        if len(codes) == 0:
            return []
        pairs = []
        for code in codes.tolist():
            pa, pb = code >> 32, code & 0xFFFFFFFF
            ta = rec.points3D.get(pa)
            tb = rec.points3D.get(pb)
            if ta is None or tb is None:
                continue
            key = (pa, pb)
            lens_now = (ta.track.length(), tb.track.length())
            if self._merge_tested.get(key) == lens_now:
                continue
            self._merge_tested[key] = lens_now
            pairs.append(key)
        return pairs

    def _batched_merge_test(self, pairs, thr):
        """Test all pairs' merged points against both tracks' observations
        in one image-major reprojection batch. Returns surviving pairs."""
        rec = self.reconstruction
        Q = len(pairs)
        pair_arr = np.asarray(pairs, dtype=np.int64)  # [Q, 2]
        involved = np.unique(pair_arr.reshape(-1))
        pids, _, iids, xy, p2ds = rec._all_observations(involved)
        if len(pids) == 0:
            return []
        order = np.argsort(pids, kind="stable")
        pids, iids, xy = pids[order], iids[order], xy[order]
        upids = np.unique(pids)
        seg_starts = np.searchsorted(pids, upids)
        seg_ends = np.searchsorted(pids, upids, side="right")
        # merged positions (track-length weighted, upstream Merge)
        xyz_a = np.stack([rec.points3D[a].xyz for a, _ in pairs])
        xyz_b = np.stack([rec.points3D[b].xyz for _, b in pairs])
        na = np.array([rec.points3D[a].track.length() for a, _ in pairs])
        nb = np.array([rec.points3D[b].track.length() for _, b in pairs])
        merged = (na[:, None] * xyz_a + nb[:, None] * xyz_b) / (na + nb)[:, None]
        # expand: per pair, observation rows of both pids
        rows_l, pair_l = [], []
        for side in (0, 1):
            k = np.searchsorted(upids, pair_arr[:, side])
            k = np.minimum(k, len(upids) - 1)
            s, e = seg_starts[k], seg_ends[k]
            cnt = e - s
            pr = np.repeat(np.arange(Q), cnt)
            fl = np.arange(cnt.sum()) + np.repeat(s - (np.cumsum(cnt) - cnt), cnt)
            rows_l.append(fl)
            pair_l.append(pr)
        rows = np.concatenate(rows_l)
        pair_of_obs = np.concatenate(pair_l)
        o_iids = iids[rows]
        o_xy = xy[rows]
        o_xyz = merged[pair_of_obs]
        # image-major projection
        fail = np.zeros(Q, dtype=bool)
        order2 = np.argsort(o_iids, kind="stable")
        o_iids, o_xy, o_xyz = o_iids[order2], o_xy[order2], o_xyz[order2]
        pair_of_obs = pair_of_obs[order2]
        bounds = np.nonzero(np.diff(o_iids, prepend=o_iids[0] - 1))[0]
        bounds = np.append(bounds, len(o_iids))
        for s, e in zip(bounds[:-1], bounds[1:]):
            img = rec.images[int(o_iids[s])]
            cam = rec.cameras[img.camera_id]
            R_t = img.cam_from_world.matrix()
            p_cam = o_xyz[s:e] @ R_t[:, :3].T + R_t[:, 3]
            z = p_cam[:, 2]
            uv = p_cam[:, :2] / np.where(z[:, None] <= 1e-12, 1.0, z[:, None])
            proj = cam.img_from_cam(uv)
            err = np.linalg.norm(proj - o_xy[s:e], axis=1)
            bad = (z <= 0) | (err > thr)
            fail[pair_of_obs[s:e][bad]] = True
        return [pairs[q] for q in np.nonzero(~fail)[0]]

    def complete_tracks(self, point3D_ids=None) -> int:
        """Transitively extend tracks to unlinked keypoints
        (upstream CompleteAllTracks). Returns #completed observations.

        Vectorized: each transitivity round generates ALL candidate edges
        (linked node -> unlinked registered node) with CSR expansions over
        the LinkIndex, then batch-tests reprojection image-major. Rounds
        bound BFS depth exactly like the reference's per-point queue."""
        rec = self.reconstruction
        opts = self.options
        lix = self.link_index
        thr = opts.complete_max_reproj_error
        sel_arr = None
        if point3D_ids is not None:
            sel = set(int(p) for p in point3D_ids)
            if not sel:
                return 0
            sel_arr = np.fromiter(sel, dtype=np.int64, count=len(sel))
            sel_arr.sort()
        indptr = lix.indptr
        adj = lix.adj
        node_image = lix.node_image
        node_idx = lix.node_idx
        num = 0
        sel_set = set(sel_arr.tolist()) if sel_arr is not None else None
        for _round in range(max(opts.complete_max_transitivity, 0)):
            flat_pid, reg_flag = lix.refresh()
            src_mask = flat_pid >= 0
            if sel_arr is not None:
                pos = np.searchsorted(sel_arr, flat_pid)
                pos_safe = np.minimum(pos, len(sel_arr) - 1)
                src_mask &= sel_arr[pos_safe] == flat_pid
            # expand only points whose tracks changed since their last
            # completion pass (O(changed x degree) instead of O(all edges))
            memo_tab, memo_changed = self._changed_pid_mask(self._completed_len)
            if len(memo_tab):
                mpos = np.searchsorted(memo_tab, flat_pid)
                mpos_safe = np.minimum(mpos, len(memo_tab) - 1)
                known = memo_tab[mpos_safe] == flat_pid
                src_mask &= known & memo_changed[mpos_safe]
            src_nodes = np.nonzero(src_mask)[0]
            self._update_len_memo(self._completed_len, sel_set)
            if len(src_nodes) == 0:
                break
            trav = self.graph._get_traversal()
            if trav is not None:
                # native single-pass expansion + dedup (graph_ops.cc)
                tgt, cand_pid = trav.expand_complete_candidates(
                    node_image, flat_pid, reg_flag, src_nodes
                )
            else:
                tgt, cand_pid = complete_candidates_numpy(
                    indptr, adj, node_image, flat_pid, reg_flag, src_nodes
                )
            if len(tgt) == 0:
                break
            # point positions
            pid_table, xyz_table = rec._point_table()
            if len(pid_table) == 0:
                break
            rows = np.searchsorted(pid_table, cand_pid)
            rows_safe = np.minimum(rows, len(pid_table) - 1)
            live = pid_table[rows_safe] == cand_pid
            tgt, cand_pid, rows_safe = tgt[live], cand_pid[live], rows_safe[live]
            if len(tgt) == 0:
                break
            xyz = xyz_table[rows_safe]
            timg = node_image[tgt]
            tkp = node_idx[tgt]
            # image-major batched projection test
            order = np.argsort(timg, kind="stable")
            tgt, cand_pid, xyz = tgt[order], cand_pid[order], xyz[order]
            timg, tkp = timg[order], tkp[order]
            bounds = np.nonzero(np.diff(timg, prepend=timg[0] - 1))[0]
            bounds = np.append(bounds, len(timg))
            added = 0
            for s, e in zip(bounds[:-1], bounds[1:]):
                img = rec.images[int(timg[s])]
                cam = rec.cameras[img.camera_id]
                R_t = img.cam_from_world.matrix()
                p_cam = xyz[s:e] @ R_t[:, :3].T + R_t[:, 3]
                z = p_cam[:, 2]
                uv = p_cam[:, :2] / np.where(z[:, None] <= 1e-12, 1.0, z[:, None])
                proj = cam.img_from_cam(uv)
                err = np.linalg.norm(proj - img.points2D_xy[tkp[s:e]], axis=1)
                good = (z > 0) & (err <= thr)
                iid = int(timg[s])
                for k in np.nonzero(good)[0]:
                    kidx = int(tkp[s + k])
                    # may have been claimed earlier this round
                    if img.points2D_point3D_ids[kidx] != np.uint64(
                        INVALID_POINT3D_ID
                    ):
                        continue
                    rec.add_observation(
                        int(cand_pid[s + k]), TrackElement(iid, kidx)
                    )
                    added += 1
            num += added
            if added == 0:
                break
        return num

    def complete_image(self, image_id: int) -> int:
        """Complete tracks seen by one image (upstream CompleteImage)."""
        rec = self.reconstruction
        img = rec.images[image_id]
        pids = {
            int(pid)
            for pid in img.points2D_point3D_ids
            if pid != np.uint64(INVALID_POINT3D_ID)
        }
        return self.complete_tracks(pids)

    # reference binding names (incremental_triangulator.h:81-90)
    def complete_all_tracks(self, point3D_ids=None) -> int:
        return self.complete_tracks(point3D_ids)

    def merge_all_tracks(self, point3D_ids=None) -> int:
        return self.merge_tracks(point3D_ids)

    def retriangulate(self) -> int:
        """Re-triangulate under-reconstructed images (upstream Retriangulate,
        options re_*). Returns #new observations."""
        rec = self.reconstruction
        num = 0
        for iid in rec.reg_image_ids:
            img = rec.images[iid]
            if img.num_points2D == 0:
                continue
            ratio = img.num_points3D / img.num_points2D
            if ratio >= self.options.re_min_ratio:
                continue
            if self._re_num_trials[iid] >= self.options.re_max_trials:
                continue
            self._re_num_trials[iid] += 1
            num += self.triangulate_image(iid)
        return num
