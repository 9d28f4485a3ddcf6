"""Visual retrieval: hierarchical k-means vocabulary tree + inverted index.

Port of ``pycolmap_tpu/features/retrieval.py`` (the reference's HKM
vocab-tree retrieval, ref: pipeline/match_features.h:177-214
VocabTreeMatchingOptions; upstream colmap/src/colmap/retrieval, after
Nistér & Stewénius "Scalable Recognition with a Vocabulary Tree"):

- :class:`VocabTree` — a branching^depth hierarchical k-means vocabulary
  (default 8^4 = 4096 visual words) trained level by level from the
  database's own descriptors; every node of a level refines its children at
  once. The seeding is drawn on the host from ``default_rng(seed)`` exactly
  as the reference draws it; each level's k-means iterations run on the
  entry point's device (default: the card): each descriptor competes only
  among its parent's children, and the centers are summed in a fixed order
  (a sorted segment sum), so two runs train the same tree. Trees save to
  and load from the reference's npz layout.
- quantization: the flat [N, K] product and its argmax (top-k in a stable
  order) up to 16,384 words, a beam descent bounded by ``num_checks``
  above; both on the device, in chunks.
- :class:`InvertedIndex` — word -> postings of (image, tf-idf weight),
  host numpy as in the reference: a query touches only the images that
  share its words and scores by cosine of L2-normalized tf-idf vectors.

The similarities are float64 products of the float32 unit rows and
centers, on the card and the CPU alike: float32 products of two libraries
differ in summation order by ~6e-8, enough to flip near-tied assignments
between a card run and a CPU run (ROADMAP.md, deliberate differences).
The reference's TPU-tunnel thresholds (host products below 2e9 FLOP,
device training above 2e10, device quantization above 4e9, padded chunk
counts, the executable cache) have no counterpart: there is one path, on
``device``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.features.matcher import _to_unit_float

_FLAT_QUANT_MAX_WORDS = 16384
# rows per quantization chunk: [32768, K] float64 is the bytes of the
# reference's [65536, K] float32 chunk
_QUANT_CHUNK = 1 << 15
# elements of a [rows, candidates, D] gather per chunk (training, beam)
_GATHER_ELEMS = 1 << 26


def _unit_rows(a: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(a, axis=1, keepdims=True)
    return a / np.maximum(n, 1e-12)


def _unit_rows_t(a):
    """Unit rows of a float64 tensor."""
    return a / torch.linalg.norm(a, dim=1, keepdim=True).clamp(min=1e-12)


def _topk_stable(sims, k: int):
    """Indices of each row's k largest values, largest first, ties by the
    lower index (numpy's argmax rule, XLA's top_k order). [R, k] int64."""
    if k == 1:
        return torch.argmax(sims, dim=1, keepdim=True)
    kth = torch.topk(sims, k, dim=1).values[:, -1:]
    above = sims > kth
    tied = sims == kth
    # the lowest-index ties fill the places the strictly larger leave
    need = k - above.sum(dim=1, keepdim=True)
    take = above | (tied & (torch.cumsum(tied.long(), dim=1) <= need))
    cols = torch.arange(sims.shape[1], device=sims.device)
    # the k taken columns in index order, then stably by value
    idx = torch.sort(torch.where(take, cols, sims.shape[1]), dim=1).values[:, :k]
    order = torch.sort(torch.gather(sims, 1, idx), dim=1, descending=True,
                       stable=True).indices
    return torch.gather(idx, 1, order)


def _flat_words(d64, centers64, nn: int):
    """Flat quantization of unit float64 rows against float64 centers, in
    row chunks. [N, min(nn, K)] int64 on the device."""
    nn = min(nn, len(centers64))
    out = torch.empty((len(d64), nn), dtype=torch.int64, device=d64.device)
    for s in range(0, len(d64), _QUANT_CHUNK):
        sims = d64[s:s + _QUANT_CHUNK] @ centers64.T
        out[s:s + _QUANT_CHUNK] = _topk_stable(sims, nn)
    return out


def quantize_batch_device(descs_u8, centers, num_neighbors: int = 1,
                          device=None):
    """Quantize a [N, D] uint8 descriptor block against [K, D] centers on
    ``device`` (default: the card): the rows are normalized there, the
    flat product runs in chunks; returns [N, num_neighbors] int32 word
    ids."""
    dev = resolve_device(device)
    d = torch.from_numpy(np.ascontiguousarray(descs_u8)).to(dev).double()
    c = torch.from_numpy(np.ascontiguousarray(centers, np.float32)).to(
        dev).double()
    words = _flat_words(_unit_rows_t(d), c, max(1, int(num_neighbors)))
    return words.to(torch.int32).cpu().numpy()


def _hkm_level(descs, parent, centers, branching: int, iters: int):
    """One HKM level on the descriptors' device: ``iters`` rounds of
    assignment among each parent's ``branching`` children (first index on
    ties) and the center update (means of the float32 rows, summed in
    float64 in sorted order, renormalized; an empty child keeps its
    center). descs [N, D] float32 unit rows, parent [N] int64, centers
    [K, D] float32. Returns (centers [K, D] float32, child [N] int64), the
    child of the last round's assignment."""
    N, D = descs.shape
    K = len(centers)
    B = branching
    d64 = descs.double()
    c = centers
    rows = max(1, _GATHER_ELEMS // (B * D))
    child = torch.zeros(N, dtype=torch.int64, device=descs.device)
    for _ in range(iters):
        blocks = c.double().view(K // B, B, D)
        for s in range(0, N, rows):
            p = parent[s:s + rows]
            sims = torch.bmm(blocks[p], d64[s:s + rows, :, None])[:, :, 0]
            child[s:s + rows] = p * B + torch.argmax(sims, dim=1)
        order = torch.argsort(child, stable=True)
        counts = torch.bincount(child, minlength=K)
        csum = torch.zeros((N + 1, D), dtype=torch.float64,
                           device=descs.device)
        torch.cumsum(d64[order], dim=0, out=csum[1:])
        ends = torch.cumsum(counts, dim=0)
        sums = csum[ends] - csum[ends - counts]
        mean = sums / counts.clamp(min=1)[:, None].double()
        c = torch.where((counts > 0)[:, None], _unit_rows_t(mean).float(), c)
    return c, child


class VocabTree:
    """Hierarchical k-means vocabulary (branching^depth leaf words).

    levels[l] is an [branching**(l+1), D] array of unit-norm centers; node n
    of level l has children n*B .. (n+1)*B-1 at level l+1. Leaf words are
    the nodes of the last level.
    """

    def __init__(self, levels: list, branching: int):
        self.levels = [np.asarray(c, np.float32) for c in levels]
        self.branching = int(branching)

    @property
    def depth(self) -> int:
        return len(self.levels)

    @property
    def num_words(self) -> int:
        return len(self.levels[-1])

    # -- persistence (the reference package's npz layout) ------------------
    def save(self, path) -> None:
        # atomic: a process killed mid-save must not leave a truncated npz
        # that poisons the next run's load
        path = str(path)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            np.savez_compressed(
                tmp, branching=self.branching, depth=self.depth,
                **{f"level_{i}": c for i, c in enumerate(self.levels)},
            )
            src = tmp if os.path.exists(tmp) else tmp + ".npz"
            os.replace(src, path)
        finally:
            for leftover in (tmp, tmp + ".npz"):
                if os.path.exists(leftover):
                    try:
                        os.remove(leftover)
                    except OSError:
                        pass

    @classmethod
    def load(cls, path) -> "VocabTree":
        with np.load(path) as z:
            depth = int(z["depth"])
            levels = [z[f"level_{i}"] for i in range(depth)]
            return cls(levels, int(z["branching"]))

    # -- training ---------------------------------------------------------
    @classmethod
    def train(cls, descs: np.ndarray, branching: int = 8, depth: int = 4,
              iters: int = 8, seed: int = 0, device=None,
              timings=None) -> "VocabTree":
        """Blocked level-wise HKM on ``device`` (default: the card).

        The children of every node of a level are seeded on the host with
        the reference's draws (per parent, random members; the
        parent-agnostic pool where a parent has too few), then refined by
        :func:`_hkm_level`. ``timings`` (a dict) gets the seconds of each
        level under ``train_levels``."""
        dev = resolve_device(device)
        descs = np.asarray(descs, np.float32)
        N, D = descs.shape
        d_dev = torch.from_numpy(np.ascontiguousarray(descs)).to(dev)
        rng = np.random.default_rng(seed)
        parent = np.zeros(N, np.int64)  # node id at current level
        levels = []
        seconds = []
        for lvl in range(depth):
            t = time.perf_counter()
            K = branching ** (lvl + 1)
            centers = np.empty((K, D), np.float32)
            glob = rng.choice(N, size=min(N, K), replace=False)
            centers[:] = descs[np.resize(glob, K)]
            # members of each parent in index order (np.nonzero's)
            order = np.argsort(parent, kind="stable")
            bounds = np.searchsorted(parent[order],
                                     np.arange(branching ** lvl + 1))
            for p in range(branching ** lvl):
                members = order[bounds[p]:bounds[p + 1]]
                if len(members) == 0:
                    continue
                take = rng.choice(members, size=min(len(members), branching),
                                  replace=False)
                centers[p * branching:p * branching + len(take)] = descs[take]
            centers = _unit_rows(centers)
            c_dev, child = _hkm_level(
                d_dev, torch.from_numpy(parent).to(dev),
                torch.from_numpy(centers).to(dev), branching, iters)
            levels.append(c_dev.cpu().numpy())
            parent = child.cpu().numpy()
            seconds.append(time.perf_counter() - t)
        if timings is not None:
            timings["train_levels"] = seconds
        return cls(levels, branching)

    # -- quantization -----------------------------------------------------
    def quantize(self, descs, num_neighbors: int = 1, num_checks: int = 256,
                 device=None) -> np.ndarray:
        """descs [N, D] unit rows (array, or a tensor on its device) -> word
        ids [N, num_neighbors] int32 (repeat-padded), on ``device``
        (default: the card).

        The flat product's top-k for vocabularies <= 16k words (exact), a
        beam descent bounded by num_checks above that."""
        if isinstance(descs, torch.Tensor):
            d = descs.double()
        else:
            descs = np.asarray(descs, np.float32)
            d = torch.from_numpy(np.ascontiguousarray(descs)).to(
                resolve_device(device)).double()
        nn = max(1, int(num_neighbors))
        if len(d) == 0:
            return np.zeros((0, nn), np.int32)
        levels = [torch.from_numpy(c).to(d.device).double()
                  for c in self.levels]
        if self.num_words <= _FLAT_QUANT_MAX_WORDS:
            return _flat_words(d, levels[-1], nn).to(torch.int32).cpu().numpy()
        B = self.branching
        # beam descent: W beams/descriptor -> W*B candidates/level
        W = max(1, min(int(num_checks) // B, B ** (self.depth - 1)))
        rows = max(1, _GATHER_ELEMS // (W * B * d.shape[1]))
        out = torch.empty((len(d), nn), dtype=torch.int64, device=d.device)
        arange_b = torch.arange(B, device=d.device)
        for s in range(0, len(d), rows):
            dc = d[s:s + rows]
            beams = None  # [rows, W_cur]
            for lvl, centers in enumerate(levels):
                if beams is None:
                    cand = arange_b[None, :].expand(len(dc), B)
                else:
                    cand = (beams[:, :, None] * B
                            + arange_b[None, None, :]).reshape(len(dc), -1)
                sims = torch.bmm(centers[cand], dc[:, :, None])[:, :, 0]
                keep = W if lvl < self.depth - 1 else nn
                keep = min(keep, cand.shape[1])
                beams = torch.gather(cand, 1, _topk_stable(sims, keep))
            if beams.shape[1] < nn:
                beams = beams[:, :1].expand(len(dc), nn)
            out[s:s + rows] = beams[:, :nn]
        return out.to(torch.int32).cpu().numpy()


class InvertedIndex:
    """Word -> (image, tf-idf weight) postings with cosine scoring.

    Build with add_image() per image, then finalize(); query() touches only
    the postings of the query's words (sub-linear in database size).
    """

    def __init__(self, num_words: int):
        self.num_words = int(num_words)
        self._image_words: list = []  # (image_id, unique word ids, counts)
        self.image_ids: list = []
        self._finalized = False

    def add_image(self, image_id, words: np.ndarray) -> None:
        words = np.asarray(words).reshape(-1)
        uw, counts = np.unique(words, return_counts=True)
        self._image_words.append((uw, counts))
        self.image_ids.append(image_id)
        self._finalized = False

    def finalize(self) -> None:
        M = len(self.image_ids)
        df = np.zeros(self.num_words, np.float64)
        for uw, _ in self._image_words:
            df[uw] += 1.0
        self.idf = np.log(max(M, 1) / np.maximum(df, 1.0)).astype(np.float32)
        # per-image L2-normalized tf-idf entries, bucketed into word postings
        post_w: list = []
        post_img: list = []
        post_val: list = []
        for row, (uw, counts) in enumerate(self._image_words):
            if len(uw) == 0:
                continue
            v = counts.astype(np.float32) / counts.sum() * self.idf[uw]
            n = float(np.linalg.norm(v))
            if n > 1e-12:
                v = v / n
            post_w.append(uw)
            post_img.append(np.full(len(uw), row, np.int32))
            post_val.append(v)
        if post_w:
            w = np.concatenate(post_w)
            order = np.argsort(w, kind="stable")
            self._post_words = w[order]
            self._post_imgs = np.concatenate(post_img)[order]
            self._post_vals = np.concatenate(post_val)[order]
            self._starts = np.searchsorted(
                self._post_words, np.arange(self.num_words)
            )
            self._ends = np.searchsorted(
                self._post_words, np.arange(self.num_words) + 1
            )
        else:
            self._post_words = np.zeros(0, np.int64)
            self._post_imgs = np.zeros(0, np.int32)
            self._post_vals = np.zeros(0, np.float32)
            self._starts = np.zeros(self.num_words, np.int64)
            self._ends = np.zeros(self.num_words, np.int64)
        self._finalized = True

    def query_row(self, row: int, num_images: int):
        """Rank database images against image `row` of the index."""
        uw, counts = self._image_words[row]
        return self._query(uw, counts, num_images, exclude_row=row)

    def query(self, words: np.ndarray, num_images: int):
        words = np.asarray(words).reshape(-1)
        uw, counts = np.unique(words, return_counts=True)
        return self._query(uw, counts, num_images, exclude_row=-1)

    def _query(self, uw, counts, num_images, exclude_row):
        if not self._finalized:
            self.finalize()
        if len(uw) == 0:
            return []
        q = counts.astype(np.float32) / counts.sum() * self.idf[uw]
        n = float(np.linalg.norm(q))
        if n > 1e-12:
            q = q / n
        # the postings of the query's words only
        starts, ends = self._starts[uw], self._ends[uw]
        hit = ends > starts
        if not hit.any():
            return []
        scores = np.zeros(len(self.image_ids), np.float32)
        # the reference's np.add.at(scores, imgs, postings * q), bit for
        # bit: a word's postings name each image once, so one word at a time
        # each image adds its float64 product and rounds to float32, in the
        # reference's order, without add.at's per-element loop
        for s, e, qi in zip(starts[hit], ends[hit], q[hit]):
            rows = self._post_imgs[s:e]
            scores[rows] = scores[rows] + self._post_vals[s:e] * qi
        if 0 <= exclude_row < len(scores):
            scores[exclude_row] = -np.inf
        # the images the postings reached with a positive score (one the
        # postings did not reach scores 0)
        touched = np.flatnonzero(scores > 0)
        order = touched[np.argsort(-scores[touched])][:num_images]
        return [(self.image_ids[r], float(scores[r])) for r in order]


def build_visual_index(
    db, image_ids, num_words: int = 4096, branching: int = 8,
    max_num_features: int = -1, num_neighbors: int = 1,
    num_checks: int = 256, vocab_tree_path: str = "", seed: int = 0,
    train_sample_per_image: int = 512, device=None, timings=None,
):
    """Train/load the vocab tree and index all images' descriptors, the
    training and the quantization on ``device`` (default: the card).

    Returns (tree, index) or (None, None) when the database has no
    descriptors. num_words is rounded to the nearest branching power and
    capped at ~sample_size/10: a vocabulary with nearly one word per
    training descriptor over-segments (matching descriptors from different
    views land in different words and retrieval scores collapse).
    ``timings`` (a dict) gets seconds for read, train (and train_levels),
    quantize and index.
    """
    dev = resolve_device(device)
    stages = {}
    t = time.perf_counter()
    rng = np.random.default_rng(seed)
    per_image = {}
    sample = []
    for iid in image_ids:
        d = np.asarray(db.read_descriptors(iid))
        if max_num_features > 0 and len(d) > max_num_features:
            d = d[rng.choice(len(d), max_num_features, replace=False)]
        per_image[iid] = d
        if len(d):
            take = min(len(d), train_sample_per_image)
            sample.append(
                _to_unit_float(d[rng.choice(len(d), take, replace=False)])
            )
    if not sample:
        return None, None
    sample = np.concatenate(sample)
    # bound k-means training cost at C5 scale (1000+ images): 200k
    # descriptors train a <=4096-word vocabulary just as well
    if len(sample) > 200_000:
        sample = sample[rng.choice(len(sample), 200_000, replace=False)]
    eff_words = min(int(num_words), max(branching, len(sample) // 10))
    # deepest level with branching**depth <= 2*eff_words: plain round() can
    # overshoot the over-segmentation cap by nearly branching× (eff=200,
    # b=8 -> 512 words = sample/4), while a hard floor can undershoot by
    # branching× and collapse discrimination; a bounded 2× overshoot keeps
    # both failure modes in check
    depth = max(1, int(np.log(2 * eff_words) / np.log(branching) + 1e-9))
    stages["read"] = time.perf_counter() - t

    t = time.perf_counter()
    tree = None
    if vocab_tree_path:
        try:
            tree = VocabTree.load(vocab_tree_path)
        except Exception as exc:
            # truncated npz files raise arbitrary zlib/zipfile errors, so the
            # catch stays broad — but retraining takes a while, so say why
            from pycolmap_torch.utils import logging as _logging

            _logging.get_logger().warning(
                f"failed to load vocab tree {vocab_tree_path!r} "
                f"({type(exc).__name__}: {exc}); retraining from scratch"
            )
            tree = None  # unreadable/truncated tree -> retrain
    if tree is None:
        tree = VocabTree.train(
            sample, branching=branching, depth=depth, seed=seed, device=dev,
            timings=stages,
        )
        if vocab_tree_path:
            try:
                tree.save(vocab_tree_path)
            except OSError:
                pass
    stages["train"] = time.perf_counter() - t

    # one pass over every image's descriptors: uint8 rows are normalized on
    # the device, others by the host's _to_unit_float
    t = time.perf_counter()
    nn = max(1, int(num_neighbors))
    blocks = [per_image[iid] for iid in image_ids if len(per_image[iid])]
    if all(b.dtype == np.uint8 for b in blocks):
        d = torch.from_numpy(np.concatenate(blocks)).to(dev).double()
        d = _unit_rows_t(d)
    else:
        d = torch.from_numpy(np.concatenate(
            [_to_unit_float(b) for b in blocks])).to(dev)
    words_all = tree.quantize(d, num_neighbors=nn, num_checks=num_checks)
    del d
    stages["quantize"] = time.perf_counter() - t

    t = time.perf_counter()
    index = InvertedIndex(tree.num_words)
    k = 0
    for iid in image_ids:
        n = len(per_image[iid])
        index.add_image(iid, words_all[k:k + n] if n
                        else np.zeros((0, 1), np.int32))
        k += n
    index.finalize()
    stages["index"] = time.perf_counter() - t
    if timings is not None:
        timings.update(stages)
    return tree, index


def retrieve_pairs(db, image_ids, num_images: int = 100,
                   max_num_features: int = -1, num_nearest_neighbors: int = 1,
                   num_checks: int = 256, vocab_tree_path: str = "",
                   num_words: int = 4096, device=None) -> list:
    """Top-num_images most similar images per query -> sorted pair list."""
    ranked = retrieve_ranked_pairs(
        db, image_ids, num_images=num_images,
        max_num_features=max_num_features,
        num_nearest_neighbors=num_nearest_neighbors, num_checks=num_checks,
        vocab_tree_path=vocab_tree_path, num_words=num_words, device=device,
    )
    pairs = {
        (min(q, m), max(q, m)) for q, matches in ranked for m, _ in matches
    }
    return sorted(pairs)


def retrieve_ranked_pairs(
    db, image_ids, num_images: int = 100, max_num_features: int = -1,
    num_nearest_neighbors: int = 1, num_checks: int = 256,
    vocab_tree_path: str = "", num_words: int = 4096, device=None,
) -> list:
    """Per-query ranked retrieval: [(query_id, [(match_id, score), ...])].

    Order within each query is by descending tf-idf cosine score — the
    pipelines use it to cap verification work per query
    (num_images_after_verification semantics, ref match_features.h:177-214).
    """
    _, index = build_visual_index(
        db, image_ids, num_words=num_words,
        max_num_features=max_num_features,
        num_neighbors=num_nearest_neighbors, num_checks=num_checks,
        vocab_tree_path=vocab_tree_path, device=device,
    )
    if index is None:
        return []
    out = []
    for row, iid in enumerate(index.image_ids):
        out.append((iid, index.query_row(row, num_images)))
    return out


def detect_loops(db, ordered_image_ids, period: int = 10,
                 num_images: int = 50, num_nearest_neighbors: int = 1,
                 num_checks: int = 256, max_num_features: int = -1,
                 vocab_tree_path: str = "", min_sequence_gap: int = 20,
                 min_score: float = 0.0, device=None):
    """Loop-closure candidates for sequential matching: every `period`-th
    image queries the inverted index; matches far apart in sequence order
    are loop candidates (ref: SequentialMatchingOptions loop_detection_*).

    Returns [(query_id, [(match_id, score), ...])] restricted to
    far-apart-in-sequence matches, for the pipeline to match/verify.
    """
    ids = list(ordered_image_ids)
    _, index = build_visual_index(
        db, ids, max_num_features=max_num_features,
        num_neighbors=num_nearest_neighbors, num_checks=num_checks,
        vocab_tree_path=vocab_tree_path, device=device,
    )
    if index is None:
        return []
    pos = {iid: k for k, iid in enumerate(ids)}
    out = []
    for k in range(0, len(ids), max(period, 1)):
        # over-query: the query's sequential neighbors legitimately score
        # highest and would otherwise crowd loop candidates out of the
        # top-num_images slots before the gap filter
        ranked = index.query_row(k, num_images + 2 * min_sequence_gap)
        loops = [
            (m, s) for m, s in ranked
            if abs(pos[m] - k) > min_sequence_gap and s >= min_score
        ][:num_images]
        if loops:
            out.append((ids[k], loops))
    return out


def build_bow_index(db, image_ids, num_words: int = 4096,
                    max_num_features: int = -1, seed: int = 0, device=None):
    """Back-compat shim: (leaf centers, {image_id: dense tf-idf vec})."""
    tree, index = build_visual_index(
        db, image_ids, num_words=num_words,
        max_num_features=max_num_features, seed=seed, device=device,
    )
    if tree is None:
        return None, {}
    vecs = {}
    for row, iid in enumerate(index.image_ids):
        uw, counts = index._image_words[row]
        v = np.zeros(tree.num_words, np.float32)
        if len(uw):
            t = counts.astype(np.float32) / counts.sum() * index.idf[uw]
            n = np.linalg.norm(t)
            v[uw] = t / n if n > 1e-12 else t
        vecs[iid] = v
    return tree.levels[-1], vecs
