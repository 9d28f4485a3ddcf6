"""Feature matching + geometric verification pipelines.

Port of ``pycolmap_tpu/pipeline/match_features.py`` (API parity:
pycolmap/pipeline/match_features.h — ``match_exhaustive`` :219
(ExhaustiveMatchingOptions :102-108), ``match_sequential`` :228
(SequentialMatchingOptions :110-152), ``match_spatial`` :237
(SpatialMatchingOptions :154-175), ``match_vocabtree`` :246
(VocabTreeMatchingOptions :177-214) and ``verify_matches`` :51-68).

The pair list is generated on the host; descriptor matching runs in chunks
of 64 pairs through ``match_descriptors_batch`` (the top-2 kernel on the
card) and verification in blocks of 16 pairs through
``verify_pairs_batch``, both on the entry point's device (default: the
card). ``match_vocabtree`` and sequential loop detection rank candidates
with the vocabulary tree (``features/retrieval.py``), trained and
quantized on the same device.
"""

from __future__ import annotations

import numpy as np

from pycolmap_torch import resolve_device
from pycolmap_torch.estimators.batch_two_view import verify_pairs_batch
from pycolmap_torch.estimators.two_view_geometry import (
    TwoViewGeometryConfiguration,
    TwoViewGeometryOptions,
    estimate_calibrated_two_view_geometry,
)
from pycolmap_torch.features import retrieval
from pycolmap_torch.features.matcher import (
    SiftMatchingOptions,
    match_descriptors_batch,
    match_guided,
)
from pycolmap_torch.scene import Database
from pycolmap_torch.utils.options import BaseOptions, options_dataclass


@options_dataclass
class ExhaustiveMatchingOptions(BaseOptions):
    block_size: int = 50


@options_dataclass
class SequentialMatchingOptions(BaseOptions):
    overlap: int = 10
    quadratic_overlap: bool = True
    loop_detection: bool = False
    loop_detection_period: int = 10
    loop_detection_num_images: int = 50
    loop_detection_num_nearest_neighbors: int = 1
    loop_detection_num_checks: int = 256
    loop_detection_num_images_after_verification: int = 0
    loop_detection_max_num_features: int = -1
    vocab_tree_path: str = ""


@options_dataclass
class SpatialMatchingOptions(BaseOptions):
    ignore_z: bool = True
    max_num_neighbors: int = 50
    max_distance: float = 100.0


@options_dataclass
class VocabTreeMatchingOptions(BaseOptions):
    num_images: int = 100
    num_nearest_neighbors: int = 5
    num_checks: int = 256
    num_images_after_verification: int = 0
    max_num_features: int = -1
    vocab_tree_path: str = ""
    match_list_path: str = ""


class _FeatureCache:
    """Host-side cache of per-image keypoints/descriptors/cameras."""

    def __init__(self, db: Database):
        self.db = db
        self.keypoints = {}
        self.descriptors = {}
        self.cameras = {}
        self.image_cam = {}

    def load(self, image_id: int):
        if image_id not in self.keypoints:
            self.keypoints[image_id] = self.db.read_keypoints(image_id)
            self.descriptors[image_id] = self.db.read_descriptors(image_id)
        return self.keypoints[image_id], self.descriptors[image_id]

    def camera_of(self, image_id: int):
        if image_id not in self.image_cam:
            self.image_cam[image_id] = self.db.read_image(image_id).camera_id
        cam_id = self.image_cam[image_id]
        if cam_id not in self.cameras:
            self.cameras[cam_id] = self.db.read_camera(cam_id)
        return self.cameras[cam_id]


BATCH_VERIFY_SIZE = 16  # pairs verified per batched estimate
BATCH_MATCH_SIZE = 64  # pairs descriptor-matched per call


class _PairMatcher:
    """Shared match+verify engine behind every pairing strategy.

    Verification runs pair-parallel: blocks of pairs are estimated at once
    (estimators/batch_two_view.py); a pair that asks for guided matching
    is re-estimated alone when guided matching finds more matches.
    ``run(pairs)`` returns per-pair pass/fail in order; ``run_ranked``
    serves retrieval-ranked candidates (loop detection, ``match_vocabtree``).
    """

    def __init__(self, db, matching_options, verification_options,
                 device, verbose=False, db_out=None):
        self.db = db
        self.db_out = db_out if db_out is not None else db
        self.matching_options = matching_options
        self.verification_options = verification_options
        self.device = device
        self.verbose = verbose
        self.cache = _FeatureCache(db)

    def run(self, pairs) -> list:
        """Match + verify `pairs`; returns [bool passed] aligned to pairs."""
        mopt, vopt = self.matching_options, self.verification_options
        results = {}
        block = []  # (id1, id2, pair_data dict, d1, d2, kp1, kp2)

        def flush():
            if not block:
                return
            geoms = verify_pairs_batch([b[2] for b in block], vopt,
                                       device=self.device)
            for (id1, id2, p, d1, d2, kp1, kp2), g in zip(block, geoms):
                if mopt.guided_matching and g.config not in (
                    int(TwoViewGeometryConfiguration.UNDEFINED),
                    int(TwoViewGeometryConfiguration.DEGENERATE),
                ):
                    guided = match_guided(
                        d1, d2, kp1[:, :2], kp2[:, :2], g, mopt,
                        max_error=vopt.ransac.max_error, device=self.device,
                    )
                    if len(guided) > len(g.inlier_matches):
                        g2 = estimate_calibrated_two_view_geometry(
                            p["cam1"], kp1[:, :2], p["cam2"], kp2[:, :2],
                            guided, vopt, device=self.device,
                        )
                        if len(g2.inlier_matches) > len(g.inlier_matches):
                            g = g2
                self.db_out.write_two_view_geometry(id1, id2, g)
                results[(id1, id2)] = (
                    len(g.inlier_matches) >= vopt.min_num_inliers
                )
                if self.verbose:
                    print(
                        f"pair ({id1}, {id2}): {len(p['matches'])} "
                        f"matches, {len(g.inlier_matches)} inliers, "
                        f"config {g.config}"
                    )
            block.clear()

        pairs = list(pairs)
        for s in range(0, len(pairs), BATCH_MATCH_SIZE):
            chunk = pairs[s:s + BATCH_MATCH_SIZE]
            feats = [
                (self.cache.load(id1), self.cache.load(id2))
                for id1, id2 in chunk
            ]
            matches_l = match_descriptors_batch(
                [(f1[1], f2[1]) for f1, f2 in feats], mopt, device=self.device
            )
            for (image_id1, image_id2), ((kp1, d1), (kp2, d2)), matches in zip(
                chunk, feats, matches_l
            ):
                self.db_out.write_matches(image_id1, image_id2, matches)
                if len(matches) < vopt.min_num_inliers:
                    results[(image_id1, image_id2)] = False
                    continue
                block.append(
                    (
                        image_id1, image_id2,
                        {
                            "x1_px": kp1[matches[:, 0], :2],
                            "x2_px": kp2[matches[:, 1], :2],
                            "cam1": self.cache.camera_of(image_id1),
                            "cam2": self.cache.camera_of(image_id2),
                            "matches": matches,
                        },
                        d1, d2, kp1, kp2,
                    )
                )
                if len(block) >= BATCH_VERIFY_SIZE:
                    flush()
        flush()
        self.db_out.commit()
        return [results.get(p, False) for p in pairs]

    def run_ranked(self, ranked, cap_after_verification: int = 0) -> int:
        """Retrieval-ranked matching: per query image, candidates are
        verified in descending retrieval-score order; when
        cap_after_verification > 0, a query stops submitting candidates
        after that many PASS verification (num_images_after_verification
        semantics, ref match_features.h:177-214). Pairs already processed
        under an earlier query are not re-verified but count toward the
        cap.

        ranked: [(query_id, [(match_id, score), ...])].
        """
        num_verified = 0
        done: dict = {}
        for query_id, cands in ranked:
            passed = 0
            todo = [
                (min(query_id, m), max(query_id, m)) for m, _ in cands
            ]
            pos = 0
            while pos < len(todo):
                if cap_after_verification > 0 and passed >= cap_after_verification:
                    break
                # submit candidates in blocks; under a cap, never submit
                # more than the successes still needed (each may pass)
                limit = BATCH_VERIFY_SIZE
                if cap_after_verification > 0:
                    limit = min(limit, cap_after_verification - passed)
                chunk = []
                while pos < len(todo) and len(chunk) < limit:
                    key = todo[pos]
                    pos += 1
                    if key in done:
                        passed += int(done[key])
                        if (cap_after_verification > 0
                                and passed >= cap_after_verification):
                            break
                    else:
                        chunk.append(key)
                if chunk:
                    for key, ok in zip(chunk, self.run(chunk)):
                        done[key] = ok
                        passed += int(ok)
                        num_verified += int(ok)
        return num_verified


def _match_and_verify_pairs(
    db: Database,
    pairs,
    matching_options: SiftMatchingOptions,
    verification_options: TwoViewGeometryOptions,
    device,
    verbose: bool = False,
    db_out: Database = None,
):
    matcher = _PairMatcher(db, matching_options, verification_options,
                           device, verbose, db_out)
    return sum(matcher.run(pairs))


def _defaults(sift_options, matching_options, verification_options,
              matching_cls):
    return (sift_options if sift_options is not None else SiftMatchingOptions(),
            matching_options if matching_options is not None else matching_cls(),
            verification_options if verification_options is not None
            else TwoViewGeometryOptions())


def match_exhaustive(
    database_path,
    sift_options: SiftMatchingOptions = None,
    matching_options: ExhaustiveMatchingOptions = None,
    verification_options: TwoViewGeometryOptions = None,
    device=None,
    verbose: bool = False,
):
    """All N(N-1)/2 pairs in block order (ref: match_features.h:219-227).
    Runs on ``device`` (default: the card)."""
    device = resolve_device(device)
    sift_options, matching_options, verification_options = _defaults(
        sift_options, matching_options, verification_options,
        ExhaustiveMatchingOptions)
    db = Database(database_path)
    try:
        image_ids = [img.image_id for img in db.read_all_images()]
        bs = matching_options.block_size
        pairs = []
        # block-partitioned order for cache reuse (ref: block_size semantics)
        for b1 in range(0, len(image_ids), bs):
            for b2 in range(b1, len(image_ids), bs):
                for i in image_ids[b1 : b1 + bs]:
                    for j in image_ids[b2 : b2 + bs]:
                        if i < j:
                            pairs.append((i, j))
        return _match_and_verify_pairs(
            db, pairs, sift_options, verification_options, device, verbose
        )
    finally:
        db.close()


def match_sequential(
    database_path,
    sift_options: SiftMatchingOptions = None,
    matching_options: SequentialMatchingOptions = None,
    verification_options: TwoViewGeometryOptions = None,
    device=None,
    verbose: bool = False,
):
    """Window + quadratic overlap pairs (ref: match_features.h:110-152,
    :228), and with ``loop_detection`` the vocabulary tree's loop
    candidates of every ``loop_detection_period``-th image. Runs on
    ``device`` (default: the card)."""
    device = resolve_device(device)
    sift_options, matching_options, verification_options = _defaults(
        sift_options, matching_options, verification_options,
        SequentialMatchingOptions)
    db = Database(database_path)
    try:
        # sequential order = sorted by name (upstream orders by name)
        images = sorted(db.read_all_images(), key=lambda im: im.name)
        ids = [im.image_id for im in images]
        pairs = set()
        n = len(ids)
        for i in range(n):
            for k in range(1, matching_options.overlap + 1):
                if i + k < n:
                    pairs.add((min(ids[i], ids[i + k]), max(ids[i], ids[i + k])))
                if matching_options.quadratic_overlap:
                    q = i + (1 << k)
                    if q < n:
                        pairs.add((min(ids[i], ids[q]), max(ids[i], ids[q])))
        matcher = _PairMatcher(db, sift_options, verification_options,
                               device, verbose)
        num = sum(matcher.run(sorted(pairs)))
        if matching_options.loop_detection:
            mo = matching_options
            ranked = retrieval.detect_loops(
                db, ids, period=mo.loop_detection_period,
                num_images=mo.loop_detection_num_images,
                num_nearest_neighbors=mo.loop_detection_num_nearest_neighbors,
                num_checks=mo.loop_detection_num_checks,
                max_num_features=mo.loop_detection_max_num_features,
                vocab_tree_path=mo.vocab_tree_path, device=device,
            )
            # drop candidates already matched by the sequential window
            ranked = [
                (q, [(m, s) for m, s in cands
                     if (min(q, m), max(q, m)) not in pairs])
                for q, cands in ranked
            ]
            num += matcher.run_ranked(
                ranked,
                cap_after_verification=(
                    mo.loop_detection_num_images_after_verification),
            )
        return num
    finally:
        db.close()


def match_spatial(
    database_path,
    sift_options: SiftMatchingOptions = None,
    matching_options: SpatialMatchingOptions = None,
    verification_options: TwoViewGeometryOptions = None,
    device=None,
    verbose: bool = False,
):
    """Prior-position kNN pairs (ref: match_features.h:154-175, :237). Runs
    on ``device`` (default: the card)."""
    device = resolve_device(device)
    sift_options, matching_options, verification_options = _defaults(
        sift_options, matching_options, verification_options,
        SpatialMatchingOptions)
    db = Database(database_path)
    try:
        pos = {}
        for im in db.read_all_images():
            if im.cam_from_world_prior is not None:
                c = im.cam_from_world_prior.inverse().translation
                if matching_options.ignore_z:
                    c = np.array([c[0], c[1], 0.0])
                pos[im.image_id] = c
        ids = list(pos.keys())
        if len(ids) < 2:
            return 0
        P = np.stack([pos[i] for i in ids])
        pairs = set()
        d2 = np.sum((P[:, None] - P[None, :]) ** 2, axis=-1)
        np.fill_diagonal(d2, np.inf)
        max_d2 = matching_options.max_distance**2
        for a in range(len(ids)):
            order = np.argsort(d2[a])[: matching_options.max_num_neighbors]
            for b in order:
                if d2[a, b] <= max_d2:
                    pairs.add((min(ids[a], ids[b]), max(ids[a], ids[b])))
        return _match_and_verify_pairs(
            db, sorted(pairs), sift_options, verification_options, device,
            verbose)
    finally:
        db.close()


def match_vocabtree(
    database_path,
    sift_options: SiftMatchingOptions = None,
    matching_options: VocabTreeMatchingOptions = None,
    verification_options: TwoViewGeometryOptions = None,
    device=None,
    verbose: bool = False,
):
    """Visual-retrieval pairs (ref: match_features.h:177-214, :246): each
    image's ``num_images`` most similar images by the vocabulary tree,
    verified in descending score order (at most
    ``num_images_after_verification`` passing per query when > 0), or the
    pairs of ``match_list_path``. Runs on ``device`` (default: the
    card)."""
    device = resolve_device(device)
    sift_options, matching_options, verification_options = _defaults(
        sift_options, matching_options, verification_options,
        VocabTreeMatchingOptions)
    db = Database(database_path)
    try:
        images = db.read_all_images()
        if matching_options.match_list_path:
            # explicit pair list file: "name1 name2" per line (ref
            # VocabTreeMatchingOptions::match_list_path)
            with open(matching_options.match_list_path) as f:
                name_pairs = [ln.split() for ln in f if ln.strip()]
            by_name = {im.name: im.image_id for im in images}
            pairs = sorted(
                {
                    (min(by_name[a], by_name[b]), max(by_name[a], by_name[b]))
                    for a, b in name_pairs
                    if a in by_name and b in by_name
                }
            )
            return _match_and_verify_pairs(
                db, pairs, sift_options, verification_options, device,
                verbose)
        mo = matching_options
        ranked = retrieval.retrieve_ranked_pairs(
            db, [im.image_id for im in images], num_images=mo.num_images,
            max_num_features=mo.max_num_features,
            num_nearest_neighbors=mo.num_nearest_neighbors,
            num_checks=mo.num_checks, vocab_tree_path=mo.vocab_tree_path,
            device=device,
        )
        matcher = _PairMatcher(db, sift_options, verification_options,
                               device, verbose)
        return matcher.run_ranked(
            ranked, cap_after_verification=mo.num_images_after_verification)
    finally:
        db.close()


def verify_matches(
    database_path,
    pairs,
    options: TwoViewGeometryOptions = None,
    device=None,
):
    """Geometric verification of existing matches for given (name1, name2)
    or (id1, id2) pairs (ref: match_features.h:51-68), one pair at a time
    through the per-pair estimators on ``device`` (default: the card)."""
    device = resolve_device(device)
    if options is None:
        options = TwoViewGeometryOptions()
    db = Database(database_path)
    try:
        cache = _FeatureCache(db)
        resolved = []
        for a, b in pairs:
            if isinstance(a, str):
                a = db.image_id_from_name(a)
                b = db.image_id_from_name(b)
            if a is None or b is None:
                continue
            resolved.append((a, b))
        num = 0
        for image_id1, image_id2 in resolved:
            matches = db.read_matches(image_id1, image_id2)
            kp1, _ = cache.load(image_id1)
            kp2, _ = cache.load(image_id2)
            g = estimate_calibrated_two_view_geometry(
                cache.camera_of(image_id1), kp1[:, :2],
                cache.camera_of(image_id2), kp2[:, :2], matches, options,
                device=device,
            )
            db.write_two_view_geometry(image_id1, image_id2, g)
            if len(g.inlier_matches) >= options.min_num_inliers:
                num += 1
        db.commit()
        return num
    finally:
        db.close()
