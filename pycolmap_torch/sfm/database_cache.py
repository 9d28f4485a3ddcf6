"""DatabaseCache: load the SQLite database into scene memory + graph.

Upstream analog: colmap/scene DatabaseCache (loaded at the top of
IncrementalMapperController, SURVEY.md §3.3 step 1). Filters pairs by
min_num_matches and finalizes the CSR correspondence graph.
"""

from __future__ import annotations

import numpy as np

from pycolmap_torch.scene import (
    CorrespondenceGraph,
    Database,
    pair_id_to_image_pair,
)


def _make_keypoint_loader(database_path, image_id):
    """Per-image deferred keypoint fetch (fresh connection per call: the
    loading Database handle is closed by the time lazy access happens, and
    closures must survive deepcopy in setup_reconstruction)."""

    def load():
        db = Database(database_path)
        try:
            return db.read_keypoints(image_id)[:, :2]
        finally:
            db.close()

    return load


class DatabaseCache:
    def __init__(self):
        self.cameras = {}
        self.images = {}
        self.correspondence_graph = CorrespondenceGraph()
        # (id1, id2) -> relative rotation angle [rad] from the stored
        # two-view geometry (0 when the matcher did not store a pose)
        self.pair_rotation = {}
        # (id1, id2) -> (qvec wxyz, tvec) of cam2_from_cam1 for verified
        # pairs that stored a pose — the pose-graph relaxation's relative
        # rotation/translation measurements (sfm/pose_graph.py)
        self.pair_pose = {}

    # above this many images, keypoint coordinate arrays stream from the DB
    # on first access instead of being materialized at load (pipeline/sfm.h
    # :59-93 streaming-DB-load analog; bounds load-time RSS at C4/C5 scale)
    LAZY_KEYPOINTS_MIN_IMAGES = 200

    @staticmethod
    def load(
        database_path,
        min_num_matches: int = 15,
        ignore_watermarks: bool = False,
        image_names=None,
        lazy_keypoints: bool | None = None,
    ) -> "DatabaseCache":
        from pycolmap_torch.estimators.two_view_geometry import (
            TwoViewGeometryConfiguration as C,
        )

        cache = DatabaseCache()
        db = Database(database_path)
        try:
            for cam in db.read_all_cameras():
                cache.cameras[cam.camera_id] = cam
            select = set(image_names) if image_names else None
            all_images = [
                img for img in db.read_all_images()
                if select is None or img.name in select
            ]
            if lazy_keypoints is None:
                lazy_keypoints = (
                    len(all_images) >= DatabaseCache.LAZY_KEYPOINTS_MIN_IMAGES
                )
            counts = None
            if lazy_keypoints:
                counts = dict(
                    db._conn.execute("SELECT image_id, rows FROM keypoints")
                )
            for img in all_images:
                if lazy_keypoints:
                    n = int(counts.get(img.image_id, 0) or 0)
                    img.set_lazy_keypoints(
                        n,
                        _make_keypoint_loader(database_path, img.image_id),
                    )
                else:
                    kps = db.read_keypoints(img.image_id)
                    img.set_keypoints(kps[:, :2])
                    n = len(kps)
                cache.images[img.image_id] = img
                cache.correspondence_graph.add_image(img.image_id, n)

            rows = db._conn.execute(
                "SELECT pair_id, rows, data, config, qvec, tvec"
                " FROM two_view_geometries"
            ).fetchall()
            for pair_id, nrows, data, config, qvec, tvec in rows:
                if nrows is None or nrows < min_num_matches:
                    continue
                if ignore_watermarks and config == int(C.WATERMARK):
                    continue
                if config in (int(C.UNDEFINED), int(C.DEGENERATE)):
                    continue
                id1, id2 = pair_id_to_image_pair(pair_id)
                if id1 not in cache.images or id2 not in cache.images:
                    continue
                m = np.frombuffer(data, dtype=np.uint32).reshape(nrows, 2)
                cache.correspondence_graph.add_correspondences(
                    id1, id2, m.astype(np.int64)
                )
                if qvec:
                    q = np.frombuffer(qvec, dtype=np.float64)
                    if q.size == 4 and np.isfinite(q).all():
                        w = abs(q[0]) / max(np.linalg.norm(q), 1e-12)
                        cache.pair_rotation[(id1, id2)] = float(
                            2.0 * np.arccos(min(w, 1.0))
                        )
                        if tvec:
                            t = np.frombuffer(tvec, dtype=np.float64)
                            # identity qvec + zero tvec is the writer's
                            # "no pose recorded" sentinel, not a
                            # measurement — feeding it to the pose graph
                            # would claim the pair has zero relative motion
                            if (
                                t.size == 3
                                and np.isfinite(t).all()
                                and not (
                                    abs(q[0]) > 1.0 - 1e-12
                                    and np.abs(t).max() < 1e-12
                                )
                            ):
                                cache.pair_pose[(id1, id2)] = (
                                    q.copy(), t.copy()
                                )
            cache.correspondence_graph.finalize()
        finally:
            db.close()
        return cache

    @property
    def num_images(self):
        return len(self.images)

    def setup_reconstruction(self, reconstruction):
        """Populate a Reconstruction with the cached cameras + images."""
        for cam_id, cam in self.cameras.items():
            if cam_id not in reconstruction.cameras:
                reconstruction.add_camera(cam)
        for iid, img in self.images.items():
            if iid not in reconstruction.images:
                import copy

                img2 = copy.deepcopy(img)
                img2.registered = False
                reconstruction.add_image(img2)
