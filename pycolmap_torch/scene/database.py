"""SQLite feature/match database, schema-compatible with COLMAP.

API parity: pycolmap/scene/database.h:9-47 (+ the upstream colmap/scene
Database the binding wraps). The schema (tables cameras, images, keypoints,
descriptors, matches, two_view_geometries; blob layouts; pair_id packing
``pair_id = id1 * 2147483647 + id2`` per scene/database.h:28-29) matches
COLMAP 3.9.1 so databases interoperate both ways.

This is the I/O layer between pipeline stages — a checkpoint, not a compute
path (SURVEY.md §5 checkpoint/resume), hence plain Python sqlite3.
"""

from __future__ import annotations

import sqlite3

import numpy as np

from pycolmap_torch.geometry.types import Rigid3d, Rotation3d
from pycolmap_torch.scene.camera import Camera
from pycolmap_torch.scene.image import Image

MAX_NUM_IMAGES = 2147483647


def image_pair_to_pair_id(image_id1: int, image_id2: int) -> int:
    if image_id1 > image_id2:
        image_id1, image_id2 = image_id2, image_id1
    return image_id1 * MAX_NUM_IMAGES + image_id2


def pair_id_to_image_pair(pair_id: int):
    image_id2 = pair_id % MAX_NUM_IMAGES
    image_id1 = pair_id // MAX_NUM_IMAGES
    return int(image_id1), int(image_id2)


def swap_image_pair(image_id1: int, image_id2: int) -> bool:
    """True if the pair was stored swapped (id1 > id2)."""
    return image_id1 > image_id2


_SCHEMA = """
CREATE TABLE IF NOT EXISTS cameras (
    camera_id INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    model     INTEGER NOT NULL,
    width     INTEGER NOT NULL,
    height    INTEGER NOT NULL,
    params    BLOB,
    prior_focal_length INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS images (
    image_id  INTEGER PRIMARY KEY AUTOINCREMENT NOT NULL,
    name      TEXT NOT NULL UNIQUE,
    camera_id INTEGER NOT NULL,
    prior_qw REAL, prior_qx REAL, prior_qy REAL, prior_qz REAL,
    prior_tx REAL, prior_ty REAL, prior_tz REAL,
    CONSTRAINT image_id_check CHECK(image_id >= 0 and image_id < 2147483647),
    FOREIGN KEY(camera_id) REFERENCES cameras(camera_id));
CREATE UNIQUE INDEX IF NOT EXISTS index_name ON images(name);
CREATE TABLE IF NOT EXISTS keypoints (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS descriptors (
    image_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    FOREIGN KEY(image_id) REFERENCES images(image_id) ON DELETE CASCADE);
CREATE TABLE IF NOT EXISTS matches (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB);
CREATE TABLE IF NOT EXISTS two_view_geometries (
    pair_id INTEGER PRIMARY KEY NOT NULL,
    rows INTEGER NOT NULL, cols INTEGER NOT NULL, data BLOB,
    config INTEGER NOT NULL,
    F BLOB, E BLOB, H BLOB, qvec BLOB, tvec BLOB);
"""


def _blob(arr, dtype) -> bytes:
    return np.ascontiguousarray(arr, dtype=dtype).tobytes()


def _mat_blob(mat) -> bytes:
    if mat is None:
        return np.zeros(0).tobytes()
    return np.ascontiguousarray(mat, dtype=np.float64).tobytes()


def keypoints_to_affine(keypoints: np.ndarray) -> np.ndarray:
    """Nx2/Nx4 (x,y[,scale,orientation]) -> Nx6 affine keypoint rows.

    Matches upstream FeatureKeypoint::FromParameters: the affine shape is
    scale * rot(orientation).
    """
    keypoints = np.asarray(keypoints, dtype=np.float32)
    n = keypoints.shape[0]
    out = np.zeros((n, 6), dtype=np.float32)
    out[:, :2] = keypoints[:, :2]
    if keypoints.shape[1] >= 4:
        scale = keypoints[:, 2]
        ori = keypoints[:, 3]
        c, s = np.cos(ori), np.sin(ori)
        out[:, 2] = scale * c
        out[:, 3] = -scale * s
        out[:, 4] = scale * s
        out[:, 5] = scale * c
    else:
        out[:, 2] = 1.0
        out[:, 5] = 1.0
    return out


def affine_to_keypoints(data: np.ndarray) -> np.ndarray:
    """Nx6 affine rows -> Nx4 (x, y, scale, orientation)."""
    data = np.asarray(data, dtype=np.float32)
    if data.shape[1] == 2:
        out = np.zeros((data.shape[0], 4), dtype=np.float32)
        out[:, :2] = data
        out[:, 2] = 1.0
        return out
    if data.shape[1] == 4:
        return data.copy()
    out = np.zeros((data.shape[0], 4), dtype=np.float32)
    out[:, :2] = data[:, :2]
    out[:, 2] = np.sqrt(np.maximum(data[:, 2] ** 2 + data[:, 4] ** 2, 0))
    out[:, 3] = np.arctan2(data[:, 4], data[:, 2])
    return out


class Database:
    """COLMAP-compatible feature/match store."""

    def __init__(self, path=None):
        self._conn = None
        if path is not None:
            self.open(path)

    # -- lifecycle ----------------------------------------------------------
    def open(self, path):
        self._conn = sqlite3.connect(str(path))
        self._conn.executescript(_SCHEMA)
        self._conn.commit()

    def close(self):
        if self._conn is not None:
            self._conn.commit()
            self._conn.close()
            self._conn = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- counts -------------------------------------------------------------
    def _count(self, table) -> int:
        return self._conn.execute(f"SELECT COUNT(*) FROM {table}").fetchone()[0]

    @property
    def num_cameras(self):
        return self._count("cameras")

    @property
    def num_images(self):
        return self._count("images")

    @property
    def num_keypoints(self):
        r = self._conn.execute("SELECT SUM(rows) FROM keypoints").fetchone()[0]
        return int(r or 0)

    @property
    def num_descriptors(self):
        r = self._conn.execute("SELECT SUM(rows) FROM descriptors").fetchone()[0]
        return int(r or 0)

    @property
    def num_matches(self):
        r = self._conn.execute("SELECT SUM(rows) FROM matches").fetchone()[0]
        return int(r or 0)

    @property
    def num_matched_image_pairs(self):
        return self._count("matches")

    @property
    def num_verified_image_pairs(self):
        return self._count("two_view_geometries")

    @property
    def num_inlier_matches(self):
        r = self._conn.execute(
            "SELECT SUM(rows) FROM two_view_geometries"
        ).fetchone()[0]
        return int(r or 0)

    # -- cameras ------------------------------------------------------------
    def write_camera(self, camera: Camera, use_camera_id: bool = False) -> int:
        params_blob = _blob(camera.params, np.float64)
        if use_camera_id:
            self._conn.execute(
                "INSERT INTO cameras VALUES (?, ?, ?, ?, ?, ?)",
                (camera.camera_id, camera.model_id, camera.width, camera.height,
                 params_blob, int(camera.has_prior_focal_length)),
            )
            cam_id = camera.camera_id
        else:
            cur = self._conn.execute(
                "INSERT INTO cameras (model, width, height, params, prior_focal_length)"
                " VALUES (?, ?, ?, ?, ?)",
                (camera.model_id, camera.width, camera.height, params_blob,
                 int(camera.has_prior_focal_length)),
            )
            cam_id = cur.lastrowid
        return cam_id

    def update_camera(self, camera: Camera):
        self._conn.execute(
            "UPDATE cameras SET model=?, width=?, height=?, params=?, "
            "prior_focal_length=? WHERE camera_id=?",
            (camera.model_id, camera.width, camera.height,
             _blob(camera.params, np.float64),
             int(camera.has_prior_focal_length), camera.camera_id),
        )

    def read_camera(self, camera_id: int) -> Camera:
        row = self._conn.execute(
            "SELECT camera_id, model, width, height, params, prior_focal_length"
            " FROM cameras WHERE camera_id=?", (camera_id,)
        ).fetchone()
        if row is None:
            raise KeyError(f"camera {camera_id} not in database")
        params = np.frombuffer(row[4], dtype=np.float64) if row[4] else np.zeros(0)
        cam = Camera(row[0], int(row[1]), row[2], row[3], params.copy())
        cam.has_prior_focal_length = bool(row[5])
        return cam

    def read_all_cameras(self):
        return [
            self.read_camera(r[0])
            for r in self._conn.execute("SELECT camera_id FROM cameras")
        ]

    # -- images -------------------------------------------------------------
    def write_image(self, image: Image, use_image_id: bool = False) -> int:
        prior = image.cam_from_world_prior
        if prior is not None:
            q = prior.rotation.quat  # xyzw
            vals = (q[3], q[0], q[1], q[2], *prior.translation)
        else:
            vals = (None,) * 7
        if use_image_id:
            cur = self._conn.execute(
                "INSERT INTO images VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?, ?)",
                (image.image_id, image.name, image.camera_id, *vals),
            )
            return image.image_id
        cur = self._conn.execute(
            "INSERT INTO images (name, camera_id, prior_qw, prior_qx, prior_qy,"
            " prior_qz, prior_tx, prior_ty, prior_tz)"
            " VALUES (?, ?, ?, ?, ?, ?, ?, ?, ?)",
            (image.name, image.camera_id, *vals),
        )
        return cur.lastrowid

    def read_image(self, image_id: int) -> Image:
        row = self._conn.execute(
            "SELECT image_id, name, camera_id, prior_qw, prior_qx, prior_qy,"
            " prior_qz, prior_tx, prior_ty, prior_tz FROM images WHERE image_id=?",
            (image_id,),
        ).fetchone()
        if row is None:
            raise KeyError(f"image {image_id} not in database")
        img = Image(name=row[1], camera_id=row[2], id=row[0])
        if row[3] is not None:
            img.cam_from_world_prior = Rigid3d(
                Rotation3d(np.array([row[4], row[5], row[6], row[3]])),
                np.array([row[7], row[8], row[9]]),
            )
        return img

    def read_all_images(self):
        return [
            self.read_image(r[0])
            for r in self._conn.execute("SELECT image_id FROM images ORDER BY image_id")
        ]

    def image_id_from_name(self, name: str):
        row = self._conn.execute(
            "SELECT image_id FROM images WHERE name=?", (name,)
        ).fetchone()
        return None if row is None else int(row[0])

    def exists_image(self, image_id: int) -> bool:
        return (
            self._conn.execute(
                "SELECT 1 FROM images WHERE image_id=?", (image_id,)
            ).fetchone()
            is not None
        )

    # -- keypoints / descriptors --------------------------------------------
    def write_keypoints(self, image_id: int, keypoints: np.ndarray):
        """keypoints: Nx2 / Nx4 (x,y,scale,ori) / Nx6 affine; stored as Nx6."""
        kp = np.asarray(keypoints, dtype=np.float32)
        if kp.ndim != 2:
            raise ValueError("keypoints must be 2D")
        if kp.shape[1] != 6:
            kp = keypoints_to_affine(kp)
        self._conn.execute(
            "INSERT OR REPLACE INTO keypoints VALUES (?, ?, ?, ?)",
            (image_id, kp.shape[0], kp.shape[1], _blob(kp, np.float32)),
        )

    def read_keypoints(self, image_id: int) -> np.ndarray:
        """Returns Nx4 (x, y, scale, orientation)."""
        row = self._conn.execute(
            "SELECT rows, cols, data FROM keypoints WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 4), dtype=np.float32)
        data = np.frombuffer(row[2], dtype=np.float32).reshape(row[0], row[1])
        return affine_to_keypoints(data)

    def write_descriptors(self, image_id: int, descriptors: np.ndarray):
        desc = np.asarray(descriptors, dtype=np.uint8)
        self._conn.execute(
            "INSERT OR REPLACE INTO descriptors VALUES (?, ?, ?, ?)",
            (image_id, desc.shape[0], desc.shape[1], _blob(desc, np.uint8)),
        )

    def read_descriptors(self, image_id: int) -> np.ndarray:
        row = self._conn.execute(
            "SELECT rows, cols, data FROM descriptors WHERE image_id=?", (image_id,)
        ).fetchone()
        if row is None:
            return np.zeros((0, 128), dtype=np.uint8)
        return np.frombuffer(row[2], dtype=np.uint8).reshape(row[0], row[1]).copy()

    def exists_keypoints(self, image_id: int) -> bool:
        return (
            self._conn.execute(
                "SELECT 1 FROM keypoints WHERE image_id=?", (image_id,)
            ).fetchone()
            is not None
        )

    def exists_descriptors(self, image_id: int) -> bool:
        return (
            self._conn.execute(
                "SELECT 1 FROM descriptors WHERE image_id=?", (image_id,)
            ).fetchone()
            is not None
        )

    # -- matches ------------------------------------------------------------
    def write_matches(self, image_id1: int, image_id2: int, matches: np.ndarray):
        """matches: Nx2 uint32 indices (idx_in_1, idx_in_2)."""
        m = np.asarray(matches, dtype=np.uint32).reshape(-1, 2)
        if swap_image_pair(image_id1, image_id2):
            m = m[:, ::-1]
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        self._conn.execute(
            "INSERT OR REPLACE INTO matches VALUES (?, ?, ?, ?)",
            (pair_id, m.shape[0], 2, _blob(m, np.uint32)),
        )

    def read_matches(self, image_id1: int, image_id2: int) -> np.ndarray:
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        row = self._conn.execute(
            "SELECT rows, cols, data FROM matches WHERE pair_id=?", (pair_id,)
        ).fetchone()
        if row is None or row[0] == 0:
            return np.zeros((0, 2), dtype=np.uint32)
        m = np.frombuffer(row[2], dtype=np.uint32).reshape(row[0], row[1]).copy()
        if swap_image_pair(image_id1, image_id2):
            m = m[:, ::-1]
        return m

    def read_all_matches(self):
        """Returns (pair_ids list, list of Nx2 arrays)."""
        pair_ids, all_matches = [], []
        for pair_id, rows, cols, data in self._conn.execute(
            "SELECT pair_id, rows, cols, data FROM matches"
        ):
            pair_ids.append(pair_id)
            if rows:
                all_matches.append(
                    np.frombuffer(data, dtype=np.uint32).reshape(rows, cols).copy()
                )
            else:
                all_matches.append(np.zeros((0, 2), dtype=np.uint32))
        return pair_ids, all_matches

    # -- two-view geometries -------------------------------------------------
    def write_two_view_geometry(self, image_id1: int, image_id2: int, geometry):
        """geometry: TwoViewGeometry-like with inlier_matches, config, E/F/H, cam2_from_cam1."""
        m = np.asarray(geometry.inlier_matches, dtype=np.uint32).reshape(-1, 2)
        if swap_image_pair(image_id1, image_id2):
            m = m[:, ::-1]
        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        qvec = np.array([1.0, 0, 0, 0])
        tvec = np.zeros(3)
        if getattr(geometry, "cam2_from_cam1", None) is not None:
            q = geometry.cam2_from_cam1.rotation.quat  # xyzw
            qvec = np.array([q[3], q[0], q[1], q[2]])
            tvec = geometry.cam2_from_cam1.translation
        self._conn.execute(
            "INSERT OR REPLACE INTO two_view_geometries VALUES (?,?,?,?,?,?,?,?,?,?)",
            (pair_id, m.shape[0], 2, _blob(m, np.uint32), int(geometry.config),
             _mat_blob(getattr(geometry, "F", None)),
             _mat_blob(getattr(geometry, "E", None)),
             _mat_blob(getattr(geometry, "H", None)),
             _mat_blob(qvec), _mat_blob(tvec)),
        )

    def read_two_view_geometry(self, image_id1: int, image_id2: int):
        from pycolmap_torch.estimators.two_view_geometry import TwoViewGeometry

        pair_id = image_pair_to_pair_id(image_id1, image_id2)
        row = self._conn.execute(
            "SELECT rows, cols, data, config, F, E, H, qvec, tvec"
            " FROM two_view_geometries WHERE pair_id=?",
            (pair_id,),
        ).fetchone()
        if row is None:
            return None
        g = TwoViewGeometry()
        if row[0]:
            m = np.frombuffer(row[2], dtype=np.uint32).reshape(row[0], row[1]).copy()
            if swap_image_pair(image_id1, image_id2):
                m = m[:, ::-1]
            g.inlier_matches = m
        g.config = int(row[3])

        def _unmat(b):
            if b is None:
                return None
            a = np.frombuffer(b, dtype=np.float64)
            return a.reshape(3, 3).copy() if a.size == 9 else None

        g.F, g.E, g.H = _unmat(row[4]), _unmat(row[5]), _unmat(row[6])
        q = np.frombuffer(row[7], dtype=np.float64) if row[7] else np.zeros(0)
        t = np.frombuffer(row[8], dtype=np.float64) if row[8] else np.zeros(0)
        if q.size == 4 and t.size == 3:
            g.cam2_from_cam1 = Rigid3d(
                Rotation3d(np.array([q[1], q[2], q[3], q[0]])), t.copy()
            )
        return g

    def read_two_view_geometries(self):
        """All verified pairs: returns (pair_ids, list of inlier match arrays)."""
        pair_ids, all_matches = [], []
        for pair_id, rows, cols, data in self._conn.execute(
            "SELECT pair_id, rows, cols, data FROM two_view_geometries"
        ):
            pair_ids.append(pair_id)
            if rows:
                all_matches.append(
                    np.frombuffer(data, dtype=np.uint32).reshape(rows, cols).copy()
                )
            else:
                all_matches.append(np.zeros((0, 2), dtype=np.uint32))
        return pair_ids, all_matches

    def read_two_view_geometry_num_inliers(self):
        """(pair_ids, num_inliers) without decoding match blobs."""
        rows = self._conn.execute(
            "SELECT pair_id, rows FROM two_view_geometries"
        ).fetchall()
        return [r[0] for r in rows], [r[1] for r in rows]

    def clear_matches(self):
        self._conn.execute("DELETE FROM matches")

    def clear_two_view_geometries(self):
        self._conn.execute("DELETE FROM two_view_geometries")

    def commit(self):
        self._conn.commit()


class DatabaseTransaction:
    """Context-managed transaction (ref: scene/database.h:45-46)."""

    def __init__(self, database: Database):
        self._db = database

    def __enter__(self):
        self._db._conn.execute("BEGIN")
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self._db._conn.commit()
        else:
            self._db._conn.rollback()
        return False
