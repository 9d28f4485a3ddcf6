"""Reconstruction: the central scene container (cameras + images + points3D).

API parity: pycolmap/scene/reconstruction.h:57-439. I/O is byte-compatible
with COLMAP's cameras/images/points3D ``.bin``/``.txt`` formats (format fixed
by upstream Reconstruction::Read/Write, ref: scene/reconstruction.h:68-103),
so golden tests can compare against files written by the reference and users
can interoperate with existing COLMAP tooling.

Heavy numeric paths (reprojection-error stats, filtering) batch all
observations into arrays and project them image by image through the numpy
camera models rather than looping per observation.

Port of ``pycolmap_tpu/scene/reconstruction.py``: the same host numpy code,
so both packages write byte-identical model files.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

from pycolmap_torch.geometry.types import Rigid3d, Rotation3d, Sim3d
from pycolmap_torch.scene.camera import Camera
from pycolmap_torch.scene.image import Image
from pycolmap_torch.scene.point2d import INVALID_POINT3D_ID
from pycolmap_torch.scene.point3d import Point3D
from pycolmap_torch.scene.track import Track, TrackElement
from pycolmap_torch.ops import camera_models as cm


def _read_next_bytes(fid, num_bytes, fmt):
    return struct.unpack("<" + fmt, fid.read(num_bytes))


class Reconstruction:
    def __init__(self, path=None):
        self.cameras: dict[int, Camera] = {}
        self.images: dict[int, Image] = {}
        self.points3D: dict[int, Point3D] = {}
        self._num_added_points3D = 0
        if path is not None:
            self.read(path)

    # ------------------------------------------------------------------
    # basic accessors / mutation (ref: scene/reconstruction.h:126-184)
    # ------------------------------------------------------------------
    @property
    def num_cameras(self) -> int:
        return len(self.cameras)

    @property
    def num_images(self) -> int:
        return len(self.images)

    @property
    def num_points3D(self) -> int:
        return len(self.points3D)

    @property
    def num_reg_images(self) -> int:
        return sum(1 for im in self.images.values() if im.registered)

    @property
    def reg_image_ids(self):
        return [i for i, im in self.images.items() if im.registered]

    def add_camera(self, camera: Camera):
        if camera.camera_id in self.cameras:
            raise ValueError(f"camera {camera.camera_id} already exists")
        self.cameras[camera.camera_id] = camera

    def add_image(self, image: Image):
        if image.image_id in self.images:
            raise ValueError(f"image {image.image_id} already exists")
        self.images[image.image_id] = image

    def add_point3D(self, xyz, track: Track = None, color=(0, 0, 0)) -> int:
        self._num_added_points3D += 1
        point3D_id = self._num_added_points3D
        pt = Point3D(xyz, color=color, track=track if track is not None else Track())
        self.points3D[point3D_id] = pt
        for el in pt.track.elements:
            self.images[el.image_id].set_point3D_for_point2D(el.point2D_idx, point3D_id)
        return point3D_id

    def add_observation(self, point3D_id: int, element: TrackElement):
        self.points3D[point3D_id].track.append(element)
        self.images[element.image_id].set_point3D_for_point2D(
            element.point2D_idx, point3D_id
        )

    def delete_point3D(self, point3D_id: int):
        pt = self.points3D.pop(point3D_id, None)
        if pt is None:
            return
        for el in pt.track.elements:
            img = self.images.get(el.image_id)
            if img is not None and img.points2D_point3D_ids[el.point2D_idx] == np.uint64(point3D_id):
                img.reset_point3D_for_point2D(el.point2D_idx)

    def delete_observation(self, image_id: int, point2D_idx: int):
        img = self.images[image_id]
        point3D_id = int(img.points2D_point3D_ids[point2D_idx])
        if point3D_id == INVALID_POINT3D_ID:
            return
        pt = self.points3D[point3D_id]
        if pt.track.length() <= 2:
            self.delete_point3D(point3D_id)
            return
        pt.track.delete_element(image_id, point2D_idx)
        img.reset_point3D_for_point2D(point2D_idx)

    def merge_points3D(self, point3D_id1: int, point3D_id2: int) -> int:
        """Merge two points; weighted-average position; returns new id."""
        p1 = self.points3D[point3D_id1]
        p2 = self.points3D[point3D_id2]
        n1, n2 = p1.track.length(), p2.track.length()
        xyz = (n1 * p1.xyz + n2 * p2.xyz) / (n1 + n2)
        color = ((n1 * p1.color.astype(np.float64) + n2 * p2.color) / (n1 + n2)).astype(np.uint8)
        track = Track(p1.track.elements + p2.track.elements)
        self.delete_point3D(point3D_id1)
        self.delete_point3D(point3D_id2)
        return self.add_point3D(xyz, track, color)

    def register_image(self, image_id: int):
        self.images[image_id].registered = True

    def deregister_image(self, image_id: int):
        """Deregister and drop all of the image's observations."""
        img = self.images[image_id]
        for idx in list(img.get_observation_points2D_idxs()):
            self.delete_observation(image_id, int(idx))
        img.registered = False

    def is_image_registered(self, image_id: int) -> bool:
        return self.images[image_id].registered

    # ------------------------------------------------------------------
    # geometry ops (ref: scene/reconstruction.h:185-247)
    # ------------------------------------------------------------------
    def compute_centroid(self, p0: float = 0.1, p1: float = 0.9) -> np.ndarray:
        xyz = self._points_array()
        if len(xyz) == 0:
            return np.zeros(3)
        lo = np.quantile(xyz, p0, axis=0)
        hi = np.quantile(xyz, p1, axis=0)
        sel = np.all((xyz >= lo) & (xyz <= hi), axis=1)
        if not np.any(sel):
            return xyz.mean(axis=0)
        return xyz[sel].mean(axis=0)

    def compute_bounding_box(self, p0: float = 0.0, p1: float = 1.0):
        xyz = self._points_array()
        if len(xyz) == 0:
            return np.zeros(3), np.zeros(3)
        return np.quantile(xyz, p0, axis=0), np.quantile(xyz, p1, axis=0)

    def normalize(
        self,
        fixed_scale: bool = False,
        extent: float = 10.0,
        p0: float = 0.1,
        p1: float = 0.9,
        use_images: bool = True,
    ) -> Sim3d:
        """Center and rescale the scene (ref: scene/reconstruction.h:185-196)."""
        if use_images:
            data = np.array(
                [self.images[i].projection_center() for i in self.reg_image_ids]
            ).reshape(-1, 3)
        else:
            data = self._points_array()
        if len(data) < 2:
            return Sim3d()
        lo = np.quantile(data, p0, axis=0)
        hi = np.quantile(data, p1, axis=0)
        sel = np.all((data >= lo) & (data <= hi), axis=1)
        sel_data = data[sel] if np.any(sel) else data
        centroid = sel_data.mean(axis=0)
        if fixed_scale:
            scale = 1.0
        else:
            old_extent = float(np.max(hi - lo))
            scale = extent / old_extent if old_extent > 1e-12 else 1.0
        tform = Sim3d(scale, Rotation3d(), -scale * centroid)
        self.transform(tform)
        return tform

    def transform(self, tform: Sim3d):
        """Apply new_world = tform * old_world to everything."""
        for pt in self.points3D.values():
            pt.xyz = tform * pt.xyz
        for img in self.images.values():
            img.cam_from_world = tform.transform_camera_world(img.cam_from_world)

    def crop(self, bbox_min, bbox_max) -> "Reconstruction":
        """Return a copy with points outside the box removed (ref: :213-247)."""
        import copy as _copy

        out = _copy.deepcopy(self)
        bbox_min = np.asarray(bbox_min)
        bbox_max = np.asarray(bbox_max)
        for pid in list(out.points3D.keys()):
            xyz = out.points3D[pid].xyz
            if np.any(xyz < bbox_min) or np.any(xyz > bbox_max):
                out.delete_point3D(pid)
        return out

    # ------------------------------------------------------------------
    # stats (ref: scene/reconstruction.h:248-253, 425-438)
    # ------------------------------------------------------------------
    def _points_array(self) -> np.ndarray:
        if not self.points3D:
            return np.zeros((0, 3))
        return np.array([p.xyz for p in self.points3D.values()])

    def compute_num_observations(self) -> int:
        return sum(p.track.length() for p in self.points3D.values())

    def compute_mean_track_length(self) -> float:
        if not self.points3D:
            return 0.0
        return self.compute_num_observations() / len(self.points3D)

    def compute_mean_observations_per_reg_image(self) -> float:
        n = self.num_reg_images
        if n == 0:
            return 0.0
        return self.compute_num_observations() / n

    def _point_table(self):
        """(sorted pid array [P], xyz table [P, 3]) for vectorized lookups."""
        P = len(self.points3D)
        pid_arr = np.fromiter(self.points3D.keys(), dtype=np.int64, count=P)
        if P == 0:
            return pid_arr, np.zeros((0, 3))
        xyz_arr = np.stack([pt.xyz for pt in self.points3D.values()])
        order = np.argsort(pid_arr)
        return pid_arr[order], xyz_arr[order]

    def _all_observations(self, point3D_ids=None):
        """Flatten (a subset of) observations into arrays, image-major.

        Vectorized: one numpy pass per registered image (no per-observation
        python loop — that loop dominated local-BA filtering wall time).
        Returns (point3D_ids, xyz [M,3], image_ids, xy [M,2], point2D_idxs).
        """
        pid_table, xyz_table = self._point_table()
        sel = None
        if point3D_ids is not None:
            sel = np.fromiter(point3D_ids, dtype=np.int64)
        pids_l, xyz_l, iids_l, xy_l, p2d_l = [], [], [], [], []
        for iid, img in self.images.items():
            if not img.registered:
                continue
            idxs = img.get_observation_points2D_idxs()
            if len(idxs) == 0:
                continue
            pids_i = img.points2D_point3D_ids[idxs].view(np.int64)
            if sel is not None:
                keep = np.isin(pids_i, sel)
                if not keep.any():
                    continue
                idxs = idxs[keep]
                pids_i = pids_i[keep]
            rows = np.searchsorted(pid_table, pids_i)
            # defensive: drop stale links (pid no longer in points3D)
            rows_safe = np.minimum(rows, max(len(pid_table) - 1, 0))
            ok = (
                (len(pid_table) > 0)
                & (rows < len(pid_table))
                & (pid_table[rows_safe] == pids_i)
            )
            if not np.all(ok):
                idxs = idxs[ok]
                pids_i = pids_i[ok]
                rows_safe = rows_safe[ok]
            pids_l.append(pids_i)
            xyz_l.append(xyz_table[rows_safe])
            iids_l.append(np.full(len(idxs), iid, dtype=np.int64))
            xy_l.append(img.points2D_xy[idxs])
            p2d_l.append(idxs.astype(np.int64))
        if not pids_l:
            return (
                np.zeros(0, dtype=np.int64),
                np.zeros((0, 3)),
                np.zeros(0, dtype=np.int64),
                np.zeros((0, 2)),
                np.zeros(0, dtype=np.int64),
            )
        return (
            np.concatenate(pids_l),
            np.concatenate(xyz_l),
            np.concatenate(iids_l),
            np.concatenate(xy_l),
            np.concatenate(p2d_l),
        )

    def _reproj_errors_full(self, point3D_ids=None):
        """Per-observation reprojection errors, image-major vectorized.

        Returns (pids, iids, p2ds, errors, depths) arrays of length M.
        """
        pids, xyz, iids, xy, p2ds = self._all_observations(point3D_ids)
        M = len(pids)
        errors = np.zeros(M)
        depths = np.zeros(M)
        if M == 0:
            return pids, iids, p2ds, errors, depths
        # observations are image-contiguous: one projection batch per image
        bounds = np.nonzero(np.diff(iids, prepend=iids[0] - 1))[0]
        bounds = np.append(bounds, M)
        for s, e in zip(bounds[:-1], bounds[1:]):
            img = self.images[int(iids[s])]
            cam = self.cameras[img.camera_id]
            R_t = img.cam_from_world.matrix()
            p_cam = xyz[s:e] @ R_t[:, :3].T + R_t[:, 3]
            z = p_cam[:, 2]
            uv = p_cam[:, :2] / np.where(
                np.abs(z[:, None]) < 1e-12, 1e-12, z[:, None]
            )
            proj = cam.img_from_cam(uv)
            err = np.linalg.norm(proj - xy[s:e], axis=1)
            errors[s:e] = np.where(z > 0, err, np.inf)
            depths[s:e] = z
        return pids, iids, p2ds, errors, depths

    def compute_reprojection_errors(self, point3D_ids=None):
        """Per-observation reprojection errors.

        Returns (point3D_ids, image_ids, errors, depths) arrays of length M.
        """
        pids, iids, _, errors, depths = self._reproj_errors_full(point3D_ids)
        return pids, iids, errors, depths

    def compute_mean_reprojection_error(self) -> float:
        _, _, errors, _ = self.compute_reprojection_errors()
        finite = errors[np.isfinite(errors)]
        return float(finite.mean()) if len(finite) else 0.0

    def update_point_errors(self):
        """Recompute and store per-point mean reprojection error."""
        pids, _, errors, _ = self.compute_reprojection_errors()
        finite = np.isfinite(errors)
        pids = pids[finite]
        errors = errors[finite]
        if len(pids) == 0:
            return
        order = np.argsort(pids, kind="stable")
        spids = pids[order]
        serrs = errors[order]
        starts = np.nonzero(np.diff(spids, prepend=spids[0] - 1))[0]
        counts = np.diff(np.append(starts, len(spids)))
        means = np.add.reduceat(serrs, starts) / counts
        for pid, m in zip(spids[starts].tolist(), means.tolist()):
            pt = self.points3D.get(pid)
            if pt is not None:
                pt.error = m

    def summary(self) -> str:
        return (
            "Reconstruction:"
            f"\n\tnum_reg_images = {self.num_reg_images}"
            f"\n\tnum_cameras = {self.num_cameras}"
            f"\n\tnum_points3D = {self.num_points3D}"
            f"\n\tnum_observations = {self.compute_num_observations()}"
            f"\n\tmean_track_length = {self.compute_mean_track_length():.5g}"
            f"\n\tmean_observations_per_image = {self.compute_mean_observations_per_reg_image():.5g}"
            f"\n\tmean_reprojection_error = {self.compute_mean_reprojection_error():.5g}"
        )

    def __repr__(self):
        return (
            f"Reconstruction(num_reg_images={self.num_reg_images}, "
            f"num_cameras={self.num_cameras}, num_points3D={self.num_points3D}, "
            f"num_observations={self.compute_num_observations()})"
        )

    # ------------------------------------------------------------------
    # filtering (ref: scene/reconstruction.h:213-247; upstream FilterPoints3D)
    # ------------------------------------------------------------------
    def filter_points3D(
        self,
        max_reproj_error: float = 4.0,
        min_tri_angle_deg: float = 1.5,
        point3D_ids=None,
    ) -> int:
        """Drop observations with high reprojection error or negative depth and
        points with small maximum triangulation angle. Returns #filtered obs.

        Fully vectorized (segment reductions over the sorted observation
        table); only the final deletions mutate scene objects."""
        num_filtered = 0
        pids, iids, p2ds, errors, depths = self._reproj_errors_full(point3D_ids)
        if len(pids):
            # 1) per-observation error / cheirality test
            bad = (~np.isfinite(errors)) | (errors > max_reproj_error) | (
                depths <= 0
            )
            order = np.argsort(pids, kind="stable")
            spids = pids[order]
            sbad = bad[order]
            starts = np.nonzero(np.diff(spids, prepend=spids[0] - 1))[0]
            counts = np.diff(np.append(starts, len(spids)))
            bad_counts = np.add.reduceat(sbad.astype(np.int64), starts)
            kill_point = counts - bad_counts < 2
            upids = spids[starts]
            for pid, cnt in zip(
                upids[kill_point].tolist(), counts[kill_point].tolist()
            ):
                if pid in self.points3D:
                    num_filtered += cnt
                    self.delete_point3D(pid)
            # individual bad observations on surviving points
            kill_obs = np.repeat(kill_point, counts)
            for k in order[sbad & ~kill_obs].tolist():
                if int(pids[k]) in self.points3D:
                    self.delete_observation(int(iids[k]), int(p2ds[k]))
                    num_filtered += 1
        # 2) triangulation-angle test (padded [P, T] pairwise-angle batch)
        min_cos = np.cos(np.deg2rad(min_tri_angle_deg))
        pids, xyz, iids, _, _ = self._all_observations(point3D_ids)
        if len(pids) == 0:
            return num_filtered
        reg_ids = self.reg_image_ids
        if not reg_ids:
            return num_filtered
        max_iid = max(reg_ids)
        centers = np.zeros((max_iid + 1, 3))
        for i in reg_ids:
            centers[i] = self.images[i].projection_center()
        rays = centers[iids] - xyz
        norms = np.linalg.norm(rays, axis=1)
        unit = (rays / np.maximum(norms, 1e-12)[:, None]).astype(np.float32)
        order = np.argsort(pids, kind="stable")
        spids = pids[order]
        sunit = unit[order]
        svalid = (norms[order] > 1e-12).astype(np.float32)
        starts = np.nonzero(np.diff(spids, prepend=spids[0] - 1))[0]
        counts = np.diff(np.append(starts, len(spids)))
        P = len(starts)
        T = int(min(counts.max(), 256))  # truncate absurdly long tracks
        rowidx = np.repeat(np.arange(P), counts)
        colidx = np.arange(len(spids)) - np.repeat(starts, counts)
        keep = colidx < T
        grid = np.zeros((P, T, 3), dtype=np.float32)
        gmask = np.zeros((P, T), dtype=np.float32)
        grid[rowidx[keep], colidx[keep]] = sunit[keep]
        gmask[rowidx[keep], colidx[keep]] = svalid[keep]
        # batched sgemm (f32 matmul), not einsum-in-f64: this [P, T, T]
        # pairwise test dominated local-BA filtering at dense track lengths
        cosang = grid @ grid.transpose(0, 2, 1)
        pair_ok = (gmask[:, :, None] * gmask[:, None, :]) > 0
        diag = np.arange(T)
        pair_ok[:, diag, diag] = False
        # a point passes iff some valid pair has angle >= threshold
        # (f32 rounding guard: 1e-6 on the cos comparison)
        wide = np.any(
            pair_ok & (np.clip(cosang, -1, 1) <= min_cos + 1e-6), axis=(1, 2)
        )
        enough = gmask.sum(axis=1) >= 2
        kill = enough & ~wide
        upids = spids[starts]
        for pid in upids[kill].tolist():
            pt = self.points3D.get(pid)
            if pt is not None:
                num_filtered += pt.track.length()
                self.delete_point3D(pid)
        return num_filtered

    def filter_observations_with_negative_depth(self) -> int:
        pids, iids, p2ds, errors, depths = self._reproj_errors_full()
        num = 0
        for k in np.nonzero(depths <= 0)[0]:
            if int(pids[k]) in self.points3D:
                self.delete_observation(int(iids[k]), int(p2ds[k]))
                num += 1
        return num

    # ------------------------------------------------------------------
    # consistency check (ref: scene/reconstruction.h:386-408)
    # ------------------------------------------------------------------
    def check(self):
        for img_id, img in self.images.items():
            if img.camera_id not in self.cameras:
                raise RuntimeError(f"image {img_id} references missing camera")
            ids = img.points2D_point3D_ids
            for idx in np.nonzero(ids != np.uint64(INVALID_POINT3D_ID))[0]:
                pid = int(ids[idx])
                if pid not in self.points3D:
                    raise RuntimeError(
                        f"image {img_id} point2D {idx} -> missing point3D {pid}"
                    )
                track = self.points3D[pid].track
                if not any(
                    el.image_id == img_id and el.point2D_idx == idx
                    for el in track.elements
                ):
                    raise RuntimeError(
                        f"track of point3D {pid} missing obs ({img_id},{idx})"
                    )
        for pid, pt in self.points3D.items():
            seen = set()
            for el in pt.track.elements:
                if el.image_id not in self.images:
                    raise RuntimeError(f"point3D {pid} track -> missing image")
                key = (el.image_id, el.point2D_idx)
                if key in seen:
                    raise RuntimeError(f"duplicate track element in point3D {pid}")
                seen.add(key)
                if self.images[el.image_id].points2D_point3D_ids[
                    el.point2D_idx
                ] != np.uint64(pid):
                    raise RuntimeError(
                        f"point3D {pid} track obs ({el.image_id},{el.point2D_idx}) "
                        "does not link back"
                    )

    # ------------------------------------------------------------------
    # I/O (byte-compatible with COLMAP; ref: scene/reconstruction.h:68-103)
    # ------------------------------------------------------------------
    def read(self, path):
        path = Path(path)
        if (path / "cameras.bin").exists():
            self.read_binary(path)
        elif (path / "cameras.txt").exists():
            self.read_text(path)
        else:
            raise FileNotFoundError(f"no reconstruction found at {path}")

    def write(self, path):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        self.write_binary(path)

    # -- binary -------------------------------------------------------------
    def read_binary(self, path):
        path = Path(path)
        self._read_cameras_binary(path / "cameras.bin")
        self._read_images_binary(path / "images.bin")
        self._read_points3D_binary(path / "points3D.bin")
        self._sync_from_tracks()

    def write_binary(self, path):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        self._write_cameras_binary(path / "cameras.bin")
        self._write_images_binary(path / "images.bin")
        self._write_points3D_binary(path / "points3D.bin")

    def _read_cameras_binary(self, fname):
        self.cameras = {}
        with open(fname, "rb") as f:
            (num,) = _read_next_bytes(f, 8, "Q")
            for _ in range(num):
                cam_id, model_id, width, height = _read_next_bytes(f, 24, "iiQQ")
                n = cm.num_params_for_model(model_id)
                params = _read_next_bytes(f, 8 * n, "d" * n)
                self.cameras[cam_id] = Camera(
                    cam_id, cm.model_name_from_id(model_id), width, height, params
                )

    def _write_cameras_binary(self, fname):
        with open(fname, "wb") as f:
            f.write(struct.pack("<Q", len(self.cameras)))
            for cam_id in sorted(self.cameras):
                cam = self.cameras[cam_id]
                f.write(
                    struct.pack(
                        "<iiQQ", cam_id, cam.model_id, cam.width, cam.height
                    )
                )
                f.write(struct.pack("<" + "d" * len(cam.params), *cam.params))

    def _read_images_binary(self, fname):
        self.images = {}
        with open(fname, "rb") as f:
            (num,) = _read_next_bytes(f, 8, "Q")
            for _ in range(num):
                vals = _read_next_bytes(f, 64, "idddddddi")
                image_id = vals[0]
                qw, qx, qy, qz = vals[1:5]
                tx, ty, tz = vals[5:8]
                camera_id = vals[8]
                name_bytes = b""
                while True:
                    c = f.read(1)
                    if c == b"\x00":
                        break
                    name_bytes += c
                (num_pts,) = _read_next_bytes(f, 8, "Q")
                data = np.frombuffer(f.read(24 * num_pts), dtype=np.uint8)
                rec = data.view(
                    np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<u8")])
                )
                img = Image(
                    name=name_bytes.decode("utf-8"),
                    cam_from_world=Rigid3d(
                        Rotation3d(np.array([qx, qy, qz, qw])), np.array([tx, ty, tz])
                    ),
                    camera_id=camera_id,
                    id=image_id,
                )
                img.set_keypoints(np.stack([rec["x"], rec["y"]], axis=1) if num_pts else np.zeros((0, 2)))
                img._p3d_ids[:] = rec["pid"]
                img.num_points3D = int(np.sum(rec["pid"] != np.uint64(INVALID_POINT3D_ID)))
                img.registered = True
                self.images[image_id] = img

    def _write_images_binary(self, fname):
        with open(fname, "wb") as f:
            reg = [i for i in sorted(self.images) if self.images[i].registered]
            f.write(struct.pack("<Q", len(reg)))
            for image_id in reg:
                img = self.images[image_id]
                q = img.cam_from_world.rotation.quat  # xyzw
                t = img.cam_from_world.translation
                f.write(
                    struct.pack(
                        "<idddddddi",
                        image_id,
                        q[3], q[0], q[1], q[2],
                        t[0], t[1], t[2],
                        img.camera_id,
                    )
                )
                f.write(img.name.encode("utf-8") + b"\x00")
                n = img.num_points2D
                f.write(struct.pack("<Q", n))
                if n:
                    rec = np.empty(
                        n, dtype=np.dtype([("x", "<f8"), ("y", "<f8"), ("pid", "<u8")])
                    )
                    rec["x"] = img.points2D_xy[:, 0]
                    rec["y"] = img.points2D_xy[:, 1]
                    rec["pid"] = img.points2D_point3D_ids
                    f.write(rec.tobytes())

    def _read_points3D_binary(self, fname):
        self.points3D = {}
        with open(fname, "rb") as f:
            (num,) = _read_next_bytes(f, 8, "Q")
            for _ in range(num):
                vals = _read_next_bytes(f, 43, "QdddBBBd")
                pid = vals[0]
                xyz = np.array(vals[1:4])
                color = np.array(vals[4:7], dtype=np.uint8)
                error = vals[7]
                (track_len,) = _read_next_bytes(f, 8, "Q")
                data = np.frombuffer(f.read(8 * track_len), dtype="<u4").reshape(-1, 2)
                track = Track(
                    [TrackElement(int(a), int(b)) for a, b in data]
                )
                self.points3D[pid] = Point3D(xyz, color, error, track)
                self._num_added_points3D = max(self._num_added_points3D, pid)

    def _write_points3D_binary(self, fname):
        with open(fname, "wb") as f:
            f.write(struct.pack("<Q", len(self.points3D)))
            for pid in sorted(self.points3D):
                pt = self.points3D[pid]
                f.write(
                    struct.pack(
                        "<QdddBBBd",
                        pid,
                        pt.xyz[0], pt.xyz[1], pt.xyz[2],
                        int(pt.color[0]), int(pt.color[1]), int(pt.color[2]),
                        pt.error,
                    )
                )
                f.write(struct.pack("<Q", pt.track.length()))
                for el in pt.track.elements:
                    f.write(struct.pack("<II", el.image_id, el.point2D_idx))

    # -- text ---------------------------------------------------------------
    def read_text(self, path):
        path = Path(path)
        self._read_cameras_text(path / "cameras.txt")
        self._read_images_text(path / "images.txt")
        self._read_points3D_text(path / "points3D.txt")
        self._sync_from_tracks()

    def write_text(self, path):
        path = Path(path)
        path.mkdir(parents=True, exist_ok=True)
        self._write_cameras_text(path / "cameras.txt")
        self._write_images_text(path / "images.txt")
        self._write_points3D_text(path / "points3D.txt")

    def _read_cameras_text(self, fname):
        self.cameras = {}
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                cam_id = int(parts[0])
                self.cameras[cam_id] = Camera(
                    cam_id, parts[1], int(parts[2]), int(parts[3]),
                    [float(x) for x in parts[4:]],
                )

    def _write_cameras_text(self, fname):
        with open(fname, "w") as f:
            f.write("# Camera list with one line of data per camera:\n")
            f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
            f.write(f"# Number of cameras: {len(self.cameras)}\n")
            for cam_id in sorted(self.cameras):
                cam = self.cameras[cam_id]
                params = " ".join(repr(float(p)) for p in cam.params)
                f.write(f"{cam_id} {cam.model} {cam.width} {cam.height} {params}\n")

    def _read_images_text(self, fname):
        self.images = {}
        with open(fname) as f:
            lines = [l.strip() for l in f if l.strip() and not l.startswith("#")]
        for i in range(0, len(lines), 2):
            parts = lines[i].split()
            image_id = int(parts[0])
            qw, qx, qy, qz = map(float, parts[1:5])
            t = np.array([float(x) for x in parts[5:8]])
            camera_id = int(parts[8])
            name = " ".join(parts[9:])
            img = Image(
                name=name,
                cam_from_world=Rigid3d(Rotation3d(np.array([qx, qy, qz, qw])), t),
                camera_id=camera_id,
                id=image_id,
            )
            pts = lines[i + 1].split() if i + 1 < len(lines) else []
            n = len(pts) // 3
            xy = np.zeros((n, 2))
            pids = np.full(n, INVALID_POINT3D_ID, dtype=np.uint64)
            for k in range(n):
                xy[k] = (float(pts[3 * k]), float(pts[3 * k + 1]))
                pid = int(pts[3 * k + 2])
                if pid != -1:
                    pids[k] = pid
            img.set_keypoints(xy)
            img._p3d_ids[:] = pids
            img.num_points3D = int(np.sum(pids != np.uint64(INVALID_POINT3D_ID)))
            img.registered = True
            self.images[image_id] = img

    def _write_images_text(self, fname):
        with open(fname, "w") as f:
            f.write("# Image list with two lines of data per image:\n")
            f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
            f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
            reg = [i for i in sorted(self.images) if self.images[i].registered]
            f.write(f"# Number of images: {len(reg)}\n")
            for image_id in reg:
                img = self.images[image_id]
                q = img.cam_from_world.rotation.quat
                t = img.cam_from_world.translation
                f.write(
                    f"{image_id} {float(q[3])!r} {float(q[0])!r} {float(q[1])!r} "
                    f"{float(q[2])!r} {float(t[0])!r} {float(t[1])!r} "
                    f"{float(t[2])!r} {img.camera_id} {img.name}\n"
                )
                elems = []
                for k in range(img.num_points2D):
                    pid = int(img.points2D_point3D_ids[k])
                    pid_str = "-1" if pid == INVALID_POINT3D_ID else str(pid)
                    elems.append(
                        f"{float(img.points2D_xy[k,0])!r} "
                        f"{float(img.points2D_xy[k,1])!r} {pid_str}"
                    )
                f.write(" ".join(elems) + "\n")

    def _read_points3D_text(self, fname):
        self.points3D = {}
        with open(fname) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split()
                pid = int(parts[0])
                xyz = np.array([float(x) for x in parts[1:4]])
                color = np.array([int(x) for x in parts[4:7]], dtype=np.uint8)
                error = float(parts[7])
                track = Track(
                    [
                        TrackElement(int(parts[8 + 2 * k]), int(parts[9 + 2 * k]))
                        for k in range((len(parts) - 8) // 2)
                    ]
                )
                self.points3D[pid] = Point3D(xyz, color, error, track)
                self._num_added_points3D = max(self._num_added_points3D, pid)

    def _write_points3D_text(self, fname):
        with open(fname, "w") as f:
            f.write("# 3D point list with one line of data per point:\n")
            f.write(
                "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
            )
            f.write(f"# Number of points: {len(self.points3D)}\n")
            for pid in sorted(self.points3D):
                pt = self.points3D[pid]
                track_str = " ".join(
                    f"{el.image_id} {el.point2D_idx}" for el in pt.track.elements
                )
                f.write(
                    f"{pid} {float(pt.xyz[0])!r} {float(pt.xyz[1])!r} "
                    f"{float(pt.xyz[2])!r} {pt.color[0]} {pt.color[1]} "
                    f"{pt.color[2]} {float(pt.error)!r} {track_str}\n"
                )

    def _sync_from_tracks(self):
        """After reading, make image point2D->point3D links consistent."""
        for pid, pt in self.points3D.items():
            for el in pt.track.elements:
                img = self.images.get(el.image_id)
                if img is not None and el.point2D_idx < img.num_points2D:
                    img._p3d_ids[el.point2D_idx] = pid
        for img in self.images.values():
            img.num_points3D = int(
                np.sum(img._p3d_ids != np.uint64(INVALID_POINT3D_ID))
            )

    # -- PLY ----------------------------------------------------------------
    def export_PLY(self, fname):
        """Write the sparse point cloud as binary little-endian PLY."""
        with open(fname, "wb") as f:
            header = (
                "ply\nformat binary_little_endian 1.0\n"
                f"element vertex {len(self.points3D)}\n"
                "property float x\nproperty float y\nproperty float z\n"
                "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                "end_header\n"
            )
            f.write(header.encode("ascii"))
            rec = np.empty(
                len(self.points3D),
                dtype=np.dtype(
                    [("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                     ("r", "u1"), ("g", "u1"), ("b", "u1")]
                ),
            )
            for k, pt in enumerate(self.points3D.values()):
                rec[k] = (pt.xyz[0], pt.xyz[1], pt.xyz[2], pt.color[0], pt.color[1], pt.color[2])
            f.write(rec.tobytes())

    def import_PLY(self, fname):
        """Read a point cloud from PLY into points3D (tracks empty)."""
        with open(fname, "rb") as f:
            line = f.readline().strip()
            if line != b"ply":
                raise ValueError("not a PLY file")
            fmt = None
            num = 0
            props = []
            while True:
                line = f.readline().strip().decode("ascii")
                if line.startswith("format"):
                    fmt = line.split()[1]
                elif line.startswith("element vertex"):
                    num = int(line.split()[2])
                elif line.startswith("property"):
                    props.append(tuple(line.split()[1:]))
                elif line == "end_header":
                    break
            self.points3D = {}
            self._num_added_points3D = 0
            if fmt == "ascii":
                for _ in range(num):
                    vals = f.readline().split()
                    xyz = [float(v) for v in vals[:3]]
                    color = [int(v) for v in vals[3:6]] if len(vals) >= 6 else [0, 0, 0]
                    self.add_point3D(xyz, Track(), color)
            else:
                np_types = {"float": "<f4", "double": "<f8", "uchar": "u1", "int": "<i4"}
                dt = np.dtype([(f"p{k}", np_types[t]) for k, (t, _) in enumerate(props)])
                rec = np.frombuffer(f.read(dt.itemsize * num), dtype=dt)
                names = [n for _, n in props]
                xi, yi, zi = names.index("x"), names.index("y"), names.index("z")
                has_color = "red" in names
                for k in range(num):
                    xyz = [rec[k][xi], rec[k][yi], rec[k][zi]]
                    if has_color:
                        ri = names.index("red")
                        color = [rec[k][ri], rec[k][ri + 1], rec[k][ri + 2]]
                    else:
                        color = [0, 0, 0]
                    self.add_point3D(xyz, Track(), color)
