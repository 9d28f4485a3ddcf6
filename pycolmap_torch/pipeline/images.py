"""Image ingestion, camera inference, reading and undistortion.

Port of ``pycolmap_tpu/pipeline/images.py`` (API parity:
pycolmap/pipeline/images.h — ``import_images`` :24-63,
``infer_camera_from_image`` EXIF-focal heuristic :65-94,
``undistort_images`` :96-148, ``CameraMode`` :151-155,
``ImageReaderOptions`` :158-200, ``UndistortCameraOptions`` :209-233).

Binary PGM and PPM (P5, P6, 8 bit) are read and written with numpy, so the
pipeline runs on a host without Pillow; the bytes and pixels are Pillow's,
and a PNM's size comes from its header. A PNM has no EXIF, so its camera
takes the default focal length. Every other format goes through Pillow,
imported when needed, as the reference reads every format. The
undistortion remap is a bilinear gather on the entry point's device.
"""

from __future__ import annotations

import enum
import os
from pathlib import Path

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.features.window_sampler import _bilinear_plane
from pycolmap_torch.scene import (
    Camera,
    Database,
    DatabaseTransaction,
    Image,
    Reconstruction,
)
from pycolmap_torch.utils.options import BaseOptions, options_dataclass

IMAGE_EXTENSIONS = {".jpg", ".jpeg", ".png", ".bmp", ".tif", ".tiff", ".pgm", ".ppm"}
_PNM = {".pgm", ".ppm"}


class CameraMode(enum.IntEnum):
    AUTO = 0
    SINGLE = 1
    PER_FOLDER = 2
    PER_IMAGE = 3


@options_dataclass
class ImageReaderOptions(BaseOptions):
    """Mirrors reference ImageReaderOptions (images.h:158-200)."""

    camera_model: str = "SIMPLE_RADIAL"
    single_camera: bool = False
    single_camera_per_folder: bool = False
    single_camera_per_image: bool = False
    existing_camera_id: int = -1
    camera_params: str = ""
    default_focal_length_factor: float = 1.2
    mask_path: str = ""


@options_dataclass
class UndistortCameraOptions(BaseOptions):
    """Mirrors reference UndistortCameraOptions (images.h:209-233)."""

    blank_pixels: float = 0.0
    min_scale: float = 0.2
    max_scale: float = 2.0
    max_image_size: int = -1
    roi_min_x: float = 0.0
    roi_min_y: float = 0.0
    roi_max_x: float = 1.0
    roi_max_y: float = 1.0


def _pnm_header(data):
    """(width, height, maxval, channels, pixel offset) of a binary 8-bit
    PGM or PPM held in `data`, or None for any other file."""
    if data[:2] not in (b"P5", b"P6"):
        return None
    fields = []
    pos = 2
    # header: magic, then width, height, maxval separated by whitespace or
    # comments, then one whitespace byte before the pixels
    while len(fields) < 3:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.find(b"\n", pos) + 1
            if pos == 0:  # a comment runs past the bytes given
                return None
            continue
        end = pos
        while data[end:end + 1].isdigit():
            end += 1
        if end == pos:
            return None
        fields.append(int(data[pos:end]))
        pos = end
    w, h, maxval = fields
    if not 0 < maxval <= 255 or not data[pos:pos + 1].isspace():
        return None
    return w, h, maxval, 1 if data[:2] == b"P5" else 3, pos + 1


def _read_pnm(path):
    """A binary 8-bit PGM (HxW) or PPM (HxWx3) as uint8, or None for any
    other file (Pillow then reads it). Samples of a file whose maxval is
    below 255 are scaled to 0..255 as Pillow scales them:
    ``round(min(v, maxval) * 255 / maxval)``, halves to even."""
    with open(path, "rb") as f:
        data = f.read()
    header = _pnm_header(data)
    if header is None:
        return None
    w, h, maxval, c, pos = header
    arr = np.frombuffer(data, np.uint8, count=h * w * c, offset=pos)
    arr = arr.reshape((h, w) if c == 1 else (h, w, 3))
    if maxval < 255:
        scaled = np.minimum(arr, maxval).astype(np.float64) * 255.0 / maxval
        return np.round(scaled).astype(np.uint8)
    return arr.copy()


def _pnm_size(path):
    """(width, height) from a PGM / PPM header, or None if `path` is not a
    binary 8-bit PNM."""
    if Path(path).suffix.lower() not in _PNM:
        return None
    with open(path, "rb") as f:
        header = _pnm_header(f.read(4096))
    return None if header is None else header[:2]


def _read_u8(path):
    if Path(path).suffix.lower() in _PNM:
        arr = _read_pnm(path)
        if arr is not None:
            return arr
    from PIL import Image as PILImage

    with PILImage.open(path) as im:
        if im.mode not in ("L", "RGB"):
            im = im.convert("RGB")
        return np.array(im, dtype=np.uint8)


def _gray(arr):
    """Pillow's ``convert("L")`` of an RGB uint8 array, bit for bit."""
    if arr.ndim == 2:
        return arr
    r, g, b = (arr[..., i].astype(np.uint32) for i in range(3))
    return ((r * 19595 + g * 38470 + b * 7471 + 0x8000) >> 16).astype(np.uint8)


def read_image_gray(path) -> np.ndarray:
    """HxW float32 grayscale in [0, 1]."""
    return _gray(_read_u8(path)).astype(np.float32) / 255.0


def read_image_gray_u8(path) -> np.ndarray:
    """HxW uint8 grayscale (Pillow's ``convert("L")``), for consumers that
    normalise on the device (features/sift.py)."""
    return _gray(_read_u8(path))


def read_image_rgb(path) -> np.ndarray:
    """HxWx3 uint8 (a gray file's channel replicated)."""
    arr = _read_u8(path)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=2)
    return arr


def list_images(image_path) -> list[str]:
    """Relative paths of all images under image_path, sorted."""
    image_path = Path(image_path)
    out = []
    for root, _, files in os.walk(image_path):
        for f in sorted(files):
            if Path(f).suffix.lower() in IMAGE_EXTENSIONS:
                out.append(str(Path(root).relative_to(image_path) / f))
    return sorted(out)


def _exif_focal_px(path, width: int) -> float | None:
    """EXIF focal length -> pixels (heuristic per images.h:75-86); None for
    a PNM, which has no EXIF, and for a file without a usable tag."""
    if _pnm_size(path) is not None:
        return None
    from PIL import ExifTags, Image as PILImage

    try:
        with PILImage.open(path) as im:
            exif = im.getexif()
    except OSError:
        return None
    if not exif:
        return None
    tag_by_name = {v: k for k, v in ExifTags.TAGS.items()}
    try:
        f35 = exif.get(tag_by_name.get("FocalLengthIn35mmFilm"))
        if f35:
            return float(f35) / 35.0 * width
        focal_mm = exif.get(tag_by_name.get("FocalLength"))
        if focal_mm:
            # assume 35mm-equivalent sensor width unless plane res known
            return float(focal_mm) / 35.0 * width
    except (TypeError, ValueError, ZeroDivisionError):
        return None
    return None


def _image_size(path):
    size = _pnm_size(path)
    if size is None:
        from PIL import Image as PILImage

        with PILImage.open(path) as im:
            size = im.size
    return size


def infer_camera_from_image(image_path, options: ImageReaderOptions = None) -> Camera:
    """Build a camera for one image: EXIF focal if available, else
    default_focal_length_factor * max(width, height) (ref: images.h:65-94)."""
    if options is None:
        options = ImageReaderOptions()
    width, height = _image_size(image_path)
    focal = _exif_focal_px(image_path, width)
    has_prior = focal is not None
    if focal is None:
        focal = options.default_focal_length_factor * max(width, height)
    cam = Camera.create(0, options.camera_model, focal, width, height)
    cam.has_prior_focal_length = has_prior
    if options.camera_params:
        cam.set_params_from_string(options.camera_params)
    return cam


def import_images(
    database_path,
    image_path,
    camera_mode: CameraMode = CameraMode.AUTO,
    image_names=None,
    options: ImageReaderOptions = None,
    device=None,
):
    """Ingest images into the database (ref: images.h:24-63). Host work
    only; ``device`` is checked as every entry point's is (default: the
    card, which a host without CUDA lacks)."""
    resolve_device(device)
    if options is None:
        options = ImageReaderOptions()
    image_path = Path(image_path)
    names = image_names if image_names else list_images(image_path)
    camera_mode = CameraMode(camera_mode)

    db = Database(database_path)
    try:
        with DatabaseTransaction(db):
            cam_for_folder: dict[str, int] = {}
            single_cam_id = None
            for name in names:
                if db.image_id_from_name(name) is not None:
                    continue
                cam = infer_camera_from_image(image_path / name, options)
                if camera_mode == CameraMode.PER_FOLDER or options.single_camera_per_folder:
                    folder = str(Path(name).parent)
                    if folder not in cam_for_folder:
                        cam_for_folder[folder] = db.write_camera(cam)
                    cam_id = cam_for_folder[folder]
                elif camera_mode == CameraMode.PER_IMAGE or options.single_camera_per_image:
                    cam_id = db.write_camera(cam)
                else:  # SINGLE, and AUTO, which the reference shares too
                    if single_cam_id is None:
                        single_cam_id = db.write_camera(cam)
                    cam_id = single_cam_id
                db.write_image(Image(name=name, camera_id=cam_id))
    finally:
        db.close()


def write_image(path, arr: np.ndarray) -> None:
    """Write an HxW or HxWx3 uint8 array. ``.pgm`` / ``.ppm`` are written
    with numpy (P5 for gray, P6 for RGB, whatever the extension, with
    Pillow's header); other formats through Pillow."""
    path = Path(path)
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    if path.suffix.lower() in _PNM:
        magic = b"P5" if arr.ndim == 2 else b"P6"
        with open(path, "wb") as f:
            f.write(magic + b"\n%d %d\n255\n" % (arr.shape[1], arr.shape[0]))
            f.write(arr.tobytes())
        return
    from PIL import Image as PILImage

    PILImage.fromarray(arr).save(path)


def undistort_camera(camera: Camera, options: UndistortCameraOptions = None) -> Camera:
    """Compute the undistorted PINHOLE camera (upstream UndistortCamera)."""
    if options is None:
        options = UndistortCameraOptions()
    new_cam = Camera.create(
        camera.camera_id, "PINHOLE", camera.focal_length, camera.width, camera.height
    )
    new_cam.params[0] = camera.focal_length_x
    new_cam.params[1] = camera.focal_length_y
    new_cam.params[2] = camera.principal_point_x
    new_cam.params[3] = camera.principal_point_y

    # determine scaling so that no blank pixels remain (blank_pixels=0) by
    # examining the undistorted border positions
    w, h = camera.width, camera.height
    n = 64
    xs = np.linspace(0.5, w - 0.5, n)
    ys = np.linspace(0.5, h - 0.5, n)
    top = np.stack([xs, np.full(n, 0.5)], axis=1)
    bottom = np.stack([xs, np.full(n, h - 0.5)], axis=1)
    left = np.stack([np.full(n, 0.5), ys], axis=1)
    right = np.stack([np.full(n, w - 0.5), ys], axis=1)
    pts = np.concatenate([top, bottom, left, right])
    uv = camera.cam_from_img(pts)  # undistorted normalized coords
    # project through new pinhole camera
    xy = uv * [new_cam.params[0], new_cam.params[1]] + [
        new_cam.params[2], new_cam.params[3]
    ]
    # scale the focal so the undistorted border maps inside the image
    cx, cy = new_cam.params[2], new_cam.params[3]
    span_x = max(xy[:, 0].max() - cx, cx - xy[:, 0].min())
    span_y = max(xy[:, 1].max() - cy, cy - xy[:, 1].min())
    scale_x = (w / 2) / span_x if span_x > 0 else 1.0
    scale_y = (h / 2) / span_y if span_y > 0 else 1.0
    if options.blank_pixels == 0:
        scale = min(scale_x, scale_y)
    else:
        scale = max(scale_x, scale_y)
    scale = float(np.clip(scale, options.min_scale, options.max_scale))
    new_cam.params[0] *= scale
    new_cam.params[1] *= scale
    return new_cam


def undistort_image(image_arr: np.ndarray, camera: Camera, new_camera: Camera,
                    device=None) -> np.ndarray:
    """Remap an HxW[xC] image to the undistorted camera: a bilinear gather
    in f32 on ``device`` (default: the card); uint8 input is rounded and
    clipped back to uint8."""
    device = resolve_device(device)
    h, w = new_camera.height, new_camera.width
    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs.ravel() + 0.5, ys.ravel() + 0.5], axis=1)
    uv = new_camera.cam_from_img(pix)  # normalized (pinhole: linear)
    src = camera.img_from_cam(uv)  # distorted source pixels
    # the reference samples at f32 coordinates
    src_x = torch.from_numpy((src[:, 0].reshape(h, w) - 0.5).astype(np.float32))
    src_y = torch.from_numpy((src[:, 1].reshape(h, w) - 0.5).astype(np.float32))
    arr = torch.from_numpy(np.asarray(image_arr, dtype=np.float32)).to(device)
    # channel-first planes; each tap outside the image counts zero, as the
    # reference's features/sift.py _bilinear_gather
    planes = arr[None] if arr.dim() == 2 else arr.permute(2, 0, 1)
    chan = torch.arange(planes.shape[0], device=device)[:, None, None]
    out = _bilinear_plane(planes, chan, src_y.to(device), src_x.to(device))
    out = out[0] if arr.dim() == 2 else out.permute(1, 2, 0)
    if image_arr.dtype == np.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.cpu().numpy()


def undistort_images(
    output_path,
    input_path,
    image_path,
    output_type: str = "COLMAP",
    options: UndistortCameraOptions = None,
    image_names=None,
    device=None,
):
    """Undistort a reconstruction's images into a dense workspace
    (ref: images.h:96-148). Writes sparse/ model + images/ remaps; the
    remap runs on ``device`` (default: the card)."""
    if options is None:
        options = UndistortCameraOptions()
    device = resolve_device(device)
    output_path = Path(output_path)
    image_path = Path(image_path)
    rec = Reconstruction(input_path)
    (output_path / "images").mkdir(parents=True, exist_ok=True)
    (output_path / "sparse").mkdir(parents=True, exist_ok=True)

    new_cams = {}
    for cam_id, cam in rec.cameras.items():
        new_cams[cam_id] = undistort_camera(cam, options)

    select = set(image_names) if image_names else None
    for img in rec.images.values():
        if not img.registered:
            continue
        if select is not None and img.name not in select:
            continue
        src_file = image_path / img.name
        if not src_file.exists():
            continue
        arr = read_image_rgb(src_file)
        cam = rec.cameras[img.camera_id]
        out = undistort_image(arr, cam, new_cams[img.camera_id], device)
        dst = output_path / "images" / img.name
        dst.parent.mkdir(parents=True, exist_ok=True)
        write_image(dst, out)

    # write undistorted sparse model
    for cam_id, cam in new_cams.items():
        rec.cameras[cam_id] = cam
    rec.write_binary(output_path / "sparse")
    return rec
