"""Database-writing feature extraction pipeline.

Port of ``pycolmap_tpu/pipeline/extract_features.py`` (API parity:
pycolmap/pipeline/extract_features.h:143-153, ``extract_features``). The
"controller" is a loop: images are imported, read as uint8 gray, shrunk on
the device to ``max_image_size`` when larger, and extracted in same-shape
batches of four (``Sift.extract_batch``: the window-sampler kernel on the
card); each image's keypoints and uint8 descriptors are written in one
transaction.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from pycolmap_torch import resolve_device
from pycolmap_torch.features.sift import Sift, SiftExtractionOptions
from pycolmap_torch.mvs.controller import resize_bilinear
from pycolmap_torch.pipeline.images import (
    CameraMode,
    ImageReaderOptions,
    import_images,
    read_image_gray_u8,
)
from pycolmap_torch.scene import Database, DatabaseTransaction

# same-shape images extracted back to back (the reference's vmapped batch)
BATCH_SIZE = 4


def _resize_to_max(img: np.ndarray, max_size: int, device):
    """Downsample so max(h, w) <= max_size; returns (img, scale). The
    bilinear, antialiased resize runs on `device` (the reference's
    ``jax.image.resize``); uint8 stays uint8 (rounded and clipped)."""
    h, w = img.shape
    if max(h, w) <= max_size:
        return img, 1.0
    scale = max_size / max(h, w)
    new_h, new_w = int(round(h * scale)), int(round(w * scale))
    src = torch.from_numpy(np.asarray(img, dtype=np.float32)).to(device)
    out = resize_bilinear(src, (new_h, new_w))
    if img.dtype == np.uint8:
        out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
    return out.cpu().numpy(), max(h, w) / max_size


def extract_features(
    database_path,
    image_path,
    image_names=None,
    camera_mode: CameraMode = CameraMode.AUTO,
    camera_model: str = "SIMPLE_RADIAL",
    reader_options: ImageReaderOptions = None,
    sift_options: SiftExtractionOptions = None,
    device=None,
    verbose: bool = False,
):
    """Import images + extract SIFT + write keypoints/descriptors to the DB.
    Runs on ``device`` (default: the card); images that already have
    keypoints and descriptors are skipped."""
    device = resolve_device(device)
    if reader_options is None:
        reader_options = ImageReaderOptions()
    if camera_model:
        reader_options.camera_model = camera_model
    if sift_options is None:
        sift_options = SiftExtractionOptions()

    import_images(database_path, image_path, camera_mode, image_names,
                  reader_options, device=device)

    db = Database(database_path)
    sift = Sift(sift_options, device)
    image_path = Path(image_path)

    def _flush(batch):
        if not batch:
            return
        results = sift.extract_batch([arr for _, arr, _ in batch])
        for (img, _, inv_scale), (kps, descs) in zip(batch, results):
            if inv_scale != 1.0:
                kps = kps.copy()
                kps[:, :3] *= inv_scale
            descs_u8 = np.clip(np.round(descs * 512.0), 0, 255).astype(np.uint8)
            with DatabaseTransaction(db):
                db.write_keypoints(img.image_id, kps)
                db.write_descriptors(img.image_id, descs_u8)
            if verbose:
                print(f"extracted {len(kps):5d} features: {img.name}")

    try:
        pending = {}  # shape -> list of (img, array, inv_scale)
        for img in db.read_all_images():
            if db.exists_keypoints(img.image_id) and db.exists_descriptors(img.image_id):
                continue
            f = image_path / img.name
            if not f.exists():
                continue
            arr, inv_scale = _resize_to_max(
                read_image_gray_u8(f), sift_options.max_image_size, device)
            batch = pending.setdefault(arr.shape, [])
            batch.append((img, arr, inv_scale))
            if len(batch) >= BATCH_SIZE:
                _flush(batch)
                pending[arr.shape] = []
        for batch in pending.values():
            _flush(batch)
    finally:
        db.close()
