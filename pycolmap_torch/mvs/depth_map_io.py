"""COLMAP-compatible depth/normal map binary I/O (a numpy copy of
``pycolmap_tpu/mvs/depth_map_io.py``: the two packages write the same bytes).

Format (upstream mvs/mat.h): ASCII header "width&height&channels&" followed
by row-major little-endian float32 data. File naming follows the reference
workspace: ``stereo/depth_maps/<image_name>.<type>.bin`` with type
``photometric`` or ``geometric`` (ref: pipeline/mvs.h workspace layout).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def write_mat(path, data: np.ndarray):
    data = np.asarray(data, dtype=np.float32)
    if data.ndim == 2:
        data = data[:, :, None]
    h, w, c = data.shape
    with open(path, "wb") as f:
        f.write(f"{w}&{h}&{c}&".encode("ascii"))
        # COLMAP stores channel-major slices (all of channel 0, then 1, ...)
        f.write(np.ascontiguousarray(data.transpose(2, 0, 1)).tobytes())


def read_mat(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = b""
        for _ in range(3):
            while True:
                ch = f.read(1)
                header += ch
                if ch == b"&":
                    break
        w, h, c = (int(x) for x in header.decode("ascii").split("&")[:3])
        data = np.frombuffer(f.read(4 * w * h * c), dtype=np.float32)
    out = data.reshape(c, h, w).transpose(1, 2, 0)
    return out[:, :, 0] if c == 1 else out


def depth_map_path(workspace_path, image_name: str, kind: str) -> Path:
    return (
        Path(workspace_path) / "stereo" / "depth_maps" / f"{image_name}.{kind}.bin"
    )


def normal_map_path(workspace_path, image_name: str, kind: str) -> Path:
    return (
        Path(workspace_path) / "stereo" / "normal_maps" / f"{image_name}.{kind}.bin"
    )
