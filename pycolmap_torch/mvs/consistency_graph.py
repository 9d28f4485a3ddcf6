"""Consistency-graph output of PatchMatch stereo (a numpy copy of
``pycolmap_tpu/mvs/consistency_graph.py``: the same bytes).

Mirrors upstream COLMAP's workspace artifact (ref: pipeline/mvs.h:146-147
``write_consistency_graph`` option; upstream mvs/consistency_graph.cc):
``stereo/consistency_graphs/<image>.<type>.bin`` holds, for every pixel with
consistent source images, the tuple (col, row, count, image_idx...) as
int32s after the same ``width&height&1&`` ASCII header the depth maps use.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np


def consistency_graph_path(workspace_path, image_name: str, kind: str) -> Path:
    return (
        Path(workspace_path)
        / "stereo"
        / "consistency_graphs"
        / f"{image_name}.{kind}.bin"
    )


def write_consistency_graph(path, consistent_ids):
    """consistent_ids: [S, H, W] bool — per source-image per-pixel agreement,
    with S the reference image's source list order (caller maps row s to the
    model image idx)."""
    S, H, W = consistent_ids.shape
    counts = consistent_ids.sum(axis=0).astype(np.int32)  # [H, W]
    ys, xs = np.nonzero(counts)
    entries = []
    for y, x in zip(ys, xs):
        ids = np.nonzero(consistent_ids[:, y, x])[0].astype(np.int32)
        entries.append(
            np.concatenate([[np.int32(x), np.int32(y), np.int32(len(ids))], ids])
        )
    data = (
        np.concatenate(entries).astype("<i4")
        if entries
        else np.zeros(0, "<i4")
    )
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with open(path, "wb") as f:
        f.write(f"{W}&{H}&1&".encode("ascii"))
        f.write(data.tobytes())


def read_consistency_graph(path):
    """Returns (width, height, entries) with entries a list of
    (x, y, [source_row_indices])."""
    with open(path, "rb") as f:
        header = b""
        for _ in range(3):
            while True:
                ch = f.read(1)
                header += ch
                if ch == b"&":
                    break
        w, h, _ = (int(v) for v in header.decode("ascii").split("&")[:3])
        data = np.frombuffer(f.read(), dtype="<i4")
    entries = []
    i = 0
    while i < len(data):
        x, y, n = data[i], data[i + 1], data[i + 2]
        entries.append((int(x), int(y), data[i + 3 : i + 3 + n].tolist()))
        i += 3 + n
    return w, h, entries
