"""Dense reconstruction pipeline stages (API parity: pycolmap/pipeline/mvs.h).

Port of ``pycolmap_tpu/pipeline/mvs.py``: ``patch_match_stereo`` (:183) and
``stereo_fusion`` (:246) with reference-compatible options structs; the
compute lives in ``pycolmap_torch.mvs``. Both run on the card unless
``device="cpu"`` is given.
"""

from __future__ import annotations

from pycolmap_torch.mvs.controller import patch_match_stereo
from pycolmap_torch.mvs.fusion import StereoFusionOptions, stereo_fusion
from pycolmap_torch.mvs.patch_match import PatchMatchOptions

__all__ = [
    "PatchMatchOptions",
    "StereoFusionOptions",
    "patch_match_stereo",
    "stereo_fusion",
]
