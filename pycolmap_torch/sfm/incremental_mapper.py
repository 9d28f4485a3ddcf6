"""Incremental mapper options.

Port of ``pycolmap_tpu/sfm/incremental_mapper.py`` (API parity:
pycolmap/sfm/incremental_mapper.h, options :14-98), for now only its
options: ``IncrementalPipelineOptions`` nests them, and the known-pose
entry points (``pipeline.sfm.triangulate_points``) read their filter
thresholds. The ``IncrementalMapper`` class itself (initial pair search,
absolute-pose registration, local and global BA scheduling, filtering) waits
for the mapping slice, with the estimators it needs (ROADMAP.md).
"""

from __future__ import annotations

import enum

from pycolmap_torch.utils.options import BaseOptions, options_dataclass


class ImageSelectionMethod(enum.IntEnum):
    """ref: sfm/incremental_mapper.h:14-21."""

    MAX_VISIBLE_POINTS_NUM = 0
    MAX_VISIBLE_POINTS_RATIO = 1
    MIN_UNCERTAINTY = 2


@options_dataclass
class IncrementalMapperOptions(BaseOptions):
    """Defaults mirror reference IncrementalMapperOptions (incremental_mapper.h)."""

    init_min_num_inliers: int = 100
    init_max_error: float = 4.0
    init_max_forward_motion: float = 0.95
    init_min_tri_angle: float = 16.0
    init_max_reg_trials: int = 2
    abs_pose_max_error: float = 12.0
    abs_pose_min_num_inliers: int = 30
    abs_pose_min_inlier_ratio: float = 0.25
    abs_pose_refine_focal_length: bool = True
    abs_pose_refine_extra_params: bool = True
    local_ba_num_images: int = 6
    local_ba_min_tri_angle: float = 6.0
    min_tri_angle: float = 1.5
    max_reg_trials: int = 3
    max_model_overlap: int = 20
    fix_existing_images: bool = False
    num_threads: int = -1
    filter_max_reproj_error: float = 4.0
    filter_min_tri_angle: float = 1.5
    max_extra_param: float = 1.0
    min_focal_length_ratio: float = 0.1
    max_focal_length_ratio: float = 10.0
    image_selection_method: ImageSelectionMethod = (
        ImageSelectionMethod.MIN_UNCERTAINTY
    )
