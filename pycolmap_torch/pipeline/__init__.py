from pycolmap_torch.pipeline.images import (
    UndistortCameraOptions,
    undistort_images,
)
from pycolmap_torch.pipeline.mvs import (
    PatchMatchOptions,
    StereoFusionOptions,
    patch_match_stereo,
    stereo_fusion,
)
from pycolmap_torch.pipeline.sfm import (
    IncrementalPipelineOptions,
    bundle_adjustment,
    triangulate_points,
)

__all__ = ["IncrementalPipelineOptions", "PatchMatchOptions",
           "StereoFusionOptions", "UndistortCameraOptions",
           "bundle_adjustment", "patch_match_stereo", "stereo_fusion",
           "triangulate_points", "undistort_images"]
