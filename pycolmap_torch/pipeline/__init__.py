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
    incremental_mapping,
    triangulate_points,
)
from pycolmap_torch.sfm.incremental_mapper import (
    ImageSelectionMethod,
    IncrementalMapper,
    IncrementalMapperOptions,
)

__all__ = ["ImageSelectionMethod", "IncrementalMapper",
           "IncrementalMapperOptions", "IncrementalPipelineOptions",
           "PatchMatchOptions", "StereoFusionOptions",
           "UndistortCameraOptions", "bundle_adjustment",
           "incremental_mapping", "patch_match_stereo", "stereo_fusion",
           "triangulate_points", "undistort_images"]
