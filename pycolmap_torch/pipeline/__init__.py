from pycolmap_torch.pipeline.extract_features import extract_features
from pycolmap_torch.pipeline.images import (
    CameraMode,
    ImageReaderOptions,
    UndistortCameraOptions,
    import_images,
    infer_camera_from_image,
    undistort_images,
)
from pycolmap_torch.pipeline.match_features import (
    ExhaustiveMatchingOptions,
    SequentialMatchingOptions,
    SpatialMatchingOptions,
    VocabTreeMatchingOptions,
    match_exhaustive,
    match_sequential,
    match_spatial,
    verify_matches,
)
from pycolmap_torch.pipeline.mvs import (
    PatchMatchOptions,
    StereoFusionOptions,
    patch_match_stereo,
    stereo_fusion,
)
from pycolmap_torch.pipeline.sfm import (
    IncrementalPipelineOptions,
    ReconstructionManager,
    bundle_adjustment,
    incremental_mapping,
    triangulate_points,
)
from pycolmap_torch.sfm.incremental_mapper import (
    ImageSelectionMethod,
    IncrementalMapper,
    IncrementalMapperOptions,
)

__all__ = ["CameraMode", "ExhaustiveMatchingOptions", "ImageReaderOptions",
           "ImageSelectionMethod", "IncrementalMapper",
           "IncrementalMapperOptions", "IncrementalPipelineOptions",
           "PatchMatchOptions", "ReconstructionManager",
           "SequentialMatchingOptions", "SpatialMatchingOptions",
           "StereoFusionOptions", "UndistortCameraOptions",
           "VocabTreeMatchingOptions", "bundle_adjustment",
           "extract_features", "import_images", "incremental_mapping",
           "infer_camera_from_image", "match_exhaustive", "match_sequential",
           "match_spatial", "patch_match_stereo", "stereo_fusion",
           "triangulate_points", "undistort_images", "verify_matches"]
