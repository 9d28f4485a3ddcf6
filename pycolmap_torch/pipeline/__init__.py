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
    match_vocabtree,
    verify_matches,
)
from pycolmap_torch.pipeline.mvs import (
    PatchMatchOptions,
    StereoFusionOptions,
    patch_match_stereo,
    stereo_fusion,
)
from pycolmap_torch.mvs.meshing import (
    DelaunayMeshingOptions,
    PoissonMeshingOptions,
    dense_delaunay_meshing,
    poisson_meshing,
    sparse_delaunay_meshing,
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

__all__ = ["CameraMode", "DelaunayMeshingOptions",
           "ExhaustiveMatchingOptions", "ImageReaderOptions",
           "ImageSelectionMethod", "IncrementalMapper",
           "IncrementalMapperOptions", "IncrementalPipelineOptions",
           "PatchMatchOptions", "PoissonMeshingOptions",
           "ReconstructionManager", "SequentialMatchingOptions",
           "SpatialMatchingOptions", "StereoFusionOptions",
           "UndistortCameraOptions", "VocabTreeMatchingOptions",
           "bundle_adjustment", "dense_delaunay_meshing", "extract_features",
           "import_images", "incremental_mapping", "infer_camera_from_image",
           "match_exhaustive", "match_sequential", "match_spatial",
           "match_vocabtree", "patch_match_stereo", "poisson_meshing",
           "sparse_delaunay_meshing", "stereo_fusion", "triangulate_points",
           "undistort_images", "verify_matches"]
