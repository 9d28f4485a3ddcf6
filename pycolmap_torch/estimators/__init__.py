from pycolmap_torch.estimators.absolute_pose import (
    AbsolutePoseEstimationOptions,
    AbsolutePoseRefinementOptions,
    absolute_pose_estimation,
    estimate_absolute_pose,
    pose_refinement,
    refine_absolute_pose,
)
from pycolmap_torch.estimators.alignment import (
    ImageAlignmentError,
    align_reconstruction_to_locations,
    align_reconstructions_via_points,
    align_reconstructions_via_proj_centers,
    align_reconstructions_via_reprojections,
    align_reconstrution_to_locations,
    compare_reconstructions,
    estimate_sim3d_robust,
)
from pycolmap_torch.estimators.essential_matrix import (
    essential_matrix_estimation,
    estimate_essential_matrix,
)
from pycolmap_torch.estimators.fundamental_matrix import (
    estimate_fundamental_matrix,
    fundamental_matrix_estimation,
)
from pycolmap_torch.estimators.generalized_absolute_pose import (
    rig_absolute_pose_estimation,
)
from pycolmap_torch.estimators.homography_decomposition import (
    homography_decomposition,
)
from pycolmap_torch.estimators.homography_matrix import (
    estimate_homography_matrix,
    homography_matrix_estimation,
)
from pycolmap_torch.estimators.ransac import RANSACOptions
from pycolmap_torch.estimators.triangulation import (
    EstimateTriangulationOptions,
    estimate_triangulation,
)
from pycolmap_torch.estimators.two_view_geometry import (
    TwoViewGeometry,
    TwoViewGeometryConfiguration,
    TwoViewGeometryOptions,
    estimate_calibrated_two_view_geometry,
    estimate_two_view_geometry,
    estimate_two_view_geometry_pose,
)

__all__ = [
    "AbsolutePoseEstimationOptions", "AbsolutePoseRefinementOptions",
    "EstimateTriangulationOptions", "ImageAlignmentError", "RANSACOptions",
    "TwoViewGeometry", "TwoViewGeometryConfiguration",
    "TwoViewGeometryOptions", "absolute_pose_estimation",
    "align_reconstruction_to_locations", "align_reconstructions_via_points",
    "align_reconstructions_via_proj_centers",
    "align_reconstructions_via_reprojections",
    "align_reconstrution_to_locations", "compare_reconstructions",
    "essential_matrix_estimation", "estimate_sim3d_robust",
    "estimate_absolute_pose", "estimate_calibrated_two_view_geometry",
    "estimate_essential_matrix", "estimate_fundamental_matrix",
    "estimate_homography_matrix", "estimate_triangulation",
    "estimate_two_view_geometry", "estimate_two_view_geometry_pose",
    "fundamental_matrix_estimation", "homography_decomposition",
    "homography_matrix_estimation", "pose_refinement", "refine_absolute_pose",
    "rig_absolute_pose_estimation",
]
