"""pycolmap_torch — the PyTorch/CUDA port of pycolmap_tpu.

The package mirrors the ``pycolmap_tpu`` tree file for file, so each module
names its reference twin. Plain tensor code is PyTorch; every Pallas kernel
of the reference becomes a CUDA C++ kernel for Hopper (``*/csrc``, built by
``_cuda_build.py``), with a plain PyTorch version beside it that serves CPU
tensors.

Entry points run on the card unless the caller passes ``device="cpu"``.
Called with no device on a host without CUDA they raise: there is no silent
CPU fallback.

The public surface re-exports what is ported of the reference's: scene
objects, geometry types, the estimators (alignment and the rig pose
among them), features, vocabulary-tree retrieval, the pipeline stages from
images to a model and on to a mesh, ``hierarchical_mapping``, and the
shard-mesh selectors of multi-device bundle adjustment
(``get_default_mesh``, ``resolve_mesh``, ``set_default_mesh``;
``parallel/device_ctx.py``). ``has_cuda`` says whether this host has the
card; ``has_tpu`` is False.
"""

from __future__ import annotations

import enum as _enum

import torch

__version__ = "0.1.0"

has_cuda = torch.cuda.is_available()
has_tpu = False


class Device(_enum.IntEnum):
    """Compute device selector (API parity: pycolmap/main.cc:102-106):
    ``cuda`` is the card, ``auto`` the default (the card)."""

    auto = -1
    cpu = 0
    cuda = 1


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` (or ``Device.auto``) means the card (``cuda``); a host without
    CUDA raises. A CUDA device that is not available raises as well;
    ``"cpu"`` always works.
    """
    if isinstance(device, Device):
        device = {Device.auto: None, Device.cpu: "cpu",
                  Device.cuda: "cuda"}[device]
    if device is None:
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pycolmap_torch runs on a CUDA device by default and this host "
            "has none; pass device='cpu' to run the plain PyTorch versions"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


# The re-exports come after resolve_device: every submodule imports it from
# this package while the package is still initialising.
from pycolmap_torch.geometry import Rigid3d, Rotation3d, Sim3d  # noqa: E402
from pycolmap_torch.scene import (  # noqa: E402
    Camera,
    Correspondence,
    CorrespondenceGraph,
    Database,
    DatabaseTransaction,
    Image,
    Point2D,
    Point3D,
    Reconstruction,
    Track,
    TrackElement,
    image_pair_to_pair_id,
    pair_id_to_image_pair,
)
from pycolmap_torch.estimators import (  # noqa: E402
    AbsolutePoseEstimationOptions,
    AbsolutePoseRefinementOptions,
    EstimateTriangulationOptions,
    ImageAlignmentError,
    RANSACOptions,
    TwoViewGeometry,
    TwoViewGeometryConfiguration,
    TwoViewGeometryOptions,
    absolute_pose_estimation,
    align_reconstruction_to_locations,
    align_reconstructions_via_points,
    align_reconstructions_via_proj_centers,
    align_reconstructions_via_reprojections,
    align_reconstrution_to_locations,
    compare_reconstructions,
    essential_matrix_estimation,
    estimate_sim3d_robust,
    estimate_absolute_pose,
    estimate_calibrated_two_view_geometry,
    estimate_essential_matrix,
    estimate_fundamental_matrix,
    estimate_homography_matrix,
    estimate_triangulation,
    estimate_two_view_geometry,
    estimate_two_view_geometry_pose,
    fundamental_matrix_estimation,
    homography_decomposition,
    homography_matrix_estimation,
    pose_refinement,
    refine_absolute_pose,
    rig_absolute_pose_estimation,
)
from pycolmap_torch.features import (  # noqa: E402
    Normalization,
    Sift,
    SiftExtractionOptions,
    SiftMatchingOptions,
    extract_sift,
    match_descriptors,
    match_guided,
)
from pycolmap_torch.features.retrieval import (  # noqa: E402
    InvertedIndex,
    VocabTree,
    build_visual_index,
)
from pycolmap_torch.pipeline import (  # noqa: E402
    CameraMode,
    DelaunayMeshingOptions,
    ExhaustiveMatchingOptions,
    ImageReaderOptions,
    IncrementalPipelineOptions,
    PatchMatchOptions,
    PoissonMeshingOptions,
    ReconstructionManager,
    SequentialMatchingOptions,
    SpatialMatchingOptions,
    StereoFusionOptions,
    UndistortCameraOptions,
    VocabTreeMatchingOptions,
    bundle_adjustment,
    dense_delaunay_meshing,
    extract_features,
    import_images,
    incremental_mapping,
    infer_camera_from_image,
    match_exhaustive,
    match_sequential,
    match_spatial,
    match_vocabtree,
    patch_match_stereo,
    poisson_meshing,
    sparse_delaunay_meshing,
    stereo_fusion,
    triangulate_points,
    undistort_images,
    verify_matches,
)
from pycolmap_torch.parallel.graph_partition import (  # noqa: E402
    hierarchical_mapping,
)
from pycolmap_torch.parallel.device_ctx import (  # noqa: E402
    get_default_mesh,
    resolve_mesh,
    set_default_mesh,
)
from pycolmap_torch.sfm.bundle_adjustment import (  # noqa: E402
    BundleAdjustmentOptions,
    LossFunctionType,
)
from pycolmap_torch.sfm.incremental_mapper import (  # noqa: E402
    ImageSelectionMethod,
    IncrementalMapper,
    IncrementalMapperOptions,
)
from pycolmap_torch.sfm.incremental_triangulator import (  # noqa: E402
    IncrementalTriangulator,
    IncrementalTriangulatorOptions,
)
from pycolmap_torch.utils.logging import logging  # noqa: E402
