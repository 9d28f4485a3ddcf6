"""Carry state from the reference package into the port.

The reference's ``BundleProblem`` and its options (BA, SIFT extraction,
SIFT matching, the incremental pipeline, PatchMatch, stereo fusion,
undistortion, RANSAC and the estimators', image reading, the pair
matchers' and meshing's) and the vocabulary tree cross as plain data
(numpy arrays, dicts), never as reference objects, so this module imports
nothing of ``pycolmap_tpu``. Parity tests
build one problem, hand its fields to both packages, and compare the
results. The pipeline has no other state: its database (COLMAP's SQLite
schema), models, images and depth maps cross as files, which both packages
read and write alike.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from pycolmap_torch.estimators.absolute_pose import (
    AbsolutePoseEstimationOptions,
    AbsolutePoseRefinementOptions,
)
from pycolmap_torch.estimators.ransac import RANSACOptions
from pycolmap_torch.estimators.triangulation import EstimateTriangulationOptions
from pycolmap_torch.estimators.two_view_geometry import TwoViewGeometryOptions
from pycolmap_torch.features.matcher import SiftMatchingOptions
from pycolmap_torch.features.retrieval import VocabTree
from pycolmap_torch.features.sift import SiftExtractionOptions
from pycolmap_torch.mvs.fusion import StereoFusionOptions
from pycolmap_torch.mvs.meshing import (
    DelaunayMeshingOptions,
    PoissonMeshingOptions,
)
from pycolmap_torch.mvs.patch_match import PatchMatchOptions
from pycolmap_torch.pipeline.images import (
    ImageReaderOptions,
    UndistortCameraOptions,
)
from pycolmap_torch.pipeline.match_features import (
    ExhaustiveMatchingOptions,
    SequentialMatchingOptions,
    SpatialMatchingOptions,
    VocabTreeMatchingOptions,
)
from pycolmap_torch.pipeline.sfm import IncrementalPipelineOptions
from pycolmap_torch.sfm.bundle_adjustment import (
    BundleAdjustmentOptions,
    BundleProblem,
)

_INT_FIELDS = ("obs_image_idx", "obs_camera_idx", "obs_point_idx")
# PatchMatch's GPU selector: the port's entry points take ``device``
_DROPPED_PM_OPTIONS = ("gpu_index",)


def bundle_problem_from_numpy(arrays: Mapping, model_id) -> BundleProblem:
    """Build the port's problem from the reference problem's fields.

    arrays: field name -> array-like for every ``BundleProblem`` field but
    ``model_id`` (e.g. ``{k: np.asarray(v) for k, v in
    jax_problem._asdict().items() if k != "model_id"}``). Returns host
    tensors: int32 indices, f32 everything else.
    """
    fields = {}
    for name in BundleProblem._fields:
        if name == "model_id":
            continue
        dtype = np.int32 if name in _INT_FIELDS else np.float32
        # a writable copy: reference arrays may be read-only views
        fields[name] = torch.from_numpy(np.array(arrays[name], dtype=dtype))
    return BundleProblem(model_id=model_id, **fields)


def ba_options_from_dict(values: Mapping) -> BundleAdjustmentOptions:
    """Build the port's options from the reference options' ``todict()``.

    Enum values arrive as the reference's IntEnum members or plain ints and
    map onto the port's enum by value."""
    opts = BundleAdjustmentOptions()
    opts.mergedict({
        k: (int(v) if k == "loss_function_type" else v)
        for k, v in _portable(values).items()
    })
    return opts


def _portable(values: Mapping) -> dict:
    """The options values without a ``devices`` that is a JAX mesh: a
    selector string or count carries over, a mesh object has no
    counterpart (the port's own is a ShardMesh)."""
    dev = values.get("devices")
    return {k: v for k, v in values.items()
            if k != "devices" or dev is None or isinstance(dev, (str, int))}


def _options_from(cls, values: Mapping):
    opts = cls()
    opts.mergedict(dict(values))
    return opts


def sift_options_from_dict(values: Mapping) -> SiftExtractionOptions:
    """The port's extraction options from the reference options'
    ``todict()``; ``normalization`` maps onto the port's enum by value."""
    return _options_from(SiftExtractionOptions, values)


def matching_options_from_dict(values: Mapping) -> SiftMatchingOptions:
    """The port's matching options from the reference options' ``todict()``."""
    return _options_from(SiftMatchingOptions, values)


def pipeline_options_from_dict(values: Mapping) -> IncrementalPipelineOptions:
    """The port's pipeline options from the reference
    ``IncrementalPipelineOptions.todict()``, nested mapper and
    triangulation options included; enums map by value."""
    opts = IncrementalPipelineOptions()
    opts.mergedict(_portable(values))
    return opts


def patch_match_options_from_dict(values: Mapping) -> PatchMatchOptions:
    """The port's PatchMatch options from the reference
    ``PatchMatchOptions.todict()`` (``gpu_index`` dropped)."""
    opts = PatchMatchOptions()
    opts.mergedict({k: v for k, v in values.items()
                    if k not in _DROPPED_PM_OPTIONS})
    return opts


def stereo_fusion_options_from_dict(values: Mapping) -> StereoFusionOptions:
    """The port's fusion options from the reference options' ``todict()``."""
    opts = StereoFusionOptions()
    opts.mergedict(dict(values))
    return opts


def undistort_options_from_dict(values: Mapping) -> UndistortCameraOptions:
    """The port's undistortion options from the reference
    ``UndistortCameraOptions.todict()``."""
    opts = UndistortCameraOptions()
    opts.mergedict(dict(values))
    return opts


def ransac_options_from_dict(values: Mapping) -> RANSACOptions:
    """The port's RANSAC options from the reference options' ``todict()``."""
    return _options_from(RANSACOptions, values)


def two_view_geometry_options_from_dict(values: Mapping) -> TwoViewGeometryOptions:
    """The port's two-view options from the reference
    ``TwoViewGeometryOptions.todict()``, its nested ``ransac`` included."""
    return _options_from(TwoViewGeometryOptions, values)


def absolute_pose_estimation_options_from_dict(
        values: Mapping) -> AbsolutePoseEstimationOptions:
    """The port's absolute-pose estimation options (nested ``ransac``
    included) from the reference options' ``todict()``."""
    return _options_from(AbsolutePoseEstimationOptions, values)


def absolute_pose_refinement_options_from_dict(
        values: Mapping) -> AbsolutePoseRefinementOptions:
    """The port's pose refinement options from the reference options'
    ``todict()``."""
    return _options_from(AbsolutePoseRefinementOptions, values)


def triangulation_options_from_dict(
        values: Mapping) -> EstimateTriangulationOptions:
    """The port's ``EstimateTriangulationOptions`` (nested ``ransac``
    included) from the reference options' ``todict()``."""
    return _options_from(EstimateTriangulationOptions, values)


def image_reader_options_from_dict(values: Mapping) -> ImageReaderOptions:
    """The port's ``ImageReaderOptions`` from the reference options'
    ``todict()``."""
    return _options_from(ImageReaderOptions, values)


def exhaustive_matching_options_from_dict(
        values: Mapping) -> ExhaustiveMatchingOptions:
    """The port's ``ExhaustiveMatchingOptions`` from the reference options'
    ``todict()``."""
    return _options_from(ExhaustiveMatchingOptions, values)


def sequential_matching_options_from_dict(
        values: Mapping) -> SequentialMatchingOptions:
    """The port's ``SequentialMatchingOptions`` from the reference options'
    ``todict()``."""
    return _options_from(SequentialMatchingOptions, values)


def spatial_matching_options_from_dict(
        values: Mapping) -> SpatialMatchingOptions:
    """The port's ``SpatialMatchingOptions`` from the reference options'
    ``todict()``."""
    return _options_from(SpatialMatchingOptions, values)


def vocab_tree_matching_options_from_dict(
        values: Mapping) -> VocabTreeMatchingOptions:
    """The port's ``VocabTreeMatchingOptions`` from the reference options'
    ``todict()``."""
    return _options_from(VocabTreeMatchingOptions, values)


def poisson_meshing_options_from_dict(
        values: Mapping) -> PoissonMeshingOptions:
    """The port's ``PoissonMeshingOptions`` from the reference options'
    ``todict()``."""
    return _options_from(PoissonMeshingOptions, values)


def delaunay_meshing_options_from_dict(
        values: Mapping) -> DelaunayMeshingOptions:
    """The port's ``DelaunayMeshingOptions`` from the reference options'
    ``todict()``."""
    return _options_from(DelaunayMeshingOptions, values)


def vocab_tree_from_reference(tree) -> VocabTree:
    """The port's ``VocabTree`` from a reference ``VocabTree``: its levels
    cross as numpy arrays, with its branching."""
    return VocabTree([np.asarray(c, np.float32) for c in tree.levels],
                     int(tree.branching))
