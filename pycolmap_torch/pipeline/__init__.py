from pycolmap_torch.pipeline.sfm import (
    IncrementalPipelineOptions,
    bundle_adjustment,
    triangulate_points,
)

__all__ = ["IncrementalPipelineOptions", "bundle_adjustment",
           "triangulate_points"]
