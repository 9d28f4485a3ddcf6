"""SIFT extraction and descriptor matching (port of
``pycolmap_tpu/features``; ``match_guided`` waits for the two-view
estimators, see ROADMAP.md)."""

from pycolmap_torch.features.matcher import (
    SiftMatchingOptions,
    match_descriptors,
    match_descriptors_batch,
)
from pycolmap_torch.features.sift import (
    Normalization,
    Sift,
    SiftExtractionOptions,
    extract_sift,
)
