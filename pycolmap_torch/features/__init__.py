"""SIFT extraction, descriptor matching and guided matching (port of
``pycolmap_tpu/features``; the vocabulary-tree retrieval module is not
ported yet, see ROADMAP.md)."""

from pycolmap_torch.features.matcher import (
    SiftMatchingOptions,
    match_descriptors,
    match_descriptors_batch,
    match_guided,
)
from pycolmap_torch.features.sift import (
    Normalization,
    Sift,
    SiftExtractionOptions,
    extract_sift,
)
