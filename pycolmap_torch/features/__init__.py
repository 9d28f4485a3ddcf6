"""SIFT extraction, descriptor matching, guided matching and
vocabulary-tree retrieval (``features/retrieval.py``); port of
``pycolmap_tpu/features``."""

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
