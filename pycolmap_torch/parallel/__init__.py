"""Partitioned mapping and synthetic problems (port of
``pycolmap_tpu/parallel``: ``graph_partition`` and ``synthetic``; the
multi-device modules are still to be ported)."""

from pycolmap_torch.parallel import graph_partition  # noqa: F401
