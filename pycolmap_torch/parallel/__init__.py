"""Partitioned mapping, synthetic problems and the multi-device layer
(port of ``pycolmap_tpu/parallel``: ``graph_partition``, ``synthetic``,
``device_ctx``, ``sharded_ba``, ``camera_sharding`` and ``distributed``)."""

from pycolmap_torch.parallel import graph_partition  # noqa: F401
