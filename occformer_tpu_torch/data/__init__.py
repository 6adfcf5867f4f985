"""Datasets and the host data path of the port.

``nuscenes`` (``CustomNuScenesOccLSSDataset``) and ``synthetic``
(``SyntheticOccDataset``) register their datasets in ``registry.DATASETS``
when imported, as this package does; ``transforms`` and ``voxelize`` the
steps of the nuScenes pipeline in ``registry.PIPELINES``.  ``native`` binds
the C++ kernels of ``csrc/occ_data.cpp``, built at first use; ``loader``
shards, collates and prefetches; ``fixtures`` writes a nuScenes-layout tree
from a seed.
"""
from . import nuscenes, synthetic  # noqa: F401  (register the datasets)
