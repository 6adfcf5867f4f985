"""Datasets and the host data path of the port.

``nuscenes`` (``CustomNuScenesOccLSSDataset``), ``semantic_kitti``
(``CustomSemanticKITTILssDataset``) and ``synthetic``
(``SyntheticOccDataset``) register their datasets in ``registry.DATASETS``
when imported, as this package does; ``transforms`` and ``voxelize`` the
steps of the nuScenes and SemanticKITTI pipelines in ``registry.PIPELINES``.
``native`` binds the C++ kernels of ``csrc/occ_data.cpp``, built at first
use; ``loader`` shards, collates and prefetches; ``fixtures`` writes a
nuScenes-layout tree and a SemanticKITTI one from a seed.
"""
from . import nuscenes, semantic_kitti, synthetic  # noqa: F401  (register the datasets)
