"""Submission files.

The port's copy of ``occformer_tpu/utils/semkitti_io.py:
write_nusc_lidarseg_bin`` (reference apis/utils.py:112-134).  The
SemanticKITTI writers wait for the KITTI slice.
"""
from __future__ import annotations

import os

import numpy as np


def write_nusc_lidarseg_bin(point_labels: np.ndarray, out_path: str):
    """Per-point uint8 predictions for the nuScenes lidarseg benchmark."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    point_labels.astype(np.uint8).tofile(out_path)
