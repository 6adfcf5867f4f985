"""Segmentation metrics on the host.

The port's copy of ``occformer_tpu/utils/metrics.py:cm_to_ious`` (reference
utils/formating.py / lidarseg evaluation).  ``SSCMetrics`` waits for the
KITTI slice.
"""
from __future__ import annotations

import numpy as np


def cm_to_ious(cm: np.ndarray) -> np.ndarray:
    """Per-class IoU of a confusion matrix (rows: ground truth, columns:
    prediction); NaN for a class absent from both."""
    mean_ious = []
    cm = cm.astype(np.float64)
    for i in range(cm.shape[0]):
        tp = cm[i, i]
        p = cm[:, i].sum()
        g = cm[i, :].sum()
        union = p + g - tp
        mean_ious.append(tp / union if union > 0 else np.nan)
    return np.array(mean_ious)
