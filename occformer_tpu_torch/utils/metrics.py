"""Segmentation metrics on the host: the lidarseg confusion matrix's IoU and
the semantic scene completion (SSC) counters.

The port's copy of ``occformer_tpu/utils/metrics.py`` (reference
utils/{metric_util.py:8-23, ssc_metric.py:14-169}).  Every counter is an
integer sum, so the states of several processes add up exactly to one pass
over the whole split.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def fast_hist(pred: np.ndarray, label: np.ndarray, max_label: int) -> np.ndarray:
    """Confusion matrix over labels [0, max_label) (metric_util.py:8-13)."""
    pred = np.asarray(pred).reshape(-1)
    label = np.asarray(label).reshape(-1)
    k = (label >= 0) & (label < max_label)
    bin_count = np.bincount(max_label * label[k].astype(int) + pred[k],
                            minlength=max_label ** 2)
    return bin_count[: max_label ** 2].reshape(max_label, max_label)


def fast_hist_crop(pred: np.ndarray, label: np.ndarray, unique_label: np.ndarray) -> np.ndarray:
    """The histogram cropped to ``unique_label + 1`` (metric_util.py:16-20)."""
    hist = fast_hist(pred.flatten(), label.flatten(), np.max(unique_label) + 2)
    return hist[unique_label + 1, :][:, unique_label + 1]


def per_class_iou(hist: np.ndarray) -> np.ndarray:
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.diag(hist) / (hist.sum(1) + hist.sum(0) - np.diag(hist))


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


class SSCMetrics:
    """Semantic scene completion counters (ssc_metric.py:14-169): per-class
    tp/fp/fn and the binary occupancy (SC) tp/fp/fn, integer arrays."""

    def __init__(self, num_classes: int):
        self.n = num_classes
        self.reset()

    def reset(self):
        self.tps = np.zeros(self.n, np.int64)
        self.fps = np.zeros(self.n, np.int64)
        self.fns = np.zeros(self.n, np.int64)
        self.sc_tp = 0
        self.sc_fp = 0
        self.sc_fn = 0

    def update(self, pred: np.ndarray, target: np.ndarray, invalid_label: int = 255):
        """pred/target: integer voxel labels of one shape; ``invalid_label``
        voxels are ignored."""
        mask = target != invalid_label
        p = pred[mask]
        t = target[mask]
        p_occ = p > 0
        t_occ = t > 0
        self.sc_tp += int(np.sum(p_occ & t_occ))
        self.sc_fp += int(np.sum(p_occ & ~t_occ))
        self.sc_fn += int(np.sum(~p_occ & t_occ))
        # one confusion matrix instead of a pass per class
        n = self.n
        ok = (t >= 0) & (t < n) & (p >= 0) & (p < n)
        cm = np.bincount(n * t[ok].astype(np.int64) + p[ok].astype(np.int64),
                         minlength=n * n).reshape(n, n)
        tp = np.diag(cm)
        self.tps += tp
        # a label outside [0, n) counts as a miss of the other side's class
        self.fps += np.bincount(p[(p != t) & (p >= 0) & (p < n)].astype(np.int64),
                                minlength=n)[:n]
        self.fns += np.bincount(t[(p != t) & (t >= 0) & (t < n)].astype(np.int64),
                                minlength=n)[:n]

    def state(self) -> Dict[str, np.ndarray]:
        """The counters as summable arrays."""
        return {
            "ssc_tps": self.tps.copy(),
            "ssc_fps": self.fps.copy(),
            "ssc_fns": self.fns.copy(),
            "ssc_sc": np.array([self.sc_tp, self.sc_fp, self.sc_fn], np.int64),
        }

    def set_state(self, s: Dict[str, np.ndarray]):
        self.tps = np.asarray(s["ssc_tps"], np.int64)
        self.fps = np.asarray(s["ssc_fps"], np.int64)
        self.fns = np.asarray(s["ssc_fns"], np.int64)
        self.sc_tp, self.sc_fp, self.sc_fn = (int(x) for x in s["ssc_sc"])

    def merge(self, other: "SSCMetrics"):
        self.tps += other.tps
        self.fps += other.fps
        self.fns += other.fns
        self.sc_tp += other.sc_tp
        self.sc_fp += other.sc_fp
        self.sc_fn += other.sc_fn

    def compute(self) -> Dict[str, np.ndarray]:
        denom = self.sc_tp + self.sc_fp + self.sc_fn
        sc_iou = self.sc_tp / denom if denom > 0 else 0.0
        union = self.tps + self.fps + self.fns
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(union > 0, self.tps / union, np.nan)
        # the SSC mIoU leaves out the empty class 0
        return {
            "sc_iou": sc_iou,
            "iou_per_class": iou,
            "ssc_miou": float(np.nanmean(iou[1:])),
            "precision": self.sc_tp / max(self.sc_tp + self.sc_fp, 1),
            "recall": self.sc_tp / max(self.sc_tp + self.sc_fn, 1),
        }
