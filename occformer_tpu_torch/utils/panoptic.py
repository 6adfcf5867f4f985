"""Panoptic quality (PQ / SQ / RQ) evaluation and the panoptic formatting
of the head's outputs, on the host in numpy.

The port's copy of ``occformer_tpu/utils/panoptic.py`` (reference
projects/mmdet3d_plugin/utils/panoptic_eval.py:11-245: offset 2^32, class 0
ignored; the panoptic recipe evaluates with ``min_points=15``).  Per class,
predicted and GT segments are matched by IoU > 0.5 from joint-id
histograms.  Every counter of ``PanopticEval.state`` is a per-class sum
(int64 counts, float64 IoU sums), so the states of several processes add up
to one pass over the whole split.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


class PanopticEval:
    def __init__(self, n_classes: int, ignore: Sequence[int] = (0,),
                 offset: int = 2 ** 32, min_points: int = 30, eps: float = 1e-15):
        self.n_classes = n_classes
        self.ignore = np.asarray(ignore, np.int64)
        self.include = np.asarray(
            [c for c in range(n_classes) if c not in self.ignore], np.int64
        )
        self.offset = offset
        self.min_points = min_points
        self.eps = eps
        self.reset()

    def reset(self):
        self.pan_tp = np.zeros(self.n_classes, np.int64)
        self.pan_fp = np.zeros(self.n_classes, np.int64)
        self.pan_fn = np.zeros(self.n_classes, np.int64)
        self.pan_iou = np.zeros(self.n_classes, np.float64)

    def state(self) -> Dict[str, np.ndarray]:
        """Counters as summable arrays (cross-host reduction boundary).
        All four are per-class sums, so summing across hosts is exact."""
        return {
            "pan_tp": self.pan_tp.copy(),
            "pan_fp": self.pan_fp.copy(),
            "pan_fn": self.pan_fn.copy(),
            "pan_iou": self.pan_iou.copy(),
        }

    def set_state(self, s: Dict[str, np.ndarray]):
        self.pan_tp = np.asarray(s["pan_tp"], np.int64)
        self.pan_fp = np.asarray(s["pan_fp"], np.int64)
        self.pan_fn = np.asarray(s["pan_fn"], np.int64)
        self.pan_iou = np.asarray(s["pan_iou"], np.float64)

    def add_batch(self, sem_pred, pan_pred, sem_gt, pan_gt):
        """All inputs flat int arrays of equal length."""
        sem_pred = np.asarray(sem_pred, np.int64).reshape(-1)
        pan_pred = np.asarray(pan_pred, np.int64).reshape(-1)
        sem_gt = np.asarray(sem_gt, np.int64).reshape(-1)
        pan_gt = np.asarray(pan_gt, np.int64).reshape(-1)

        # drop ignored GT points
        keep = ~np.isin(sem_gt, self.ignore)
        sem_pred, pan_pred = sem_pred[keep], pan_pred[keep]
        sem_gt, pan_gt = sem_gt[keep], pan_gt[keep]

        for cl in self.include:
            pred_in = sem_pred == cl
            gt_in = sem_gt == cl

            # relabel instances contiguously (0 reserved for "not this class")
            pred_inst = np.where(pred_in, pan_pred + 1, 0)
            gt_inst = np.where(gt_in, pan_gt + 1, 0)

            pred_ids, pred_cnt = np.unique(pred_inst[pred_inst > 0], return_counts=True)
            gt_ids, gt_cnt = np.unique(gt_inst[gt_inst > 0], return_counts=True)
            pred_sizes = dict(zip(pred_ids.tolist(), pred_cnt.tolist()))
            gt_sizes = dict(zip(gt_ids.tolist(), gt_cnt.tolist()))

            # joint histogram of overlapping (gt, pred) segment pairs
            both = (pred_inst > 0) & (gt_inst > 0)
            joint = gt_inst[both] * self.offset + pred_inst[both]
            joint_ids, joint_cnt = np.unique(joint, return_counts=True)

            matched_gt, matched_pred = set(), set()
            for jid, inter in zip(joint_ids.tolist(), joint_cnt.tolist()):
                g = jid // self.offset
                p = jid % self.offset
                union = gt_sizes[g] + pred_sizes[p] - inter
                iou = inter / max(union, 1)
                if iou > 0.5:
                    self.pan_tp[cl] += 1
                    self.pan_iou[cl] += iou
                    matched_gt.add(g)
                    matched_pred.add(p)

            for g, sz in gt_sizes.items():
                if g not in matched_gt and sz >= self.min_points:
                    self.pan_fn[cl] += 1
            for p, sz in pred_sizes.items():
                if p not in matched_pred and sz >= self.min_points:
                    self.pan_fp[cl] += 1

    def get_pq(self) -> Tuple[float, float, float, np.ndarray, np.ndarray, np.ndarray]:
        sq = self.pan_iou / np.maximum(self.pan_tp, self.eps)
        rq = self.pan_tp / np.maximum(
            self.pan_tp + 0.5 * self.pan_fp + 0.5 * self.pan_fn, self.eps
        )
        pq = sq * rq
        return (
            float(pq[self.include].mean()),
            float(sq[self.include].mean()),
            float(rq[self.include].mean()),
            pq, sq, rq,
        )

    def evaluate_panoptic_single(self, sem_pred, pan_pred, sem_gt, pan_gt):
        """Single-shot PQ for train-time metrics
        (mask2former_nusc_panoptic_occ.py forward_lidar_panopticseg)."""
        self.reset()
        self.add_batch(sem_pred, pan_pred, sem_gt, pan_gt)
        pq, sq, rq, *_ = self.get_pq()
        return pq, sq, rq


def format_panoptic_results(
    cls_logits: np.ndarray,   # [Q, C+1]
    mask_logits: np.ndarray,  # [Q, ...spatial]
    thing_indices: Sequence[int],
    skip_empty_argmax: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Voxel/point panoptic formatting (host-side postprocessing).

    Reference mask2former_nusc_panoptic_occ.py:715-800: each cell takes the
    argmax query; stuff classes collapse to class*1000; thing classes get a
    fresh instance id per winning query.
    """
    cls_prob = _softmax(cls_logits)[:, :-1]
    if skip_empty_argmax:
        labels = cls_prob[:, 1:].argmax(-1) + 1
    else:
        labels = cls_prob.argmax(-1)
    cell_query = mask_logits.argmax(0)  # winning query per cell
    sem = labels[cell_query]
    pan = np.zeros_like(sem, np.int64)
    instance_id = 1
    for label_id in np.unique(sem):
        label_mask = sem == label_id
        if int(label_id) not in thing_indices:
            pan[label_mask] = int(label_id) * 1000
            continue
        for q in np.unique(cell_query[label_mask]):
            qm = cell_query == q
            pan[qm] = int(label_id) * 1000 + instance_id
            instance_id += 1
    return sem, pan


def _softmax(x: np.ndarray) -> np.ndarray:
    e = np.exp(x - x.max(-1, keepdims=True))
    return e / e.sum(-1, keepdims=True)
