"""Evaluation: the serving step of the flagship and the split evaluation.

Port of ``occformer_tpu/engine/eval.py``: ``build_eval_step`` and
``lidarseg_point_logits`` (voxel class scores upsampled to the occupancy
grid (argmax), per-point predicted labels, and the lidarseg confusion
matrix; reference apis/test.py:22-105, mask2former_nusc_occ.py:505-542; for
the panoptic head also the last layer's class logits and every query's mask
logits at the LiDAR points, mask2former_nusc_panoptic_occ.py:515-563), and
``evaluate``, ``metrics_from_state`` and ``format_iou_table`` (the confusion
matrix and, for SemanticKITTI, the semantic scene completion counters of
``utils/metrics.py:SSCMetrics``, for the panoptic head the PQ counters of
``utils/panoptic.py:PanopticEval``, summed over a split; the per-class IoU
table, SC IoU / SSC mIoU and PQ / SQ / RQ; reference apis/test.py:107-212).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..models.mask2former_head import format_results, mask_logits_from_embeds
from ..ops.sampling import grid_sample_3d, point_sample_3d, resize_trilinear
from ..parallel.distributed import host_allreduce_sum
from ..utils.metrics import SSCMetrics, cm_to_ious
from ..utils.panoptic import PanopticEval, format_panoptic_results

# the reference panoptic recipe's evaluator (mask2former_nusc_panoptic_occ.py:148)
PANOPTIC_IGNORE = (0,)
PANOPTIC_MIN_POINTS = 15


def lidarseg_point_logits(voxel_scores: torch.Tensor, lidar_xyz01: torch.Tensor,
                          align_corners: bool = True) -> torch.Tensor:
    """Trilinear per-point readout of ``voxel_scores [B, X, Y, Z, C]`` at
    ``lidar_xyz01 [B, P, 3]`` in [0, 1]; border padding keeps out-of-range
    returns usable.  Returns [B, P, C]."""
    return grid_sample_3d(voxel_scores, lidar_xyz01 * 2.0 - 1.0,
                          align_corners=align_corners, padding_mode="border")


def to_device_batch(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays or tensors -> tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def build_eval_step(model, occ_size: Tuple[int, int, int], num_classes: int,
                    compute_dtype: Optional[torch.dtype] = None,
                    panoptic: bool = False) -> Callable:
    """Returns ``eval_step(batch) -> dict`` on the model's device.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the forward and the
    readout under ``torch.autocast``, the model keeping its (float32)
    parameters, as the JAX package serves (``param_dtype`` float32 at a bf16
    compute dtype) and as ``build_train_step`` trains.  Outputs:
    ``voxel_pred`` [B, *occ_size] uint8, and with ``lidar_xyz`` in the batch
    ``point_pred`` [B, P] int32 (the empty class 0 is skipped); with
    ``lidar_label`` and ``lidar_valid`` also ``confusion`` [n, n] int64.
    With ``panoptic`` the LiDAR labels are panoptic ids (``class * 1000 +
    instance``), the confusion matrix takes their class part, and with
    ``lidar_xyz`` the step also returns ``point_cls`` [B, Q, C+1], the last
    layer's class logits, and ``point_mask`` [B, Q, P], each query's mask
    logits at the points: its embedding contracted, in float32, with the
    mask feature read there (align_corners, border; through K2 on the card,
    since the read is linear it equals the mask volume's read).  Both
    float32.
    """
    device = next(model.parameters()).device
    n = int(num_classes)

    @torch.inference_mode()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        # named ranges for torch.profiler; the model's forward names its own stages
        with record_function("stage:upload"):
            batch = to_device_batch(batch, device)
        with torch.autocast(device.type, dtype=compute_dtype or torch.float32,
                            enabled=compute_dtype is not None):
            out = model(batch)
            with record_function("stage:readout"):
                final_mask = mask_logits_from_embeds(out["mask_embeds"][-1],
                                                     out["mask_feature"])
                voxels = format_results(out["cls_preds"][-1], final_mask)  # [B, X, Y, Z, C]
                # voxel semantics at full occupancy resolution (trilinear, align_corners)
                up = resize_trilinear(voxels, tuple(occ_size), align_corners=True)
                result = {"voxel_pred": up.argmax(dim=-1).to(torch.uint8)}
                if "lidar_xyz" in batch:
                    logits = lidarseg_point_logits(voxels, batch["lidar_xyz"])
                    pts_pred = logits[..., 1:].argmax(dim=-1) + 1
                    result["point_pred"] = pts_pred.to(torch.int32)
                    if panoptic:
                        feat_pts = point_sample_3d(out["mask_feature"].contiguous(),
                                                   batch["lidar_xyz"],
                                                   align_corners=True, padding_mode="border")
                        with torch.autocast(device.type, enabled=False):
                            result["point_cls"] = out["cls_preds"][-1].float()
                            result["point_mask"] = torch.einsum(
                                "bqc,bpc->bqp", out["mask_embeds"][-1].float(),
                                feat_pts.float())
                    if "lidar_label" in batch:
                        label = batch["lidar_label"].long()
                        if panoptic:  # the class part
                            label = torch.div(label, 1000, rounding_mode="floor")
                        idx = label * n + pts_pred
                        idx = torch.where(batch["lidar_valid"].bool(), idx,
                                          torch.full_like(idx, n * n))
                        cm = torch.bincount(idx.reshape(-1), minlength=n * n + 1)[:-1]
                        result["confusion"] = cm.reshape(n, n)
        return result

    return eval_step


def metrics_from_state(state: Dict[str, np.ndarray], num_classes: int,
                       class_names=None) -> Dict[str, Any]:
    """The metric table of (already reduced) counters: ``confusion``, the
    lidarseg confusion matrix, gives ``nuScenes_lidarseg_<class>`` for the
    foreground classes and ``nuScenes_lidarseg_mean``; the ``ssc_*``
    counters (present where SSC was computed) give ``semkitti_SC_IoU``,
    ``semkitti_SSC_mIoU``, ``SSC_precision`` and ``SSC_recall``; the
    ``pan_*`` counters (present where panoptic quality was computed)
    ``nuScenes_panoptic_PQ``, ``_SQ`` and ``_RQ``.  All
    entries are sums, so summing per-process states first equals one pass
    over the whole split."""
    results: Dict[str, Any] = {}
    cm = np.asarray(state["confusion"])
    if cm.sum() > 0:
        fg = cm[1:, 1:]  # crop the empty/noise row and column (fast_hist_crop)
        ious = cm_to_ious(fg)
        names = class_names or [str(i) for i in range(num_classes)]
        for i, iou in enumerate(ious):
            results[f"nuScenes_lidarseg_{names[i + 1]}"] = float(iou)
        results["nuScenes_lidarseg_mean"] = float(np.nanmean(ious))
    if "ssc_tps" in state:
        ssc = SSCMetrics(num_classes)
        ssc.set_state(state)
        m = ssc.compute()
        results["semkitti_SC_IoU"] = float(m["sc_iou"])
        results["semkitti_SSC_mIoU"] = float(m["ssc_miou"])
        results["SSC_precision"] = float(m["precision"])
        results["SSC_recall"] = float(m["recall"])
    if "pan_tp" in state:
        pan = PanopticEval(num_classes, ignore=PANOPTIC_IGNORE, min_points=PANOPTIC_MIN_POINTS)
        pan.set_state(state)
        pq, sq, rq = pan.get_pq()[:3]
        results["nuScenes_panoptic_PQ"] = float(pq)
        results["nuScenes_panoptic_SQ"] = float(sq)
        results["nuScenes_panoptic_RQ"] = float(rq)
    return results


def evaluate(model, loader, occ_size, num_classes: int, class_names=None,
             compute_ssc: bool = False, save_cb: Optional[Callable] = None,
             panoptic: bool = False, thing_indices: Optional[Sequence[int]] = None,
             all_reduce: Optional[Callable] = None,
             compute_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Full-split evaluation of ``model`` (on its device, in eval mode)
    through ``build_eval_step(..., compute_dtype, panoptic)``: the lidarseg
    IoU table and, with ``compute_ssc``, the SSC metrics of ``voxel_pred``
    against the batch's ``gt_occ`` (label 255 ignored).  With ``panoptic``,
    point-level PQ / SQ / RQ over the split (JAX :127-200): each sample's
    valid points formatted on the host (``format_panoptic_results`` with
    ``thing_indices``) and held to its panoptic LiDAR labels by
    ``PanopticEval(ignore=[0], min_points=15)``.

    ``save_cb(out, meta_list, batch)`` runs per batch on the host (the
    submission writers, reference apis/test.py:161-167).  ``all_reduce``
    sums the counter state across processes before the metrics are derived
    (default: ``parallel/distributed.py:host_allreduce_sum``, the identity
    for one process), the analogue of the reference's
    ``dist.all_reduce(evaluation_semantic)`` (apis/test.py:209)."""
    all_reduce = all_reduce or host_allreduce_sum
    step = build_eval_step(model, occ_size, num_classes, compute_dtype, panoptic=panoptic)
    cm = np.zeros((num_classes, num_classes), np.int64)
    ssc = SSCMetrics(num_classes) if compute_ssc else None
    pan = (PanopticEval(num_classes, ignore=PANOPTIC_IGNORE, min_points=PANOPTIC_MIN_POINTS)
           if panoptic else None)
    things = tuple(thing_indices or ())
    for batch in loader:
        batch = dict(batch)  # host-only keys popped locally, the caller's dict untouched
        gt_occ = batch.pop("gt_occ", None)
        meta = batch.pop("_meta", None)
        out = step(batch)
        if save_cb is not None:
            save_cb(out, meta, batch)
        if "confusion" in out:
            cm += out["confusion"].cpu().numpy()
        if ssc is not None and gt_occ is not None:
            ssc.update(out["voxel_pred"].cpu().numpy(), torch.as_tensor(gt_occ).cpu().numpy())
        if pan is not None and "point_mask" in out and "lidar_label" in batch:
            add_panoptic(pan, out, batch, things)
    state = {"confusion": cm}
    if ssc is not None:
        state.update(ssc.state())
    if pan is not None:
        state.update(pan.state())
    state = all_reduce(state)
    return metrics_from_state(state, num_classes, class_names=class_names)


def add_panoptic(pan: PanopticEval, out: Dict[str, torch.Tensor], batch: Dict,
                 thing_indices: Sequence[int]) -> None:
    """Adds a served batch to ``pan``: per sample, its valid points'
    panoptic formatting (``format_panoptic_results`` of ``point_cls`` and
    ``point_mask``) against their panoptic labels, on the host."""
    point_cls = out["point_cls"].cpu().numpy()
    point_mask = out["point_mask"].cpu().numpy()
    labels = np.asarray(torch.as_tensor(batch["lidar_label"]).cpu()).astype(np.int64)
    valid = np.asarray(torch.as_tensor(batch["lidar_valid"]).cpu()).astype(bool)
    for b in range(point_cls.shape[0]):
        sem_pred, pan_pred = format_panoptic_results(point_cls[b], point_mask[b],
                                                     thing_indices)
        v = valid[b]
        pan.add_batch(sem_pred[v], pan_pred[v], (labels[b] // 1000)[v], labels[b][v])


def format_iou_table(results: Dict[str, float]) -> str:
    """PrettyTable-style text report (reference utils/formating.py:14-47)."""
    lines = ["| metric | value |", "|---|---|"]
    for k, v in results.items():
        lines.append(f"| {k} | {v:.4f} |")
    return "\n".join(lines)
