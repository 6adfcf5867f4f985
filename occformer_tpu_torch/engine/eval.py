"""Evaluation: the serving step of the flagship and the split evaluation.

Port of ``occformer_tpu/engine/eval.py``, lidarseg and SSC branches:
``build_eval_step`` and ``lidarseg_point_logits`` (voxel class scores
upsampled to the occupancy grid (argmax), per-point predicted labels, and
the lidarseg confusion matrix; reference apis/test.py:22-105,
mask2former_nusc_occ.py:505-542), and ``evaluate``, ``metrics_from_state``
and ``format_iou_table`` (the confusion matrix and, for SemanticKITTI, the
semantic scene completion counters of ``utils/metrics.py:SSCMetrics``
summed over a split; the per-class IoU table and SC IoU / SSC mIoU;
reference apis/test.py:107-212).  The panoptic branch waits for its slice.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from ..models.mask2former_head import format_results, mask_logits_from_embeds
from ..ops.sampling import grid_sample_3d, resize_trilinear
from ..parallel.distributed import host_allreduce_sum
from ..utils.metrics import SSCMetrics, cm_to_ious


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
                    compute_dtype: Optional[torch.dtype] = None) -> Callable:
    """Returns ``eval_step(batch) -> dict`` on the model's device.

    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the forward and the
    readout under ``torch.autocast``, the model keeping its (float32)
    parameters, as the JAX package serves (``param_dtype`` float32 at a bf16
    compute dtype) and as ``build_train_step`` trains.  Outputs:
    ``voxel_pred`` [B, *occ_size] uint8, and with ``lidar_xyz`` in the batch
    ``point_pred`` [B, P] int32 (the empty class 0 is skipped); with
    ``lidar_label`` and ``lidar_valid`` also ``confusion`` [n, n] int64.
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
                    if "lidar_label" in batch:
                        idx = batch["lidar_label"].long() * n + pts_pred
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
    ``semkitti_SSC_mIoU``, ``SSC_precision`` and ``SSC_recall``.  All
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
    return results


def evaluate(model, loader, occ_size, num_classes: int, class_names=None,
             compute_ssc: bool = False, save_cb: Optional[Callable] = None,
             panoptic: bool = False,
             all_reduce: Optional[Callable] = None,
             compute_dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """Full-split evaluation of ``model`` (on its device, in eval mode)
    through ``build_eval_step(..., compute_dtype)``: the lidarseg IoU table
    and, with ``compute_ssc``, the SSC metrics of ``voxel_pred`` against the
    batch's ``gt_occ`` (label 255 ignored).

    ``save_cb(out, meta_list, batch)`` runs per batch on the host (the
    submission writers, reference apis/test.py:161-167).  ``all_reduce``
    sums the counter state across processes before the metrics are derived
    (default: ``parallel/distributed.py:host_allreduce_sum``, the identity
    for one process), the analogue of the reference's
    ``dist.all_reduce(evaluation_semantic)`` (apis/test.py:209)."""
    if panoptic:
        raise NotImplementedError("panoptic evaluation comes with the panoptic slice")
    all_reduce = all_reduce or host_allreduce_sum
    step = build_eval_step(model, occ_size, num_classes, compute_dtype)
    cm = np.zeros((num_classes, num_classes), np.int64)
    ssc = SSCMetrics(num_classes) if compute_ssc else None
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
    state = {"confusion": cm}
    if ssc is not None:
        state.update(ssc.state())
    state = all_reduce(state)
    return metrics_from_state(state, num_classes, class_names=class_names)


def format_iou_table(results: Dict[str, float]) -> str:
    """PrettyTable-style text report (reference utils/formating.py:14-47)."""
    lines = ["| metric | value |", "|---|---|"]
    for k, v in results.items():
        lines.append(f"| {k} | {v:.4f} |")
    return "\n".join(lines)
