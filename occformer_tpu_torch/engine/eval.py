"""Evaluation step: the serving path of the flagship.

Port of ``occformer_tpu/engine/eval.py:build_eval_step`` and
``lidarseg_point_logits``, semantic branch: voxel class scores upsampled to
the occupancy grid (argmax), per-point predicted labels, and the lidarseg
confusion matrix (reference apis/test.py:22-105,
mask2former_nusc_occ.py:505-542).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.profiler import record_function

from ..models.mask2former_head import format_results, mask_logits_from_embeds
from ..ops.sampling import grid_sample_3d, resize_trilinear


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


def build_eval_step(model, occ_size: Tuple[int, int, int], num_classes: int) -> Callable:
    """Returns ``eval_step(batch) -> dict`` on the model's device.

    Outputs: ``voxel_pred`` [B, *occ_size] uint8, and with ``lidar_xyz`` in
    the batch ``point_pred`` [B, P] int32 (the empty class 0 is skipped); with
    ``lidar_label`` and ``lidar_valid`` also ``confusion`` [n, n] int64.
    """
    device = next(model.parameters()).device
    n = int(num_classes)

    @torch.inference_mode()
    def eval_step(batch: Dict) -> Dict[str, torch.Tensor]:
        # named ranges for torch.profiler; the model's forward names its own stages
        with record_function("stage:upload"):
            batch = to_device_batch(batch, device)
        out = model(batch)
        with record_function("stage:readout"):
            final_mask = mask_logits_from_embeds(out["mask_embeds"][-1], out["mask_feature"])
            voxels = format_results(out["cls_preds"][-1], final_mask)  # [B, X, Y, Z, C] f32
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
