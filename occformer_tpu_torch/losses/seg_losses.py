"""Segmentation losses the Mask2Former loss imports.

Port of ``occformer_tpu/losses/seg_losses.py:dice_loss`` (reference
mask2former/losses/dice_loss.py:8-61, the naive-dice variant, eps 1.0 in the
configs) and the elementwise BCE-with-logits of
``losses/mask2former_loss.py:_bce_elem``.  Both run in float32 (the reference
wraps its losses in ``@force_fp32``).
"""
from __future__ import annotations

from typing import Optional

import torch


def bce_elem(logits: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise BCE with logits, float32."""
    x = logits.float()
    t = target.float()
    return x.clamp(min=0) - x * t + torch.log1p(torch.exp(-x.abs()))


def dice_loss(pred_logits: torch.Tensor, target: torch.Tensor,
              weight: Optional[torch.Tensor] = None,
              avg_factor: Optional[torch.Tensor] = None,
              eps: float = 1.0, activate: bool = True) -> torch.Tensor:
    """Naive dice loss over rows ``[N, P]`` with per-row weights ``[N]``."""
    pred = torch.sigmoid(pred_logits.float()) if activate else pred_logits.float()
    target = target.float()
    a = (pred * target).sum(-1)
    b = pred.sum(-1)
    c = target.sum(-1)
    loss = 1.0 - (2 * a + eps) / (b + c + eps)
    if weight is not None:
        loss = loss * weight.float()
    if avg_factor is None:
        return loss.mean()
    return loss.sum() / torch.clamp(torch.as_tensor(avg_factor, dtype=torch.float32),
                                    min=torch.finfo(torch.float32).eps)
