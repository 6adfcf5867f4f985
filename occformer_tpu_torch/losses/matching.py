"""Hungarian mask matching.

Port of ``occformer_tpu/losses/matching.py`` (reference assigners/
mask_hungarian_assigner.py:12-126, match_costs/match_cost.py:10-130): the
[Q, G] cost (classification + point BCE + point dice) is computed on the
device in float32, and the assignment runs on the host with
``scipy.optimize.linear_sum_assignment``, as the reference and the JAX
package's ``_lsa_host`` do.  (The JAX package's device auction exists only
because its TPU backend rejected host callbacks.)  Invalid GT slots get -1.
"""
from __future__ import annotations

import numpy as np
import torch

BIG_COST = 1e8


def mask_matching_cost(cls_score: torch.Tensor, mask_points_pred: torch.Tensor,
                       gt_labels: torch.Tensor, gt_points: torch.Tensor,
                       gt_valid: torch.Tensor, cls_weight: float = 2.0,
                       mask_weight: float = 5.0, dice_weight: float = 5.0,
                       dice_eps: float = 1.0) -> torch.Tensor:
    """cls_score [..., Q, C+1] logits, mask_points_pred [..., Q, P] logits,
    gt_labels [..., G], gt_points [..., G, P] (soft 0..1), gt_valid [..., G]
    -> [..., Q, G] float32 cost; invalid GT columns get BIG_COST.  Leading
    dimensions, if any, are batch dimensions shared by all five."""
    cls_score = cls_score.float()
    x = mask_points_pred.float()
    gt = gt_points.float()
    gt_t = gt.transpose(-1, -2)
    P = x.shape[-1]
    # ClassificationCost: minus the softmax probability of the GT class
    labels = gt_labels.long().unsqueeze(-2).expand(*cls_score.shape[:-1], -1)
    cls_cost = -torch.softmax(cls_score, dim=-1).gather(-1, labels)
    # CrossEntropyLossCost (use_sigmoid): point-mean BCE against 1 and 0
    soft = torch.log1p(torch.exp(-x.abs()))
    pos = x.clamp(min=0) - x + soft
    neg = x.clamp(min=0) + soft
    mask_cost = (pos @ gt_t + neg @ (1.0 - gt_t)) / P
    # DiceCost, pred_act=True, naive denominator
    pred = torch.sigmoid(x)
    num = 2.0 * (pred @ gt_t)
    den = pred.sum(-1).unsqueeze(-1) + gt.sum(-1).unsqueeze(-2)
    dice_cost = 1.0 - (num + dice_eps) / (den + dice_eps)
    cost = cls_weight * cls_cost + mask_weight * mask_cost + dice_weight * dice_cost
    return torch.where(gt_valid.unsqueeze(-2).bool(), cost, torch.full_like(cost, BIG_COST))


def linear_sum_assignment_valid(cost: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """[..., Q, G] cost and [..., G] valid (numpy) -> [..., G] int64 assigned
    query per GT slot, -1 for invalid slots.  Only valid columns take part
    (the JAX package's ``_lsa_host``)."""
    from scipy.optimize import linear_sum_assignment

    cost = np.asarray(cost, np.float64)
    valid = np.asarray(valid, bool)
    G = cost.shape[-1]
    out = np.full(cost.shape[:-2] + (G,), -1, np.int64)
    flat_cost = cost.reshape(-1, cost.shape[-2], G)
    flat_valid = valid.reshape(-1, G)
    flat_out = out.reshape(-1, G)
    for i in range(flat_cost.shape[0]):
        cols = np.nonzero(flat_valid[i])[0]
        if cols.size == 0:
            continue
        sub = np.nan_to_num(flat_cost[i][:, cols], nan=BIG_COST, posinf=BIG_COST,
                            neginf=-BIG_COST)
        rows, cols_idx = linear_sum_assignment(sub)
        flat_out[i, cols[cols_idx]] = rows
    return out


def hungarian_match(cost: torch.Tensor, gt_valid: torch.Tensor) -> torch.Tensor:
    """[..., Q, G] cost + [..., G] valid -> [..., G] int64 assigned query
    (-1 invalid) on the cost's device.  The cost is detached and solved on
    the host in one transfer (the reference's ``cost.detach().cpu()``)."""
    cost_np = cost.detach().float().cpu().numpy()
    valid_np = gt_valid.detach().cpu().numpy()
    out = linear_sum_assignment_valid(cost_np, valid_np)
    return torch.from_numpy(out).to(cost.device)

