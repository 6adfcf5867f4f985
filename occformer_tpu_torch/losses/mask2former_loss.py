"""Mask2Former occupancy training loss with deep supervision.

Port of ``occformer_tpu/losses/mask2former_loss.py`` (reference
mask2former/mask2former_occ.py:224-444 and mask2former_nusc_occ.py:196-455),
the branch the flagship trains with: LiDAR-point supervision
(``use_lidar_points``) with the feature-space point readout and the shared
candidate readout (``feature_readout=True``, ``shared_candidate_readout=True``,
``mxu_readout="off"``, JAX ``:723-906`` and ``:1032-1141``).  That is the path
the JAX package itself runs on every backend but the TPU; its TPU-only
batched volume readout (``_mxu_batched_loss``) exists for the TPU's matrix
unit.  Every point readout goes through ``ops.sampling.point_sample_3d``,
i.e. through K2 on the card.

* GT is one mask slot per class (``preprocess_gt``), a validity bit per slot.
* Matching is detached: per (layer, sample) the cost at the matching points,
  then scipy's ``linear_sum_assignment`` on the host for all layers at once.
* The loss's random draws come in as an argument (``make_loss_draws`` makes
  them from a ``torch.Generator``): torch cannot reproduce ``jax.random``, so
  the parity tests build the same arrays from the JAX key tree.
* The GT tables are layer-invariant and are built once per call (bool masks
  read as 0/1 by K2); the mask feature is made contiguous once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from ..ops.sampling import point_sample_3d
from .matching import hungarian_match, mask_matching_cost
from .point_sampling import gumbel_noise, gumbel_topk_sample, uncertainty_topk
from .seg_losses import bce_elem

# every point readout of the nuScenes loss: torch's default align_corners
# (reference mask2former_nusc_occ.py:244-250, :404-410) and border padding;
# KITTI's grid branch, which reads with align_corners=True, is not ported
ALIGN_CORNERS = False
PADDING = "border"


@dataclasses.dataclass(frozen=True)
class MaskLossConfig:
    num_classes: int
    num_points: int = 12544 * 4
    oversample_ratio: float = 3.0
    importance_sample_ratio: float = 0.75
    cls_loss_weight: float = 2.0
    mask_loss_weight: float = 5.0
    dice_loss_weight: float = 5.0
    cls_cost_weight: float = 2.0
    mask_cost_weight: float = 5.0
    dice_cost_weight: float = 5.0
    dice_eps: float = 1.0
    # class_weight[num_classes + 1]; background weight last
    class_weight: Tuple[float, ...] = ()
    # matching-point count (None = num_points, the reference semantics)
    match_num_points: Optional[int] = None

    @property
    def num_match_points(self) -> int:
        return self.match_num_points or self.num_points

    @property
    def num_candidates(self) -> int:
        return int(self.num_points * self.oversample_ratio)

    @property
    def num_uncertain(self) -> int:
        return int(self.importance_sample_ratio * self.num_points)


def preprocess_gt(gt_occ: torch.Tensor, num_classes: int):
    """[B, X, Y, Z] labels -> (masks [B, G, X, Y, Z] bool, labels [B, G] int64,
    valid [B, G] bool).  Slot g is the mask of class g, valid iff the class
    occurs (labels >= num_classes, e.g. 255, fall in no slot)."""
    B = gt_occ.shape[0]
    classes = torch.arange(num_classes, device=gt_occ.device)
    masks = gt_occ[:, None] == classes.view(1, -1, 1, 1, 1).to(gt_occ.dtype)
    valid = masks.flatten(2).any(-1)
    return masks, classes.expand(B, num_classes), valid


def make_loss_draws(generator: torch.Generator, cfg: MaskLossConfig,
                    lidar_valid: torch.Tensor, num_layers: int) -> Dict[str, torch.Tensor]:
    """Every random draw of one loss call, from ``generator`` (on its device),
    stacked over [layer, sample]:

    * ``match_perm`` [L, B, Pm // 2]: Gumbel top-k of ``lidar_valid`` (the
      matching LiDAR points), ``match_rand1`` [L, B, Pm // 2, 3] (their fill
      where invalid) and ``match_rand2`` [L, B, Pm - Pm // 2, 3] (uniform
      points), JAX ``_matching_points_nusc``;
    * ``cand_perm`` [L, B, n] with n = min(candidates, P), ``cand_rand``
      [L, B, n, 3], ``cand_extra`` [L, B, candidates - n, 3] and
      ``rand_fill`` [L, B, G, n_rand, 3], JAX ``_loss_single_sample``.
    """
    L = num_layers
    B, P = lidar_valid.shape
    G = cfg.num_classes
    n_match = cfg.num_match_points
    k1 = n_match // 2
    n_cand = min(cfg.num_candidates, P)
    n_rand = cfg.num_points - cfg.num_uncertain
    dev = generator.device
    valid = lidar_valid.to(dev).float().expand(L, B, P)

    def uniform(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    return {
        "match_perm": gumbel_topk_sample(valid, k1, gumbel_noise((L, B, P), generator)),
        "match_rand1": uniform(L, B, k1, 3),
        "match_rand2": uniform(L, B, n_match - k1, 3),
        "cand_perm": gumbel_topk_sample(valid, n_cand, gumbel_noise((L, B, P), generator)),
        "cand_rand": uniform(L, B, n_cand, 3),
        "cand_extra": uniform(L, B, cfg.num_candidates - n_cand, 3),
        "rand_fill": uniform(L, B, G, n_rand, 3),
    }


def _fill_invalid(xyz, valid, perm, fill):
    """LiDAR points ``perm`` of ``xyz [P, 3]``, with ``fill`` where invalid."""
    return torch.where(valid[perm][:, None], xyz[perm], fill)


def _match_points(d, l, b, lidar_xyz, lidar_valid):
    """JAX ``_matching_points_nusc``: half drawn LiDAR points, half uniform."""
    pts = _fill_invalid(lidar_xyz[b], lidar_valid[b], d["match_perm"][l, b],
                        d["match_rand1"][l, b])
    return torch.cat([pts, d["match_rand2"][l, b]], dim=0)


def _candidates(d, l, b, lidar_xyz, lidar_valid):
    """JAX ``_loss_single_sample`` :726-737: drawn LiDAR points (uniform fill
    where invalid) plus uniform extras up to the oversampled count."""
    cand = _fill_invalid(lidar_xyz[b], lidar_valid[b], d["cand_perm"][l, b],
                         d["cand_rand"][l, b])
    return torch.cat([cand, d["cand_extra"][l, b]], dim=0)


def _cls_terms(cls_score, assign, gt_labels, gt_valid, class_weight, num_classes):
    """Weighted softmax CE numerator / avg factor and the per-slot weights."""
    Q = cls_score.shape[0]
    safe_q = torch.where(assign >= 0, assign, torch.full_like(assign, Q))
    labels = torch.full((Q + 1,), num_classes, dtype=torch.long, device=cls_score.device)
    labels[safe_q] = torch.where(gt_valid, gt_labels, torch.full_like(gt_labels, num_classes))
    labels = labels[:Q]
    cw = class_weight[labels]
    logp = torch.log_softmax(cls_score.float(), dim=-1)
    cls_num = -(logp.gather(1, labels[:, None])[:, 0] * cw).sum()
    gt_w = torch.where(gt_valid & (assign >= 0), class_weight[gt_labels],
                       torch.zeros((), device=cls_score.device))
    return cls_num, cw.sum(), gt_w


def _loss_single_sample(cfg, cls_score, emb, feature, gt_table, gt_slots, gt_labels,
                        gt_valid, assign, cand, rand_fill, class_weight):
    """Partial sums of one (layer, sample).  feature [1, X, Y, Z, C];
    gt_table [1, Xg, Yg, Zg, G] and gt_slots [G, Xg, Yg, Zg, 1] bool."""
    Q = cls_score.shape[0]
    G = gt_labels.shape[0]
    cls_num, cls_avg, gt_w = _cls_terms(cls_score, assign, gt_labels, gt_valid,
                                        class_weight, cfg.num_classes)
    # candidate features: ONE shared [S, C] readout for the selection scores
    # and the supervised logits
    feat_cand = point_sample_3d(feature, cand[None], ALIGN_CORNERS, PADDING)[0]
    # targets for every slot at the shared candidates, slots as channels
    gt_cand = point_sample_3d(gt_table, cand[None], ALIGN_CORNERS, PADDING)[0]  # [S, G]

    src = emb[assign.clamp(0, Q - 1)].float()  # [G, C] the matched embeddings
    cand_logits = src @ feat_cand.float().T  # [G, S]
    idx = uncertainty_topk(cand_logits.detach(), cfg.num_uncertain)
    sup_pred = cand_logits.gather(1, idx)
    sup_tgt = gt_cand.T.gather(1, idx)
    n_rand = rand_fill.shape[1]
    if n_rand > 0:
        fp = point_sample_3d(feature, rand_fill.reshape(1, G * n_rand, 3),
                             ALIGN_CORNERS, PADDING)[0].reshape(G, n_rand, -1)
        pred_rand = torch.einsum("gc,gpc->gp", src, fp.float())
        tgt_rand = point_sample_3d(gt_slots, rand_fill, ALIGN_CORNERS, PADDING)[..., 0]
        sup_pred = torch.cat([sup_pred, pred_rand], dim=1)
        sup_tgt = torch.cat([sup_tgt, tgt_rand], dim=1)
    sup_tgt = sup_tgt.detach()

    # nusc mask loss: unweighted points, avg = sum(gt_w) * num_points
    mask_num = (bce_elem(sup_pred, sup_tgt) * (gt_w[:, None] > 0)).sum()
    pred_sig = torch.sigmoid(sup_pred)
    a = (pred_sig * sup_tgt).sum(-1)
    b = pred_sig.sum(-1) + sup_tgt.sum(-1)
    dice_rows = 1.0 - (2 * a + cfg.dice_eps) / (b + cfg.dice_eps)
    return dict(cls_num=cls_num, cls_avg=cls_avg,
                mask_num=mask_num, mask_avg=gt_w.sum() * cfg.num_points,
                dice_num=(dice_rows * gt_w).sum(), dice_avg=gt_w.sum())


def mask2former_loss(
    cls_preds: torch.Tensor,     # [L, B, Q, C+1]
    mask_embeds: torch.Tensor,   # [L, B, Q, Cout]
    mask_feature: torch.Tensor,  # [B, X, Y, Z, Cout]
    gt_occ: torch.Tensor,        # [B, X', Y', Z'] int labels
    cfg: MaskLossConfig,
    lidar_xyz: torch.Tensor,     # [B, P, 3] in [0, 1]
    lidar_valid: torch.Tensor,   # [B, P] bool
    draws: Dict[str, torch.Tensor],
) -> Dict[str, torch.Tensor]:
    """Deep-supervision loss over all decoder layers: ``d{i}.loss_*`` for the
    intermediate layers, ``loss_*`` for the last, and the metric
    ``unassigned_gt`` (valid GT slots left unassigned over all layers; always
    0 with scipy's assignment)."""
    L, B, Q = cls_preds.shape[:3]
    dev = cls_preds.device
    draws = {k: v.to(dev) for k, v in draws.items()}
    lidar_valid = lidar_valid.bool()
    gt_masks, gt_labels, gt_valid = preprocess_gt(gt_occ, cfg.num_classes)
    gt_table = gt_masks.permute(0, 2, 3, 4, 1).contiguous()  # [B, X, Y, Z, G]
    gt_slots = gt_masks.unsqueeze(-1)                         # [B, G, X, Y, Z, 1]
    feature = mask_feature.contiguous()
    class_weight = torch.tensor(cfg.class_weight, dtype=torch.float32, device=dev)

    # phase A: matching, detached (the reference's assigner runs on detached
    # predictions); one host transfer for every (layer, sample)
    with torch.no_grad():
        costs = []
        for l in range(L):
            for b in range(B):
                pts = _match_points(draws, l, b, lidar_xyz, lidar_valid)[None]
                feat_pts = point_sample_3d(feature[b:b + 1], pts, ALIGN_CORNERS, PADDING)[0]
                mask_pts = mask_embeds[l, b].float() @ feat_pts.float().T  # [Q, P]
                gt_pts = point_sample_3d(gt_table[b:b + 1], pts, ALIGN_CORNERS,
                                         PADDING)[0].T  # [G, P]
                costs.append(mask_matching_cost(
                    cls_preds[l, b], mask_pts, gt_labels[b], gt_pts, gt_valid[b],
                    cls_weight=cfg.cls_cost_weight, mask_weight=cfg.mask_cost_weight,
                    dice_weight=cfg.dice_cost_weight, dice_eps=cfg.dice_eps))
        cost = torch.stack(costs).reshape(L, B, Q, -1)
        assigns = hungarian_match(cost, gt_valid.expand(L, B, -1))  # [L, B, G]

    # phase B: the differentiated losses given the assignments
    eps = torch.finfo(torch.float32).eps
    losses: Dict[str, torch.Tensor] = {}
    for l in range(L):
        parts = [_loss_single_sample(
            cfg, cls_preds[l, b], mask_embeds[l, b], feature[b:b + 1],
            gt_table[b:b + 1], gt_slots[b], gt_labels[b], gt_valid[b], assigns[l, b],
            _candidates(draws, l, b, lidar_xyz, lidar_valid), draws["rand_fill"][l, b],
            class_weight) for b in range(B)]
        s = {k: sum(p[k] for p in parts) for k in parts[0]}
        prefix = "" if l == L - 1 else f"d{l}."
        losses[prefix + "loss_cls"] = cfg.cls_loss_weight * s["cls_num"] / s["cls_avg"].clamp(min=eps)
        losses[prefix + "loss_mask"] = cfg.mask_loss_weight * s["mask_num"] / s["mask_avg"].clamp(min=eps)
        losses[prefix + "loss_dice"] = cfg.dice_loss_weight * s["dice_num"] / s["dice_avg"].clamp(min=eps)
    losses["unassigned_gt"] = ((assigns < 0) & gt_valid[None]).sum().float()
    return losses
