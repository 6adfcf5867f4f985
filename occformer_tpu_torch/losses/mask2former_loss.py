"""Mask2Former occupancy training loss with deep supervision.

Port of ``occformer_tpu/losses/mask2former_loss.py`` (reference
mask2former/mask2former_occ.py:224-444 and mask2former_nusc_occ.py:196-455).
Two branches, as ``MaskLossConfig.use_lidar_points`` says:

**LiDAR points** (nuScenes, the flagship): the feature-space point readout
and the shared candidate readout (JAX ``feature_readout=True``,
``shared_candidate_readout=True``).  Two routes compute the same function;
``MaskLossConfig.mxu_readout`` picks one, with the JAX package's values:

* ``"off"`` and ``"auto"``: the per-layer route (JAX ``:723-906`` and
  ``:1032-1141``), a loop over (layer, sample) that reads the feature volume
  at the loss points and contracts with the embeddings.  ``"auto"`` takes it
  as JAX does off the TPU.
* ``"on"`` and ``"interpret"``: the all-layer batched route
  (``_batched_loss``, JAX ``_mxu_batched_loss`` :372-680), which the JAX
  package runs on its TPU: per-query and per-slot mask VOLUMES (``emb .
  feature``) read at row-sorted points, each readout one call over every
  (layer, sample), and the GT read from the label grid by the corner-label
  gather (K3, ``ops/loss_gather.py:sample_id_masks``).  By linearity
  ``point_sample(emb . feature, p) == emb . point_sample(feature, p)``, so
  the two routes agree to float32 rounding.

**The GT grid** (SemanticKITTI, ``_grid_loss``; JAX ``:252-262`` and
``:908-950``, per layer, as JAX runs it): the points are GT voxels drawn in
proportion to their class's sample weight (``sample_with_frequencies``),
and the predictions are the mask VOLUMES ``emb . feature`` read there
(align_corners=True, zeros padding) or, where the prediction grid is the GT
grid, gathered.  Matching reads the [X, Y, Z, Q] query volume at the
matching voxels (K2 at C = Q); supervision reads each matched slot's volume
at its frequency-drawn candidates (K2's narrow path at C = 1), keeps the
uncertainty top-k, adds voxels drawn uniformly from the labelled ones, and
reads the volumes there with gradient (K2-bwd's narrow path).  The targets
are gathered from the GT grid exactly; the BCE weights every point by its
slot's class weight.  Its draws (Gumbel noise over the GT grid's voxels,
[X*Y*Z] for the matching and [G, X*Y*Z] twice for the supervision, per
(layer, sample)) are taken layer by layer from the step's generator, all
the matching draws first: up front they would take about 3.4 GB at
SemanticKITTI's 256 x 256 x 32 grid.  A test passes them instead.

Every point readout goes through K2 (``ops/trilerp.py``) on the card.  On
the CPU both branches and both routes run the plain versions.

* GT is one mask slot per class (``preprocess_gt``), a validity bit per slot.
  The panoptic head's GT is one slot per panoptic segment instead
  (``preprocess_panoptic_gt``: voxel ids ``class * 1000 + instance``, the
  slots the batch's padded ``panoptic_ids`` table, which the loss takes and
  turns into the slots JAX passes as ``gt_override``).  Both routes read
  these slots as they read class slots: the per-layer route their masks as
  the GT table, the batched route the ids through K3 (slot s is the
  indicator of ``gt_occ == panoptic_ids[s]``, whose trilinear read is K3's
  ``sum_k w_k * (label_k == id)``).  JAX reads panoptic GT through one-hot
  mask volumes instead, because its label kernel keeps ids in a bf16 slab,
  exact only under 256 (JAX :1018); the port's K3 compares int32 ids, so
  ids of 1000 and above, and the padding id -1, read exactly.
* Matching is detached: per (layer, sample) the cost at the matching points,
  then scipy's ``linear_sum_assignment`` on the host for all layers at once.
* The LiDAR branch's random draws come in as an argument
  (``make_loss_draws`` makes them from a ``torch.Generator``): torch cannot
  reproduce ``jax.random``, so the parity tests build the same arrays from
  the JAX key tree.  Both routes take the same draws.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops.loss_gather import sample_id_masks, sort_points_by_row
from ..parallel.distributed import all_reduce_sum, global_rows, world_size
from ..ops.sampling import point_sample_3d
from .matching import hungarian_match, mask_matching_cost
from .point_sampling import (
    gumbel_noise,
    gumbel_topk_sample,
    sample_with_frequencies,
    uncertainty_topk,
)
from .seg_losses import bce_elem

# every point readout of the LiDAR branch: torch's default align_corners
# (reference mask2former_nusc_occ.py:244-250, :404-410) and border padding;
# the grid branch's: align_corners (reference mask2former_occ.py:264) and zeros
ALIGN_CORNERS = False
PADDING = "border"
GRID_ALIGN_CORNERS = True
GRID_PADDING = "zeros"

MXU_READOUT = ("auto", "on", "off", "interpret")


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
    # the loss route: "on" / "interpret" batched, "off" / "auto" per layer
    mxu_readout: str = "auto"
    # the branch: LiDAR points (nuScenes) or frequency-drawn GT voxels (KITTI)
    use_lidar_points: bool = True
    # the grid branch's per-class sampling weights, raised to the power
    # sample_weight_gamma
    sample_weights: Optional[Tuple[float, ...]] = None
    sample_weight_gamma: float = 0.25
    # the panoptic head: GT slots are panoptic segments (preprocess_panoptic_gt)
    # and the train step computes no point mIoU
    panoptic: bool = False

    def __post_init__(self):
        if self.mxu_readout not in MXU_READOUT:
            raise ValueError(f"mxu_readout must be one of {MXU_READOUT}; "
                             f"got {self.mxu_readout!r}")
        if not self.use_lidar_points and self.sample_weights is None:
            raise ValueError("the grid branch needs sample_weights")

    @property
    def num_match_points(self) -> int:
        return self.match_num_points or self.num_points

    @property
    def num_candidates(self) -> int:
        return int(self.num_points * self.oversample_ratio)

    @property
    def num_uncertain(self) -> int:
        return int(self.importance_sample_ratio * self.num_points)

    @property
    def batched_readout(self) -> bool:
        """Whether the loss takes the all-layer batched route (the LiDAR
        branch's; the grid branch runs per layer, as in JAX)."""
        return self.use_lidar_points and self.mxu_readout in ("on", "interpret")


def preprocess_gt(gt_occ: torch.Tensor, num_classes: int):
    """[B, X, Y, Z] labels -> (masks [B, G, X, Y, Z] bool, labels [B, G] int64,
    valid [B, G] bool).  Slot g is the mask of class g, valid iff the class
    occurs (labels >= num_classes, e.g. 255, fall in no slot)."""
    B = gt_occ.shape[0]
    classes = torch.arange(num_classes, device=gt_occ.device)
    masks = gt_occ[:, None] == classes.view(1, -1, 1, 1, 1).to(gt_occ.dtype)
    valid = masks.flatten(2).any(-1)
    return masks, classes.expand(B, num_classes), valid


def preprocess_panoptic_gt(gt_occ: torch.Tensor, panoptic_ids: torch.Tensor,
                           num_classes: int):
    """Panoptic GT slots (JAX ``preprocess_panoptic_gt``, reference
    base/mmdet_utils.py:383-424): ``gt_occ [B, X, Y, Z]`` voxel ids
    ``class * 1000 + instance`` (65535 noise), ``panoptic_ids [B, S]`` the
    batch's padded id table (-1 an empty slot) -> (masks [B, S, X, Y, Z]
    bool, labels [B, S] int64, valid [B, S] bool).  Slot s is ``gt_occ ==
    panoptic_ids[:, s]``, its label ``max(id // 1000, 0)``; it is valid iff
    its id is not negative, its label is a class and its mask is not
    empty.  Noise falls in no slot."""
    ids = panoptic_ids.to(gt_occ.dtype)
    masks = gt_occ[:, None] == ids[:, :, None, None, None]
    labels = torch.div(panoptic_ids.long(), 1000, rounding_mode="floor")
    valid = (panoptic_ids >= 0) & (labels < num_classes) & masks.flatten(2).any(-1)
    return masks, labels.clamp(min=0), valid


def make_loss_draws(generator: torch.Generator, cfg: MaskLossConfig,
                    lidar_valid: torch.Tensor, num_layers: int,
                    num_slots: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """Every random draw of one loss call, from ``generator`` (on its device),
    stacked over [layer, sample], for ``num_slots`` GT slots (G, by default
    ``cfg.num_classes``; the panoptic id table's width for the panoptic
    head):

    * ``match_perm`` [L, B, Pm // 2]: Gumbel top-k of ``lidar_valid`` (the
      matching LiDAR points), ``match_rand1`` [L, B, Pm // 2, 3] (their fill
      where invalid) and ``match_rand2`` [L, B, Pm - Pm // 2, 3] (uniform
      points), JAX ``_matching_points_nusc``;
    * ``cand_perm`` [L, B, n] with n = min(candidates, P), ``cand_rand``
      [L, B, n, 3], ``cand_extra`` [L, B, candidates - n, 3] and
      ``rand_fill`` [L, B, G, n_rand, 3], JAX ``_loss_single_sample``.

    Under data parallelism each rank draws the global batch's noise and
    keeps its rows (``parallel/distributed.py:global_rows``), so the ranks'
    draws are one process's on the global batch.
    """
    L = num_layers
    B, P = lidar_valid.shape
    rows = global_rows(B)
    Bg = B * world_size()
    G = num_slots or cfg.num_classes
    n_match = cfg.num_match_points
    k1 = n_match // 2
    n_cand = min(cfg.num_candidates, P)
    n_rand = cfg.num_points - cfg.num_uncertain
    dev = generator.device
    valid = lidar_valid.to(dev).float().expand(L, B, P)

    def uniform(*shape):
        return torch.rand((L, Bg) + shape, generator=generator, device=dev)[:, rows]

    def gumbel():
        return gumbel_noise((L, Bg, P), generator)[:, rows]

    return {
        "match_perm": gumbel_topk_sample(valid, k1, gumbel()),
        "match_rand1": uniform(k1, 3),
        "match_rand2": uniform(n_match - k1, 3),
        "cand_perm": gumbel_topk_sample(valid, n_cand, gumbel()),
        "cand_rand": uniform(n_cand, 3),
        "cand_extra": uniform(cfg.num_candidates - n_cand, 3),
        "rand_fill": uniform(G, n_rand, 3),
    }


def _loss_points(d, lidar_xyz, lidar_valid):
    """The matching points [L, B, Pm, 3] (JAX ``_matching_points_nusc``: half
    drawn LiDAR points, half uniform) and the candidates [L, B, S, 3] (JAX
    ``_loss_single_sample`` :726-737: drawn LiDAR points plus uniform extras
    up to the oversampled count) of every (layer, sample); a drawn point
    takes its uniform fill where it is invalid."""
    L = d["match_perm"].shape[0]
    xyz = lidar_xyz[None].expand(L, -1, -1, -1)
    valid = lidar_valid[None].expand(L, -1, -1)

    def drawn(perm, fill):
        pts = torch.gather(xyz, 2, perm[..., None].expand(*perm.shape, 3))
        return torch.where(torch.gather(valid, 2, perm)[..., None], pts, fill)

    match = torch.cat([drawn(d["match_perm"], d["match_rand1"]), d["match_rand2"]], dim=2)
    cand = torch.cat([drawn(d["cand_perm"], d["cand_rand"]), d["cand_extra"]], dim=2)
    return match, cand


def _cls_terms(cls_score, assign, gt_labels, gt_valid, class_weight, num_classes):
    """Weighted softmax CE numerator and avg factor, and the per-slot weights
    (0 for invalid or unassigned slots).  cls_score [..., Q, C+1], assign,
    gt_labels and gt_valid [..., G] -> [...], [...], [..., G]."""
    Q = cls_score.shape[-2]
    safe_q = torch.where(assign >= 0, assign, torch.full_like(assign, Q))
    labels = torch.full((*assign.shape[:-1], Q + 1), num_classes, dtype=torch.long,
                        device=cls_score.device)
    labels.scatter_(-1, safe_q, torch.where(gt_valid, gt_labels,
                                            torch.full_like(gt_labels, num_classes)))
    labels = labels[..., :Q]
    cw = class_weight[labels]
    logp = torch.log_softmax(cls_score.float(), dim=-1)
    cls_num = -(logp.gather(-1, labels[..., None])[..., 0] * cw).sum(-1)
    gt_w = torch.where(gt_valid & (assign >= 0), class_weight[gt_labels],
                       torch.zeros((), device=cls_score.device))
    return cls_num, cw.sum(-1), gt_w


def _layer_losses(cfg, s, assigns, gt_valid):
    """The loss dict from per-layer partial sums ``s`` ([L] each).

    Under data parallelism the normalisers (no gradient flows through them)
    are summed over ranks and each rank's loss is ``world`` times its share
    of the global loss, so that ``DistributedDataParallel``'s mean of the
    ranks' gradients is the global loss's gradient; the train step averages
    the ranks' loss values back into the global one."""
    eps = torch.finfo(torch.float32).eps
    world = world_size()
    avg = all_reduce_sum(torch.stack([s["cls_avg"], s["mask_avg"], s["dice_avg"]]))
    lc = world * cfg.cls_loss_weight * s["cls_num"] / avg[0].clamp(min=eps)
    lm = world * cfg.mask_loss_weight * s["mask_num"] / avg[1].clamp(min=eps)
    ld = world * cfg.dice_loss_weight * s["dice_num"] / avg[2].clamp(min=eps)
    L = lc.shape[0]
    losses: Dict[str, torch.Tensor] = {}
    for l in range(L):
        prefix = "" if l == L - 1 else f"d{l}."
        losses[prefix + "loss_cls"] = lc[l]
        losses[prefix + "loss_mask"] = lm[l]
        losses[prefix + "loss_dice"] = ld[l]
    losses["unassigned_gt"] = ((assigns < 0) & gt_valid[None]).sum().float()
    return losses


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


def _per_layer_assign(cfg, cls_preds, mask_embeds, feature, gt_table, gt_labels,
                      gt_valid, match_pts):
    """The per-layer route's matching, detached (the reference's assigner
    runs on detached predictions); one host transfer for every (layer,
    sample).  -> [L, B, G]"""
    L, B, Q = cls_preds.shape[:3]
    with torch.no_grad():
        costs = []
        for l in range(L):
            for b in range(B):
                pts = match_pts[l, b][None]
                feat_pts = point_sample_3d(feature[b:b + 1], pts, ALIGN_CORNERS, PADDING)[0]
                mask_pts = mask_embeds[l, b].float() @ feat_pts.float().T  # [Q, P]
                gt_pts = point_sample_3d(gt_table[b:b + 1], pts, ALIGN_CORNERS,
                                         PADDING)[0].T  # [G, P]
                costs.append(mask_matching_cost(
                    cls_preds[l, b], mask_pts, gt_labels[b], gt_pts, gt_valid[b],
                    cls_weight=cfg.cls_cost_weight, mask_weight=cfg.mask_cost_weight,
                    dice_weight=cfg.dice_cost_weight, dice_eps=cfg.dice_eps))
        cost = torch.stack(costs).reshape(L, B, Q, -1)
        return hungarian_match(cost, gt_valid.expand(L, B, -1))


def _per_layer_loss(cfg, cls_preds, mask_embeds, feature, gt_table, gt_masks, gt_labels,
                    gt_valid, assigns, cand_pts, rand_fill, class_weight):
    """The per-layer route's differentiated losses given the assignments: a
    loop over (layer, sample)."""
    L, B = cls_preds.shape[:2]
    gt_slots = gt_masks.unsqueeze(-1)                         # [B, G, X, Y, Z, 1]
    sums = []
    for l in range(L):
        parts = [_loss_single_sample(
            cfg, cls_preds[l, b], mask_embeds[l, b], feature[b:b + 1],
            gt_table[b:b + 1], gt_slots[b], gt_labels[b], gt_valid[b], assigns[l, b],
            cand_pts[l, b], rand_fill[l, b], class_weight) for b in range(B)]
        sums.append({k: sum(p[k] for p in parts) for k in parts[0]})
    s = {k: torch.stack([x[k] for x in sums]) for k in sums[0]}
    return _layer_losses(cfg, s, assigns, gt_valid)


@contextlib.contextmanager
def _full_float32(device_type: str):
    """float32 matmuls in full float32 within the block: no autocast, and no
    TF32 on the card even where the caller allows it (JAX's
    ``Precision.HIGHEST``; a reduced-precision volume puts about 1e-3
    relative noise into every sampled logit, JAX :549-550).  The backward's
    matmuls run later and follow the caller's setting, full float32 by
    PyTorch's default."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        with torch.autocast(device_type, enabled=False):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _slot_volumes(emb, feature, dtype):
    """Channels-last mask volumes ``emb . feature`` of every (layer, sample):
    emb [L, B, K, C], feature [B, X, Y, Z, C] -> [L * B, X, Y, Z, K] in
    ``dtype`` (K2's table layout: one readout covers every slot)."""
    L, B, K, C = emb.shape
    X, Y, Z = feature.shape[1:4]
    vol = torch.einsum("bvc,lbkc->lbvk", feature.to(dtype).reshape(B, X * Y * Z, C),
                       emb.to(dtype))
    return vol.reshape(L * B, X, Y, Z, K).contiguous()


def _gt_reader(gt_occ, gt_masks, slot_ids, L):
    """``read_gt(points)``: [L, B, S, 3] shared or [L, B, G, P, 3] per-slot
    points -> [L, B, G, S] or [L, B, G, P] soft GT masks, detached.  Where
    each slot is one id of ``gt_occ`` (``slot_ids [B, G]``: the class ids
    while ``num_classes < 256``, JAX's gate :1018, or the panoptic ids) the
    label gather (K3) reads the id grid; else trilinear reads (K2) of the
    one-hot masks, one per layer or (layer, sample)."""
    B = gt_occ.shape[0]
    if slot_ids is not None:
        id_grid = gt_occ.to(torch.int32).contiguous()
        slot_ids = slot_ids.to(torch.int32).contiguous()

        def read_gt(points):
            out = sample_id_masks(id_grid, slot_ids, points.reshape(L * B, *points.shape[2:]),
                                  ALIGN_CORNERS, PADDING)
            return out.reshape(L, B, *out.shape[1:])
        return read_gt

    table = gt_masks.permute(0, 2, 3, 4, 1).contiguous()  # [B, Xg, Yg, Zg, G]

    def read_gt(points):
        if points.dim() == 4:
            return torch.stack([point_sample_3d(table, points[l], ALIGN_CORNERS, PADDING)
                                for l in range(L)]).transpose(2, 3)
        return torch.stack([torch.stack([
            point_sample_3d(gt_masks[b, ..., None], points[l, b], ALIGN_CORNERS,
                            PADDING)[..., 0] for b in range(B)]) for l in range(L)])
    return read_gt


def _batched_assign(cfg, cls_preds, mask_embeds, feature, read_gt, gt_labels, gt_valid,
                    match_pts):
    """The batched route's matching, detached: per-query mask volumes read
    at the row-sorted matching points of every (layer, sample) in one K2
    launch, the GT in one K3 launch.  -> [L, B, G]"""
    L, B, Q = cls_preds.shape[:3]
    G = gt_labels.shape[1]
    with torch.no_grad():
        pts = sort_points_by_row(match_pts, tuple(feature.shape[1:4]))  # [L, B, Pm, 3]
        Pm = pts.shape[2]
        # match volumes in the feature's dtype (bf16 under autocast on the
        # card, as the reference computes the cost under fp16 AMP)
        q_vol = _slot_volumes(mask_embeds.detach(), feature.detach(), feature.dtype)
        mask_pts = point_sample_3d(
            q_vol, pts.reshape(L * B, Pm, 3), ALIGN_CORNERS, PADDING)  # [NB, Pm, Q]
        del q_vol
        mask_pts = mask_pts.float().transpose(1, 2).reshape(L, B, Q, Pm)
        cost = mask_matching_cost(
            cls_preds.detach(), mask_pts, gt_labels.expand(L, B, G), read_gt(pts),
            gt_valid.expand(L, B, G), cls_weight=cfg.cls_cost_weight,
            mask_weight=cfg.mask_cost_weight, dice_weight=cfg.dice_cost_weight,
            dice_eps=cfg.dice_eps)
        return hungarian_match(cost, gt_valid.expand(L, B, G))


def uncertainty_select(cand_logits: torch.Tensor, n_unc: int) -> torch.Tensor:
    """The batched route's uncertainty selection as a 0/1 float weight over
    the candidates (last axis): the set of top-k of -|logit| (all above the
    k-th value, then ties in index order up to k, top-k's tie rule), JAX
    :587-594.  Detached."""
    score = -cand_logits.detach().abs()
    kth = torch.topk(score, n_unc, dim=-1).values[..., -1:]
    above = score > kth
    ties = score == kth
    tie_rank = ties.int().cumsum(-1)
    return (above | (ties & (tie_rank <= n_unc - above.sum(-1, keepdim=True)))).float()


def _batched_loss(cfg, cls_preds, mask_embeds, feature, read_gt, gt_labels, gt_valid,
                  assigns, cand_pts, rand_fill, class_weight):
    """The batched route's differentiated losses given the assignments (JAX
    ``_mxu_batched_loss`` :506-680): per-slot volumes read at the row-sorted
    candidates and random-fill points of every (layer, sample) in one K2
    launch each (K2-bwd in the backward), the GT in one K3 launch each."""
    L, B, Q = cls_preds.shape[:3]
    G = gt_labels.shape[1]
    X, Y, Z, C = feature.shape[1:]
    spatial = (X, Y, Z)
    NB = L * B
    n_unc = cfg.num_uncertain
    n_rand = rand_fill.shape[3]
    cand_s = sort_points_by_row(cand_pts, spatial)               # [L, B, S, 3]
    S = cand_s.shape[2]
    emb_g = torch.gather(mask_embeds, 2,
                         assigns.clamp(0, Q - 1)[..., None].expand(L, B, G, C))
    with _full_float32(feature.device.type):
        vol = _slot_volumes(emb_g, feature, torch.float32)       # [NB, X, Y, Z, G]
    cand_logits = point_sample_3d(
        vol, cand_s.reshape(NB, S, 3), ALIGN_CORNERS, PADDING)   # [NB, S, G]
    cand_logits = cand_logits.transpose(1, 2).reshape(L, B, G, S)
    gt_cand = read_gt(cand_s)                                    # [L, B, G, S]
    sel = uncertainty_select(cand_logits, n_unc)

    bce = (bce_elem(cand_logits, gt_cand) * sel).sum(-1)         # [L, B, G]
    sig = torch.sigmoid(cand_logits)
    da = (sig * gt_cand * sel).sum(-1)
    db = ((sig + gt_cand) * sel).sum(-1)
    if n_rand > 0:
        # the random fill reads slot g's volume only: slot-major volumes
        # [NB * G, X, Y, Z, 1], one copy of the channels-last ones
        rand_s = sort_points_by_row(rand_fill, spatial)          # [L, B, G, n_rand, 3]
        vol_slots = vol.permute(0, 4, 1, 2, 3).reshape(NB * G, X, Y, Z, 1)
        pred_rand = point_sample_3d(vol_slots, rand_s.reshape(NB * G, n_rand, 3),
                                    ALIGN_CORNERS, PADDING).reshape(L, B, G, n_rand)
        tgt_rand = read_gt(rand_s)                               # [L, B, G, n_rand]
        bce = bce + bce_elem(pred_rand, tgt_rand).sum(-1)
        sig_r = torch.sigmoid(pred_rand)
        da = da + (sig_r * tgt_rand).sum(-1)
        db = db + sig_r.sum(-1) + tgt_rand.sum(-1)

    cls_num, cls_avg, gt_w = _cls_terms(cls_preds, assigns, gt_labels.expand(L, B, G),
                                        gt_valid.expand(L, B, G), class_weight,
                                        cfg.num_classes)
    dice_rows = 1.0 - (2 * da + cfg.dice_eps) / (db + cfg.dice_eps)
    s = dict(cls_num=cls_num.sum(1), cls_avg=cls_avg.sum(1),
             mask_num=(bce * (gt_w > 0)).sum((1, 2)),
             mask_avg=gt_w.sum((1, 2)) * cfg.num_points,
             dice_num=(dice_rows * gt_w).sum((1, 2)), dice_avg=gt_w.sum((1, 2)))
    return _layer_losses(cfg, s, assigns, gt_valid)


# ---------------------------------------------------------------------------
# the grid branch (SemanticKITTI)
# ---------------------------------------------------------------------------

def resolve_sample_weights(cfg: MaskLossConfig, device) -> torch.Tensor:
    """The per-class sampling weights ``sample_weights ** gamma`` (JAX
    ``_resolve_sample_weights``; reference mask2former_occ.py:160-166)."""
    base = torch.tensor(cfg.sample_weights, dtype=torch.float32, device=device)
    return base ** float(cfg.sample_weight_gamma)


def _grid_drawer(draws: Optional[Dict[str, torch.Tensor]],
                 generator: Optional[torch.Generator], B: int, device) -> Callable:
    """``draw(name, layer, shape) -> [B, *shape]`` Gumbel noise of one layer:
    from ``draws[name][layer]`` where given (a test's), else from
    ``generator`` in call order, the global batch's rows drawn and this
    rank's kept under data parallelism."""
    if draws is not None:
        return lambda name, l, shape: draws[name][l].to(device)
    if generator is None:
        raise ValueError("the grid branch draws from a generator or takes draws")
    rows = global_rows(B)

    def draw(name, l, shape):
        return gumbel_noise((B * world_size(),) + tuple(shape), generator)[rows].to(device)
    return draw


def _read_grid(vol: torch.Tensor, idx: torch.Tensor, pts: torch.Tensor, gt_shape):
    """Values of channels-last volumes ``vol [K, X, Y, Z, C]`` at GT voxels
    (flat ``idx [K, P]``, [0, 1] ``pts [K, P, 3]``): gathered where the grids
    are one, else read trilinearly at the points (reference
    mmdet_utils.py:214-217).  -> [K, P, C]."""
    K, X, Y, Z, C = vol.shape
    if (X, Y, Z) == tuple(gt_shape):
        return torch.gather(vol.reshape(K, X * Y * Z, C), 1,
                            idx[..., None].expand(*idx.shape, C))
    return point_sample_3d(vol, pts, GRID_ALIGN_CORNERS, GRID_PADDING)


def _grid_assign(cfg, cls_preds, mask_embeds, feature, gt_occ, gt_labels, gt_valid, sw,
                 draw):
    """The grid branch's matching, detached: per (layer, sample) the query
    volume read at ``num_match_points`` frequency-drawn GT voxels, the GT
    there exactly.  -> [L, B, G]"""
    L, B, Q = cls_preds.shape[:3]
    gt_shape = tuple(gt_occ.shape[1:])
    N = gt_occ[0].numel()
    flat_gt = gt_occ.reshape(B, N).long()
    with torch.no_grad():
        costs = []
        for l in range(L):
            idx, pts = sample_with_frequencies(gt_occ, sw, cfg.num_match_points,
                                               draw("match", l, (N,)))  # [B, Pm]
            for b in range(B):
                with _full_float32(feature.device.type):
                    vol = _slot_volumes(mask_embeds[l:l + 1, b:b + 1].detach(),
                                        feature[b:b + 1].detach(), torch.float32)
                mask_pts = _read_grid(vol, idx[b:b + 1], pts[b:b + 1], gt_shape)[0].T
                del vol
                gt_pts = (flat_gt[b, idx[b]][None] == gt_labels[b][:, None]).float()
                costs.append(mask_matching_cost(
                    cls_preds[l, b], mask_pts, gt_labels[b], gt_pts, gt_valid[b],
                    cls_weight=cfg.cls_cost_weight, mask_weight=cfg.mask_cost_weight,
                    dice_weight=cfg.dice_cost_weight, dice_eps=cfg.dice_eps))
        cost = torch.stack(costs).reshape(L, B, Q, -1)
        return hungarian_match(cost, gt_valid.expand(L, B, -1))


def _grid_loss(cfg, cls_preds, mask_embeds, feature, gt_occ, gt_labels, gt_valid, assigns,
               sw, class_weight, draw):
    """The grid branch's differentiated losses given the assignments, layer
    by layer (JAX ``_loss_single_sample`` :908-950): per matched slot its
    mask volume, ``num_candidates`` voxels drawn by frequency and read
    without gradient, their uncertainty top-k (``uncertainty_select``'s tie
    rule), ``num_points - num_uncertain`` voxels drawn uniformly from the
    labelled ones, the supervision points read with gradient; the targets
    gathered exactly.  Mask loss: the BCE weighted per point by the slot's
    class weight, over ``sum(gt_w) * num_points``."""
    L, B, Q = cls_preds.shape[:3]
    G = gt_labels.shape[1]
    C = feature.shape[-1]
    gt_shape = tuple(gt_occ.shape[1:])
    N = gt_occ[0].numel()
    flat_gt = gt_occ.reshape(B, N).long()
    X, Y, Z = feature.shape[1:4]
    feat = feature.float().reshape(B, X * Y * Z, C)  # one float32 copy for every layer
    uniform = torch.ones_like(sw)  # the fill: every labelled voxel alike
    n_unc = cfg.num_uncertain
    n_rand = cfg.num_points - n_unc
    sums = []
    for l in range(L):
        cand_g = draw("cand", l, (G, N))                                 # [B, G, N]
        fill_g = draw("fill", l, (G, N)) if n_rand > 0 else None
        parts = []
        for b in range(B):
            assign = assigns[l, b]
            cls_num, cls_avg, gt_w = _cls_terms(cls_preds[l, b], assign, gt_labels[b],
                                                gt_valid[b], class_weight, cfg.num_classes)
            emb = mask_embeds[l, b][assign.clamp(0, Q - 1)].float()      # [G, C]
            with _full_float32(feature.device.type):
                vol = (emb @ feat[b].T).reshape(G, X, Y, Z, 1)            # slot-major volumes
            cand, cand_pts = sample_with_frequencies(gt_occ[b], sw, cfg.num_candidates,
                                                     cand_g[b])           # [G, S]
            with torch.no_grad():
                cand_logits = _read_grid(vol, cand, cand_pts, gt_shape)[..., 0]
            sel = uncertainty_select(cand_logits, n_unc)
            top = torch.sort(sel, dim=-1, descending=True, stable=True).indices[:, :n_unc]
            sup = cand.gather(1, top)
            sup_pts = cand_pts.gather(1, top[..., None].expand(-1, -1, 3))
            if n_rand > 0:
                fill, fill_pts = sample_with_frequencies(gt_occ[b], uniform, n_rand, fill_g[b])
                sup, sup_pts = torch.cat([sup, fill], 1), torch.cat([sup_pts, fill_pts], 1)
            sup_pred = _read_grid(vol, sup, sup_pts, gt_shape)[..., 0]
            sup_tgt = (flat_gt[b][sup] == gt_labels[b][:, None]).float()
            pred_sig = torch.sigmoid(sup_pred)
            a = (pred_sig * sup_tgt).sum(-1)
            den = pred_sig.sum(-1) + sup_tgt.sum(-1)
            dice_rows = 1.0 - (2 * a + cfg.dice_eps) / (den + cfg.dice_eps)
            parts.append(dict(cls_num=cls_num, cls_avg=cls_avg,
                              mask_num=(bce_elem(sup_pred, sup_tgt) * gt_w[:, None]).sum(),
                              mask_avg=gt_w.sum() * cfg.num_points,
                              dice_num=(dice_rows * gt_w).sum(), dice_avg=gt_w.sum()))
        sums.append({k: sum(p[k] for p in parts) for k in parts[0]})
    s = {k: torch.stack([x[k] for x in sums]) for k in sums[0]}
    return _layer_losses(cfg, s, assigns, gt_valid)


def _grid_prepare(cls_preds, gt_occ, cfg, draws, generator):
    _, gt_labels, gt_valid = preprocess_gt(gt_occ, cfg.num_classes)
    dev = cls_preds.device
    return (gt_labels, gt_valid, resolve_sample_weights(cfg, dev),
            _grid_drawer(draws, generator, gt_occ.shape[0], dev))


def _prepare(cls_preds, mask_feature, gt_occ, cfg, lidar_xyz, lidar_valid, draws,
             panoptic_ids):
    """What both routes and both phases read: the GT slots (one per panoptic
    id, else one per class) and the ids that name them in ``gt_occ`` (None:
    read them as one-hot masks), the feature, the draws on the loss's device
    and the loss points."""
    dev = cls_preds.device
    draws = {k: v.to(dev) for k, v in draws.items()}
    if panoptic_ids is not None:
        gt_masks, gt_labels, gt_valid = preprocess_panoptic_gt(gt_occ, panoptic_ids,
                                                               cfg.num_classes)
        # an invalid slot's label may lie past the classes (a panoptic id's);
        # every table the labels index ends at the background class
        gt_labels = gt_labels.clamp(max=cfg.num_classes)
        slot_ids = panoptic_ids
    else:
        gt_masks, gt_labels, gt_valid = preprocess_gt(gt_occ, cfg.num_classes)
        slot_ids = gt_labels if cfg.num_classes < 256 else None
    match_pts, cand_pts = _loss_points(draws, lidar_xyz, lidar_valid.bool())
    return dict(gt_masks=gt_masks, gt_labels=gt_labels, gt_valid=gt_valid,
                slot_ids=slot_ids, feature=mask_feature.contiguous(), match_pts=match_pts,
                cand_pts=cand_pts, rand_fill=draws["rand_fill"])


def _assign(cfg, p, cls_preds, mask_embeds, gt_occ):
    """(assignments [L, B, G], the route's GT reader or table)."""
    if cfg.batched_readout:
        read_gt = _gt_reader(gt_occ, p["gt_masks"], p["slot_ids"], cls_preds.shape[0])
        return _batched_assign(cfg, cls_preds, mask_embeds, p["feature"], read_gt,
                               p["gt_labels"], p["gt_valid"], p["match_pts"]), read_gt
    gt_table = p["gt_masks"].permute(0, 2, 3, 4, 1).contiguous()  # [B, X, Y, Z, G]
    return _per_layer_assign(cfg, cls_preds, mask_embeds, p["feature"], gt_table,
                             p["gt_labels"], p["gt_valid"], p["match_pts"]), gt_table


def _check_panoptic(cfg, panoptic_ids):
    if panoptic_ids is not None and not cfg.use_lidar_points:
        raise ValueError("the panoptic slots need the LiDAR branch")


def match_assignments(cls_preds, mask_embeds, mask_feature, gt_occ, cfg: MaskLossConfig,
                      lidar_xyz=None, lidar_valid=None, draws=None,
                      generator: Optional[torch.Generator] = None,
                      panoptic_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The Hungarian assignment [L, B, G] (query per GT slot, -1 for invalid
    slots) that ``mask2former_loss`` computes on ``cfg``'s branch and route
    from the same arguments."""
    _check_panoptic(cfg, panoptic_ids)
    if not cfg.use_lidar_points:
        gt_labels, gt_valid, sw, draw = _grid_prepare(cls_preds, gt_occ, cfg, draws,
                                                      generator)
        return _grid_assign(cfg, cls_preds, mask_embeds, mask_feature.contiguous(), gt_occ,
                            gt_labels, gt_valid, sw, draw)
    p = _prepare(cls_preds, mask_feature, gt_occ, cfg, lidar_xyz, lidar_valid, draws,
                 panoptic_ids)
    return _assign(cfg, p, cls_preds, mask_embeds, gt_occ)[0]


def mask2former_loss(
    cls_preds: torch.Tensor,     # [L, B, Q, C+1]
    mask_embeds: torch.Tensor,   # [L, B, Q, Cout]
    mask_feature: torch.Tensor,  # [B, X, Y, Z, Cout]
    gt_occ: torch.Tensor,        # [B, X', Y', Z'] int labels
    cfg: MaskLossConfig,
    lidar_xyz: Optional[torch.Tensor] = None,    # [B, P, 3] in [0, 1]
    lidar_valid: Optional[torch.Tensor] = None,  # [B, P] bool
    draws: Optional[Dict[str, torch.Tensor]] = None,
    generator: Optional[torch.Generator] = None,
    panoptic_ids: Optional[torch.Tensor] = None,  # [B, S] the panoptic head's
) -> Dict[str, torch.Tensor]:
    """Deep-supervision loss over all decoder layers: ``d{i}.loss_*`` for the
    intermediate layers, ``loss_*`` for the last, and the metric
    ``unassigned_gt`` (valid GT slots left unassigned over all layers; always
    0 with scipy's assignment).  The LiDAR branch takes its ``draws``
    (``make_loss_draws``) and ``cfg.mxu_readout`` picks its route; the grid
    branch draws from ``generator`` unless ``draws`` holds its Gumbel noise
    (``"match"`` [L, B, N], ``"cand"`` and ``"fill"`` [L, B, G, N] over the
    N voxels of the GT grid).

    ``panoptic_ids`` (the panoptic head's padded id table [B, S]; the LiDAR
    branch) replaces the class slots with ``preprocess_panoptic_gt``'s, the
    GT JAX passes as ``gt_override``; the batched route reads them through
    K3 at these ids."""
    class_weight = torch.tensor(cfg.class_weight, dtype=torch.float32,
                                device=cls_preds.device)
    _check_panoptic(cfg, panoptic_ids)
    if not cfg.use_lidar_points:
        feature = mask_feature.contiguous()
        gt_labels, gt_valid, sw, draw = _grid_prepare(cls_preds, gt_occ, cfg, draws,
                                                      generator)
        assigns = _grid_assign(cfg, cls_preds, mask_embeds, feature, gt_occ, gt_labels,
                               gt_valid, sw, draw)
        return _grid_loss(cfg, cls_preds, mask_embeds, feature, gt_occ, gt_labels, gt_valid,
                          assigns, sw, class_weight, draw)
    p = _prepare(cls_preds, mask_feature, gt_occ, cfg, lidar_xyz, lidar_valid, draws,
                 panoptic_ids)
    assigns, gt = _assign(cfg, p, cls_preds, mask_embeds, gt_occ)
    if cfg.batched_readout:
        return _batched_loss(cfg, cls_preds, mask_embeds, p["feature"], gt, p["gt_labels"],
                             p["gt_valid"], assigns, p["cand_pts"], p["rand_fill"],
                             class_weight)
    return _per_layer_loss(cfg, cls_preds, mask_embeds, p["feature"], gt, p["gt_masks"],
                           p["gt_labels"], p["gt_valid"], assigns, p["cand_pts"],
                           p["rand_fill"], class_weight)
