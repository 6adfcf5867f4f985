"""Training step of the nuScenes configurations (semantic and panoptic) and
of the SemanticKITTI one.

Port of ``occformer_tpu/engine/train.py`` (``build_loss_cfg``,
``build_train_step`` with gradient accumulation, the train-time point mIoU).
One step: forward (BatchNorm batch statistics, drop-path and gradient
checkpointing when the model is in train mode; under ``torch.autocast`` when
a compute dtype is given, with float32 parameters), the deep-supervision
Mask2Former loss with Hungarian matching plus the LSS depth loss, backward,
and the optimizer (``engine/optim.py``).  Every random draw of the step, the
drop-path masks and the loss's point draws, comes from the ``torch.Generator``
the caller passes, so the same generator state gives the same step.  Each
phase is a ``torch.profiler`` range (``stage:forward``, ``stage:loss``,
``stage:backward``, ``stage:optimizer``).
"""
from __future__ import annotations

import contextlib
from typing import Callable, ContextManager, Dict, List, Optional, Union

import torch
from torch.nn.parallel import DistributedDataParallel
from torch.profiler import record_function

from ..losses.mask2former_loss import MaskLossConfig, make_loss_draws, mask2former_loss
from ..models.layers import drop_path_generator
from ..models.lss import depth_bce_loss
from ..models.mask2former_head import format_results, mask_logits_from_embeds
from ..ops.sampling import grid_sample_3d
from ..parallel.distributed import all_reduce_sum, world_size
from ..utils.semkitti import kitti_class_weights, kitti_sample_weights
from .eval import to_device_batch
from .optim import TrainOptimizer


def build_loss_cfg(head_cfg: Dict, train_cfg: Optional[Dict]) -> MaskLossConfig:
    """The loss config of a head config and its ``train_cfg.pts`` (JAX
    ``build_loss_cfg``).  nuScenes heads (``Mask2FormerNusc*``) keep the
    config's class weights and sample at LiDAR points with
    ``align_corners=False``; ``mxu_readout`` picks their loss route as in JAX
    (default ``"auto"``, the per-layer route; ``"on"`` the all-layer batched
    one).  The SemanticKITTI head samples GT voxels by class frequency
    (``kitti_sample_weights``) and reads with ``align_corners=True``; its
    class weights are 1/log(frequency) with the config's background weight
    last (reference mask2former_occ.py:133-150).  The panoptic head
    (``Mask2FormerNuscPanopticOccHead``) sets ``panoptic``: its GT slots are
    the batch's panoptic segments.  The JAX package's other TPU knobs
    (``gt_chunks``, ``point_chunks``, ``feature_readout``,
    ``shared_candidate_readout``, ``gt_label_kernel``; the panoptic config
    sets ``feature_readout=True`` and ``point_chunks=8``) are not read: the
    port always reads the LiDAR branch's features with shared candidates,
    and its batched route always reads the GT with K3; none of them changes
    the function."""
    head_cfg = dict(head_cfg)
    train_cfg = dict(train_cfg or {})
    num_classes = head_cfg.get("num_occupancy_classes", 20)
    is_nusc = head_cfg.get("type", "").startswith("Mask2FormerNusc")
    loss_cls = dict(head_cfg.get("loss_cls") or {})
    if is_nusc:
        class_weight = tuple(loss_cls.get("class_weight", (1.0,) * num_classes + (0.1,)))
        sample_weights = None
    else:
        bg = loss_cls.get("class_weight", [1.0] * num_classes + [0.1])[-1]
        class_weight = tuple(kitti_class_weights(bg).tolist())
        sample_weights = tuple(kitti_sample_weights().tolist())
    assigner = dict(train_cfg.get("assigner") or {})
    return MaskLossConfig(
        num_classes=num_classes,
        num_points=train_cfg.get("num_points", 12544),
        oversample_ratio=train_cfg.get("oversample_ratio", 3.0),
        importance_sample_ratio=train_cfg.get("importance_sample_ratio", 0.75),
        cls_loss_weight=loss_cls.get("loss_weight", 2.0),
        mask_loss_weight=(head_cfg.get("loss_mask") or {}).get("loss_weight", 5.0),
        dice_loss_weight=(head_cfg.get("loss_dice") or {}).get("loss_weight", 5.0),
        cls_cost_weight=(assigner.get("cls_cost") or {}).get("weight", 2.0),
        mask_cost_weight=(assigner.get("mask_cost") or {}).get("weight", 5.0),
        dice_cost_weight=(assigner.get("dice_cost") or {}).get("weight", 5.0),
        dice_eps=(head_cfg.get("loss_dice") or {}).get("eps", 1.0),
        class_weight=class_weight,
        match_num_points=train_cfg.get("match_num_points"),
        mxu_readout=str(head_cfg.get("mxu_readout", "auto")),
        use_lidar_points=is_nusc,
        sample_weights=sample_weights,
        sample_weight_gamma=head_cfg.get("sample_weight_gamma", 0.25),
        panoptic=head_cfg.get("type") == "Mask2FormerNuscPanopticOccHead",
    )


def wrap_ddp(model: torch.nn.Module) -> DistributedDataParallel:
    """``model`` (on its device, in train mode) in ``DistributedDataParallel``
    as ``build_train_step`` runs it under an active process group.

    * ``find_unused_parameters=True``: the image backbone's frozen stages
      get no gradient (``models/resnet.py`` runs them without gradient in
      training; at the flagship's ``frozen_stages=0`` the stem's conv1 and
      bn1, at the R101-DCN's ``frozen_stages=1`` also layer1), and without
      the search DDP waits for them and fails the next step.  (The
      R101-DCN's BatchNorm affines, frozen by ``norm_cfg.requires_grad=False``
      in the optimizer, do get a gradient, as JAX's do, and count in
      ``grad_norm``.)  The search walks the step's autograd graph once a step.  The
      occupancy encoder's ``with_cp`` recomputation is the non-reentrant
      checkpoint, whose gradients reach DDP's hooks once each, so it needs
      nothing more.
    * ``broadcast_buffers=False``: every rank moves its BatchNorm running
      statistics by the same all-reduced global statistics, so the buffers
      never part; a broadcast from rank 0 would hide it if they did."""
    dev = next(model.parameters()).device
    return DistributedDataParallel(
        model, device_ids=[dev.index] if dev.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=True)


@torch.no_grad()
def train_point_miou(out: Dict[str, torch.Tensor], batch: Dict[str, torch.Tensor],
                     num_classes: int) -> torch.Tensor:
    """Train-time LiDAR-seg mean IoU on the batch (reference
    mask2former_nusc_occ.py:524-540, JAX ``_train_point_miou_device``):
    final-layer voxel scores read out at the LiDAR points (align_corners,
    border), argmax over the foreground classes, IoU of classes 1..n-1,
    NaN-mean.  A metric only: it is not summed into the loss."""
    voxels = format_results(out["cls_preds"][-1],
                            mask_logits_from_embeds(out["mask_embeds"][-1],
                                                    out["mask_feature"]))
    logits = grid_sample_3d(voxels, batch["lidar_xyz"].float() * 2.0 - 1.0,
                            align_corners=True, padding_mode="border")
    pred = logits[..., 1:].argmax(dim=-1) + 1
    label = batch["lidar_label"].long()
    n = num_classes
    ok = batch["lidar_valid"].bool() & (label > 0) & (label < n)
    idx = torch.where(ok, label * n + pred, torch.full_like(label, n * n))
    cm = torch.bincount(idx.reshape(-1), minlength=n * n + 1)[:-1]
    cm = all_reduce_sum(cm).reshape(n, n)[1:, 1:].float()  # over the global batch
    tp = cm.diagonal()
    denom = cm.sum(0) + cm.sum(1) - tp
    iou = torch.where(denom > 0, tp / denom.clamp(min=1), torch.full_like(tp, float("nan")))
    return torch.nanmean(iou)


def build_train_step(model: torch.nn.Module, optimizer: TrainOptimizer,
                     loss_cfg: MaskLossConfig,
                     device: Union[str, torch.device, None] = None,
                     compute_dtype: Optional[torch.dtype] = None,
                     accum_steps: int = 1,
                     stage_hook: Optional[Callable[[str], ContextManager]] = None) -> Callable:
    """Returns ``train_step(batch, generator, draws=None) -> metrics``.

    ``batch``: numpy arrays or tensors, the model's inputs plus ``gt_occ``
    [B, X, Y, Z], ``gt_depth`` [B, N, H, W] and, for the LiDAR loss branch,
    ``lidar_xyz`` [B, P, 3] in [0, 1], ``lidar_valid`` [B, P] and, for the
    point mIoU, ``lidar_label``; for the panoptic head ``panoptic_ids`` [B,
    S], each sample's padded table of panoptic ids (JAX :171-176).
    ``metrics``: every loss (``d{i}.loss_*``, ``loss_*``, ``loss_depth``),
    ``total_loss`` (the sum of the keys holding ``loss``), ``grad_norm``,
    ``unassigned_gt`` and, but for the panoptic head, whose LiDAR labels are
    panoptic ids (JAX :197-200), ``point_mean_iou``, as device scalars.  ``draws``
    replaces the loss's draws (``make_loss_draws``) with given ones, e.g.
    the JAX package's in a parity test: one dict, or a list with one dict
    per micro-batch (the grid branch draws from ``generator`` layer by
    layer while the loss runs, unless they are given).

    ``accum_steps > 1`` accumulates gradients as JAX's step does: the
    batch's leading axis (``accum_steps * micro_B``) splits into micro-batches
    that run forward, loss and backward in turn, so BatchNorm statistics
    update as ``accum_steps`` sequential steps would, each drawing its
    drop-path masks and then its loss draws from ``generator``; gradients
    and metrics are averaged over them, and the optimizer updates once.

    ``model`` may be a ``DistributedDataParallel`` wrapper: each rank then
    runs its shard of the global batch, and the step is the one-process step
    on the global batch (the rank-major concatenation of the shards).  Each
    rank keeps its rows of the global batch's drop-path masks and loss
    draws (one per-step generator on every rank), BatchNorm takes the global
    batch's statistics, the loss normalisers are summed over ranks, the
    gradients are averaged by DDP before the clip reads their norm, and the
    returned metrics are the global batch's (losses averaged over ranks,
    ``unassigned_gt`` summed, ``point_mean_iou`` from the summed confusion).
    With ``accum_steps > 1`` every micro-batch but the last runs under
    ``no_sync``.

    The step runs on ``cuda`` unless the caller passes ``device="cpu"``; the
    model must already be there.  It does not change the model's mode: call
    ``model.train()`` first for the train-mode forward.  ``compute_dtype``
    (e.g. ``torch.bfloat16``) runs the forward under ``torch.autocast``; the
    losses always run in float32.  ``stage_hook(name)``, where given, is a
    context the step enters around each of its stages (``forward``,
    ``loss``, ``backward``, ``optimizer``) inside the stage's profiler
    range, e.g. ``tools/memory_analysis.py``'s peak by stage.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the train step's plain PyTorch path on the CPU")
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be at least 1; got {accum_steps}")
    ddp = isinstance(model, DistributedDataParallel)
    if world_size() > 1 and not ddp:
        raise ValueError(f"a process group of {world_size()} is active: wrap the model in "
                         "DistributedDataParallel (engine/train.py:wrap_ddp)")
    core = model.module if ddp else model
    params = list(core.parameters())
    if any(p.device.type != dev.type for p in params):
        raise ValueError(f"the model's parameters must lie on {dev}")
    vt = core.img_view_transformer

    def autocast():
        if compute_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(dev.type, dtype=compute_dtype)

    @contextlib.contextmanager
    def stage(name):
        with record_function(f"stage:{name}"), \
                (stage_hook(name) if stage_hook is not None else contextlib.nullcontext()):
            yield

    def micro_step(batch, generator, draws):
        """Forward, losses and backward of one micro-batch; its metrics."""
        with stage("forward"), autocast(), drop_path_generator(generator):
            out = model(batch)
        with stage("loss"):
            L = out["cls_preds"].shape[0]
            ids = batch["panoptic_ids"] if loss_cfg.panoptic else None
            if draws is None and loss_cfg.use_lidar_points:
                draws = make_loss_draws(generator, loss_cfg, batch["lidar_valid"], L,
                                        None if ids is None else ids.shape[1])
            losses = mask2former_loss(
                out["cls_preds"], out["mask_embeds"], out["mask_feature"],
                batch["gt_occ"], loss_cfg, batch.get("lidar_xyz"), batch.get("lidar_valid"),
                draws, generator=generator, panoptic_ids=ids)
            losses["loss_depth"] = depth_bce_loss(
                batch["gt_depth"], out["depth_prob"], vt.grid_config, vt.downsample,
                vt.loss_depth_weight)
            total = sum(v for k, v in losses.items() if "loss" in k)
        with stage("backward"):
            total.backward()
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["total_loss"] = total.detach()
        if "lidar_label" in batch and not loss_cfg.panoptic:
            metrics["point_mean_iou"] = train_point_miou(
                {k: v.detach() for k, v in out.items()}, batch, loss_cfg.num_classes)
        return metrics

    def train_step(batch: Dict, generator: torch.Generator,
                   draws: Union[Dict[str, torch.Tensor], List[Dict[str, torch.Tensor]],
                                None] = None) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(batch, dev)
        B = batch["gt_occ"].shape[0]
        if B % accum_steps:
            raise ValueError(f"batch {B} is not divisible by accum_steps {accum_steps}")
        if draws is None or isinstance(draws, dict):
            if draws is not None and accum_steps > 1:
                raise ValueError("pass one set of loss draws per micro-batch")
            draws = [draws] * accum_steps
        if len(draws) != accum_steps:
            raise ValueError(f"{len(draws)} sets of loss draws for {accum_steps} micro-batches")
        mb = B // accum_steps
        micro = [batch] if accum_steps == 1 else [
            {k: v[m * mb:(m + 1) * mb] for k, v in batch.items()} for m in range(accum_steps)]
        optimizer.zero_grad()
        per_micro = []
        for m, (b, d) in enumerate(zip(micro, draws)):
            # DDP all-reduces the gradients in the last micro-batch's backward
            sync = not ddp or m == accum_steps - 1
            with contextlib.nullcontext() if sync else model.no_sync():
                per_micro.append(micro_step(b, generator, d))
        metrics = per_micro[0]
        if accum_steps > 1:
            inv = 1.0 / accum_steps
            torch._foreach_mul_([p.grad for p in params if p.grad is not None], inv)
            metrics = {k: sum(m[k] for m in per_micro) * inv for k in metrics}
        world = world_size()
        if world > 1:
            keys = [k for k in metrics if k != "point_mean_iou"]
            summed = all_reduce_sum(torch.stack([metrics[k].float() for k in keys]))
            metrics.update({k: v if k == "unassigned_gt" else v / world
                            for k, v in zip(keys, summed)})
        with stage("optimizer"):
            metrics["grad_norm"] = optimizer.step()
        return metrics

    return train_step
