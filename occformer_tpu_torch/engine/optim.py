"""Optimizer and LR schedule: AdamW with mmdet-style paramwise rules.

Port of ``occformer_tpu/engine/optim.py`` (reference config
occformer_nusc_r50_256x704.py:284-307, apis/mmdet_train.py:95): AdamW lr
1e-4, weight decay 0.01, betas (0.9, 0.999), eps 1e-8; no weight decay on
query / level embeddings, relative-position-bias tables, norm parameters and
biases; step LR x0.1 at epochs [20, 23]; global-norm gradient clip 5.  The
JAX package's optax chain (zero frozen grads -> clip -> adamw with a decay
mask) becomes ``TrainOptimizer``: ``torch.optim.AdamW`` over two parameter
groups (decay / no decay) plus the freeze and the clip, in that order.
Parameter names are the port's, i.e. the reference checkpoint's key space.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Sequence

import torch

NO_DECAY_NAMES = (
    "query_embed",
    "query_feat",
    "level_embed",
    "level_encoding",
    "absolute_pos_embed",
    "relative_position_bias_table",
)


def decay_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """True where weight decay applies: tensors of 2+ dims whose name holds
    none of ``NO_DECAY_NAMES`` (norm scales and biases are 1-D).  JAX
    ``_decay_mask``."""
    return {name: p.dim() > 1 and not any(nd in name for nd in NO_DECAY_NAMES)
            for name, p in model.named_parameters()}


def backbone_freeze_mask(model: torch.nn.Module,
                         backbone_cfg: Optional[Dict]) -> Optional[Dict[str, bool]]:
    """mmdet freezing semantics -> {name: frozen}, or None when nothing is
    frozen.  ``frozen_stages = n >= 0`` freezes the stem (conv1 / bn1) and
    layer1..layer n of the image backbone (``img_backbone``);
    ``norm_cfg=dict(requires_grad=False)`` freezes every backbone BatchNorm
    scale and bias.  JAX ``backbone_freeze_mask``."""
    cfg = dict(backbone_cfg or {})
    fs = cfg.get("frozen_stages")
    frozen_stages = -1 if fs is None else int(fs)
    norm_frozen = (cfg.get("norm_cfg") or {}).get("requires_grad", True) is False
    if frozen_stages < 0 and not norm_frozen:
        return None
    frozen_layers = {f"layer{i}" for i in range(1, frozen_stages + 1)}
    bn_names = {name for name, m in model.named_modules()
                if isinstance(m, torch.nn.modules.batchnorm._BatchNorm)}

    def frozen(name: str) -> bool:
        parts = name.split(".")
        if parts[0] != "img_backbone":
            return False
        if frozen_stages >= 0 and parts[1] in ("conv1", "bn1"):
            return True
        if parts[1] in frozen_layers:
            return True
        return norm_frozen and name.rsplit(".", 1)[0] in bn_names

    return {name: frozen(name) for name, _ in model.named_parameters()}


def step_lr_schedule(base_lr: float, steps_per_epoch: int,
                     milestones_epochs: Sequence[int],
                     gamma: float = 0.1) -> Callable[[int], float]:
    """mmcv StepLrUpdater: step -> lr, times ``gamma`` at each milestone
    epoch.  (The JAX package's optional linear warmup is not ported: no
    config of the repo sets one.)"""
    boundaries = [int(m * steps_per_epoch) for m in milestones_epochs]

    def schedule(step: int) -> float:
        lr = base_lr
        for b in boundaries:
            if step >= b:
                lr *= gamma
        return lr

    return schedule


class TrainOptimizer:
    """AdamW + freeze + global-norm clip, as the JAX package's optax chain;
    made by ``build_optimizer``.

    ``step()`` zeroes the frozen parameters' gradients, scales every gradient
    by ``min(1, grad_clip / norm)`` (optax ``clip_by_global_norm``) where the
    norm leaves the frozen ones out, as if they had no gradient, sets the
    scheduled learning rate and takes one AdamW step.  It returns the norm of
    the gradients as they came from the backward (the train step's
    ``grad_norm`` metric).  Both norms come from one set of per-tensor norms.
    """

    def __init__(self, adamw: torch.optim.AdamW, params, frozen,
                 schedule: Callable[[int], float], grad_clip: Optional[float]):
        self.adamw, self.params, self.schedule, self.grad_clip = (
            adamw, params, schedule, grad_clip)
        self.frozen = [p for p, f in zip(params, frozen) if f]
        # 1 where a parameter's gradient counts in the clip's norm
        self.trainable = torch.tensor([0.0 if f else 1.0 for f in frozen],
                                      device=params[0].device)
        self.step_count = 0

    def zero_grad(self):
        self.adamw.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        for p in self.params:  # a parameter the loss did not reach
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norms = torch.stack(torch._foreach_norm(grads)).float()
        norm = torch.linalg.vector_norm(norms)
        if self.frozen:
            torch._foreach_zero_([p.grad for p in self.frozen])
        if self.grad_clip is not None:
            clipped = torch.linalg.vector_norm(norms * self.trainable) if self.frozen else norm
            torch._foreach_mul_(grads, torch.clamp(self.grad_clip / clipped, max=1.0))
        lr = self.schedule(self.step_count)
        for group in self.adamw.param_groups:
            group["lr"] = lr
        self.adamw.step()
        self.step_count += 1
        return norm

    def state_dict(self) -> Dict:
        """AdamW's state (its moments and per-parameter step, by parameter
        position) and the schedule's step."""
        return {"adamw": self.adamw.state_dict(), "step_count": self.step_count}

    def load_state_dict(self, state: Dict):
        self.adamw.load_state_dict(state["adamw"])
        self.step_count = int(state["step_count"])


def build_optimizer(model: torch.nn.Module, lr=1e-4, weight_decay: float = 0.01,
                    betas=(0.9, 0.999), eps: float = 1e-8,
                    grad_clip: Optional[float] = 5.0,
                    freeze_mask: Optional[Dict[str, bool]] = None) -> TrainOptimizer:
    """The flagship's optimizer over ``model``'s parameters: AdamW in two
    groups (decay / no decay, ``decay_mask``; frozen parameters decay
    nowhere), the freeze of ``freeze_mask`` and the clip.  ``lr`` is a float
    or a ``step -> lr`` schedule (``step_lr_schedule``)."""
    named = list(model.named_parameters())
    decay = decay_mask(model)
    frozen = [(freeze_mask or {}).get(n, False) for n, _ in named]
    decayed = [decay[n] and not f for (n, _), f in zip(named, frozen)]
    schedule = lr if callable(lr) else (lambda step: lr)
    groups = [
        {"params": [p for (_, p), d in zip(named, decayed) if d],
         "weight_decay": weight_decay},
        {"params": [p for (_, p), d in zip(named, decayed) if not d], "weight_decay": 0.0},
    ]
    adamw = torch.optim.AdamW(groups, lr=schedule(0), betas=tuple(betas), eps=eps,
                              weight_decay=weight_decay)
    return TrainOptimizer(adamw, [p for _, p in named], frozen, schedule, grad_clip)


def build_optimizer_from_config(model: torch.nn.Module, cfg: Dict,
                                steps_per_epoch: int) -> TrainOptimizer:
    """``build_optimizer`` as a config asks for it (the train CLI's): AdamW
    of ``optimizer``, the clip of ``optimizer_config.grad_clip``, the step
    schedule of ``lr_config.step`` over ``steps_per_epoch``, and the
    backbone freeze of ``model.img_backbone``."""
    opt_cfg = cfg.get("optimizer", {})
    return build_optimizer(
        model,
        lr=step_lr_schedule(opt_cfg.get("lr", 1e-4), steps_per_epoch,
                            cfg.get("lr_config", {}).get("step", [20, 23])),
        weight_decay=opt_cfg.get("weight_decay", 0.01),
        betas=tuple(opt_cfg.get("betas", (0.9, 0.999))), eps=opt_cfg.get("eps", 1e-8),
        grad_clip=cfg.get("optimizer_config", {}).get("grad_clip", {}).get("max_norm", 5.0),
        freeze_mask=backbone_freeze_mask(model, cfg["model"].get("img_backbone")))
