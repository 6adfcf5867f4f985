"""Point sampling for mask supervision.

Port of ``occformer_tpu/losses/point_sampling.py``: multinomial sampling
without replacement as Gumbel top-k (``gumbel_topk_sample``), here in the
index form (the Gumbel noise comes in with the caller's draws, so the same
noise gives the same indices on either side), and the uncertainty top-k of
importance sampling (``uncertainty_topk``).
"""
from __future__ import annotations

import torch


def gumbel_noise(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws, float32, on the generator's device."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def gumbel_topk_sample(weights: torch.Tensor, k: int, gumbel: torch.Tensor) -> torch.Tensor:
    """``k`` indices drawn without replacement in proportion to ``weights
    [..., N]`` (zero weight = never drawn): the top ``k`` of log(w) + the
    Gumbel noise ``gumbel`` (``gumbel_noise``).  Returns int64 [..., k] in
    decreasing key order."""
    w = weights.float()
    logw = torch.where(w > 0, torch.log(w.clamp(min=1e-30)),
                       torch.full_like(w, float("-inf")))
    return torch.topk(logw + gumbel, k).indices


def uncertainty_topk(point_logits: torch.Tensor, num_uncertain: int) -> torch.Tensor:
    """Per row, the ``num_uncertain`` candidates with the smallest |logit|
    (reference mmdet_utils.py:49-69).  [G, S] -> int64 [G, num_uncertain]."""
    return torch.topk(-point_logits.float().abs(), num_uncertain, dim=-1).indices
