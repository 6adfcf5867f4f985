"""Point sampling for mask supervision.

Port of ``occformer_tpu/losses/point_sampling.py``: multinomial sampling
without replacement as Gumbel top-k (``gumbel_topk_sample``), here in the
index form (the Gumbel noise comes in with the caller's draws, so the same
noise gives the same indices on either side); its form with ``lax.top_k``'s
tie rule (``index_topk``), on which SemanticKITTI's frequency-weighted
voxel sampling (``sample_with_frequencies``, reference mmdet_utils.py:92-114)
draws GT voxels; and the uncertainty top-k of importance sampling
(``uncertainty_topk``).
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


def index_topk(weights: torch.Tensor, k: int, gumbel: torch.Tensor) -> torch.Tensor:
    """``gumbel_topk_sample`` with ``lax.top_k``'s order where keys tie:
    the zero-weight entries (key -inf in the JAX package) come after every
    drawn one, in index order.  Here they take distinct finite keys, -(2^23 +
    i) * 2^77 for index i, exact in float32 and below every log-weight plus
    Gumbel noise, so one ``torch.topk`` gives JAX's indices.  ``weights``
    [..., N] broadcasts against ``gumbel`` [..., N]; N < 2^23.  Returns
    int64 [..., k]."""
    n = weights.shape[-1]
    if n >= 1 << 23:
        raise ValueError(f"index_topk takes fewer than 2^23 entries; got {n}")
    w = weights.float()
    rank = -(torch.arange(n, device=w.device, dtype=torch.float32) + float(1 << 23)) \
        * float(2.0 ** 77)
    logw = torch.where(w > 0, torch.log(w.clamp(min=1e-30)), rank)
    keys = torch.where(w > 0, logw + gumbel, logw.expand_as(gumbel))
    return torch.topk(keys, k).indices


def unravel_3d(indices: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Flat voxel index -> (x, y, z) [..., 3] (reference mmdet_utils.py:71-89)."""
    X, Y, Z = shape
    z = indices % Z
    y = (indices // Z) % Y
    x = indices // (Y * Z)
    return torch.stack([x, y, z], dim=-1)


def voxel_points(indices: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """Flat voxel indices -> [0, 1] points ``idx / (size - 1)`` per axis,
    the normalisation the reference reads them with at align_corners=True."""
    norm = torch.tensor([s - 1 for s in shape], dtype=torch.float32, device=indices.device)
    return unravel_3d(indices, shape).float() / norm


def sample_with_frequencies(gt_occ: torch.Tensor, class_weights: torch.Tensor,
                            num_points: int, gumbel: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Frequency-weighted voxel sampling (JAX ``sample_with_frequencies``,
    reference mmdet_utils.py:92-114): ``num_points`` voxels of the label grid
    ``gt_occ [..., X, Y, Z]`` drawn without replacement, each in proportion
    to its class's weight in ``class_weights [G]`` (labels outside [0, G),
    255, after every labelled voxel, as zero weights), with the Gumbel noise
    ``gumbel [..., X*Y*Z]`` (broadcast against the grid's leading axes: one
    grid, one draw per row of noise).  The weights are looked up by label:
    JAX's ``einsum`` over the one-hot masks holds one term a voxel.  Returns
    (flat indices [..., num_points], [0, 1] points [..., num_points, 3])."""
    shape = tuple(gt_occ.shape[-3:])
    flat = gt_occ.reshape(*gt_occ.shape[:-3], -1).long()
    G = class_weights.shape[0]
    w = torch.where((flat >= 0) & (flat < G), class_weights.float()[flat.clamp(0, G - 1)],
                    torch.zeros((), device=flat.device))
    idx = index_topk(w, num_points, gumbel)
    return idx, voxel_points(idx, shape)
