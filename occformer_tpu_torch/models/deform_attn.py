"""Multi-scale deformable attention over 3D voxel pyramids.

Port of ``occformer_tpu/models/deform_attn.py:MultiScaleDeformableAttention3D``
(reference necks/multi_scale_deform_attn_3d.py:84-286).  Sampling offsets and
softmax attention weights come from linear layers; the weighted trilinear
gather over all levels is K1, ``ops.trilerp_fused.ms_deform_gather_3d``.

Coordinates are (x, y, z) indexing the [X, Y, Z] volume axes.  The reference
checkpoint stores each ``sampling_offsets`` output triple as (z, y, x), the
order torch's grid wants; this module keeps that layout for its parameters
and flips each triple to (x, y, z) in the forward.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..ops.trilerp_fused import ms_deform_gather_3d


def deform_attn_offset_bias_init(num_heads: int, num_levels: int, num_points: int) -> np.ndarray:
    """Radial init of the sampling-offset bias (reference :162-181), as
    (x, y, z) triples — the JAX package's init."""
    thetas = np.arange(num_heads, dtype=np.float32) * (2.0 * math.pi / num_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas),
                     (np.sin(thetas) + np.cos(thetas)) / 2.0], axis=-1)
    grid = grid / np.abs(grid).max(axis=-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, num_levels, num_points, 1))
    for i in range(num_points):
        grid[:, :, i, :] *= i + 1
    return grid.reshape(-1).astype(np.float32)


class MultiScaleDeformableAttention3D(nn.Module):
    """Batch-first: query [B, Nq, C], value [B, Nv, C] (levels flattened
    x-major and stacked), reference_points [B, Nq, L, 3] in [0, 1]."""

    def __init__(self, embed_dims: int = 256, num_heads: int = 8, num_levels: int = 3,
                 num_points: int = 4, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims, self.num_heads = embed_dims, num_heads
        self.num_levels, self.num_points = num_levels, num_points
        HLP = num_heads * num_levels * num_points
        self.sampling_offsets = nn.Linear(embed_dims, HLP * 3, dtype=dtype)
        self.attention_weights = nn.Linear(embed_dims, HLP, dtype=dtype)
        self.value_proj = nn.Linear(embed_dims, embed_dims, dtype=dtype)
        self.output_proj = nn.Linear(embed_dims, embed_dims, dtype=dtype)
        self.reset_offsets()

    @torch.no_grad()
    def reset_offsets(self):
        """Reference init_weights (multi_scale_deform_attn_3d.py:160-186): zero
        offset and weight kernels, radial offset bias (stored (z, y, x)), zero
        weight bias."""
        H, L, P = self.num_heads, self.num_levels, self.num_points
        bias = deform_attn_offset_bias_init(H, L, P).reshape(-1, 3)[:, ::-1].reshape(-1)
        self.sampling_offsets.weight.zero_()
        self.sampling_offsets.bias.copy_(torch.from_numpy(bias.copy()))
        self.attention_weights.weight.zero_()
        self.attention_weights.bias.zero_()

    def forward(self, query, value, reference_points,
                spatial_shapes: Sequence[Tuple[int, int, int]], query_pos=None):
        B, Nq, C = query.shape
        H, L, P = self.num_heads, self.num_levels, self.num_points
        identity = query
        if query_pos is not None:
            query = query + query_pos

        value = self.value_proj(value).reshape(B, -1, H, C // H)
        # (z, y, x) triples of the reference layout -> (x, y, z)
        offsets = self.sampling_offsets(query).reshape(B, Nq, H, L, P, 3).flip(-1)
        weights = self.attention_weights(query).reshape(B, Nq, H, L * P)
        weights = torch.softmax(weights.float(), dim=-1).to(value.dtype)
        weights = weights.reshape(B, Nq, H, L, P)

        normalizer = torch.tensor([list(s) for s in spatial_shapes],
                                  dtype=torch.float32, device=query.device)
        locs = (reference_points[:, :, None, :, None, :].float()
                + offsets.float() / normalizer[None, None, None, :, None, :])
        out = ms_deform_gather_3d(value.contiguous(), spatial_shapes,
                                  locs.contiguous(), weights.contiguous())
        return self.output_proj(out.reshape(B, Nq, C)) + identity
