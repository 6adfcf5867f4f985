"""Voxel scatter of the lifted depth x context features (LSS splat).

Port of ``occformer_tpu/ops/scatter.py:voxel_scatter_lifted``.  The sum by
voxel is one ``index_add_`` per camera into ``B * nvox + 1`` rows; invalid
points go to the dummy last row, which is dropped.
"""
from __future__ import annotations

from typing import Sequence

import torch


def voxel_scatter_lifted(
    depth: torch.Tensor,
    ctx: torch.Tensor,
    coords: torch.Tensor,
    valid: torch.Tensor,
    nx: Sequence[int],
) -> torch.Tensor:
    """Fused lift (depth ⊗ context) + scatter.

    Args:
      depth:  [B, N, D, fH, fW] softmaxed depth distribution
      ctx:    [B, N, fH, fW, C] context features
      coords: [B, N, D, fH, fW, 3] voxel indices of each frustum point
      valid:  [B, N, D, fH, fW] bool
      nx:     (X, Y, Z)

    Returns [B, X, Y, Z, C] in ``depth.dtype``.  The sum is kept in float32
    and cast once at the end.
    """
    B, N, D, fH, fW = depth.shape
    C = ctx.shape[-1]
    X, Y, Z = int(nx[0]), int(nx[1]), int(nx[2])
    nvox = X * Y * Z

    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=coords.dtype, device=coords.device)
    coords = torch.minimum(coords.clamp(min=0), hi)
    lin = (coords[..., 0].long() * Y + coords[..., 1]) * Z + coords[..., 2]
    batch_off = (torch.arange(B, device=lin.device) * nvox).view(B, 1, 1, 1, 1)
    seg = torch.where(valid, lin + batch_off, torch.full_like(lin, B * nvox))

    # camera by camera, so one camera's [B, D, fH, fW, C] product is the
    # largest temporary rather than the whole [B, N, D, fH, fW, C] lift
    out = torch.zeros((B * nvox + 1, C), dtype=torch.float32, device=depth.device)
    for n in range(N):
        feats_n = depth[:, n, ..., None] * ctx[:, n, None]  # [B, D, fH, fW, C]
        out.index_add_(0, seg[:, n].reshape(-1), feats_n.reshape(-1, C).float())
    return out[: B * nvox].reshape(B, X, Y, Z, C).to(depth.dtype)
