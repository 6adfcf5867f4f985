"""Bilinear / trilinear sampling and resizing on ``F.grid_sample`` /
``F.interpolate``.

Port of ``occformer_tpu/ops/sampling.py`` with its conventions kept at the
public functions: volumes are channels-last ``[B, X, Y, Z, C]``, images
``[B, H, W, C]``, and ``coords[..., i]`` indexes spatial axis ``i`` in order,
normalized to [-1, 1] with torch's ``align_corners`` mapping.  Torch grids
run in the reverse order (the last grid component indexes the last spatial
axis), so each call flips the coordinate triple or pair.  The lerp runs in
float32 and the result comes back in the input's dtype.  ``point_sample_3d``,
the loss's point readout, goes through K2 (``ops/trilerp.py``).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .trilerp import trilerp_sample


def grid_sample_3d(
    vol: torch.Tensor,
    coords: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Trilinear sampling of ``vol [B, X, Y, Z, C]`` at ``coords [B, ..., 3]``
    (x, y, z) in [-1, 1].  Returns ``[B, ..., C]``."""
    B, X, Y, Z, C = vol.shape
    batch_shape = coords.shape[1:-1]
    grid = coords.reshape(B, -1, 1, 1, 3).flip(-1).float()
    v = vol.permute(0, 4, 1, 2, 3).float()  # [B, C, X, Y, Z]
    out = F.grid_sample(v, grid, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)  # [B, C, S, 1, 1]
    out = out[..., 0, 0].transpose(1, 2)
    out_dtype = vol.dtype if vol.is_floating_point() else torch.float32
    return out.to(out_dtype).reshape(B, *batch_shape, C)


def point_sample_3d(
    vol: torch.Tensor,
    points: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Sample ``vol [B, X, Y, Z, C]`` at [0, 1]-normalized ``points [B, P, 3]``
    (x, y, z) -> ``[B, P, C]`` (reference mmdet_utils.py:21-47 maps [0, 1] to
    [-1, 1]).  Through K2 for CUDA tensors; a bool volume reads as 0/1 and
    gives float32."""
    coords = (points.float() * 2.0 - 1.0).contiguous()
    return trilerp_sample(vol, coords, align_corners, padding_mode)


def grid_sample_2d(
    img: torch.Tensor,
    coords: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Bilinear sampling of ``img [B, H, W, C]`` at ``coords [B, ..., 2]``
    (coords[..., 0] indexes H, coords[..., 1] indexes W)."""
    B, H, W, C = img.shape
    batch_shape = coords.shape[1:-1]
    grid = coords.reshape(B, -1, 1, 2).flip(-1).float()
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    return out[..., 0].transpose(1, 2).to(img.dtype).reshape(B, *batch_shape, C)


def resize_trilinear(
    vol: torch.Tensor, size: Tuple[int, int, int], align_corners: bool = False
) -> torch.Tensor:
    """Trilinear resize of ``[B, X, Y, Z, C]`` (torch ``F.interpolate``)."""
    out = F.interpolate(vol.permute(0, 4, 1, 2, 3).float(),
                        size=tuple(int(s) for s in size), mode="trilinear",
                        align_corners=align_corners)
    return out.permute(0, 2, 3, 4, 1).to(vol.dtype)
