"""Dual-path 3D occupancy encoder.

Port of ``occformer_tpu/models/occnet.py`` (reference
backbones/{occnet.py,dualpath_block.py}).  Each block: strided 3D conv-in ->
z-mean to the BEV plane -> the BEV plane and every z-slice go through ONE
shared SwinBlock as one batch (global and local paths) -> ASPP on the BEV
output -> sigmoid-gated fusion -> residual.  Volumes are channels-first
``[B, C, X, Y, Z]``; stage ``i``, block ``j`` is ``layers.{i}.{j}``.
In train mode the shared SwinBlock drops paths at rate 0.2 (hard-coded, as
in the JAX package, ``occnet.py:63``), and ``with_cp`` recomputes each block
in the backward instead of keeping its activations (reference occnet.py:67-68
``cp.checkpoint``; JAX ``nn.remat``).
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from .aspp import BottleNeckASPP
from .layers import Conv3dFixedOrderBackward, checkpoint
from .swin import SwinBlock


class DualpathTransformerBlock(nn.Module):
    def __init__(self, in_channels: int, channels: int, stride: int = 1,
                 layer_index: int = 0, num_groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        # its backward on cuDNN's deterministic algorithms: at the tiny test
        # model's shapes the default ones vary from run to run (ROADMAP C.8)
        self.input_conv = nn.Sequential(
            Conv3dFixedOrderBackward(in_channels, channels, 3, stride=stride, padding=1,
                                     bias=False, dtype=dtype),
            nn.GroupNorm(num_groups, channels, dtype=dtype), nn.ReLU())
        self.bev_encoder = SwinBlock(channels, channels // 32, channels, window_size=7,
                                     shift=(layer_index % 2) == 1, drop_path_rate=0.2,
                                     dtype=dtype)
        self.aspp = BottleNeckASPP(channels, num_groups=num_groups, dtype=dtype)
        self.combine_coeff = nn.Conv3d(channels, 1, 1, bias=True, dtype=dtype)
        self.downsample = None
        if stride > 1 or in_channels != channels:
            self.downsample = nn.Sequential(
                nn.Conv3d(in_channels, channels, 1, stride=stride, bias=False, dtype=dtype),
                nn.GroupNorm(num_groups, channels, dtype=dtype))

    def forward(self, x):
        identity = x
        y = self.input_conv(x)  # [B, C, X, Y, Z]
        B, C, X, Y, Z = y.shape
        # [BEV] ++ [z-slices, b-major] as one channels-last batch
        y_bev = y.mean(dim=4).permute(0, 2, 3, 1)  # [B, X, Y, C]
        slices = y.permute(0, 4, 2, 3, 1).reshape(B * Z, X, Y, C)
        both = self.bev_encoder(torch.cat([y_bev, slices], dim=0), segments=(1, Z))
        y_bev = both[:B].permute(0, 3, 1, 2)  # [B, C, X, Y]
        y = both[B:].reshape(B, Z, X, Y, C).permute(0, 4, 2, 3, 1)

        y_bev = self.aspp(y_bev)
        y = y + torch.sigmoid(self.combine_coeff(y)) * y_bev[..., None]
        if self.downsample is not None:
            identity = self.downsample(identity)
        return y + identity


class OccupancyEncoder(nn.Module):
    """4-stage dual-path encoder returning the stage volumes in ``out_indices``."""

    def __init__(self, in_channels: int = 128, num_stage: int = 4,
                 block_numbers: Sequence[int] = (2, 2, 2, 2),
                 block_inplanes: Sequence[int] = (128, 256, 512, 1024),
                 block_strides: Sequence[int] = (1, 2, 2, 2),
                 out_indices: Sequence[int] = (0, 1, 2, 3), num_groups: int = 32,
                 with_cp: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.with_cp = bool(with_cp)
        self.layers = nn.ModuleList()
        cin, layer_index = in_channels, 0
        for i in range(num_stage):
            blocks = nn.ModuleList()
            for j in range(block_numbers[i]):
                blocks.append(DualpathTransformerBlock(
                    cin, block_inplanes[i], stride=block_strides[i] if j == 0 else 1,
                    layer_index=layer_index, num_groups=num_groups, dtype=dtype))
                cin = block_inplanes[i]
                layer_index += 1
            self.layers.append(blocks)

    def forward(self, x):
        outs = []
        for i, blocks in enumerate(self.layers):
            for block in blocks:
                if self.with_cp and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x)
                else:
                    x = block(x)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
