"""Deformable convolution v1 (mmcv ``DeformConv2dPack``, type='DCN') in
plain PyTorch.

Port of ``occformer_tpu/models/dcn.py`` as the DepthNet uses it (one deform
group, no modulation, no bias, stride 1), with mmcv's parameter layout so a
reference checkpoint loads unchanged: ``weight`` (O, I/groups, K, K) and
``conv_offset``, whose output channels interleave the (dy, dx) pair of every
tap (channel ``2k + {0, 1}``).  Each tap is one bilinear sample
(pixel-index coordinates, zeros outside); the weighted sum over taps and
input channels is one grouped matmul.  Channels-first.

The nine taps are read in one call of ``ops/trilerp_fused.py:
fused_multilevel_gather`` (K4 on the card, its plain version on the CPU):
one level of Z = 1, the input channels-last as the table ``[B, H*W, Cin]``
and the taps' coordinates (y, x, 0) in [-1, 1] with ``align_corners=True``.
At Z = 1 the z corner weights are exact (index 0 with weight 1, its
neighbour out of range), so this is the bilinear sample of
``ops/sampling.py:grid_sample_2d``.  K4-bwd sums the input's gradient in a
fixed order (``csrc/ordered_rows.cuh``), so a reloaded train step repeats
it bit for bit, where ``F.grid_sample``'s backward adds with atomics; the
offsets' gradient comes from its coordinates' gradient.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.trilerp_fused import fused_multilevel_gather


class DeformConv2d(nn.Module):
    """[B, Cin, H, W] -> [B, F, H', W'] (H' = H + 2 * padding - K + 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 padding: int = 1, groups: int = 1, dtype: torch.dtype = torch.float32):
        super().__init__()
        K = kernel_size
        self.K, self.padding, self.groups = K, padding, groups
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, K, K,
                                               dtype=dtype))
        self.conv_offset = nn.Conv2d(in_channels, 2 * K * K, K, padding=padding,
                                     bias=True, dtype=dtype)
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x):
        B, Cin, H, W = x.shape
        K, KK = self.K, self.K * self.K
        off = self.conv_offset(x).float()  # [B, 2*KK, oh, ow]
        oh, ow = off.shape[2:]
        dy, dx = off.reshape(B, KK, 2, oh, ow).unbind(2)  # [B, KK, oh, ow]

        # sampling position of tap k: out_idx - pad + k_offset + offset
        dev = x.device
        k = torch.arange(KK, device=dev)
        base_y = (torch.arange(oh, device=dev) - self.padding).float()
        base_x = (torch.arange(ow, device=dev) - self.padding).float()
        py = base_y[None, :, None] + (k // K).float()[:, None, None] + dy
        px = base_x[None, None, :] + (k % K).float()[:, None, None] + dx
        # pixel index -> [-1, 1] under align_corners=True
        ny = py / (H - 1) * 2 - 1 if H > 1 else torch.zeros_like(py)
        nx = px / (W - 1) * 2 - 1 if W > 1 else torch.zeros_like(px)
        table = x.permute(0, 2, 3, 1).reshape(B, H * W, Cin).contiguous()
        coords = torch.stack([ny, nx, torch.zeros_like(ny)], dim=-1).reshape(B, -1, 3)
        sampled = fused_multilevel_gather([table], [(H, W, 1)], Cin, [coords.contiguous()],
                                          align_corners=True)[0]  # [B, Cin, KK*oh*ow]

        # grouped sum over (input channel, tap): weight (O, I/g, K, K)
        ng = self.groups
        cols = sampled.reshape(B, ng, (Cin // ng) * KK, oh * ow)
        w = self.weight.reshape(ng, -1, (Cin // ng) * KK)  # [ng, O/ng, I/ng*KK]
        return torch.einsum("gok,bgkl->bgol", w, cols).reshape(B, -1, oh, ow)
