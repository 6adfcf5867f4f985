"""Deformable convolution v1 and v2 (mmcv ``DeformConv2dPack``, type='DCN',
and ``ModulatedDeformConv2dPack``, type='DCNv2') in plain PyTorch.

Port of ``occformer_tpu/models/dcn.py``: the DepthNet's DCN (one deform
group, no modulation, four conv groups) and the R101-DCN backbone's DCNv2
(``modulated=True``, the stride of its block), with mmcv's parameter layout
so a reference checkpoint loads unchanged: ``weight`` (O, I/groups, K, K)
and ``conv_offset``, whose output channels interleave the (dy, dx) pair of
every tap of every deform group (channel ``g * 2K^2 + 2k + {0, 1}``) and,
modulated, put the mask logits after all the offsets (channel
``2GK^2 + g * K^2 + k``).  (The JAX package orders them [dy, dx, mask] per
group; ``engine/convert_weights.py:_dcn_offset_perm`` maps one onto the
other.)  Tap k of output pixel (i, j) samples the input at ``(i * stride -
pad + k // K + dy, j * stride - pad + k % K + dx)`` bilinearly (pixel-index
coordinates, zeros outside); modulated, the sample is scaled by the mask's
sigmoid.  The weighted sum over taps and input channels is one grouped
matmul.  Channels-first.

The taps of every deform group are read in one call of ``ops/
trilerp_fused.py:fused_multilevel_gather`` (K4 on the card, its plain
version on the CPU): one level of Z = 1 whose batch is (image, deform
group), the group's input channels channels-last as the table ``[B * G,
H*W, Cin / G]`` and the taps' coordinates (y, x, 0) in [-1, 1] with
``align_corners=True``.  At Z = 1 the z corner weights are exact (index 0
with weight 1, its neighbour out of range), so this is the bilinear sample
of ``ops/sampling.py:grid_sample_2d``.  K4-bwd sums the input's gradient in
a fixed order (``csrc/ordered_rows.cuh``), so a reloaded train step repeats
it bit for bit, where ``F.grid_sample``'s backward adds with atomics; the
offsets' gradient comes from its coordinates' gradient.  The mask
multiplies the gathered samples in PyTorch, as the JAX package does it in
XLA outside its kernels.  Sampling coordinates and the mask are float32
under bf16 autocast; the mask is cast to the samples' dtype before the
product, as JAX casts it.
"""
from __future__ import annotations

import math

import torch
import torch.nn as nn

from ..ops.trilerp_fused import fused_multilevel_gather


class DeformConv2d(nn.Module):
    """[B, Cin, H, W] -> [B, F, H', W'] (H' = (H + 2 * padding - K) // stride + 1)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, groups: int = 1, deform_groups: int = 1,
                 modulated: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        K = kernel_size
        self.K, self.stride, self.padding, self.groups = K, stride, padding, groups
        self.deform_groups, self.modulated = deform_groups, modulated
        self.weight = nn.Parameter(torch.empty(out_channels, in_channels // groups, K, K,
                                               dtype=dtype))
        self.conv_offset = nn.Conv2d(in_channels, (3 if modulated else 2) * deform_groups * K * K,
                                     K, stride=stride, padding=padding, bias=True, dtype=dtype)
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        nn.init.zeros_(self.conv_offset.weight)
        nn.init.zeros_(self.conv_offset.bias)

    def forward(self, x):
        B, Cin, H, W = x.shape
        K, KK, G = self.K, self.K * self.K, self.deform_groups
        off = self.conv_offset(x).float()  # [B, (2|3) * G * KK, oh, ow]
        oh, ow = off.shape[2:]
        dy, dx = off[:, :2 * G * KK].reshape(B, G, KK, 2, oh, ow).unbind(3)  # [B, G, KK, oh, ow]

        # sampling position of tap k: out_idx * stride - pad + k_offset + offset
        dev = x.device
        k = torch.arange(KK, device=dev)
        base_y = (torch.arange(oh, device=dev) * self.stride - self.padding).float()
        base_x = (torch.arange(ow, device=dev) * self.stride - self.padding).float()
        py = base_y[None, :, None] + (k // K).float()[:, None, None] + dy
        px = base_x[None, None, :] + (k % K).float()[:, None, None] + dx
        # pixel index -> [-1, 1] under align_corners=True
        ny = py / (H - 1) * 2 - 1 if H > 1 else torch.zeros_like(py)
        nx = px / (W - 1) * 2 - 1 if W > 1 else torch.zeros_like(px)
        cg = Cin // G
        table = x.permute(0, 2, 3, 1).reshape(B, H * W, G, cg).transpose(1, 2)
        table = table.reshape(B * G, H * W, cg).contiguous()
        coords = torch.stack([ny, nx, torch.zeros_like(ny)], dim=-1).reshape(B * G, -1, 3)
        sampled = fused_multilevel_gather([table], [(H, W, 1)], cg, [coords.contiguous()],
                                          align_corners=True)[0]  # [B*G, cg, KK*oh*ow]
        if self.modulated:
            gate = torch.sigmoid(off[:, 2 * G * KK:]).reshape(B, G, 1, KK * oh * ow)
            sampled = sampled.reshape(B, G, cg, -1) * gate.to(sampled.dtype)

        # grouped sum over (input channel, tap): weight (O, I/g, K, K)
        ng = self.groups
        cols = sampled.reshape(B, ng, (Cin // ng) * KK, oh * ow)
        w = self.weight.reshape(ng, -1, (Cin // ng) * KK)  # [ng, O/ng, I/ng*KK]
        return torch.einsum("gok,bgkl->bgol", w, cols).reshape(B, -1, oh, ow)
