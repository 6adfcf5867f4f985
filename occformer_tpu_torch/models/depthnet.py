"""Camera-aware DepthNet: depth distribution + context from image features.

Port of ``occformer_tpu/models/depthnet.py`` (reference
ViewTransformerLSSBEVDepth.py:450-504) with the checkpoint's names:
``reduce_conv``, ``bn`` (BatchNorm1d over the camera embedding, in float32),
``{depth,context}_mlp``, ``{depth,context}_se``, ``context_conv`` and
``depth_conv`` = 3 BasicBlocks, ASPP, DCN (no bias), 1x1 depth logits.
Channels-first.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dcn import DeformConv2d
from .layers import BasicBlock2D, BatchNorm1d, BatchNorm2d, Conv2dIm2colBackward, Mlp, SELayer


class _ASPPModule(nn.Module):
    def __init__(self, cin, cout, k, padding, dilation, norm, dtype, conv=nn.Conv2d):
        super().__init__()
        self.atrous_conv = conv(cin, cout, k, padding=padding, dilation=dilation,
                                bias=False, dtype=dtype)
        self.bn = norm(cout)

    def forward(self, x):
        return F.relu(self.bn(self.atrous_conv(x)))


class ASPP2D(nn.Module):
    """1x1 + three dilated 3x3 branches (dilation 6, 12, 18) + global-average
    branch, concat, 1x1; every branch as wide as the input.

    ``norm`` builds the norm layer for a channel count (BatchNorm in the
    DepthNet, GroupNorm in the 3D encoder).  The DepthNet variant has no
    residual add; the encoder's (``residual=True``) ends with ``x + y``.
    ``fixed_order``: the branches of dilation 12 and 18 take their backward
    as im2col and matrix products (``layers.Conv2dIm2colBackward``): at the
    flagship DepthNet's [6, 512, 16, 44] cuDNN's default backward of those
    two varies from run to run and its deterministic one is 4.6-7.8x slower
    (ROADMAP C.8); dilation 6's repeats.
    """

    def __init__(self, inplanes: int, norm, residual: bool = False,
                 dtype: torch.dtype = torch.float32, fixed_order: bool = False):
        super().__init__()
        mid = inplanes
        dilated = Conv2dIm2colBackward if fixed_order else nn.Conv2d
        self.aspp1 = _ASPPModule(inplanes, mid, 1, 0, 1, norm, dtype)
        self.aspp2 = _ASPPModule(inplanes, mid, 3, 6, 6, norm, dtype)
        self.aspp3 = _ASPPModule(inplanes, mid, 3, 12, 12, norm, dtype, dilated)
        self.aspp4 = _ASPPModule(inplanes, mid, 3, 18, 18, norm, dtype, dilated)
        self.global_avg_pool = nn.Sequential(
            nn.AdaptiveAvgPool2d((1, 1)),
            nn.Conv2d(inplanes, mid, 1, bias=False, dtype=dtype),
            norm(mid), nn.ReLU())
        self.conv1 = nn.Conv2d(mid * 5, inplanes, 1, bias=False, dtype=dtype)
        self.bn1 = norm(inplanes)
        self.residual = residual

    def forward(self, x):
        xs = [m(x) for m in (self.aspp1, self.aspp2, self.aspp3, self.aspp4)]
        g = self.global_avg_pool(x).expand(-1, -1, *xs[0].shape[2:])
        y = F.relu(self.bn1(self.conv1(torch.cat(xs + [g], dim=1))))
        return x + y if self.residual else y


class DepthNet(nn.Module):
    """[B*N, mid, fH, fW] + [B*N, cam] -> (depth logits [.., D, fH, fW],
    context [.., C, fH, fW])."""

    def __init__(self, mid_channels: int, context_channels: int, depth_channels: int,
                 cam_channels: int = 27, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reduce_conv = nn.Sequential(
            nn.Conv2d(mid_channels, mid_channels, 3, padding=1, bias=True, dtype=dtype),
            BatchNorm2d(mid_channels, dtype=dtype), nn.ReLU())
        self.bn = BatchNorm1d(cam_channels, dtype=dtype)
        self.depth_mlp = Mlp(cam_channels, mid_channels, mid_channels, dtype=dtype)
        self.depth_se = SELayer(mid_channels, dtype=dtype)
        self.context_mlp = Mlp(cam_channels, mid_channels, mid_channels, dtype=dtype)
        self.context_se = SELayer(mid_channels, dtype=dtype)
        self.context_conv = nn.Conv2d(mid_channels, context_channels, 1, dtype=dtype)
        self.depth_conv = nn.Sequential(
            *(BasicBlock2D(mid_channels, dtype=dtype) for _ in range(3)),
            ASPP2D(mid_channels, lambda c: BatchNorm2d(c, dtype=dtype), dtype=dtype,
                   fixed_order=True),
            # mmcv DeformConv2d (v1, type='DCN', groups=4) has no bias
            DeformConv2d(mid_channels, mid_channels, 3, padding=1, groups=4, dtype=dtype),
            nn.Conv2d(mid_channels, depth_channels, 1, dtype=dtype))

    def forward(self, x, mlp_input):
        mlp_input = camera_embedding(self.bn, mlp_input).to(x.dtype)
        y = self.reduce_conv(x)
        ctx = self.context_conv(self.context_se(y, self.context_mlp(mlp_input)))
        dep = self.depth_se(y, self.depth_mlp(mlp_input))
        return self.depth_conv(dep), ctx


def camera_embedding(bn: BatchNorm1d, mlp_input: torch.Tensor) -> torch.Tensor:
    """The camera embedding through ``bn`` (BatchNorm1d) in float32, whatever
    the autocast (reference :469); in train mode over the batch's cameras."""
    if bn.training:
        return bn(mlp_input.float())
    return F.batch_norm(mlp_input.float(), bn.running_mean.float(), bn.running_var.float(),
                        bn.weight.float(), bn.bias.float(), False, 0.0, bn.eps)


def get_mlp_input(rots, trans, intrins, post_rots, post_trans, bda):
    """Flatten the camera parameters into the DepthNet embedding (reference
    ViewTransformerLSSBEVDepth.py:591-646): nuScenes' 3x3 intrinsics and
    BDA give [B, N, 27]; KITTI's 3x4 P2 adds its shift column (30) and a
    4x4 BDA its translation (33)."""
    B, N = rots.shape[:2]
    bda_tran = bda[:, :3, 3] if bda.shape[-1] == 4 else None
    bda_exp = bda[:, None, :3, :3].expand(B, N, 3, 3)
    feats = [intrins[:, :, 0, 0], intrins[:, :, 1, 1],
             intrins[:, :, 0, 2], intrins[:, :, 1, 2]]
    if intrins.shape[-1] == 4:
        feats += [intrins[:, :, 0, 3], intrins[:, :, 1, 3], intrins[:, :, 2, 3]]
    feats += [
        post_rots[:, :, 0, 0], post_rots[:, :, 0, 1], post_trans[:, :, 0],
        post_rots[:, :, 1, 0], post_rots[:, :, 1, 1], post_trans[:, :, 1],
        bda_exp[:, :, 0, 0], bda_exp[:, :, 0, 1],
        bda_exp[:, :, 1, 0], bda_exp[:, :, 1, 1], bda_exp[:, :, 2, 2],
    ]
    mlp = torch.stack(feats, dim=-1)
    if intrins.shape[-1] == 4 and bda_tran is not None:
        mlp = torch.cat([mlp, bda_tran[:, None].expand(B, N, 3)], dim=-1)
    sensor2ego = torch.cat([rots, trans.reshape(B, N, 3, 1)], dim=-1).reshape(B, N, 12)
    return torch.cat([mlp, sensor2ego], dim=-1)
