"""EfficientNet (b0-b8 and the edge variants) image backbone.

Port of ``occformer_tpu/models/efficientnet.py`` (reference
backbones/efficientnet.py: the mmcls table and compound scaling, :233-271
``model_scaling``, :308-349 the layer settings), with mmcls's module names, so
that an mmcls classifier's ``backbone.*`` keys and the reference checkpoints'
``img_backbone.*`` keys load unchanged:

* ``layers.0``: the stem ``ConvModule`` (``conv``, ``bn``, Swish);
* ``layers.{1..n}.{j}``: the blocks, ``InvertedResidual`` (``expand_conv``
  where the expand ratio is not 1, ``depthwise_conv``, ``se.conv1`` /
  ``se.conv2``, ``linear_conv``) or ``EdgeResidual`` (``conv1``, ``se``,
  ``conv2``);
* ``layers.{n+1}``: the final 1x1 ``ConvModule``, built when
  ``out_indices`` reaches it.

SemanticKITTI runs b7 with ``out_indices`` (2, 3, 4, 5, 6): strides 4, 8,
16, 32, 32 and channels 48, 80, 224, 640, 2560.  Convolutions pad as
TensorFlow's and flax's "SAME" (mmcls ``Conv2dAdaptivePadding``): at stride
2 the padding is asymmetric, one row and column more after than before where
the total is odd, so it is applied with ``F.pad`` before an unpadded
convolution.  BatchNorm has eps 1e-3 and flax momentum 0.99 (torch 0.01);
the activation is SiLU.  In train mode each residual block drops its branch
per sample (``DropPath``, rates rising linearly to ``drop_path_rate``) and,
with ``with_cp``, recomputes its forward in the backward through
``layers.checkpoint``, which replays the drop-path draws.
"""
from __future__ import annotations

import copy
import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d, DropPath, checkpoint

# block cfg: [kernel, out_channels, se_divisor, stride, expand_ratio, type]
# type: -1 plain conv, 0 inverted residual (MBConv), 1 edge residual
LAYER_SETTINGS = {
    "b": [
        [[3, 32, 0, 2, 0, -1]],
        [[3, 16, 4, 1, 1, 0]],
        [[3, 24, 4, 2, 6, 0], [3, 24, 4, 1, 6, 0]],
        [[5, 40, 4, 2, 6, 0], [5, 40, 4, 1, 6, 0]],
        [[3, 80, 4, 2, 6, 0], [3, 80, 4, 1, 6, 0], [3, 80, 4, 1, 6, 0],
         [5, 112, 4, 1, 6, 0], [5, 112, 4, 1, 6, 0], [5, 112, 4, 1, 6, 0]],
        [[5, 192, 4, 2, 6, 0], [5, 192, 4, 1, 6, 0], [5, 192, 4, 1, 6, 0],
         [5, 192, 4, 1, 6, 0], [3, 320, 4, 1, 6, 0]],
        [[1, 1280, 0, 1, 0, -1]],
    ],
    "e": [
        [[3, 32, 0, 2, 0, -1]],
        [[3, 24, 0, 1, 3, 1]],
        [[3, 32, 0, 2, 8, 1], [3, 32, 0, 1, 8, 1]],
        [[3, 48, 0, 2, 8, 1], [3, 48, 0, 1, 8, 1], [3, 48, 0, 1, 8, 1],
         [3, 48, 0, 1, 8, 1]],
        [[5, 96, 0, 2, 8, 0], [5, 96, 0, 1, 8, 0], [5, 96, 0, 1, 8, 0],
         [5, 96, 0, 1, 8, 0], [5, 96, 0, 1, 8, 0], [5, 144, 0, 1, 8, 0],
         [5, 144, 0, 1, 8, 0], [5, 144, 0, 1, 8, 0], [5, 144, 0, 1, 8, 0]],
        [[5, 192, 0, 2, 8, 0], [5, 192, 0, 1, 8, 0]],
        [[1, 1280, 0, 1, 0, -1]],
    ],
}

# arch -> (width multiplier, depth multiplier)
ARCH_SETTINGS = {
    "b0": (1.0, 1.0), "b1": (1.0, 1.1), "b2": (1.1, 1.2), "b3": (1.2, 1.4),
    "b4": (1.4, 1.8), "b5": (1.6, 2.2), "b6": (1.8, 2.6), "b7": (2.0, 3.1),
    "b8": (2.2, 3.6), "es": (1.0, 1.0), "em": (1.0, 1.1), "el": (1.2, 1.4),
}


def make_divisible(v: float, divisor: int = 8) -> int:
    new_v = max(divisor, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


def scale_layer_settings(layer_setting, width_mult: float, depth_mult: float):
    """Compound scaling (reference ``model_scaling``): widths made divisible
    by 8, the middle stages split where the channel count changes, each part
    deepened by ceil(depth_mult * n) (repeating its last block), and a part
    whose first block has stride 1 merged back into the stage before."""
    setting = copy.deepcopy(layer_setting)
    for layer in setting:
        for block in layer:
            block[1] = make_divisible(block[1] * width_mult, 8)

    split = [setting[0]]
    for layer in setting[1:-1]:
        cuts = [0] + [i + 1 for i in range(len(layer) - 1)
                      if layer[i + 1][1] != layer[i][1]] + [len(layer)]
        split += [layer[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
    split.append(setting[-1])

    counts = [len(l) for l in split[1:-1]]
    new_counts = [int(math.ceil(depth_mult * n)) for n in counts]
    merged = [split[0]]
    for i, layer in enumerate(split[1:-1]):
        if new_counts[i] <= counts[i]:
            grp = layer[: new_counts[i]]
        else:
            grp = copy.deepcopy(layer) + [layer[-1]] * (new_counts[i] - counts[i])
        if grp[0][3] == 1 and i != 0:
            merged[-1] = merged[-1] + copy.deepcopy(grp)
        else:
            merged.append(copy.deepcopy(grp))
    merged.append(split[-1])
    return merged


def same_padding(size: int, kernel: int, stride: int):
    """(before, after) padding of one axis under "SAME": the output is
    ceil(size / stride) long."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class ConvModule(nn.Module):
    """mmcv's ``ConvModule`` as mmcls's EfficientNet builds it: ``conv``
    with "SAME" padding, then optionally ``bn`` and SiLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 1, stride: int = 1,
                 groups: int = 1, bias: bool = False, norm: bool = True, act: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.kernel, self.stride = kernel, stride
        # stride 1 at an odd kernel pads symmetrically: inside the convolution
        pad = (kernel - 1) // 2 if stride == 1 else 0
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, groups=groups, bias=bias,
                              dtype=dtype)
        self.bn = BatchNorm2d(cout, eps=1e-3, momentum=0.01, dtype=dtype) if norm else None
        self.act = act

    def forward(self, x):
        if self.stride != 1:
            ph = same_padding(x.shape[-2], self.kernel, self.stride)
            pw = same_padding(x.shape[-1], self.kernel, self.stride)
            x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.silu(x) if self.act else x


class SELayer(nn.Module):
    """Squeeze-excite: the spatial mean, ``conv1`` (SiLU), ``conv2``
    (sigmoid), scaling the input's channels."""

    def __init__(self, channels: int, squeeze: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = ConvModule(channels, squeeze, bias=True, norm=False, dtype=dtype)
        self.conv2 = ConvModule(squeeze, channels, bias=True, norm=False, act=False,
                                dtype=dtype)

    def forward(self, x):
        g = self.conv2(self.conv1(x.mean(dim=(2, 3), keepdim=True)))
        return x * torch.sigmoid(g)


class InvertedResidual(nn.Module):
    """MBConv: expand 1x1 -> depthwise kxk -> SE -> project 1x1, and the
    residual add (with drop path) where the shape is kept."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand_ratio: int,
                 se_divisor: float, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = int(cin * expand_ratio)
        self.expand_conv = (ConvModule(cin, mid, dtype=dtype) if expand_ratio != 1
                            else None)
        self.depthwise_conv = ConvModule(mid, mid, kernel, stride, groups=mid, dtype=dtype)
        self.se = (SELayer(mid, int(mid / (se_divisor * expand_ratio)), dtype=dtype)
                   if se_divisor > 0 else None)
        self.linear_conv = ConvModule(mid, cout, act=False, dtype=dtype)
        self.residual = stride == 1 and cin == cout
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        y = x if self.expand_conv is None else self.expand_conv(x)
        y = self.depthwise_conv(y)
        if self.se is not None:
            y = self.se(y)
        y = self.linear_conv(y)
        return self.drop_path(y) + x if self.residual else y


class EdgeResidual(nn.Module):
    """Edge-TPU residual: fused expand kxk -> SE -> project 1x1."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, expand_ratio: int,
                 se_divisor: float, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = int(cin * expand_ratio)
        self.conv1 = ConvModule(cin, mid, kernel, stride, dtype=dtype)
        self.se = (SELayer(mid, int(mid / (se_divisor * expand_ratio)), dtype=dtype)
                   if se_divisor > 0 else None)
        self.conv2 = ConvModule(mid, cout, act=False, dtype=dtype)
        self.residual = stride == 1 and cin == cout
        self.drop_path = DropPath(drop_path)

    def forward(self, x):
        y = self.conv1(x)
        if self.se is not None:
            y = self.se(y)
        y = self.conv2(y)
        return self.drop_path(y) + x if self.residual else y


class CustomEfficientNet(nn.Module):
    """``forward(x [B, 3, H, W])`` -> the feature maps of ``out_indices``
    (1..n the block stages, n + 1 the final 1x1 convolution), channels
    first.  The config's ``frozen_stages=0`` and ``norm_eval=False`` freeze
    nothing; the JAX package reads neither."""

    def __init__(self, arch: str = "b0", out_indices: Sequence[int] = (6,),
                 drop_path_rate: float = 0.0, with_cp: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        width, depth = ARCH_SETTINGS[arch]
        setting = scale_layer_settings(LAYER_SETTINGS[arch[:1]], width, depth)
        self.out_indices = tuple(out_indices)
        self.with_cp = with_cp
        stem, final = setting[0][0], setting[-1][0]
        cin = make_divisible(stem[1], 8)
        self.layers = nn.ModuleList([ConvModule(3, cin, stem[0], stem[3], dtype=dtype)])
        total = sum(len(l) for l in setting[1:-1])
        rates = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        i = 0
        for layer in setting[1:-1]:
            blocks = nn.ModuleList()
            for k, oc, se, s, e, btype in layer:
                cls = InvertedResidual if btype == 0 else EdgeResidual
                blocks.append(cls(cin, oc, k, s, e, se, rates[i], dtype=dtype))
                cin = oc
                i += 1
            self.layers.append(blocks)
        self.n_stages = len(setting) - 2
        if max(self.out_indices) > self.n_stages:
            self.layers.append(ConvModule(cin, final[1], final[0], final[3], dtype=dtype))

    def forward(self, x):
        x = self.layers[0](x)
        outs = []
        for li in range(1, self.n_stages + 1):
            for block in self.layers[li]:
                if self.with_cp and self.training and torch.is_grad_enabled():
                    x = checkpoint(block, x)
                else:
                    x = block(x)
            if li in self.out_indices:
                outs.append(x)
        if len(self.layers) > self.n_stages + 1:
            outs.append(self.layers[-1](x))
        return tuple(outs)
