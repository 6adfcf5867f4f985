"""ResNet image backbone, torchvision/mmdet layout (channels-first).

Port of ``occformer_tpu/models/resnet.py`` with the reference checkpoint's
names (``conv1``/``bn1``, ``layer{i}.{j}.conv{k}``/``bn{k}``,
``downsample.0/1``), ``style="pytorch"``: the stride sits on the 3x3 conv.
The R50 flagship has no deformable stages; the R101-DCN config's caffe-style
blocks and DCN stages are not ported yet.

Train mode follows mmdet's ``frozen_stages`` / ``norm_eval``:
``frozen_stages = n >= 0`` stops the gradient after the stem (n = 0) or
after ``layer{n}``, so nothing before it is differentiated
(``engine/optim.py:backbone_freeze_mask`` also keeps those parameters
fixed), and, as mmdet's ``_freeze_stages`` does on every ``train()``, puts
the stem's ``bn1`` and every ``layer{i}`` with ``i <= n`` in eval mode: they
normalize with their running statistics and never update them.
``norm_eval`` keeps every BatchNorm on its running statistics while the
model trains.  (The JAX package's ``resnet.py:135-143`` trains the frozen
stages' BatchNorms; parity tests against it use ``frozen_stages=-1``.)
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import BatchNorm2d

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


def _downsample(cin, cout, stride, dtype):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, stride, bias=False, dtype=dtype),
                         BatchNorm2d(cout, dtype=dtype))


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = nn.Conv2d(planes, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.conv3 = nn.Conv2d(planes, planes * 4, 1, bias=False, dtype=dtype)
        self.bn3 = BatchNorm2d(planes * 4, dtype=dtype)
        self.downsample = (_downsample(inplanes, planes * 4, stride, dtype)
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class BasicResBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(planes, dtype=dtype)
        self.downsample = (_downsample(inplanes, planes, stride, dtype)
                           if downsample else None)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = x if self.downsample is None else self.downsample(x)
        return F.relu(y + identity)


class ResNet(nn.Module):
    """[B, 3, H, W] -> tuple of [B, C_i, H/2^(i+2), W/2^(i+2)] for ``out_indices``."""

    def __init__(self, depth: int = 50, out_indices: Sequence[int] = (0, 1, 2, 3),
                 frozen_stages: int = -1, norm_eval: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if block_type == "bottleneck" else BasicResBlock
        self.out_indices = tuple(out_indices)
        self.frozen_stages = int(frozen_stages)
        self.norm_eval = bool(norm_eval)
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(64, dtype=dtype)
        inplanes, planes = 64, 64
        for i, nblocks in enumerate(stage_blocks):
            stride = 1 if i == 0 else 2
            blocks = []
            for j in range(nblocks):
                blocks.append(block_cls(
                    inplanes, planes, stride=stride if j == 0 else 1,
                    downsample=(j == 0 and (stride != 1
                                            or inplanes != planes * block_cls.expansion)),
                    dtype=dtype))
                inplanes = planes * block_cls.expansion
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))
            planes *= 2
        self.num_stages = len(stage_blocks)

    def train(self, mode: bool = True):
        super().train(mode)
        if not mode:
            return self
        if self.norm_eval:
            frozen = [m for m in self.modules() if isinstance(m, nn.BatchNorm2d)]
        else:  # mmdet's _freeze_stages
            frozen = ([self.bn1] if self.frozen_stages >= 0 else []) + [
                getattr(self, f"layer{i}") for i in range(1, self.frozen_stages + 1)]
        for m in frozen:
            m.eval()
        return self

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.max_pool2d(y, 3, 2, 1)
        if self.training and self.frozen_stages == 0:
            y = y.detach()
        outs = []
        for i in range(self.num_stages):
            y = getattr(self, f"layer{i + 1}")(y)
            if self.training and self.frozen_stages == i + 1:
                y = y.detach()
            if i in self.out_indices:
                outs.append(y)
        return tuple(outs)
