"""ResNet image backbone, torchvision/mmdet layout (channels-first).

Port of ``occformer_tpu/models/resnet.py`` with the reference checkpoint's
names (``conv1``/``bn1``, ``layer{i}.{j}.conv{k}``/``bn{k}``,
``downsample.0/1``).  ``style="pytorch"`` (the flagship's) puts a block's
stride on its 3x3 conv; ``style="caffe"`` (the FCOS3D-pretrained R101-DCN)
on its first 1x1, the 3x3 keeping stride 1 (mmdet's ``Bottleneck``; a basic
block has no 1x1 and ignores it).  In the stages ``dcn_stages`` names
(0-based; mmdet's ``stage_with_dcn``) each block's ``conv2`` is a DCNv2
(``models/dcn.py:DeformConv2d`` with ``modulated=True``, mmcv's
``ModulatedDeformConv2dPack``: ``conv2.weight``, ``conv2.conv_offset``).

Train mode follows mmdet's ``frozen_stages`` / ``norm_eval`` / ``with_cp``:
``frozen_stages = n >= 0`` runs the stem (n = 0) and ``layer1`` ..
``layer{n}`` without gradient, so nothing before the boundary is
differentiated or kept for the backward (``engine/optim.py:
backbone_freeze_mask`` also keeps those parameters fixed), and, as mmdet's
``_freeze_stages`` does on every ``train()``, puts the stem's ``bn1`` and
every ``layer{i}`` with ``i <= n`` in eval mode: they normalize with their
running statistics and never update them.  ``norm_eval`` keeps every
BatchNorm on its running statistics while the model trains.  ``with_cp``
recomputes each trained block's forward in the backward
(``layers.checkpoint``): only the blocks' inputs stay alive.  The JAX
package nests a per-stage remat around the per-block one to fit a TPU's
memory; the numbers are the same, and on an 80 GB card per block is enough
(PERF.md).  (The JAX package's ``resnet.py:135-143`` trains the frozen
stages' BatchNorms unless ``norm_eval``; parity tests against it use
``frozen_stages=-1`` or ``norm_eval``.)
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .dcn import DeformConv2d
from .layers import BatchNorm2d, checkpoint

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


def _conv3x3(planes, stride, with_dcn, dtype):
    if with_dcn:
        return DeformConv2d(planes, planes, 3, stride=stride, padding=1, modulated=True,
                            dtype=dtype)
    return nn.Conv2d(planes, planes, 3, stride, 1, bias=False, dtype=dtype)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 downsample: bool = False, with_dcn: bool = False, style: str = "pytorch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        c1_stride, c2_stride = (stride, 1) if style == "caffe" else (1, stride)
        self.conv1 = nn.Conv2d(inplanes, planes, 1, c1_stride, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = _conv3x3(planes, c2_stride, with_dcn, dtype)
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
                 downsample: bool = False, with_dcn: bool = False, style: str = "pytorch",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(inplanes, planes, 3, stride, 1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(planes, dtype=dtype)
        self.conv2 = _conv3x3(planes, 1, with_dcn, dtype)  # mmdet: the DCN on the second 3x3
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
                 frozen_stages: int = -1, norm_eval: bool = False, style: str = "pytorch",
                 dcn_stages: Sequence[int] = (), with_cp: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if style not in ("pytorch", "caffe"):
            raise ValueError(f"style must be 'pytorch' or 'caffe'; got {style!r}")
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        block_cls = Bottleneck if block_type == "bottleneck" else BasicResBlock
        self.out_indices = tuple(out_indices)
        self.frozen_stages = int(frozen_stages)
        self.norm_eval = bool(norm_eval)
        self.with_cp = bool(with_cp)
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
                    with_dcn=i in dcn_stages, style=style, dtype=dtype))
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

    def _stage(self, i, y):
        blocks = getattr(self, f"layer{i + 1}")
        if not (self.with_cp and self.training and torch.is_grad_enabled()):
            return blocks(y)
        for block in blocks:
            y = checkpoint(block, y)
        return y

    def forward(self, x):
        grad = torch.is_grad_enabled()
        # in training, the frozen stem and stages run without gradient
        with torch.set_grad_enabled(grad and not (self.training and self.frozen_stages >= 0)):
            y = F.relu(self.bn1(self.conv1(x)))
            y = F.max_pool2d(y, 3, 2, 1)
        outs = []
        for i in range(self.num_stages):
            with torch.set_grad_enabled(grad and not (self.training
                                                      and i < self.frozen_stages)):
                y = self._stage(i, y)
            if i in self.out_indices:
                outs.append(y)
        return tuple(outs)
