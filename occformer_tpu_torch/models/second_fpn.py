"""SECONDFPN image neck: per-scale resize to a common stride, then concat.

Port of ``occformer_tpu/models/second_fpn.py`` (reference mmdetection3d
necks/second_fpn.py:12-100).  Each level gets a transposed conv (stride >= 1)
or a strided conv (fractional stride), then BN (eps 1e-3, momentum 0.01) and
ReLU, as ``deblocks.{i}.{0,1}``.  Channels-first.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .layers import BatchNorm2d


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int] = (128, 128, 256),
                 out_channels: Sequence[int] = (256, 256, 256),
                 upsample_strides: Sequence[float] = (1, 2, 4),
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.deblocks = nn.ModuleList()
        for cin, cout, s in zip(in_channels, out_channels, upsample_strides):
            if s >= 1:
                k = int(np.round(s))
                up = nn.ConvTranspose2d(cin, cout, k, stride=k, bias=False, dtype=dtype)
            else:
                k = int(np.round(1 / s))
                up = nn.Conv2d(cin, cout, k, stride=k, bias=False, dtype=dtype)
            self.deblocks.append(nn.Sequential(
                up, BatchNorm2d(cout, eps=1e-3, momentum=0.01, dtype=dtype),
                nn.ReLU()))

    def forward(self, feats):
        ups = [d(x) for d, x in zip(self.deblocks, feats)]
        return torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
