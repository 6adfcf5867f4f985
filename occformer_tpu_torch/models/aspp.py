"""GroupNorm ASPP bottleneck for the dual-path encoder's global (BEV) path.

Port of ``occformer_tpu/models/aspp.py`` (reference
backbones/modules/aspp.py:49-171): 1x1 reduce (r=4) -> ASPP with a residual
-> 1x1 expand, outer residual.  The ASPP's group count is halved when the
reduced width does not exceed the group count (aspp.py:150-153).  Dropout is
inference-off.  Channels-first ``[B, C, H, W]``.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from .depthnet import ASPP2D


def _conv_gn_relu(cin, cout, groups, dtype):
    return nn.Sequential(nn.Conv2d(cin, cout, 1, bias=False, dtype=dtype),
                         nn.GroupNorm(groups, cout, dtype=dtype), nn.ReLU())


class BottleNeckASPP(nn.Module):
    def __init__(self, inplanes: int, num_groups: int = 32,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = inplanes // 4
        aspp_groups = num_groups if mid > num_groups else mid // 2

        def gn(c):
            return nn.GroupNorm(aspp_groups, c, dtype=dtype)

        self.input_conv = _conv_gn_relu(inplanes, mid, num_groups, dtype)
        self.aspp = ASPP2D(mid, gn, residual=True, dtype=dtype)
        self.output_conv = _conv_gn_relu(mid, inplanes, num_groups, dtype)

    def forward(self, x):
        return x + self.output_conv(self.aspp(self.input_conv(x)))
