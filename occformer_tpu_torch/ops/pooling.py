"""Adaptive 3D max pooling ("preserve pooling" of the occupancy head).

Port of ``occformer_tpu/ops/pooling.py``.  The JAX version implements
torch's bins, ``start = floor(i * n / out)`` and ``end = ceil((i + 1) * n /
out)``, by hand (a strided window when ``n`` divides evenly, a masked union
window otherwise); ``F.adaptive_max_pool3d`` uses the same bins, so the port
calls it directly.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def adaptive_max_pool3d(x: torch.Tensor, out_size: Tuple[int, int, int]) -> torch.Tensor:
    """Adaptive 3D max pool over a channels-last volume ``[B, X, Y, Z, C]``."""
    out = F.adaptive_max_pool3d(x.permute(0, 4, 1, 2, 3),
                                tuple(int(s) for s in out_size))
    return out.permute(0, 2, 3, 4, 1)
