"""3-axis sine/cosine positional encoding for voxel volumes.

Reference: projects/mmdet3d_plugin/occformer/mask2former/positional_encodings/positional_encoding.py:12-118.
The port's copy of ``occformer_tpu/models/pos_embed.py`` (numpy only).
OccFormer never pads voxel volumes, so the cumsum-of-ones reduces to a pure
function of the (static) shape, computed once per shape on the host.
"""
from __future__ import annotations

import math
from functools import lru_cache
from typing import Tuple

import numpy as np


@lru_cache(maxsize=None)
def sine_positional_encoding_3d(
    shape: Tuple[int, int, int],
    num_feats: int,
    temperature: float = 10000.0,
    normalize: bool = True,
    scale: float = 2 * math.pi,
    eps: float = 1e-6,
    offset: float = 0.0,
) -> np.ndarray:
    """Return ``[X, Y, Z, 3 * num_feats]`` position embedding (numpy constant).

    Bit-equivalent to the reference's all-valid-mask path: ``*_embed`` is the
    1-based index along each axis, normalized by the axis length.
    """
    X, Y, Z = shape
    x_embed = np.arange(1, X + 1, dtype=np.float32)
    y_embed = np.arange(1, Y + 1, dtype=np.float32)
    z_embed = np.arange(1, Z + 1, dtype=np.float32)
    if normalize:
        x_embed = (x_embed + offset) / (x_embed[-1] + eps) * scale
        y_embed = (y_embed + offset) / (y_embed[-1] + eps) * scale
        z_embed = (z_embed + offset) / (z_embed[-1] + eps) * scale

    dim_t = np.arange(num_feats, dtype=np.float32)
    dim_t = temperature ** (2 * (dim_t // 2) / num_feats)

    def interleave(embed):  # [L] -> [L, num_feats], sin on even, cos on odd
        pos = embed[:, None] / dim_t[None, :]
        out = np.empty((embed.shape[0], num_feats), np.float32)
        out[:, 0::2] = np.sin(pos[:, 0::2])
        out[:, 1::2] = np.cos(pos[:, 1::2])
        # reference stacks (sin(even), cos(odd)) then flattens, which
        # interleaves them back into [sin0, cos1, sin2, cos3, ...]
        return out

    px = interleave(x_embed)[:, None, None, :]
    py = interleave(y_embed)[None, :, None, :]
    pz = interleave(z_embed)[None, None, :, :]
    pos = np.concatenate(
        [
            np.broadcast_to(px, (X, Y, Z, num_feats)),
            np.broadcast_to(py, (X, Y, Z, num_feats)),
            np.broadcast_to(pz, (X, Y, Z, num_feats)),
        ],
        axis=-1,
    )
    return pos
