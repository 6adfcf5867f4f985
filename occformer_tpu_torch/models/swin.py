"""Swin-style windowed attention block of the dual-path 3D encoder.

Port of ``occformer_tpu/models/swin.py`` (reference
backbones/modules/window_attention.py) with the checkpoint's names:
``norm1``, ``attn.w_msa.{qkv, proj, relative_position_bias_table}`` plus the
``relative_position_index`` buffer, ``norm2``, ``ffn``.  Windows are
reshape/transpose, the cyclic shift is ``torch.roll`` and the shifted-window
region mask is a numpy constant per padded size.  Drop-path (``drop_path1``
after the attention, ``drop_path2`` after the FFN) acts in train mode only.
Tensors are channels-last ``[B, H, W, C]``.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn

from .layers import FFN, DropPath


@lru_cache(maxsize=None)
def relative_position_index(wh: int, ww: int) -> np.ndarray:
    """Pairwise relative-position bias indices [N, N], Swin convention
    (window_attention.py:56-60)."""
    coords = np.stack(np.meshgrid(np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # [2, N, N]
    rel = rel.transpose(1, 2, 0).astype(np.int64)
    rel[..., 0] += wh - 1
    rel[..., 1] += ww - 1
    rel[..., 0] *= 2 * ww - 1
    return rel[..., 0] + rel[..., 1]


@lru_cache(maxsize=None)
def shift_attn_mask(h_pad: int, w_pad: int, window: int, shift: int) -> np.ndarray:
    """SW-MSA region mask: [num_windows, N, N] additive (0 / -100)
    (window_attention.py:185-207)."""
    img = np.zeros((h_pad, w_pad), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    img = img.reshape(h_pad // window, window, w_pad // window, window)
    img = img.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = img[:, None, :] - img[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """[B, H, W, C] -> [B*nWh*nWw, window*window, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // window, window, W // window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window * window, C)


def window_reverse(wins: torch.Tensor, window: int, B: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(B, H // window, W // window, window, window, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


class WindowMSA(nn.Module):
    """W-MSA with relative position bias (window_attention.py:14-113)."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.qkv = nn.Linear(embed_dims, 3 * embed_dims, dtype=dtype)
        self.proj = nn.Linear(embed_dims, embed_dims, dtype=dtype)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads, dtype=dtype))
        self.register_buffer("relative_position_index", torch.from_numpy(
            relative_position_index(window_size, window_size).copy()))

    def forward(self, x, mask=None):
        # x: [B_, N, C], B_ = num_windows * B; mask: [nW, N, N] additive
        B_, N, C = x.shape
        H = self.num_heads
        hd = C // H
        qkv = self.qkv(x).reshape(B_, N, 3, H, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0] * (hd ** -0.5), qkv[1], qkv[2]
        attn = torch.matmul(q, k.transpose(-1, -2))
        bias = self.relative_position_bias_table[self.relative_position_index.reshape(-1)]
        attn = attn + bias.reshape(N, N, H).permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(B_ // nW, nW, H, N, N) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(B_, H, N, N)
        attn = torch.softmax(attn.float(), dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B_, N, C)
        return self.proj(out)


class ShiftWindowMSA(nn.Module):
    """Pad -> (shift) -> window attention -> reverse (window_attention.py:116-274)."""

    def __init__(self, embed_dims: int, num_heads: int, window_size: int = 7,
                 shift_size: int = 0, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.shift_size = shift_size
        self.w_msa = WindowMSA(embed_dims, num_heads, window_size, dtype=dtype)

    def forward(self, x):
        B, H, W, C = x.shape
        w, s = self.window_size, self.shift_size
        pad_b = (w - H % w) % w
        pad_r = (w - W % w) % w
        x = torch.nn.functional.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        Hp, Wp = H + pad_b, W + pad_r
        mask = None
        if s > 0:
            x = torch.roll(x, (-s, -s), dims=(1, 2))
            mask = torch.from_numpy(shift_attn_mask(Hp, Wp, w, s)).to(x.device)
        wins = self.w_msa(window_partition(x, w), mask)
        x = window_reverse(wins, w, B, Hp, Wp)
        if s > 0:
            x = torch.roll(x, (s, s), dims=(1, 2))
        return x[:, :H, :W, :]


class SwinBlock(nn.Module):
    """LN -> (S)W-MSA -> drop-path -> +id -> LN -> FFN -> drop-path -> +id
    (window_attention.py:276-373)."""

    def __init__(self, embed_dims: int, num_heads: int, feedforward_channels: int,
                 window_size: int = 7, shift: bool = False, drop_path_rate: float = 0.0,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dims, dtype=dtype)
        self.attn = ShiftWindowMSA(embed_dims, num_heads, window_size,
                                   shift_size=window_size // 2 if shift else 0,
                                   dtype=dtype)
        self.norm2 = nn.LayerNorm(embed_dims, dtype=dtype)
        self.ffn = FFN(embed_dims, feedforward_channels, add_identity=False, dtype=dtype)
        self.drop_path1 = DropPath(drop_path_rate)
        self.drop_path2 = DropPath(drop_path_rate)

    def forward(self, x, segments: Sequence[int] = (1,)):
        """``segments``: how the leading axis holds the batch
        (``layers.py:DropPath``)."""
        x = x + self.drop_path1(self.attn(self.norm1(x)), segments)
        return x + self.drop_path2(self.ffn(self.norm2(x)), segments)
