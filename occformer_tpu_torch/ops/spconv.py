"""Sparse 3D convolution over fixed-capacity active sites.

Port of ``occformer_tpu/ops/spconv.py`` in plain PyTorch.  Active sites
live in fixed-capacity buffers (features [N, C], integer coords [N, 3],
validity [N]), so shapes stay static.  Two backends share one parameter
layout (an ``nn.Conv3d``'s ``conv.weight`` [D, C, k, k, k] and
``conv.bias``), so a checkpoint swaps between them:

* ``backend="dense"``: densify -> ``F.conv3d`` -> sparsify.  The dense
  intermediate is [C, X, Y, Z]: fine at occupancy grids (128 x 128 x 16),
  not at SECOND's detection grid (1408 x 1600 x 41).
* ``backend="gather"``: the sparse gather-GEMM.  Each output site's K input
  taps are found by one sort of the active linear coords and a binary
  search (``torch.searchsorted``), never a dense table, and the conv is one
  [N, K*C] @ [K*C, D] product over the gathered taps: memory scales with
  the active set, not the grid.

The strided conv's output sites are the output cells whose receptive field
holds an active input, in ascending linear index, at most
``max_out_sites`` of them: on overflow the lowest linear indices are kept
(the JAX package's rule, taken here from the sorted indices themselves
rather than from its ``-1e-9 * arange`` top-k score).  Padding slots are
invalid, with coords (0, 0, 0) and zero features.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F


def _lin(coords: torch.Tensor, grid: Sequence[int]) -> torch.Tensor:
    _, Y, Z = (int(g) for g in grid)
    c = coords.long()
    return (c[..., 0] * Y + c[..., 1]) * Z + c[..., 2]


def densify(features: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
            grid: Sequence[int]) -> torch.Tensor:
    """Scatter active sites into a dense [X, Y, Z, C] grid (coords are
    unique where valid)."""
    X, Y, Z = (int(g) for g in grid)
    C = features.shape[-1]
    n = X * Y * Z
    lin = torch.where(valid, _lin(coords, grid), torch.full_like(valid, n, dtype=torch.int64))
    dense = features.new_zeros((n + 1, C))
    dense = dense.index_put((lin,), torch.where(valid[:, None], features,
                                                torch.zeros_like(features)))
    return dense[:-1].reshape(X, Y, Z, C)


def sparsify(dense: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Gather features back at the active coords: [X, Y, Z, C] -> [N, C]."""
    X, Y, Z, C = dense.shape
    lin = _lin(coords, (X, Y, Z)).clamp(0, X * Y * Z - 1)
    out = dense.reshape(-1, C)[lin]
    return torch.where(valid[:, None], out, torch.zeros_like(out))


def lookup_sites(coords: torch.Tensor, valid: torch.Tensor, grid: Sequence[int],
                 query: torch.Tensor, query_ok: torch.Tensor) -> torch.Tensor:
    """Index (int64) of the active site at each query coord [..., 3], or -1.

    spconv's indice-pair lookup: one sort of the active linear coords, then a
    binary search per query (``torch.searchsorted``); no dense [X*Y*Z]
    table.  Linear indices are int64, so any grid fits."""
    X, Y, Z = (int(g) for g in grid)
    n_cells = X * Y * Z
    # invalid sites sort to n_cells and queries that resolve nothing use
    # n_cells + 1, so neither can match the other
    lin = torch.where(valid, _lin(coords, grid), torch.full_like(valid, n_cells,
                                                                 dtype=torch.int64))
    lin_sorted, order = torch.sort(lin)
    hi = torch.tensor([X, Y, Z], device=query.device)
    inb = ((query >= 0) & (query < hi)).all(-1)
    qlin = torch.where(query_ok & inb, _lin(torch.minimum(query.clamp(min=0), hi - 1), grid),
                       torch.full_like(inb, n_cells + 1, dtype=torch.int64))
    pos = torch.searchsorted(lin_sorted, qlin.reshape(-1)).reshape(qlin.shape)
    pos = pos.clamp(0, coords.shape[0] - 1)
    return torch.where(lin_sorted[pos] == qlin, order[pos], torch.full_like(pos, -1))


def _taps(kernel_size: int, device=None) -> torch.Tensor:
    """Kernel tap offsets [K, 3] in the row-major (tx, ty, tz) order of a
    conv weight's (kx, ky, kz) axes: tap t reads the input at ``out_pos *
    stride - (k - 1) // 2 + t``."""
    r = torch.arange(kernel_size, device=device)
    tx, ty, tz = torch.meshgrid(r, r, r, indexing="ij")
    return torch.stack([tx, ty, tz], -1).reshape(-1, 3)


def build_neighbor_table(coords: torch.Tensor, valid: torch.Tensor, grid: Sequence[int],
                         kernel_size: int) -> torch.Tensor:
    """[N, K] index of the active site at each stride-1 kernel tap, or -1:
    spconv's cached indice pairs, which a stack of submanifold convs over
    one active set may build once and pass to each (``nbr=``)."""
    taps = _taps(kernel_size, coords.device) - (kernel_size - 1) // 2
    return lookup_sites(coords, valid, grid, coords.long()[:, None, :] + taps[None],
                        valid[:, None])


def _tap_gemm(conv: nn.Conv3d, feats: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """The gathered taps [N, K, C] of each site times the conv's kernel as
    one [N, K*C] @ [K*C, D] product (plus the bias)."""
    D, C = conv.weight.shape[:2]
    g = feats[nbr.clamp(min=0)] * (nbr >= 0)[..., None].to(feats.dtype)
    w = conv.weight.permute(2, 3, 4, 1, 0).reshape(-1, D).to(feats.dtype)
    out = g.reshape(g.shape[0], -1) @ w
    return out if conv.bias is None else out + conv.bias.to(out.dtype)


class _SparseConvBase(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, kernel_size: int, stride: int,
                 bias: bool, backend: str, dtype: torch.dtype):
        super().__init__()
        if backend not in ("dense", "gather"):
            raise ValueError(f"backend {backend!r}: 'dense' or 'gather'")
        self.backend = backend
        self.kernel_size, self.stride = kernel_size, stride
        self.padding = (kernel_size - 1) // 2  # torch-style symmetric padding
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, stride, self.padding,
                              bias=bias, dtype=dtype)

    def _dense_conv(self, feats, coords, valid, grid):
        dense = densify(feats, coords, valid, grid).permute(3, 0, 1, 2)[None]
        return self.conv(dense.to(self.conv.weight.dtype))[0].permute(1, 2, 3, 0)


class SubMConv3d(_SparseConvBase):
    """Submanifold sparse conv (spconv SubMConv3d): outputs only at the
    input's active sites, so the active set never grows.  forward(feats [N,
    C], coords [N, 3], valid [N], grid, nbr=None) -> (out [N, D], coords,
    valid); ``nbr`` a ``build_neighbor_table`` for the gather backend."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 bias: bool = False, backend: str = "dense",
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, 1, bias, backend, dtype)

    def forward(self, feats, coords, valid, grid, nbr=None):
        if self.backend == "gather":
            if nbr is None:
                nbr = build_neighbor_table(coords, valid, grid, self.kernel_size)
            out = _tap_gemm(self.conv, feats, nbr)
            return torch.where(valid[:, None], out, torch.zeros_like(out)), coords, valid
        return sparsify(self._dense_conv(feats, coords, valid, grid), coords, valid), \
            coords, valid


class SparseConv3d(_SparseConvBase):
    """Strided sparse conv (spconv SparseConv3d): the output's active set is
    every output cell whose receptive field holds an active input, lowest
    linear index first, at most ``max_out_sites``.  forward(feats, coords,
    valid, grid) -> (out [cap, D], new coords [cap, 3] int32, new valid
    [cap], out grid), cap = min(max_out_sites, output cells)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 stride: int = 2, max_out_sites: int = 20000, bias: bool = False,
                 backend: str = "dense", dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride, bias, backend, dtype)
        self.max_out_sites = max_out_sites

    def _sites(self, out_lin, out_grid, n_out_cells):
        """The lowest ``cap`` of the ascending unique output cells, padded
        with invalid (0, 0, 0) slots."""
        cap = min(self.max_out_sites, n_out_cells)
        out_lin = out_lin[:cap]
        n = out_lin.shape[0]
        new_valid = torch.zeros(cap, dtype=torch.bool, device=out_lin.device)
        new_valid[:n] = True
        lin = torch.zeros(cap, dtype=torch.int64, device=out_lin.device)
        lin[:n] = out_lin
        _, oY, oZ = out_grid
        coords = torch.stack([lin // (oY * oZ), (lin // oZ) % oY, lin % oZ], -1)
        return lin, coords.to(torch.int32), new_valid

    def forward(self, feats, coords, valid, grid):
        k, s, p = self.kernel_size, self.stride, self.padding
        out_grid = tuple((int(d) + 2 * p - k) // s + 1 for d in grid)
        n_out_cells = math.prod(out_grid)
        if self.backend == "gather":
            return self._gather(feats, coords, valid, grid, out_grid, n_out_cells)
        out = self._dense_conv(feats, coords, valid, grid)  # [oX, oY, oZ, D]
        assert tuple(out.shape[:3]) == out_grid, (out.shape, out_grid)
        occ = densify(valid[:, None].float(), coords, valid, grid)[..., 0]
        occ_out = F.max_pool3d(occ[None, None], k, s, padding=p)[0, 0]
        lin, new_coords, new_valid = self._sites(
            torch.nonzero(occ_out.reshape(-1) > 0)[:, 0], out_grid, n_out_cells)
        new_feats = out.reshape(-1, out.shape[-1])[lin]
        new_feats = torch.where(new_valid[:, None], new_feats, torch.zeros_like(new_feats))
        return new_feats, new_coords, new_valid, out_grid

    def _gather(self, feats, coords, valid, grid, out_grid, n_out_cells):
        """Grid-free strided conv: the candidate output cells of every
        active input's taps, sorted and deduplicated, their input taps found
        by binary search, the conv one gathered GEMM."""
        k, s, p = self.kernel_size, self.stride, self.padding
        taps = _taps(k, feats.device)  # output o reads input o * s - p + t
        cand = coords.long()[:, None, :] + p - taps[None]  # [N, K, 3]
        o = torch.div(cand, s, rounding_mode="floor")
        hi = torch.tensor(out_grid, device=feats.device)
        ok = (valid[:, None] & (cand == o * s).all(-1)
              & ((o >= 0) & (o < hi)).all(-1))
        out_lin = torch.unique(_lin(o, out_grid)[ok])  # sorted ascending
        lin, new_coords, new_valid = self._sites(out_lin, out_grid, n_out_cells)
        q = new_coords.long()[:, None, :] * s - p + taps[None]  # [cap, K, 3]
        nbr = lookup_sites(coords, valid, grid, q, new_valid[:, None])
        out = _tap_gemm(self.conv, feats, nbr)
        out = torch.where(new_valid[:, None], out, torch.zeros_like(out))
        return out, new_coords, new_valid, out_grid


def sparse_max_pool(feats, coords, valid, grid, kernel: int = 2, stride: int = 2):
    """Sparse max pooling: densify, a max over each window with exact zeros
    (empty cells) left out, then the pooled value at each active site's
    pooled coords.  -> (out [N, C], coords // stride, valid, grid //
    stride)."""
    X, Y, Z = (int(g) for g in grid)
    dense = densify(feats, coords, valid, grid)
    neg = torch.finfo(dense.dtype).min
    masked = torch.where(dense == 0, torch.full_like(dense, neg), dense)
    pooled = F.max_pool3d(masked.permute(3, 0, 1, 2)[None], kernel, stride)[0]
    pooled = pooled.permute(1, 2, 3, 0)
    pooled = torch.where(pooled == neg, torch.zeros_like(pooled), pooled)
    new_coords = torch.div(coords, stride, rounding_mode="floor")
    new_grid = (X // stride, Y // stride, Z // stride)
    return sparsify(pooled, new_coords, valid), new_coords, valid, new_grid


def assign_score_withk(scores: torch.Tensor, point_feats: torch.Tensor,
                       center_feats: torch.Tensor, aggregate: str = "sum") -> torch.Tensor:
    """PAConv weighted kernel assembly (mmdet3d ops/paconv
    assign_score_withk): out[b, n, k] = aggregate over m of scores[b, n, k,
    m] * (point_feats - center_feats)[b, n, k, m]."""
    out = scores[..., None] * (point_feats - center_feats)
    if aggregate == "sum":
        return out.sum(3)
    if aggregate == "avg":
        return out.mean(3)
    if aggregate == "max":
        return out.max(3).values
    raise ValueError(aggregate)

