"""Bilinear / trilinear sampling and resizing on ``F.grid_sample`` /
``F.interpolate``.

Port of ``occformer_tpu/ops/sampling.py`` with its conventions kept at the
public functions: volumes are channels-last ``[B, X, Y, Z, C]``, images
``[B, H, W, C]``, and ``coords[..., i]`` indexes spatial axis ``i`` in order,
normalized to [-1, 1] with torch's ``align_corners`` mapping.  Torch grids
run in the reverse order (the last grid component indexes the last spatial
axis), so each call flips the coordinate triple or pair.  The lerp runs in
float32 and the result comes back in the input's dtype.  ``point_sample_3d``,
the loss's point readout, goes through K2 (``ops/trilerp.py``).
``resize_trilinear``'s backward is the separable adjoint of the resize, three
matrix products with the 1-D interpolation matrices, which repeats itself bit
for bit; ``F.interpolate``'s own backward adds with atomics on the card, in
an order that changes from run to run (it fed the deformable encoder's
gradients, ROADMAP C.6).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ..utils import flops
from .trilerp import trilerp_sample


def grid_sample_3d(
    vol: torch.Tensor,
    coords: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Trilinear sampling of ``vol [B, X, Y, Z, C]`` at ``coords [B, ..., 3]``
    (x, y, z) in [-1, 1].  Returns ``[B, ..., C]``."""
    B, X, Y, Z, C = vol.shape
    batch_shape = coords.shape[1:-1]
    grid = coords.reshape(B, -1, 1, 1, 3).flip(-1).float()
    v = vol.permute(0, 4, 1, 2, 3).float()  # [B, C, X, Y, Z]
    out = F.grid_sample(v, grid, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)  # [B, C, S, 1, 1]
    out = out[..., 0, 0].transpose(1, 2)
    out_dtype = vol.dtype if vol.is_floating_point() else torch.float32
    return out.to(out_dtype).reshape(B, *batch_shape, C)


def point_sample_3d(
    vol: torch.Tensor,
    points: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Sample ``vol [B, X, Y, Z, C]`` at [0, 1]-normalized ``points [B, P, 3]``
    (x, y, z) -> ``[B, P, C]`` (reference mmdet_utils.py:21-47 maps [0, 1] to
    [-1, 1]).  Through K2 for CUDA tensors; a bool volume reads as 0/1 and
    gives float32."""
    coords = (points.float() * 2.0 - 1.0).contiguous()
    return trilerp_sample(vol, coords, align_corners, padding_mode)


def grid_sample_2d(
    img: torch.Tensor,
    coords: torch.Tensor,
    align_corners: bool = False,
    padding_mode: str = "zeros",
) -> torch.Tensor:
    """Bilinear sampling of ``img [B, H, W, C]`` at ``coords [B, ..., 2]``
    (coords[..., 0] indexes H, coords[..., 1] indexes W)."""
    B, H, W, C = img.shape
    batch_shape = coords.shape[1:-1]
    grid = coords.reshape(B, -1, 1, 2).flip(-1).float()
    out = F.grid_sample(img.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
                        padding_mode=padding_mode, align_corners=align_corners)
    return out[..., 0].transpose(1, 2).to(img.dtype).reshape(B, *batch_shape, C)


_INTERP = {}


def _interp_matrix(n_in: int, n_out: int, align_corners: bool, device) -> torch.Tensor:
    """[n_out, n_in] float32: row i holds the two lerp weights with which
    ``F.interpolate(mode="trilinear")`` reads output i along one axis (source
    index ``scale * i`` with align_corners, else ``scale * (i + 0.5) - 0.5``
    clamped at 0; the upper neighbour clamped to the last input)."""
    key = (n_in, n_out, align_corners, str(device))
    if key not in _INTERP:
        i = torch.arange(n_out, dtype=torch.float32)
        if align_corners:
            src = i * ((n_in - 1) / (n_out - 1) if n_out > 1 else 0.0)
        else:
            src = ((i + 0.5) * (n_in / n_out) - 0.5).clamp(min=0.0)
        lo = src.long().clamp(max=n_in - 1)
        hi = (lo + 1).clamp(max=n_in - 1)
        w_hi = src - lo.float()
        m = torch.zeros(n_out, n_in)
        rows = torch.arange(n_out)
        m.index_put_((rows, lo), 1.0 - w_hi, accumulate=True)
        m.index_put_((rows, hi), w_hi, accumulate=True)
        _INTERP[key] = m.to(device)
    return _INTERP[key]


class _TrilinearResize(torch.autograd.Function):
    """``F.interpolate(mode="trilinear")`` on ``[B, C, X, Y, Z]`` float32;
    its backward contracts the gradient with the three axes' interpolation
    matrices (z, then y, then x), matrix products in a fixed order, which
    the analytic count (``utils/flops.py``) holds out: an interpolation's
    backward, elementwise in the JAX package, not a product of the model."""

    @staticmethod
    def forward(ctx, x, size, align_corners):
        ctx.in_size, ctx.align_corners = tuple(x.shape[2:]), align_corners
        return F.interpolate(x, size=size, mode="trilinear", align_corners=align_corners)

    @staticmethod
    def backward(ctx, g):
        with flops.uncounted():
            mx, my, mz = (_interp_matrix(n, m, ctx.align_corners, g.device)
                          for n, m in zip(ctx.in_size, g.shape[2:]))
            g = torch.einsum("bcijk,kz->bcijz", g, mz)
            g = torch.einsum("bcijz,jy->bciyz", g, my)
            g = torch.einsum("bciyz,ix->bcxyz", g, mx)
        return g.contiguous(), None, None


def resize_trilinear(
    vol: torch.Tensor, size: Tuple[int, int, int], align_corners: bool = False
) -> torch.Tensor:
    """Trilinear resize of ``[B, X, Y, Z, C]`` (torch ``F.interpolate``; the
    backward through ``_TrilinearResize``)."""
    out = _TrilinearResize.apply(vol.permute(0, 4, 1, 2, 3).float(),
                                 tuple(int(s) for s in size), align_corners)
    return out.permute(0, 2, 3, 4, 1).to(vol.dtype)
