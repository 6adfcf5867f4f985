"""Multi-scale deformable-attention gather over 3D pyramids (K1, K1-bwd).

Port of ``occformer_tpu/ops/trilerp_fused.py:fused_multilevel_weighted_gather``
(Pallas bodies ``_wfold_fwd_body`` and ``_wfold_bwd_body``), with the level
sum that ``models/deform_attn.py`` does after the call folded in:

    out[b, q, h] = sum_l sum_p weights[b, q, h, l, p] *
                   trilerp_zeros(V_l[b, :, h], 2 * locs[b, q, h, l, p] - 1)

``ms_deform_gather_3d`` launches the CUDA kernels of
``csrc/ms_deform_gather3d.cu`` for CUDA tensors, through an autograd
``Function`` whose backward is the K1-bwd kernel (d_value, d_locs,
d_weights), and runs the plain version, ``ms_deform_gather_3d_plain``
(``F.grid_sample`` per level plus the weighted sum, differentiated by
autograd), for CPU tensors.  A CUDA tensor never takes the plain version: the
kernel launches or the call raises.  ``LAUNCHES`` and ``BWD_LAUNCHES`` count
the two kernels' launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

# launches of the forward (K1) and backward (K1-bwd) kernels; a caller may
# reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def ms_deform_gather_3d_plain(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int, int]],
    locs: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Plain PyTorch version: one ``F.grid_sample`` per level in float32.

    value [B, Nv, H, hd]; locs [B, Nq, H, L, P, 3] in [0, 1] as (x, y, z);
    weights [B, Nq, H, L, P].  Returns [B, Nq, H, hd] in ``value.dtype``.
    """
    B, Nv, H, hd = value.shape
    Nq, P = locs.shape[1], locs.shape[4]
    out = torch.zeros((B, Nq, H, hd), dtype=torch.float32, device=value.device)
    start = 0
    for l, (X, Y, Z) in enumerate(spatial_shapes):
        n = X * Y * Z
        v = value[:, start:start + n].permute(0, 2, 3, 1).reshape(B * H, hd, X, Y, Z)
        # torch grids index the last spatial axis first: (x, y, z) -> (z, y, x)
        g = (locs[:, :, :, l].float() * 2.0 - 1.0).flip(-1)
        g = g.permute(0, 2, 1, 3, 4).reshape(B * H, Nq, P, 1, 3)
        s = F.grid_sample(v.float(), g, mode="bilinear", padding_mode="zeros",
                          align_corners=False)[..., 0]  # [B*H, hd, Nq, P]
        s = s.reshape(B, H, hd, Nq, P)
        w = weights[:, :, :, l].float().permute(0, 2, 1, 3)  # [B, H, Nq, P]
        out += torch.einsum("bhdqp,bhqp->bqhd", s, w)
        start += n
    return out.to(value.dtype)


def _kernel_fn(name: str):
    """The C entry point ``ms_deform_gather3d_{fwd,bwd}`` with its argtypes."""
    if name not in _FNS:
        fn = getattr(cuda_build.load("ms_deform_gather3d"), name)
        n_ptr = 4 if name.endswith("fwd") else 7
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _levels(spatial_shapes):
    levels, start = [], 0
    for (X, Y, Z) in spatial_shapes:
        levels += [X, Y, Z, start]
        start += X * Y * Z
    return (ctypes.c_int * len(levels))(*levels)


def _check(value, spatial_shapes, locs, weights):
    if value.dim() != 4 or locs.dim() != 6 or weights.dim() != 5:
        raise ValueError("expected value [B, Nv, H, hd], locs [B, Nq, H, L, P, 3], "
                         f"weights [B, Nq, H, L, P]; got {tuple(value.shape)}, "
                         f"{tuple(locs.shape)}, {tuple(weights.shape)}")
    B, Nv, H, hd = value.shape
    L = len(spatial_shapes)
    Nq, P = locs.shape[1], locs.shape[4]
    if tuple(locs.shape) != (B, Nq, H, L, P, 3):
        raise ValueError(f"locs {tuple(locs.shape)} != {(B, Nq, H, L, P, 3)}")
    if tuple(weights.shape) != (B, Nq, H, L, P):
        raise ValueError(f"weights {tuple(weights.shape)} != {(B, Nq, H, L, P)}")
    if Nv != sum(x * y * z for x, y, z in spatial_shapes):
        raise ValueError(f"value has {Nv} rows, levels {list(spatial_shapes)} "
                         f"need {sum(x * y * z for x, y, z in spatial_shapes)}")


def _launch_fwd(value, spatial_shapes, locs, weights):
    global LAUNCHES
    B, Nv, H, hd = value.shape
    Nq, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    out = torch.empty((B, Nq, H, hd), dtype=value.dtype, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = _kernel_fn("ms_deform_gather3d_fwd")(
            value.data_ptr(), locs.data_ptr(), weights.data_ptr(), out.data_ptr(),
            B, Nv, Nq, H, hd, L, P, _levels(spatial_shapes),
            _DTYPE_CODE[value.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_gather3d launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def _launch_bwd(value, spatial_shapes, locs, weights, gout):
    """K1-bwd: (d_value, d_locs, d_weights) in value's, float32 and weights'
    dtypes.  d_value is summed in float32 and cast once, as the Pallas VJP
    does."""
    global BWD_LAUNCHES
    B, Nv, H, hd = value.shape
    Nq, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    gout = gout.to(value.dtype).contiguous()
    d_value = torch.zeros(value.shape, dtype=torch.float32, device=value.device)
    d_locs = torch.empty(locs.shape, dtype=torch.float32, device=value.device)
    d_weights = torch.empty(weights.shape, dtype=torch.float32, device=value.device)
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = _kernel_fn("ms_deform_gather3d_bwd")(
            value.data_ptr(), locs.data_ptr(), weights.data_ptr(), gout.data_ptr(),
            d_value.data_ptr(), d_locs.data_ptr(), d_weights.data_ptr(),
            B, Nv, Nq, H, hd, L, P, _levels(spatial_shapes),
            _DTYPE_CODE[value.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_gather3d_bwd launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    return d_value.to(value.dtype), d_locs, d_weights.to(weights.dtype)


class _Gather(torch.autograd.Function):
    """K1 forward, K1-bwd backward."""

    @staticmethod
    def forward(ctx, value, locs, weights, spatial_shapes):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, locs, weights)
        return _launch_fwd(value, spatial_shapes, locs, weights)

    @staticmethod
    def backward(ctx, gout):
        value, locs, weights = ctx.saved_tensors
        d_value, d_locs, d_weights = _launch_bwd(value, ctx.spatial_shapes, locs,
                                                 weights, gout)
        need = ctx.needs_input_grad
        return (d_value if need[0] else None, d_locs if need[1] else None,
                d_weights if need[2] else None, None)


def ms_deform_gather_3d(
    value: torch.Tensor,
    spatial_shapes: Sequence[Tuple[int, int, int]],
    locs: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """Weighted multi-level trilinear gather, [B, Nq, H, hd] in value's dtype.

    CPU tensors run the plain version.  CUDA tensors run the kernel, which
    takes float32 or bfloat16 ``value`` with ``weights`` of the same dtype,
    float32 ``locs``, all contiguous on one device, and raises on anything
    else.  On CUDA the result is differentiable in all three inputs through
    the K1-bwd kernel.
    """
    spatial_shapes = tuple(tuple(int(s) for s in shp) for shp in spatial_shapes)
    _check(value, spatial_shapes, locs, weights)
    tensors = (value, locs, weights)
    if all(t.device.type == "cpu" for t in tensors):
        return ms_deform_gather_3d_plain(value, spatial_shapes, locs, weights)
    if not all(t.device == value.device and t.is_cuda for t in tensors):
        raise ValueError("value, locs and weights must lie on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if value.dtype not in _DTYPE_CODE or weights.dtype != value.dtype:
        raise TypeError(f"value/weights must both be float32 or bfloat16; got "
                        f"{value.dtype}/{weights.dtype}")
    if locs.dtype != torch.float32:
        raise TypeError(f"locs must be float32; got {locs.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("value, locs and weights must be contiguous")
    return _Gather.apply(value, locs, weights, spatial_shapes)
