"""Multi-scale deformable-attention gather over 3D pyramids (K1).

Port of ``occformer_tpu/ops/trilerp_fused.py:fused_multilevel_weighted_gather``
(Pallas body ``_wfold_fwd_body``), with the level sum that
``models/deform_attn.py`` does after the call folded in:

    out[b, q, h] = sum_l sum_p weights[b, q, h, l, p] *
                   trilerp_zeros(V_l[b, :, h], 2 * locs[b, q, h, l, p] - 1)

``ms_deform_gather_3d`` launches the CUDA kernel
``csrc/ms_deform_gather3d.cu`` for CUDA tensors and runs the plain version,
``ms_deform_gather_3d_plain`` (``F.grid_sample`` per level plus the weighted
sum), for CPU tensors.  A CUDA tensor never takes the plain version: the
kernel launches or the call raises.  ``LAUNCHES`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

# kernel launches made by ms_deform_gather_3d (a caller may reset it to 0)
LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FN = None


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


def _kernel_fn():
    global _FN
    if _FN is None:
        fn = cuda_build.load("ms_deform_gather3d").ms_deform_gather3d_fwd
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int), ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FN = fn
    return _FN


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
    else.
    """
    global LAUNCHES
    spatial_shapes = [tuple(int(s) for s in shp) for shp in spatial_shapes]
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

    B, Nv, H, hd = value.shape
    Nq, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    levels, start = [], 0
    for (X, Y, Z) in spatial_shapes:
        levels += [X, Y, Z, start]
        start += X * Y * Z
    out = torch.empty((B, Nq, H, hd), dtype=value.dtype, device=value.device)
    fn = _kernel_fn()
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        rc = fn(value.data_ptr(), locs.data_ptr(), weights.data_ptr(),
                out.data_ptr(), B, Nv, Nq, H, hd, L, P,
                (ctypes.c_int * len(levels))(*levels), _DTYPE_CODE[value.dtype],
                stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_gather3d launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out
