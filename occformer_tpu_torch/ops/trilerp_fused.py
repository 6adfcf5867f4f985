"""Multi-level trilinear gathers over 3D pyramids (K1, K1-bwd, K4, K4-bwd).

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
kernel launches or the call raises.  K1 has two paths, picked by
``ms_deform_fwd_path``: rows of whole 16-byte vectors at a 16-byte aligned
value and output (the flagship's hd = 24, bf16 and float32) take the
row-wide kernel, a group of ``ROW_LANES`` lanes per output row (b, q, h)
whose lanes own whole samples and read each corner row as 16-byte loads;
the rest keep one thread per output channel.  ``LAUNCHES`` and
``BWD_LAUNCHES`` count the two kernels' launches (K1 over both of its
paths), ``ROW_LAUNCHES`` K1's row-wide path alone.

``fused_multilevel_gather`` is the port of the JAX package's unweighted
``fused_multilevel_gather`` (Pallas ``call_fwd`` / ``call_bwd``, bodies
``_fwd_kernel`` and ``_bwd_kernel``): every level's trilinear samples,
channels-first, in one launch of ``csrc/multilevel_gather3d.cu`` (K4), with
K4-bwd as its autograd backward (d_tables, and d_coords when the
coordinates require grad).  K4 has two paths, picked by ``multi_fwd_path``:
rows of whole 16-byte vectors at 16-byte aligned tables (the deformable
attention's C = 24, bf16 and float32) take the row-wide kernel, which reads
each corner row as 16-byte loads; the rest keep the per-channel scalar
loop.  Its plain version is ``fused_multilevel_gather_plain``;
``MULTI_LAUNCHES`` and ``MULTI_BWD_LAUNCHES`` count the two kernels'
launches, ``MULTI_ROW_LAUNCHES`` K4's row-wide path alone.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from . import cuda_build

# launches of the forward (K1, both paths) and backward (K1-bwd) kernels,
# and of K1's row-wide path alone; a caller may reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0
ROW_LAUNCHES = 0
# K1's row-wide path: lanes per output row and samples a lane loads at a
# time; the chip measurements behind them are in
# csrc/ms_deform_gather3d.cu's header
ROW_LANES = 2
ROW_SAMPLES_PER_LANE = 1
# launches of K4 (both paths) and K4-bwd, and of K4's row-wide path alone
MULTI_LAUNCHES = 0
MULTI_BWD_LAUNCHES = 0
MULTI_ROW_LAUNCHES = 0
MAX_LEVELS = 8  # csrc/multilevel_gather3d.cu:MAX_LEVELS

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_VEC_CHANNELS = {torch.float32: 4, torch.bfloat16: 8}  # per 16-byte vector
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
    """The C entry point ``ms_deform_gather3d_{fwd,fwd_rows,bwd}`` with its
    argtypes."""
    if name not in _FNS:
        fn = getattr(cuda_build.load("ms_deform_gather3d"), name)
        n_ptr = 7 if name.endswith("bwd") else 4
        n_opts = 3 if name.endswith("rows") else 1  # dtype (, lanes, spl)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 7
                       + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * n_opts
                       + [ctypes.c_void_p])
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


def ms_deform_fwd_path(head_dim: int, dtype, data_ptrs=()) -> str:
    """K1's forward path: "row" for float32 or bfloat16 rows of whole
    16-byte vectors (``head_dim`` a multiple of 4 or 8) whose value and
    output lie at 16-byte aligned ``data_ptrs``; else "scalar"."""
    n = _VEC_CHANNELS.get(dtype)
    if n and head_dim % n == 0 and all(p % 16 == 0 for p in data_ptrs):
        return "row"
    return "scalar"


def _launch_fwd(value, spatial_shapes, locs, weights, path=None, lanes=None, samples=None):
    """K1 on ``path`` ("row" or "scalar"; ``ms_deform_fwd_path``'s choice by
    default), the row-wide path with ``lanes`` lanes per output row and
    ``samples`` samples a lane loads at a time (``ROW_LANES``,
    ``ROW_SAMPLES_PER_LANE`` by default)."""
    global LAUNCHES, ROW_LAUNCHES
    B, Nv, H, hd = value.shape
    Nq, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    out = torch.empty((B, Nq, H, hd), dtype=value.dtype, device=value.device)
    path = path or ms_deform_fwd_path(hd, value.dtype, (value.data_ptr(), out.data_ptr()))
    args = (value.data_ptr(), locs.data_ptr(), weights.data_ptr(), out.data_ptr(),
            B, Nv, Nq, H, hd, L, P, _levels(spatial_shapes), _DTYPE_CODE[value.dtype])
    with torch.cuda.device(value.device):
        stream = torch.cuda.current_stream(value.device).cuda_stream
        if path == "row":
            rc = _kernel_fn("ms_deform_gather3d_fwd_rows")(
                *args, lanes or ROW_LANES, samples or ROW_SAMPLES_PER_LANE, stream)
        elif path == "scalar":
            rc = _kernel_fn("ms_deform_gather3d_fwd")(*args, stream)
        else:
            raise ValueError(f"path must be 'row' or 'scalar'; got {path!r}")
    if rc != 0:
        raise RuntimeError(f"ms_deform_gather3d ({path}) launch failed: cudaError {rc}")
    LAUNCHES += 1
    if path == "row":
        ROW_LAUNCHES += 1
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


def fused_multilevel_gather_plain(
    tables: Sequence[torch.Tensor],
    spatials: Sequence[Tuple[int, int, int]],
    channels: int,
    coords: Sequence[torch.Tensor],
    align_corners: bool = False,
) -> List[torch.Tensor]:
    """Plain PyTorch version: one ``F.grid_sample`` per level in float32 on
    the channels-first view of the level's table, zeros padding.  Returns
    per level [G, C, S_l] in the table's dtype."""
    outs = []
    for t, (X, Y, Z), c in zip(tables, spatials, coords):
        G, S = c.shape[:2]
        vol = t.reshape(G, X, Y, Z, channels).permute(0, 4, 1, 2, 3).float()
        # torch grids index the last spatial axis first: (x, y, z) -> (z, y, x)
        grid = c.float().flip(-1).reshape(G, S, 1, 1, 3)
        out = F.grid_sample(vol, grid, mode="bilinear", padding_mode="zeros",
                            align_corners=align_corners)[..., 0, 0]  # [G, C, S]
        outs.append(out.to(t.dtype))
    return outs


def _multi_fn(name: str):
    """The C entry point ``multilevel_gather3d_{fwd,fwd_rows,bwd}`` with its
    argtypes."""
    if name not in _FNS:
        fn = getattr(cuda_build.load("multilevel_gather3d"), name)
        n_arrays = 5 if name.endswith("bwd") else 3
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * n_arrays
                       + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * 4
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def multi_fwd_path(channels: int, dtype, data_ptrs=()) -> str:
    """K4's forward path: "row" for float32 or bfloat16 rows of whole
    16-byte vectors (``channels`` a multiple of 4 or 8) whose tables all
    lie at 16-byte aligned ``data_ptrs``; else "scalar"."""
    n = _VEC_CHANNELS.get(dtype)
    if n and channels % n == 0 and all(p % 16 == 0 for p in data_ptrs):
        return "row"
    return "scalar"


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _multi_dims(spatials, coords):
    dims = [d for (X, Y, Z), c in zip(spatials, coords) for d in (X, Y, Z, c.shape[1])]
    return (ctypes.c_int * len(dims))(*dims)


def _launch_multi_fwd(tables, spatials, channels, coords, align_corners, path=None):
    """K4 on ``path`` ("row" or "scalar"; ``multi_fwd_path``'s choice by
    default)."""
    global MULTI_LAUNCHES, MULTI_ROW_LAUNCHES
    dev, dtype = tables[0].device, tables[0].dtype
    path = path or multi_fwd_path(channels, dtype, [t.data_ptr() for t in tables])
    if path not in ("row", "scalar"):
        raise ValueError(f"path must be 'row' or 'scalar'; got {path!r}")
    G = tables[0].shape[0]
    outs = [torch.empty((G, channels, c.shape[1]), dtype=dtype, device=dev) for c in coords]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _multi_fn("multilevel_gather3d_fwd_rows" if path == "row" else
                       "multilevel_gather3d_fwd")(
            len(tables), _pointers(tables), _pointers(coords), _pointers(outs),
            _multi_dims(spatials, coords), G, channels, int(bool(align_corners)),
            _DTYPE_CODE[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"multilevel_gather3d ({path}) launch failed: cudaError {rc}")
    MULTI_LAUNCHES += 1
    if path == "row":
        MULTI_ROW_LAUNCHES += 1
    return outs


def _launch_multi_bwd(tables, spatials, channels, coords, gouts, align_corners,
                      want_coords):
    """K4-bwd: (d_tables in the tables' dtype, each summed in float32 and cast
    once, as the Pallas VJP does; d_coords float32, or None)."""
    global MULTI_BWD_LAUNCHES
    dev, dtype = tables[0].device, tables[0].dtype
    G = tables[0].shape[0]
    gouts = [g.to(dtype).contiguous() for g in gouts]
    d_tables = [torch.zeros(t.shape, dtype=torch.float32, device=dev) for t in tables]
    d_coords = ([torch.empty(c.shape, dtype=torch.float32, device=dev) for c in coords]
                if want_coords else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _multi_fn("multilevel_gather3d_bwd")(
            len(tables), _pointers(tables), _pointers(coords), _pointers(gouts),
            _pointers(d_tables), None if d_coords is None else _pointers(d_coords),
            _multi_dims(spatials, coords), G, channels, int(bool(align_corners)),
            _DTYPE_CODE[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"multilevel_gather3d_bwd launch failed: cudaError {rc}")
    MULTI_BWD_LAUNCHES += 1
    return [d.to(dtype) for d in d_tables], d_coords


class _MultiGather(torch.autograd.Function):
    """K4 forward, K4-bwd backward; the tensors are the L tables, then the L
    coordinate arrays."""

    @staticmethod
    def forward(ctx, spatials, channels, align_corners, *tensors):
        L = len(spatials)
        ctx.opts = (spatials, channels, align_corners)
        ctx.save_for_backward(*tensors)
        return tuple(_launch_multi_fwd(tensors[:L], spatials, channels, tensors[L:],
                                       align_corners))

    @staticmethod
    def backward(ctx, *gouts):
        spatials, channels, align_corners = ctx.opts
        L = len(spatials)
        tensors = ctx.saved_tensors
        need = ctx.needs_input_grad[3:]
        if not any(need):
            return (None,) * (3 + 2 * L)
        want_coords = any(need[L:])
        d_tables, d_coords = _launch_multi_bwd(tensors[:L], spatials, channels, tensors[L:],
                                               gouts, align_corners, want_coords)
        d_coords = d_coords or [None] * L
        return (None, None, None,
                *[d if n else None for d, n in zip(d_tables, need[:L])],
                *[d if n else None for d, n in zip(d_coords, need[L:])])


def fused_multilevel_gather(
    tables: Sequence[torch.Tensor],
    spatials: Sequence[Tuple[int, int, int]],
    channels: int,
    coords: Sequence[torch.Tensor],
    align_corners: bool = False,
) -> List[torch.Tensor]:
    """Every level's trilinear samples in one call.

    ``tables[l]`` is the level's slab ``[G, X*Y, Z*C]`` (the memory of the
    channels-last ``[G, X, Y, Z, C]``; element (x, y, z, c) at
    ``[g, x*Y + y, z*C + c]``), ``coords[l]`` ``[G, S_l, 3]`` in [-1, 1] as
    (x, y, z).  Returns per level ``[G, C, S_l]`` in the tables' dtype;
    zeros padding, unnormalization as ``F.grid_sample`` for
    ``align_corners``.

    CPU tensors run the plain version.  CUDA tensors run K4, which takes
    contiguous float32 or bfloat16 tables of one dtype and contiguous
    float32 coords, all on one device, at most ``MAX_LEVELS`` levels, and
    raises on anything else.  On CUDA the result is differentiable in the
    tables and the coords through K4-bwd.
    """
    spatials = tuple(tuple(int(v) for v in s) for s in spatials)
    tables, coords, C = list(tables), list(coords), int(channels)
    L = len(tables)
    if not (1 <= L == len(spatials) == len(coords)):
        raise ValueError(f"{L} tables, {len(spatials)} spatials, {len(coords)} coords")
    G = tables[0].shape[0]
    for l, (t, (X, Y, Z), c) in enumerate(zip(tables, spatials, coords)):
        if tuple(t.shape) != (G, X * Y, Z * C):
            raise ValueError(f"level {l}: table {tuple(t.shape)} != {(G, X * Y, Z * C)}")
        if c.dim() != 3 or c.shape[0] != G or c.shape[2] != 3:
            raise ValueError(f"level {l}: coords {tuple(c.shape)}, want [{G}, S, 3]")
    tensors = tables + coords
    if all(t.device.type == "cpu" for t in tensors):
        return fused_multilevel_gather_plain(tables, spatials, C, coords, align_corners)
    dev = tables[0].device
    if not all(t.is_cuda and t.device == dev for t in tensors):
        raise ValueError("tables and coords must lie on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if L > MAX_LEVELS:
        raise ValueError(f"{L} levels; the kernel takes at most {MAX_LEVELS}")
    dtype = tables[0].dtype
    if dtype not in _DTYPE_CODE or any(t.dtype != dtype for t in tables):
        raise TypeError(f"tables must all be float32 or all bfloat16; got "
                        f"{[t.dtype for t in tables]}")
    if any(c.dtype != torch.float32 for c in coords):
        raise TypeError(f"coords must be float32; got {[c.dtype for c in coords]}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("tables and coords must be contiguous")
    return list(_MultiGather.apply(spatials, C, bool(align_corners), *tensors))
