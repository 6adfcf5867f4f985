"""Trilinear point sampler over channels-last 3D tables (K2, K2-bwd).

Port of ``occformer_tpu/ops/trilerp.py:trilerp_gather_slab`` (Pallas
``call_fwd`` / ``call_bwd``), the sampler behind the loss's point readouts:

    trilerp_sample(table [G, X, Y, Z, C], coords [G, S, 3]) -> [G, S, C]

``coords`` lie in [-1, 1] and ``coords[..., i]`` indexes spatial axis ``i``
(x, y, z), as in the JAX package; ``align_corners`` and ``padding_mode``
("zeros" or "border") follow ``F.grid_sample``.  The JAX slab
``[G, X*Y, Z*C]`` is the same memory as the table here.

For CUDA tensors ``trilerp_sample`` launches the kernels of
``csrc/trilerp_sample3d.cu`` through the op ``occformer::k2_fwd``
(``ops/library.py``), whose registered backward is the op
``occformer::k2_bwd``, K2-bwd (d_table, and d_coords when the coordinates
require grad).  K2-bwd
has two paths, picked by ``bwd_path``, both writing d_table once in the
table's dtype, bit-identical from call to call: wide rows (the per-layer
loss route's C = 192 feature) take a per-voxel segmented gather; narrow
rows (the batched route's C = 17 and C = 1 volumes) a per-column one, a
group of ``column_lanes`` lanes per (x, y) column of the table.  K2 has two paths too, picked by
``fwd_path``: tables whose rows are whole 16-byte vectors (bf16 C a
multiple of 8, float32 a multiple of 4; the per-layer route's C = 192
feature) take the row-wide kernel, a group of lanes per point reading each
corner row as 16-byte loads; the rest (the uint8 GT masks, the batched
route's C = 17, C = 1 and C = 100 volumes, unaligned tables) take the
narrow-row kernel (the path keeps its first design's name, "scalar"): a
group of lanes per point too, each load as wide as the row and the table's
alignment allow (``narrow_vec``), one lane per point at C = 1.
For CPU tensors it runs the plain version, ``trilerp_sample_plain``
(``F.grid_sample`` on the permuted table, differentiated by autograd).  A
CUDA tensor never takes the plain version.  Tables are float32, bfloat16 or
a bool/uint8 mask (read as 0/1); the result has the table's dtype, float32
for a mask.  ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches (each
over both of its paths), ``ROW_LAUNCHES`` K2's row-wide path alone and
``BWD_NARROW_LAUNCHES`` K2-bwd's narrow path alone.
"""
from __future__ import annotations

import ctypes
from typing import List

import torch
import torch.nn.functional as F

from . import cuda_build, library

# launches of the forward (K2, both paths) and backward (K2-bwd, both
# paths) kernels, of K2's row-wide path alone and of K2-bwd's narrow path
# alone; a caller may reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0
ROW_LAUNCHES = 0
BWD_NARROW_LAUNCHES = 0

# The narrowest row (channels) that takes K2-bwd's segmented path; the
# chip measurement behind it is in csrc/trilerp_sample3d.cu's header.
SEGMENTED_MIN_C = 48
# channels per 16-byte vector by table dtype
_VEC_CHANNELS = {torch.bfloat16: 8, torch.float32: 4}
# K2's narrow forward: elements per load by table dtype, widest first (a
# chunk loads and stores at most 16 bytes: a uint8 chunk of 4 stores 4
# float32); the most chunks a lane holds when the group is sized; the points
# a lane takes at C = 1.  The chip measurements behind the two numbers are
# in csrc/trilerp_sample3d.cu's header.
_NARROW_VECS = {torch.bfloat16: (8, 4, 2, 1), torch.float32: (4, 2, 1), torch.uint8: (4, 2, 1)}
NARROW_CHUNKS_PER_LANE = 4
NARROW_POINTS_PER_LANE = 1
_INT32_LIMIT = 2 ** 31

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.uint8: 2}
_PADDING = ("zeros", "border")
_FNS = {}


def _out_dtype(table: torch.Tensor) -> torch.dtype:
    return table.dtype if table.is_floating_point() else torch.float32


def trilerp_sample_plain(table: torch.Tensor, coords: torch.Tensor,
                         align_corners: bool = False,
                         padding_mode: str = "zeros") -> torch.Tensor:
    """Plain PyTorch version: ``F.grid_sample`` in float32 on the table
    permuted to channels-first.  table [G, X, Y, Z, C], coords [G, S, 3]
    (x, y, z) in [-1, 1] -> [G, S, C]."""
    G, S = coords.shape[:2]
    vol = table.permute(0, 4, 1, 2, 3).float()  # [G, C, X, Y, Z]
    # torch grids index the last spatial axis first: (x, y, z) -> (z, y, x)
    grid = coords.float().flip(-1).reshape(G, S, 1, 1, 3)
    out = F.grid_sample(vol, grid, mode="bilinear", padding_mode=padding_mode,
                        align_corners=align_corners)  # [G, C, S, 1, 1]
    return out[..., 0, 0].transpose(1, 2).to(_out_dtype(table))


# C entry point -> (pointer arguments, int arguments); each ends with the stream
_SIGNATURES = {"trilerp_sample3d_fwd": (3, 12), "trilerp_sample3d_fwd_rows": (3, 10),
               "trilerp_sample3d_bwd": (6, 10),
               "trilerp_sample3d_bwd_seg": (6, 9)}
# workspace entry point -> its int arguments; each returns int32s
_WORKSPACES = {"trilerp_sample3d_bwd_seg_workspace": 5,  # G, S, X, Y, Z
               "trilerp_sample3d_bwd_workspace": 4}      # G, S, X, Y


def _kernel_fn(name: str):
    if name not in _FNS:
        fn = getattr(cuda_build.load("trilerp_sample3d"), name)
        if name in _WORKSPACES:
            fn.argtypes, fn.restype = [ctypes.c_int] * _WORKSPACES[name], ctypes.c_longlong
        else:
            n_ptr, n_int = _SIGNATURES[name]
            fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def bwd_path(table_shape, num_points: int) -> str:
    """K2-bwd's path for a table ``[G, X, Y, Z, C]`` read at ``num_points``
    points per table: "segmented" for rows of at least ``SEGMENTED_MIN_C``
    channels in whole 8-channel chunks whose rows and (point, corner)
    entries index in int32, else "narrow" (the per-column gather, whose
    columns and points index in int32)."""
    G, X, Y, Z, C = table_shape
    if C % 8 == 0 and C >= SEGMENTED_MIN_C and G * X * Y * Z < _INT32_LIMIT \
            and 8 * G * num_points < _INT32_LIMIT:
        return "segmented"
    return "narrow"


def _dims(table, coords, align_corners, padding_mode):
    G, X, Y, Z, C = table.shape
    return (G, coords.shape[1], X, Y, Z, C, int(bool(align_corners)),
            int(padding_mode == "border"), _DTYPE_CODE[table.dtype])


def fwd_path(table_shape, dtype, data_ptr: int = 0) -> str:
    """K2's forward path for a table ``[G, X, Y, Z, C]`` of ``dtype`` at
    address ``data_ptr``: "row" for bfloat16 or float32 rows of whole
    16-byte vectors, a 16-byte aligned table and one table's elements
    within int32; else "scalar".  No width threshold: the sweep in
    csrc/trilerp_sample3d.cu's header found the row-wide path faster from a
    single vector (C = 8 in bf16) up."""
    G, X, Y, Z, C = table_shape
    n = _VEC_CHANNELS.get(dtype)
    if n and C % n == 0 and X * Y * Z * C < _INT32_LIMIT and data_ptr % 16 == 0:
        return "row"
    return "scalar"


def narrow_vec(channels: int, dtype, data_ptr: int = 0) -> int:
    """Elements per load of K2's narrow forward for rows of ``channels``
    elements of ``dtype`` at a table at ``data_ptr``: the most that divide
    the row and whose load the table's alignment allows."""
    return next(v for v in _NARROW_VECS[dtype]
                if channels % v == 0 and data_ptr % (v * dtype.itemsize) == 0)


def narrow_lanes(channels: int, vec: int) -> int:
    """Lanes per point of the narrow forward: the fewest (a power of two,
    at most 32) that hold the row's ``channels / vec`` chunks at
    ``NARROW_CHUNKS_PER_LANE`` a lane; one at C = 1."""
    chunks = channels // vec
    lanes = 1
    while lanes < 32 and NARROW_CHUNKS_PER_LANE * lanes < chunks:
        lanes *= 2
    return lanes


def row_lanes(channels: int, dtype) -> int:
    """Lanes per point of the row-wide forward: the fewest (a power of two,
    at most 32) that hold a row's 16-byte vectors at 3 a lane."""
    nvec = channels // _VEC_CHANNELS[dtype]
    lanes = 1
    while lanes < 32 and 3 * lanes < nvec:
        lanes *= 2
    return lanes


def _launch_fwd(table, coords, align_corners, padding_mode, path=None, lanes=None,
                points=None):
    """K2 on ``path`` ("row" or "scalar"; ``fwd_path``'s choice by default)
    with ``lanes`` lanes per point (``row_lanes``' or ``narrow_lanes``'
    choice by default) and, on the narrow path at C = 1, ``points`` points a
    lane (``NARROW_POINTS_PER_LANE`` by default)."""
    global LAUNCHES, ROW_LAUNCHES
    path = path or fwd_path(table.shape, table.dtype, table.data_ptr())
    G, S, C = coords.shape[0], coords.shape[1], table.shape[-1]
    out = torch.empty((G, S, C), dtype=_out_dtype(table), device=table.device)
    dims = _dims(table, coords, align_corners, padding_mode)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        if path == "row":
            rc = _kernel_fn("trilerp_sample3d_fwd_rows")(
                table.data_ptr(), coords.data_ptr(), out.data_ptr(), *dims,
                lanes or row_lanes(C, table.dtype), stream)
        elif path == "scalar":
            vec = narrow_vec(C, table.dtype, table.data_ptr())
            rc = _kernel_fn("trilerp_sample3d_fwd")(
                table.data_ptr(), coords.data_ptr(), out.data_ptr(), *dims, vec,
                lanes or narrow_lanes(C, vec),
                (points or NARROW_POINTS_PER_LANE) if C == 1 else 1, stream)
        else:
            raise ValueError(f"path must be 'row' or 'scalar'; got {path!r}")
    if rc != 0:
        raise RuntimeError(f"trilerp_sample3d ({path}) launch failed: cudaError {rc}")
    LAUNCHES += 1
    if path == "row":
        ROW_LAUNCHES += 1
    return out


def column_lanes(channels: int) -> int:
    """Lanes per (x, y) column of K2-bwd's narrow path: the fewest (a power
    of two, at most 32) that give each of the row's ``channels`` a lane; one
    at C = 1.  A block of 256 threads takes 256 / lanes columns."""
    lanes = 1
    while lanes < 32 and lanes < channels:
        lanes *= 2
    return lanes


def _launch_bwd(table, coords, gout, align_corners, padding_mode, want_coords,
                path=None, lanes=None):
    """K2-bwd: (d_table in the table's dtype, d_coords float32 or None) on
    ``path`` ("segmented" or "narrow"; ``bwd_path``'s choice by default),
    the narrow one with ``lanes`` lanes per column (``column_lanes``' choice
    by default).  Both sum in float32 in a fixed order and write d_table
    once; the coordinate gradient adds with float32 atomics."""
    global BWD_LAUNCHES, BWD_NARROW_LAUNCHES
    path = path or bwd_path(table.shape, coords.shape[1])
    dims = _dims(table, coords, align_corners, padding_mode)
    G, S, X, Y, Z = dims[:5]
    gout = gout.to(table.dtype).contiguous()
    if gout.data_ptr() % 16:  # the segmented gather reads 16-byte chunks
        gout = gout.clone()
    d_coords = (torch.zeros(coords.shape, dtype=torch.float32, device=table.device)
                if want_coords else None)
    dc_ptr = None if d_coords is None else d_coords.data_ptr()
    d_table = torch.empty(table.shape, dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        if path == "segmented":
            ws = torch.empty(_kernel_fn("trilerp_sample3d_bwd_seg_workspace")(G, S, X, Y, Z),
                             dtype=torch.int32, device=table.device)
            rc = _kernel_fn("trilerp_sample3d_bwd_seg")(
                table.data_ptr(), coords.data_ptr(), gout.data_ptr(), d_table.data_ptr(),
                dc_ptr, ws.data_ptr(), *dims, stream)
        elif path == "narrow":
            ws = torch.empty(_kernel_fn("trilerp_sample3d_bwd_workspace")(G, S, X, Y),
                             dtype=torch.int32, device=table.device)
            rc = _kernel_fn("trilerp_sample3d_bwd")(
                table.data_ptr(), coords.data_ptr(), gout.data_ptr(), d_table.data_ptr(),
                dc_ptr, ws.data_ptr(), *dims, lanes or column_lanes(table.shape[-1]), stream)
        else:
            raise ValueError(f"path must be 'segmented' or 'narrow'; got {path!r}")
    if rc != 0:
        raise RuntimeError(f"trilerp_sample3d_bwd ({path}) launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    if path == "narrow":
        BWD_NARROW_LAUNCHES += 1
    return d_table, d_coords


@torch.library.custom_op(library.qualname("k2_fwd"), mutates_args=(), device_types="cuda")
def _k2_fwd(table: torch.Tensor, coords: torch.Tensor, align_corners: bool,
            padding_mode: str) -> torch.Tensor:
    """K2 (the op's CUDA implementation)."""
    return _launch_fwd(table, coords, align_corners, padding_mode)


@_k2_fwd.register_kernel("cpu")
def _(table, coords, align_corners, padding_mode):
    return trilerp_sample_plain(table, coords, align_corners, padding_mode)


@_k2_fwd.register_fake
def _(table, coords, align_corners, padding_mode):
    G, S, C = coords.shape[0], coords.shape[1], table.shape[-1]
    if table.device.type == "cpu":  # the plain version's [G, C, S] transposed
        return table.new_empty((G, C, S), dtype=_out_dtype(table)).transpose(1, 2)
    return table.new_empty((G, S, C), dtype=_out_dtype(table))


@torch.library.custom_op(library.qualname("k2_bwd"), mutates_args=(), device_types="cuda")
def _k2_bwd(table: torch.Tensor, coords: torch.Tensor, gout: torch.Tensor,
            align_corners: bool, padding_mode: str,
            want_coords: bool) -> List[torch.Tensor]:
    """K2-bwd (the op's CUDA implementation): [d_table], with
    ``want_coords`` [d_table, d_coords]."""
    d_table, d_coords = _launch_bwd(table, coords, gout, align_corners, padding_mode,
                                    want_coords)
    return [d_table] + ([d_coords] if want_coords else [])


@_k2_bwd.register_kernel("cpu")
def _(table, coords, gout, align_corners, padding_mode, want_coords):
    grads = library.plain_grads(
        lambda t, c: trilerp_sample_plain(t, c, align_corners, padding_mode),
        (table, coords), (table.is_floating_point(), want_coords), (gout,))
    return grads if want_coords else grads[:1]


@_k2_bwd.register_fake
def _(table, coords, gout, align_corners, padding_mode, want_coords):
    G, X, Y, Z, C = table.shape
    if table.device.type == "cpu" and table.is_floating_point():
        # the plain version's channels-first gradient, permuted
        d_table = table.new_empty((G, C, X, Y, Z)).permute(0, 2, 3, 4, 1)
    else:
        d_table = torch.empty_like(table, memory_format=torch.contiguous_format)
    return ([d_table]
            + ([coords.new_empty(coords.shape, dtype=torch.float32)] if want_coords else []))


def _k2_setup(ctx, inputs, output):
    table, coords, align_corners, padding_mode = inputs
    ctx.save_for_backward(table, coords)
    ctx.opts = (align_corners, padding_mode)
    ctx.autocast = library.autocast_state(table.device.type)


def _k2_backward(ctx, gout):
    table, coords = ctx.saved_tensors
    need_table, need_coords = ctx.needs_input_grad[:2]
    if not (need_table or need_coords):
        return None, None, None, None
    with library.replay_autocast(table.device.type, ctx.autocast):
        grads = _k2_bwd(table, coords, gout, *ctx.opts, bool(need_coords))
    return (grads[0] if need_table else None, grads[1] if need_coords else None, None, None)


_k2_fwd.register_autograd(_k2_backward, setup_context=_k2_setup)


def trilerp_sample(table: torch.Tensor, coords: torch.Tensor,
                   align_corners: bool = False,
                   padding_mode: str = "zeros") -> torch.Tensor:
    """Trilinear samples of ``table [G, X, Y, Z, C]`` at ``coords [G, S, 3]``
    in [-1, 1] -> ``[G, S, C]``.

    CPU tensors run the plain version.  CUDA tensors run the kernel, which
    takes a contiguous float32, bfloat16 or bool/uint8 table and contiguous
    float32 coords on the same device, and raises on anything else.  The
    result is differentiable in a floating table and in the coords.
    """
    if padding_mode not in _PADDING:
        raise ValueError(f"padding_mode must be one of {_PADDING}; got {padding_mode!r}")
    if table.dim() != 5 or coords.dim() != 3 or coords.shape[-1] != 3 \
            or coords.shape[0] != table.shape[0]:
        raise ValueError("expected table [G, X, Y, Z, C] and coords [G, S, 3]; got "
                         f"{tuple(table.shape)} and {tuple(coords.shape)}")
    if table.device.type == "cpu" and coords.device.type == "cpu":
        return _k2_fwd(table, coords, bool(align_corners), padding_mode)
    if not (table.is_cuda and coords.device == table.device):
        raise ValueError("table and coords must lie on one CUDA device; got "
                         f"{table.device} and {coords.device}")
    if table.dtype == torch.bool:
        table = table.view(torch.uint8)
    if table.dtype not in _DTYPE_CODE or coords.dtype != torch.float32:
        raise TypeError("table must be float32, bfloat16 or bool/uint8 and coords "
                        f"float32; got {table.dtype} and {coords.dtype}")
    if not (table.is_contiguous() and coords.is_contiguous()):
        raise ValueError("table and coords must be contiguous")
    return _k2_fwd(table, coords, bool(align_corners), padding_mode)
