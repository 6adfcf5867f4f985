"""Trilinear point sampler over channels-last 3D tables (K2, K2-bwd).

Port of ``occformer_tpu/ops/trilerp.py:trilerp_gather_slab`` (Pallas
``call_fwd`` / ``call_bwd``), the sampler behind the loss's point readouts:

    trilerp_sample(table [G, X, Y, Z, C], coords [G, S, 3]) -> [G, S, C]

``coords`` lie in [-1, 1] and ``coords[..., i]`` indexes spatial axis ``i``
(x, y, z), as in the JAX package; ``align_corners`` and ``padding_mode``
("zeros" or "border") follow ``F.grid_sample``.  The JAX slab
``[G, X*Y, Z*C]`` is the same memory as the table here.

For CUDA tensors ``trilerp_sample`` launches the kernels of
``csrc/trilerp_sample3d.cu`` through an autograd ``Function`` whose backward
is the K2-bwd kernel (d_table, and d_coords when the coordinates require
grad).  For CPU tensors it runs the plain version, ``trilerp_sample_plain``
(``F.grid_sample`` on the permuted table, differentiated by autograd).  A
CUDA tensor never takes the plain version.  Tables are float32, bfloat16 or
a bool/uint8 mask (read as 0/1); the result has the table's dtype, float32
for a mask.  ``LAUNCHES`` and ``BWD_LAUNCHES`` count kernel launches.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import cuda_build

# launches of the forward (K2) and backward (K2-bwd) kernels; a caller may
# reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0

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


def _kernel_fn(name: str):
    if name not in _FNS:
        fn = getattr(cuda_build.load("trilerp_sample3d"), name)
        n_ptr = 3 if name.endswith("fwd") else 5
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _dims(table, coords, align_corners, padding_mode):
    G, X, Y, Z, C = table.shape
    return (G, coords.shape[1], X, Y, Z, C, int(bool(align_corners)),
            int(padding_mode == "border"), _DTYPE_CODE[table.dtype])


def _launch_fwd(table, coords, align_corners, padding_mode):
    global LAUNCHES
    G, S, C = coords.shape[0], coords.shape[1], table.shape[-1]
    out = torch.empty((G, S, C), dtype=_out_dtype(table), device=table.device)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _kernel_fn("trilerp_sample3d_fwd")(
            table.data_ptr(), coords.data_ptr(), out.data_ptr(),
            *_dims(table, coords, align_corners, padding_mode), stream)
    if rc != 0:
        raise RuntimeError(f"trilerp_sample3d launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


def _launch_bwd(table, coords, gout, align_corners, padding_mode, want_coords):
    """K2-bwd: (d_table in the table's dtype, summed in float32; d_coords
    float32 or None)."""
    global BWD_LAUNCHES
    gout = gout.to(table.dtype).contiguous()
    d_table = torch.zeros(table.shape, dtype=torch.float32, device=table.device)
    d_coords = (torch.zeros(coords.shape, dtype=torch.float32, device=table.device)
                if want_coords else None)
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = _kernel_fn("trilerp_sample3d_bwd")(
            table.data_ptr(), coords.data_ptr(), gout.data_ptr(), d_table.data_ptr(),
            None if d_coords is None else d_coords.data_ptr(),
            *_dims(table, coords, align_corners, padding_mode), stream)
    if rc != 0:
        raise RuntimeError(f"trilerp_sample3d_bwd launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    return d_table.to(table.dtype), d_coords


class _Sample(torch.autograd.Function):
    """K2 forward, K2-bwd backward."""

    @staticmethod
    def forward(ctx, table, coords, align_corners, padding_mode):
        ctx.opts = (align_corners, padding_mode)
        ctx.save_for_backward(table, coords)
        return _launch_fwd(table, coords, align_corners, padding_mode)

    @staticmethod
    def backward(ctx, gout):
        table, coords = ctx.saved_tensors
        need_table, need_coords = ctx.needs_input_grad[:2]
        if not (need_table or need_coords):
            return None, None, None, None
        d_table, d_coords = _launch_bwd(table, coords, gout, *ctx.opts,
                                        want_coords=need_coords)
        return (d_table if need_table else None, d_coords, None, None)


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
        return trilerp_sample_plain(table, coords, align_corners, padding_mode)
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
    return _Sample.apply(table, coords, bool(align_corners), padding_mode)
