"""The backend viability probe's kernels (P1, P2).

Port of the two Pallas kernels inside ``tools/probe_pallas_viability.py``
``main()``: ``add_one`` (``y = x + 1``) and ``gather_kernel``
(``out[s, :] = table[idx[s], :]``).  For CUDA tensors ``add_one`` and
``row_gather`` launch the kernels of ``csrc/probe.cu``; for CPU tensors they
run the plain versions, ``x + 1`` and ``table.index_select(0, idx)``.  A CUDA
tensor never takes the plain version: the kernel launches or the call
raises.  ``ADD_ONE_LAUNCHES`` and ``ROW_GATHER_LAUNCHES`` count the launches.
``empty`` launches a kernel that does nothing, a measurement of the card's
launch floor beside them (no TPU kernel's port, on no path).
"""
from __future__ import annotations

import ctypes

import torch

from . import cuda_build, library

# launches of P1 and P2; a caller may reset them to 0
ADD_ONE_LAUNCHES = 0
ROW_GATHER_LAUNCHES = 0

_FNS = {}


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return x + 1.0


def row_gather_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return table.index_select(0, idx)


def _fn(name: str, argtypes):
    if name not in _FNS:
        fn = getattr(cuda_build.load("probe"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


@torch.library.custom_op(library.qualname("p1"), mutates_args=(), device_types="cuda")
def _p1(x: torch.Tensor) -> torch.Tensor:
    """P1 (the op's CUDA implementation)."""
    global ADD_ONE_LAUNCHES
    y = torch.empty_like(x)
    with torch.cuda.device(x.device):
        rc = _fn("probe_add_one", [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                                   ctypes.c_void_p])(
            x.data_ptr(), y.data_ptr(), x.numel(), _stream(x.device))
    if rc != 0:
        raise RuntimeError(f"probe_add_one launch failed: cudaError {rc}")
    ADD_ONE_LAUNCHES += 1
    return y


@_p1.register_kernel("cpu")
def _(x):
    return add_one_plain(x)


@_p1.register_fake
def _(x):
    return torch.empty_like(x)


@torch.library.custom_op(library.qualname("p2"), mutates_args=(), device_types="cuda")
def _p2(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2 (the op's CUDA implementation)."""
    global ROW_GATHER_LAUNCHES
    N, C = table.shape
    out = torch.empty((idx.shape[0], C), dtype=table.dtype, device=table.device)
    with torch.cuda.device(table.device):
        rc = _fn("probe_row_gather", [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                 + [ctypes.c_void_p])(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), N, C, idx.shape[0],
            _stream(table.device))
    if rc != 0:
        raise RuntimeError(f"probe_row_gather launch failed: cudaError {rc}")
    ROW_GATHER_LAUNCHES += 1
    return out


@_p2.register_kernel("cpu")
def _(table, idx):
    return row_gather_plain(table, idx)


@_p2.register_fake
def _(table, idx):
    return table.new_empty((idx.shape[0], table.shape[1]))


def add_one(x: torch.Tensor) -> torch.Tensor:
    """P1: ``x + 1``.  CUDA: contiguous float32 only."""
    if x.is_cuda and not (x.dtype == torch.float32 and x.is_contiguous()):
        raise TypeError(f"add_one takes a contiguous float32 CUDA tensor; got "
                        f"{x.dtype} on {x.device}")
    return _p1(x)


def row_gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """P2: ``out[s, :] = table[idx[s], :]`` for ``table [N, C]`` and
    ``idx [S]``.  CUDA: contiguous float32 table and int32 indices on one
    device; an index outside [0, N) gives a row of zeros there (the kernel
    cannot raise without a synchronisation), where the plain version
    raises."""
    if table.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"expected table [N, C] and idx [S]; got {tuple(table.shape)} "
                         f"and {tuple(idx.shape)}")
    if table.device.type == "cpu" and idx.device.type == "cpu":
        return _p2(table, idx)
    if not (table.is_cuda and idx.device == table.device):
        raise ValueError(f"table and idx must lie on one CUDA device; got {table.device} "
                         f"and {idx.device}")
    if table.dtype != torch.float32 or idx.dtype != torch.int32:
        raise TypeError(f"row_gather takes a float32 table and int32 indices; got "
                        f"{table.dtype} and {idx.dtype}")
    if not (table.is_contiguous() and idx.is_contiguous()):
        raise ValueError("table and idx must be contiguous")
    return _p2(table, idx)


def empty(device) -> None:
    """Launches ``csrc/probe.cu:empty_kernel`` (one thread, no work) on
    ``device``'s current stream: its device time is the launch floor."""
    with torch.cuda.device(device):
        rc = _fn("probe_empty", [ctypes.c_void_p])(_stream(device))
    if rc != 0:
        raise RuntimeError(f"probe_empty launch failed: cudaError {rc}")
