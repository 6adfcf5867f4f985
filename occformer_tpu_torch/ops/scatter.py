"""Voxel scatter of the lifted depth x context features (LSS splat, S1).

Port of ``occformer_tpu/ops/scatter.py:voxel_scatter_lifted``: every valid
frustum point's depth x context feature summed into its voxel.

The JAX package's XLA scatter repeats its sums run to run; ``index_add_``
on the card adds with float atomics in an order that changes from run to
run, so two identical train steps differed in the last bits of their
losses (PERF.md).  So ``voxel_scatter_lifted`` calls the op
``occformer::s1`` (``ops/library.py``), whose CUDA implementation is S1
(``csrc/voxel_splat.cu``):
a counting sort of the valid points by voxel on the card (int32 rows
computed from ``coords`` and ``valid``, each voxel's points in ascending
point order) and a splat that takes each voxel's sum in that order, with
no atomics, no library call and without storing the lift product, and
writes the volume once in ``depth``'s dtype; for CPU tensors it is the
CPU implementation the plain version, ``voxel_scatter_plain`` (one
``index_add_`` per camera over
``voxel_rows``, sequential on the CPU, atomic on the card).  ``segments``
states the order S1's sort gives (a stable sort of ``voxel_rows``).
``LAUNCHES`` counts S1's launches.

Its backward is the op ``occformer::s1_bwd``: on the card S1-bwd
(``csrc/voxel_splat.cu:voxel_splat_bwd``), a kernel with a block per
pixel whose warps take contiguous chunks of its depth bins; each lane
gathers its channels of the gradient rows of 16 bins at a time (an invalid
point loads nothing), d_depth comes from a fixed shuffle tree over the
lanes and d_ctx from each warp's sums in bin order added in warp order, so
two calls give the same bits and no [B, N, D, fH, fW, C] product is
formed.  On the CPU its plain version, ``voxel_scatter_backward_plain``
(a float32 gather of every point's row and two products of that size).
``BWD_LAUNCHES`` counts S1-bwd's launches.

``voxel_scatter`` (port of ``occformer_tpu/ops/scatter.py:voxel_scatter``,
the view transformer's ``use_voxel_net`` splat) sums given feature rows
[B, P, C] by voxel: S1-rows on the card (its own sort of the valid points
by voxel and a splat that gathers each voxel's rows into shared memory and
adds them in point order), ``voxel_scatter_plain_rows`` (one
``index_add_`` into float32 rows, in point order on the CPU, so the two
agree bit for bit) for CPU tensors.  ``ROWS_LAUNCHES`` counts S1-rows'
launches.  Its backward, d_feats[p] = g[row p] (0 for an invalid point),
is the op ``occformer::s1_rows_bwd``: S1-rows-bwd on the card
(``voxel_splat_rows_bwd``: a thread per point and 16-byte vector of its
row, no padded copy of the gradient), equal bit for bit to its plain version
``voxel_scatter_rows_backward_plain`` (a padded copy of the gradient and
one ``index_select``), which the CPU runs.  ``ROWS_BWD_LAUNCHES`` counts
S1-rows-bwd's launches.

At batch 1 the occupancy encoder's ``volume.permute(0, 4, 1, 2, 3)`` hands
both backwards their gradient as a transposed view; ``_grad_rows`` passes it
on as it is and the kernels transpose it into rows themselves (PyTorch's
strided copy of it took 0.35 device ms, the kernels' transpose about 0.09).

Measured by ``chip_smoke.py`` in one run (H100 80GB HBM3 at 700 W, on the
transposed gradient the main path hands over): S1-bwd at the nuScenes rig
0.164 device ms against 1.51 ms (events) for the plain backward; S1-rows-bwd
at the use_voxel_net flagship (bf16) 0.153 device ms against 0.92 ms
(events) for the plain gather.  PERF.md section 6 keeps each run's figures.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence

import torch
import torch.nn.functional as F

from ..utils import flops
from . import cuda_build, library

# launches of the splat kernels (S1, S1-rows) and of their backwards (S1-bwd,
# S1-rows-bwd); a caller may reset them to 0
LAUNCHES = 0
ROWS_LAUNCHES = 0
BWD_LAUNCHES = 0
ROWS_BWD_LAUNCHES = 0

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def voxel_rows(coords: torch.Tensor, valid: torch.Tensor, nx: Sequence[int]) -> torch.Tensor:
    """Each point's row of the ``B * X * Y * Z + 1`` row sum: its voxel
    (coordinates clamped into the grid), or the dummy last row when invalid.
    coords [B, ..., 3], valid [B, ...] (frustum points [B, N, D, fH, fW] or
    rows [B, P]) -> int64 [B, ...]."""
    B = coords.shape[0]
    X, Y, Z = int(nx[0]), int(nx[1]), int(nx[2])
    nvox = X * Y * Z
    hi = torch.tensor([X - 1, Y - 1, Z - 1], dtype=coords.dtype, device=coords.device)
    coords = torch.minimum(coords.clamp(min=0), hi)
    lin = (coords[..., 0].long() * Y + coords[..., 1]) * Z + coords[..., 2]
    batch_off = (torch.arange(B, device=lin.device) * nvox).view(B, *[1] * (lin.dim() - 1))
    return torch.where(valid, lin + batch_off, torch.full_like(lin, B * nvox))


def voxel_scatter_plain(depth: torch.Tensor, ctx: torch.Tensor, rows: torch.Tensor,
                        n_rows: int) -> torch.Tensor:
    """Plain PyTorch version: one ``index_add_`` per camera into float32
    rows (the dummy row last), so one camera's [B, D, fH, fW, C] product is
    the largest temporary.  -> [n_rows, C] float32."""
    N, C = depth.shape[1], ctx.shape[-1]
    out = torch.zeros((n_rows + 1, C), dtype=torch.float32, device=depth.device)
    for n in range(N):
        feats_n = depth[:, n, ..., None] * ctx[:, n, None]  # [B, D, fH, fW, C]
        out.index_add_(0, rows[:, n].reshape(-1), feats_n.reshape(-1, C).float())
    return out[:n_rows]


def _kernel_fn(name: str = "voxel_splat"):
    if name not in _FNS:
        fn = getattr(cuda_build.load("voxel_splat"), name)
        # rows, points -> int32s
        if name in ("voxel_splat_workspace", "voxel_splat_rows_workspace"):
            fn.argtypes, fn.restype = [ctypes.c_longlong] * 2, ctypes.c_longlong
        elif name == "voxel_splat_rows":
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        elif name == "voxel_splat_bwd":
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                           + [ctypes.c_int] * 10 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        elif name == "voxel_splat_rows_bwd":
            fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                           + [ctypes.c_int] * 7 + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        else:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def segments(rows: torch.Tensor, n_rows: int):
    """The points sorted by row and each row's segment: (order, offsets),
    int64; row r's points, in ascending point order, are
    ``order[offsets[r]:offsets[r + 1]]``."""
    flat = rows.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=n_rows + 1)[:n_rows]
    offsets = torch.zeros(n_rows + 1, dtype=torch.int64, device=rows.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return order, offsets


def _launch(depth, ctx, coords, valid, nx):
    """S1: the volume [B * X * Y * Z, C] in ``depth``'s dtype."""
    global LAUNCHES
    B, N, D, fH, fW = depth.shape
    C = ctx.shape[-1]
    X, Y, Z = (int(n) for n in nx)
    n_rows = B * X * Y * Z
    coords = coords.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    out = torch.empty((n_rows, C), dtype=depth.dtype, device=depth.device)
    ws = torch.empty(_kernel_fn("voxel_splat_workspace")(n_rows, depth.numel()),
                     dtype=torch.int32, device=depth.device)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        rc = _kernel_fn()(depth.data_ptr(), ctx.data_ptr(), coords.data_ptr(), valid.data_ptr(),
                          out.data_ptr(), ws.data_ptr(), B, N, D, fH * fW, X, Y, Z, C,
                          _DTYPE_CODE[depth.dtype], _DTYPE_CODE[ctx.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"voxel_splat launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


@torch.library.custom_op(library.qualname("s1"), mutates_args=(), device_types="cuda")
def _s1(depth: torch.Tensor, ctx: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
        nx: List[int]) -> torch.Tensor:
    """S1 (the op's CUDA implementation)."""
    return _launch(depth, ctx, coords, valid, nx)


@_s1.register_kernel("cpu")
def _(depth, ctx, coords, valid, nx):
    n_rows = depth.shape[0] * nx[0] * nx[1] * nx[2]
    return voxel_scatter_plain(depth, ctx, voxel_rows(coords, valid, nx),
                               n_rows).to(depth.dtype)


@_s1.register_fake
def _(depth, ctx, coords, valid, nx):
    return depth.new_empty((depth.shape[0] * nx[0] * nx[1] * nx[2], ctx.shape[-1]))


def _s1_setup(ctx, inputs, output):
    depth, context, coords, valid, nx = inputs
    ctx.save_for_backward(depth, context, coords, valid)
    ctx.nx = nx


def voxel_scatter_backward_plain(depth: torch.Tensor, ctx: torch.Tensor,
                                 coords: torch.Tensor, valid: torch.Tensor,
                                 gout: torch.Tensor, nx: Sequence[int]) -> List[torch.Tensor]:
    """Plain PyTorch version of S1-bwd: each point's row of the volume's
    gradient ``gout`` [B * X * Y * Z, C] gathered in float32, d_depth[p] =
    <g[row p], ctx[pixel p]>, d_ctx[pixel] = sum over the pixel's depth
    bins of depth[p] * g[row p] (an invalid point's g is 0).  ->
    [d_depth in depth's dtype, d_ctx in ctx's dtype]."""
    rows = voxel_rows(coords, valid, nx)
    g = F.pad(gout.float(), (0, 0, 0, 1)).index_select(0, rows.reshape(-1))
    g = g.view(*rows.shape, gout.shape[-1])                 # [B, N, D, fH, fW, C]
    d_depth = (g * ctx[:, :, None].float()).sum(-1).to(depth.dtype)
    d_ctx = (g * depth[..., None].float()).sum(2).to(ctx.dtype)
    return [d_depth, d_ctx]


def _grad_rows(gout):
    """The volume's gradient [rows, C] as the backward kernels take it:
    (rows or their transpose, 1 when transposed, room for the rows or None).
    At batch 1 the encoder's ``permute`` hands it over as a transposed view
    ([C, rows] in memory), which the kernels copy into rows themselves;
    any other layout is made contiguous here."""
    if gout.dim() == 2 and gout.shape[1] > 1 and gout.stride() == (1, gout.shape[0]):
        return gout, 1, torch.empty(gout.shape, dtype=gout.dtype, device=gout.device)
    return gout.contiguous(), 0, None


def _launch_bwd(depth, ctx, coords, valid, gout, nx):
    """S1-bwd: [d_depth like depth, d_ctx like ctx]."""
    global BWD_LAUNCHES
    B, N, D, fH, fW = depth.shape
    C = ctx.shape[-1]
    X, Y, Z = (int(n) for n in nx)
    if not (depth.dtype in _DTYPE_CODE and ctx.dtype in _DTYPE_CODE
            and gout.dtype == depth.dtype):
        raise TypeError(f"S1-bwd takes float32 or bfloat16 depth and ctx and the gradient in "
                        f"depth's dtype; got {depth.dtype}, {ctx.dtype}, {gout.dtype}")
    if tuple(gout.shape) != (B * X * Y * Z, C):
        raise ValueError(f"S1-bwd: gradient {tuple(gout.shape)}, want {(B * X * Y * Z, C)}")
    depth, ctx = depth.contiguous(), ctx.contiguous()
    gout, gout_t, gbuf = _grad_rows(gout)
    coords = coords.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    d_depth = torch.empty_like(depth)
    d_ctx = torch.empty_like(ctx)
    with torch.cuda.device(depth.device):
        stream = torch.cuda.current_stream(depth.device).cuda_stream
        rc = _kernel_fn("voxel_splat_bwd")(
            depth.data_ptr(), ctx.data_ptr(), coords.data_ptr(), valid.data_ptr(),
            gout.data_ptr(), gout_t, 0 if gbuf is None else gbuf.data_ptr(), d_depth.data_ptr(),
            d_ctx.data_ptr(), B, N, D, fH * fW, X, Y, Z, C, _DTYPE_CODE[depth.dtype],
            _DTYPE_CODE[ctx.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"voxel_splat_bwd launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    return [d_depth, d_ctx]


@torch.library.custom_op(library.qualname("s1_bwd"), mutates_args=(), device_types="cuda")
def _s1_bwd(depth: torch.Tensor, ctx: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
            gout: torch.Tensor, nx: List[int]) -> List[torch.Tensor]:
    """S1-bwd (the op's CUDA implementation): [d_depth, d_ctx]."""
    return _launch_bwd(depth, ctx, coords, valid, gout, nx)


@_s1_bwd.register_kernel("cpu")
def _(depth, ctx, coords, valid, gout, nx):
    return voxel_scatter_backward_plain(depth, ctx, coords, valid, gout, nx)


@_s1_bwd.register_fake
def _(depth, ctx, coords, valid, gout, nx):
    return [torch.empty_like(depth, memory_format=torch.contiguous_format),
            torch.empty_like(ctx, memory_format=torch.contiguous_format)]


def _s1_backward(ctx_, gout):
    """S1-bwd on the volume's gradient (its plain version for CPU tensors)."""
    depth, ctx, coords, valid = ctx_.saved_tensors
    d_depth, d_ctx = _s1_bwd(depth, ctx, coords, valid, gout, ctx_.nx)
    return d_depth, d_ctx, None, None, None


_s1.register_autograd(_s1_backward, setup_context=_s1_setup)


def voxel_scatter_lifted(
    depth: torch.Tensor,
    ctx: torch.Tensor,
    coords: torch.Tensor,
    valid: torch.Tensor,
    nx: Sequence[int],
) -> torch.Tensor:
    """Fused lift (depth ⊗ context) + scatter.

    Args:
      depth:  [B, N, D, fH, fW] softmaxed depth distribution
      ctx:    [B, N, fH, fW, C] context features
      coords: [B, N, D, fH, fW, 3] voxel indices of each frustum point
      valid:  [B, N, D, fH, fW] bool
      nx:     (X, Y, Z)

    Returns [B, X, Y, Z, C] in ``depth.dtype``.  The sum is kept in float32
    and rounded once at the end.  CUDA tensors (float32 or bfloat16 depth and
    ctx, all four on one device) run S1, CPU tensors the plain version.
    """
    B = depth.shape[0]
    C = ctx.shape[-1]
    X, Y, Z = int(nx[0]), int(nx[1]), int(nx[2])
    if depth.is_cuda and not (depth.dtype in _DTYPE_CODE and ctx.dtype in _DTYPE_CODE
                              and ctx.device == coords.device == valid.device == depth.device):
        raise TypeError(f"depth and ctx must be float32 or bfloat16 and lie with coords and "
                        f"valid on one device; got {depth.dtype} on {depth.device}, "
                        f"{ctx.dtype} on {ctx.device}, coords on {coords.device}, valid on "
                        f"{valid.device}")
    # the plain version's index_add_ updates, which the analytic count does
    # not see inside the op
    flops.add("scatter", depth.numel() * C)
    out = _s1(depth.contiguous(), ctx.contiguous(), coords, valid, [X, Y, Z])
    return out.reshape(B, X, Y, Z, C)


def voxel_scatter_plain_rows(feats: torch.Tensor, rows: torch.Tensor,
                             n_rows: int) -> torch.Tensor:
    """Plain PyTorch version of S1-rows: one ``index_add_`` of the rows
    [B * P, C] into float32 rows (the dummy row last).  -> [n_rows, C]
    float32."""
    out = torch.zeros((n_rows + 1, feats.shape[-1]), dtype=torch.float32, device=feats.device)
    out.index_add_(0, rows.reshape(-1), feats.reshape(-1, feats.shape[-1]).float())
    return out[:n_rows]


def _launch_rows(feats, coords, valid, nx):
    """S1-rows: feats [B, P, C] summed by voxel -> [B * X * Y * Z, C] in
    feats' dtype."""
    global ROWS_LAUNCHES
    B, P, C = feats.shape
    X, Y, Z = (int(n) for n in nx)
    n_rows = B * X * Y * Z
    coords = coords.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    out = torch.empty((n_rows, C), dtype=feats.dtype, device=feats.device)
    ws = torch.empty(_kernel_fn("voxel_splat_rows_workspace")(n_rows, B * P),
                     dtype=torch.int32, device=feats.device)
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        rc = _kernel_fn("voxel_splat_rows")(feats.data_ptr(), coords.data_ptr(),
                                            valid.data_ptr(), out.data_ptr(), ws.data_ptr(),
                                            B, P, X, Y, Z, C, _DTYPE_CODE[feats.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"voxel_splat_rows launch failed: cudaError {rc}")
    ROWS_LAUNCHES += 1
    return out


@torch.library.custom_op(library.qualname("s1_rows"), mutates_args=(), device_types="cuda")
def _s1_rows(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
             nx: List[int]) -> torch.Tensor:
    """S1-rows (the op's CUDA implementation)."""
    return _launch_rows(feats, coords, valid, nx)


@_s1_rows.register_kernel("cpu")
def _(feats, coords, valid, nx):
    n_rows = feats.shape[0] * nx[0] * nx[1] * nx[2]
    return voxel_scatter_plain_rows(feats, voxel_rows(coords, valid, nx),
                                    n_rows).to(feats.dtype)


@_s1_rows.register_fake
def _(feats, coords, valid, nx):
    return feats.new_empty((feats.shape[0] * nx[0] * nx[1] * nx[2], feats.shape[-1]))


def _s1_rows_setup(ctx, inputs, output):
    feats, coords, valid, nx = inputs
    ctx.save_for_backward(coords, valid)
    ctx.nx = nx


def voxel_scatter_rows_backward_plain(gout: torch.Tensor, coords: torch.Tensor,
                                      valid: torch.Tensor, nx: Sequence[int]) -> torch.Tensor:
    """Plain PyTorch version of S1-rows-bwd: each point's row of the
    volume's gradient ``gout`` [B * X * Y * Z, C], d_feats[p] = g[row p] (0
    for an invalid point), by one ``index_select`` of a copy padded with a
    zero row.  -> [B, P, C] in gout's dtype."""
    rows = voxel_rows(coords, valid, nx)
    g = F.pad(gout, (0, 0, 0, 1)).index_select(0, rows.reshape(-1))
    return g.view(*rows.shape, gout.shape[-1])


def _launch_rows_bwd(gout, coords, valid, nx):
    """S1-rows-bwd: d_feats [B, P, C] in gout's dtype."""
    global ROWS_BWD_LAUNCHES
    B, P = valid.shape
    C = gout.shape[-1]
    X, Y, Z = (int(n) for n in nx)
    if gout.dtype not in _DTYPE_CODE:
        raise TypeError(f"S1-rows-bwd takes a float32 or bfloat16 gradient; got {gout.dtype}")
    if tuple(gout.shape) != (B * X * Y * Z, C):
        raise ValueError(f"S1-rows-bwd: gradient {tuple(gout.shape)}, want "
                         f"{(B * X * Y * Z, C)}")
    gout, gout_t, gbuf = _grad_rows(gout)
    coords = coords.to(torch.int32).contiguous()
    valid = valid.to(torch.bool).contiguous()
    d_feats = torch.empty((B, P, C), dtype=gout.dtype, device=gout.device)
    with torch.cuda.device(gout.device):
        stream = torch.cuda.current_stream(gout.device).cuda_stream
        rc = _kernel_fn("voxel_splat_rows_bwd")(
            gout.data_ptr(), gout_t, 0 if gbuf is None else gbuf.data_ptr(), coords.data_ptr(),
            valid.data_ptr(), d_feats.data_ptr(), B, P, X, Y, Z, C, _DTYPE_CODE[gout.dtype],
            stream)
    if rc != 0:
        raise RuntimeError(f"voxel_splat_rows_bwd launch failed: cudaError {rc}")
    ROWS_BWD_LAUNCHES += 1
    return d_feats


@torch.library.custom_op(library.qualname("s1_rows_bwd"), mutates_args=(),
                         device_types="cuda")
def _s1_rows_bwd(gout: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                 nx: List[int]) -> torch.Tensor:
    """S1-rows-bwd (the op's CUDA implementation): d_feats [B, P, C]."""
    return _launch_rows_bwd(gout, coords, valid, nx)


@_s1_rows_bwd.register_kernel("cpu")
def _(gout, coords, valid, nx):
    return voxel_scatter_rows_backward_plain(gout, coords, valid, nx)


@_s1_rows_bwd.register_fake
def _(gout, coords, valid, nx):
    return gout.new_empty((*valid.shape, gout.shape[-1]))


def _s1_rows_backward(ctx_, gout):
    """S1-rows-bwd on the volume's gradient, which autograd hands over in
    the volume's dtype, feats' (its plain version for CPU tensors)."""
    coords, valid = ctx_.saved_tensors
    return _s1_rows_bwd(gout, coords, valid, ctx_.nx), None, None, None


_s1_rows.register_autograd(_s1_rows_backward, setup_context=_s1_rows_setup)


def voxel_scatter(feats: torch.Tensor, coords: torch.Tensor, valid: torch.Tensor,
                  nx: Sequence[int]) -> torch.Tensor:
    """Sum point features into a dense voxel grid.

    Args:
      feats:  [B, P, C] per-point features
      coords: [B, P, 3] integer voxel indices (x, y, z), clamped into the
              grid; may be garbage where ``valid`` is False
      valid:  [B, P] bool
      nx:     (X, Y, Z)

    Returns [B, X, Y, Z, C] in ``feats.dtype`` (zeros where no point
    landed), each sum kept in float32 and rounded once.  CUDA tensors
    (float32 or bfloat16 feats, all three on one device) run S1-rows, CPU
    tensors the plain version.
    """
    B, P, C = feats.shape
    X, Y, Z = int(nx[0]), int(nx[1]), int(nx[2])
    if feats.is_cuda and not (feats.dtype in _DTYPE_CODE
                              and feats.device == coords.device == valid.device):
        raise TypeError(f"feats must be float32 or bfloat16 and lie with coords and valid on "
                        f"one device; got {feats.dtype} on {feats.device}, coords on "
                        f"{coords.device}, valid on {valid.device}")
    flops.add("scatter", feats.numel())  # the plain version's index_add_ updates
    out = _s1_rows(feats.contiguous(), coords, valid, [X, Y, Z])
    return out.reshape(B, X, Y, Z, C)
