"""Multi-level trilinear gathers over 3D pyramids (K1, K1-bwd, K4, K4-bwd).

Port of ``occformer_tpu/ops/trilerp_fused.py:fused_multilevel_weighted_gather``
(Pallas bodies ``_wfold_fwd_body`` and ``_wfold_bwd_body``), with the level
sum that ``models/deform_attn.py`` does after the call folded in:

    out[b, q, h] = sum_l sum_p weights[b, q, h, l, p] *
                   trilerp_zeros(V_l[b, :, h], 2 * locs[b, q, h, l, p] - 1)

``ms_deform_gather_3d`` launches the CUDA kernels of
``csrc/ms_deform_gather3d.cu`` for CUDA tensors through the op
``occformer::k1_fwd`` (``ops/library.py``), whose registered backward is
the op ``occformer::k1_bwd``, the K1-bwd kernel (d_value, d_locs,
d_weights); for CPU tensors the same ops run the plain version,
``ms_deform_gather_3d_plain`` (``F.grid_sample`` per level plus the
weighted sum), and its gradient by autograd.  A CUDA tensor never takes the plain version: the
kernel launches or the call raises.  K1 is one row-wide kernel for every
row: a group of ``ROW_LANES`` lanes per output row (b, q, h) whose lanes own
whole samples and read each corner row as vectors of the width
``ms_deform_fwd_path`` picks, the widest of 16, 8, 4 and 2 bytes that
divides the row and the value's and output's addresses (the flagship's
hd = 24: 16 bytes; a misaligned value is copied to an aligned buffer
first).  ``LAUNCHES`` and ``BWD_LAUNCHES`` count the two
kernels' launches, ``ROW_LAUNCHES`` K1's row-wide ones (every launch of
K1).  K1-bwd writes every
gradient once in its dtype with no float atomics: d_value's rows are summed
in a fixed order (``csrc/ordered_rows.cuh``: samples binned by their lower
corner, each row's terms corner by corner, each corner's in ascending sample
order), so two calls give the same bits.

``fused_multilevel_gather`` is the port of the JAX package's unweighted
``fused_multilevel_gather`` (Pallas ``call_fwd`` / ``call_bwd``, bodies
``_fwd_kernel`` and ``_bwd_kernel``): every level's trilinear samples,
channels-first, in one launch of ``csrc/multilevel_gather3d.cu`` (K4, the
op ``occformer::k4_fwd``), with K4-bwd (``occformer::k4_bwd``) as its
registered backward (d_tables, and d_coords when the
coordinates require grad), which sums d_tables in the same fixed order as
K1-bwd's d_value.  K4 is one row-wide kernel for every row, which reads
each corner row as vectors of the width ``multi_fwd_path`` picks (the
deformable attention's C = 24: 16 bytes; a misaligned table is copied to an
aligned buffer first).  Its plain version is
``fused_multilevel_gather_plain``; ``MULTI_LAUNCHES`` and
``MULTI_BWD_LAUNCHES`` count the two kernels' launches,
``MULTI_ROW_LAUNCHES`` K4's row-wide ones (every launch of K4).

The analytic count (``utils/flops.py``) sees inside no op: K1's wrapper
and its backward report, on either device, the matrix products its plain
version's weighted sum runs (the einsum over the P samples, in the forward
and in the backward), so that a count does not depend on the route.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..utils import flops
from . import cuda_build, library

# launches of the forward (K1) and backward (K1-bwd) kernels, and of K1's
# row-wide kernel (every K1 launch); a caller may reset them to 0
LAUNCHES = 0
BWD_LAUNCHES = 0
ROW_LAUNCHES = 0
# K1's lanes per output row; the chip measurements behind it are in
# csrc/ms_deform_gather3d.cu's header
ROW_LANES = 2
# launches of K4 and K4-bwd, and of K4's row-wide kernel (every K4 launch)
MULTI_LAUNCHES = 0
MULTI_BWD_LAUNCHES = 0
MULTI_ROW_LAUNCHES = 0
MAX_LEVELS = 8  # csrc/multilevel_gather3d.cu:MAX_LEVELS

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_FNS = {}


def _vector_bytes(channels: int, dtype, data_ptrs) -> int:
    """The widest of 16, 8, 4 and 2 bytes that divides a row of
    ``channels`` elements of ``dtype`` (float32 or bfloat16) and every
    address in ``data_ptrs``."""
    if dtype not in _DTYPE_CODE:
        raise TypeError(f"the kernel takes float32 or bfloat16 rows; got {dtype}")
    esize = 2 if dtype == torch.bfloat16 else 4
    for vb in (16, 8, 4, 2):
        if vb >= esize and (channels * esize) % vb == 0 and all(p % vb == 0 for p in data_ptrs):
            return vb
    raise ValueError(f"no vector width takes {channels} channels of {dtype} at "
                     f"{[p % 16 for p in data_ptrs]} bytes past 16-byte boundaries")


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
    """The C entry point ``ms_deform_gather3d_{fwd_rows,bwd,bwd_workspace}``
    with its argtypes."""
    if name not in _FNS:
        fn = getattr(cuda_build.load("ms_deform_gather3d"), name)
        if name.endswith("workspace"):  # B, Nv, Nq, H, L, P, levels
            fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
            fn.restype = ctypes.c_longlong
        else:
            n_ptr = 8 if name.endswith("bwd") else 4
            n_opts = 3 if name.endswith("rows") else 1  # dtype (, vec, lanes)
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


def ms_deform_fwd_path(head_dim: int, dtype, data_ptrs=()) -> int:
    """K1's vector width in bytes: the widest of 16, 8, 4 and 2 that divides
    a float32 or bfloat16 row of ``head_dim`` channels and the value's and
    output's ``data_ptrs`` (hd = 24: 16; hd = 12 in bfloat16: 8); raises
    for another dtype."""
    return _vector_bytes(head_dim, dtype, data_ptrs)


def _launch_fwd(value, spatial_shapes, locs, weights, vec=None, lanes=None):
    """K1 with vectors of ``vec`` bytes and ``lanes`` lanes per output row
    (``ROW_LANES`` by default).  By default the row's own width
    (``ms_deform_fwd_path`` of the row alone), a value whose address it does
    not divide copied once to an aligned buffer first: faster than reading
    it with the narrower vector its address allows
    (``csrc/ms_deform_gather3d.cu``'s header)."""
    global LAUNCHES, ROW_LAUNCHES
    B, Nv, H, hd = value.shape
    Nq, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    out = torch.empty((B, Nq, H, hd), dtype=value.dtype, device=value.device)
    if vec is None:
        vec = ms_deform_fwd_path(hd, value.dtype)
        if value.data_ptr() % vec:  # misaligned: one copy to an aligned buffer
            value = value.clone()
    with torch.cuda.device(value.device):
        rc = _kernel_fn("ms_deform_gather3d_fwd_rows")(
            value.data_ptr(), locs.data_ptr(), weights.data_ptr(), out.data_ptr(),
            B, Nv, Nq, H, hd, L, P, _levels(spatial_shapes), _DTYPE_CODE[value.dtype], vec,
            lanes or ROW_LANES, torch.cuda.current_stream(value.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_gather3d ({vec}-byte vectors) launch failed: "
                           f"cudaError {rc}")
    LAUNCHES += 1
    ROW_LAUNCHES += 1
    return out


def _launch_bwd(value, spatial_shapes, locs, weights, gout):
    """K1-bwd: (d_value, d_locs, d_weights) in value's, float32 and weights'
    dtypes, each written once by the kernels; d_value's rows are summed in
    float32 in a fixed order (each row's terms in ascending sample order),
    so two calls give the same bits."""
    global BWD_LAUNCHES
    B, Nv, H, hd = value.shape
    Nq, L, P = locs.shape[1], locs.shape[3], locs.shape[4]
    dev = value.device
    gout = gout.to(value.dtype).contiguous()
    d_value = torch.empty(value.shape, dtype=value.dtype, device=dev)
    d_locs = torch.empty(locs.shape, dtype=torch.float32, device=dev)
    d_weights = torch.empty(weights.shape, dtype=weights.dtype, device=dev)
    with torch.cuda.device(dev):
        workspace = torch.empty(
            _kernel_fn("ms_deform_gather3d_bwd_workspace")(B, Nv, Nq, H, L, P,
                                                           _levels(spatial_shapes)),
            dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _kernel_fn("ms_deform_gather3d_bwd")(
            value.data_ptr(), locs.data_ptr(), weights.data_ptr(), gout.data_ptr(),
            d_value.data_ptr(), d_locs.data_ptr(), d_weights.data_ptr(),
            workspace.data_ptr(), B, Nv, Nq, H, hd, L, P, _levels(spatial_shapes),
            _DTYPE_CODE[value.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"ms_deform_gather3d_bwd launch failed: cudaError {rc}")
    BWD_LAUNCHES += 1
    return d_value, d_locs, d_weights


def _weighted_sum_flops(value, weights) -> int:
    """The plain version's weighted sum over the samples, a batched matrix
    product of 2 * B * Nq * H * hd * L * P FLOPs (the JAX package's einsum
    too), which the analytic count would see on the CPU."""
    return 2 * weights.numel() * value.shape[-1]


def _flat_shapes(spatial_shapes) -> List[int]:
    return [int(v) for shp in spatial_shapes for v in shp]


def _shapes(flat: Sequence[int]):
    return tuple(tuple(flat[i:i + 3]) for i in range(0, len(flat), 3))


@torch.library.custom_op(library.qualname("k1_fwd"), mutates_args=(), device_types="cuda")
def _k1_fwd(value: torch.Tensor, locs: torch.Tensor, weights: torch.Tensor,
            shapes: List[int]) -> torch.Tensor:
    """K1 (the op's CUDA implementation)."""
    return _launch_fwd(value, _shapes(shapes), locs, weights)


@_k1_fwd.register_kernel("cpu")
def _(value, locs, weights, shapes):
    return ms_deform_gather_3d_plain(value, _shapes(shapes), locs, weights)


@_k1_fwd.register_fake
def _(value, locs, weights, shapes):
    B, Nv, H, hd = value.shape
    return value.new_empty((B, locs.shape[1], H, hd))


@torch.library.custom_op(library.qualname("k1_bwd"), mutates_args=(), device_types="cuda")
def _k1_bwd(value: torch.Tensor, locs: torch.Tensor, weights: torch.Tensor,
            gout: torch.Tensor, shapes: List[int]) -> List[torch.Tensor]:
    """K1-bwd (the op's CUDA implementation): [d_value, d_locs, d_weights]."""
    return list(_launch_bwd(value, _shapes(shapes), locs, weights, gout))


@_k1_bwd.register_kernel("cpu")
def _(value, locs, weights, gout, shapes):
    return library.plain_grads(
        lambda v, lc, w: ms_deform_gather_3d_plain(v, _shapes(shapes), lc, w),
        (value, locs, weights), (True, True, True), (gout,))


@_k1_bwd.register_fake
def _(value, locs, weights, gout, shapes):
    return [torch.empty_like(value, memory_format=torch.contiguous_format),
            locs.new_empty(locs.shape, dtype=torch.float32),
            torch.empty_like(weights, memory_format=torch.contiguous_format)]


def _k1_setup(ctx, inputs, output):
    value, locs, weights, shapes = inputs
    ctx.save_for_backward(value, locs, weights)
    ctx.shapes = shapes
    ctx.autocast = library.autocast_state(value.device.type)


def _k1_backward(ctx, gout):
    """K1-bwd; reports to an active analytic count the matrix products that
    the plain version's backward runs (one for the samples' gradient, one
    for the weights')."""
    value, locs, weights = ctx.saved_tensors
    need = ctx.needs_input_grad
    flops.add("dot", _weighted_sum_flops(value, weights)
              * (int(need[0] or need[1]) + int(need[2])))
    with library.replay_autocast(value.device.type, ctx.autocast):
        d_value, d_locs, d_weights = _k1_bwd(value, locs, weights, gout, ctx.shapes)
    return (d_value if need[0] else None, d_locs if need[1] else None,
            d_weights if need[2] else None, None)


_k1_fwd.register_autograd(_k1_backward, setup_context=_k1_setup)


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
    # the plain version's weighted sum, which the analytic count does not
    # see inside the op
    flops.add("dot", _weighted_sum_flops(value, weights))
    if all(t.device.type == "cpu" for t in tensors):
        return _k1_fwd(value, locs, weights, _flat_shapes(spatial_shapes))
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
    return _k1_fwd(value, locs, weights, _flat_shapes(spatial_shapes))


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
    """The C entry point ``multilevel_gather3d_{fwd_rows,bwd,bwd_workspace}``
    with its argtypes."""
    if name not in _FNS:
        fn = getattr(cuda_build.load("multilevel_gather3d"), name)
        if name.endswith("workspace"):  # L, dims, G
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int]
            fn.restype = ctypes.c_longlong
        else:
            # L, tables, coords, outs (fwd) / gout rows, d_tables, d_coords,
            # workspace (bwd), dims, G, C, align, dtype (, vec: fwd), stream
            fwd = name.endswith("rows")
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (3 if fwd else 6)
                           + [ctypes.POINTER(ctypes.c_int)] + [ctypes.c_int] * (5 if fwd else 4)
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def multi_fwd_path(channels: int, dtype, data_ptrs=()) -> int:
    """K4's vector width in bytes: the widest of 16, 8, 4 and 2 that divides
    a float32 or bfloat16 row of ``channels`` and every table's
    ``data_ptrs`` (C = 24: 16; C = 6 in float32: 8); raises for another
    dtype."""
    return _vector_bytes(channels, dtype, data_ptrs)


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def _multi_dims(spatials, coords):
    dims = [d for (X, Y, Z), c in zip(spatials, coords) for d in (X, Y, Z, c.shape[1])]
    return (ctypes.c_int * len(dims))(*dims)


def _launch_multi_fwd(tables, spatials, channels, coords, align_corners, vec=None):
    """K4 with vectors of ``vec`` bytes; by default the row's own width
    (``multi_fwd_path`` of the row alone), each table whose address it does
    not divide copied once to an aligned buffer first, as K1's value."""
    global MULTI_LAUNCHES, MULTI_ROW_LAUNCHES
    dev, dtype = tables[0].device, tables[0].dtype
    if vec is None:
        vec = multi_fwd_path(channels, dtype)
        tables = [t.clone() if t.data_ptr() % vec else t for t in tables]
    G = tables[0].shape[0]
    outs = [torch.empty((G, channels, c.shape[1]), dtype=dtype, device=dev) for c in coords]
    with torch.cuda.device(dev):
        rc = _multi_fn("multilevel_gather3d_fwd_rows")(
            len(tables), _pointers(tables), _pointers(coords), _pointers(outs),
            _multi_dims(spatials, coords), G, channels, int(bool(align_corners)),
            _DTYPE_CODE[dtype], vec, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multilevel_gather3d ({vec}-byte vectors) launch failed: "
                           f"cudaError {rc}")
    MULTI_LAUNCHES += 1
    MULTI_ROW_LAUNCHES += 1
    return outs


def _split_rows(d_all, tables):
    """The rows ``[sum_l G * X_l * Y_l * Z_l, C]`` of every level's d_table
    as views in the tables' shapes."""
    d_tables, row = [], 0
    for t in tables:
        n = t.numel() // d_all.shape[1]
        d_tables.append(d_all[row:row + n].view(t.shape))
        row += n
    return d_tables


def _launch_multi_bwd(tables, spatials, channels, coords, gouts, align_corners,
                      want_coords):
    """K4-bwd: (d_tables in the tables' dtype, each row summed in float32 in
    a fixed order (ascending (g, sample)) and written once, so that two calls
    give the same bits; d_coords float32, or None).  gout is read as rows:
    each level's [G, C, S_l] transposed into its slice of one
    [sum_l G * S_l, C] buffer, in one pass."""
    d_all, d_coords = _launch_multi_bwd_rows(tables, spatials, channels, coords, gouts,
                                             align_corners, want_coords)
    return _split_rows(d_all, tables), d_coords


def _launch_multi_bwd_rows(tables, spatials, channels, coords, gouts, align_corners,
                           want_coords):
    """K4-bwd as ``_launch_multi_bwd``, every level's d_table in one buffer
    of rows ``[sum_l G * X_l * Y_l * Z_l, C]``."""
    global MULTI_BWD_LAUNCHES
    dev, dtype = tables[0].device, tables[0].dtype
    C = channels
    gout_rows = torch.empty((sum(g.numel() for g in gouts) // C, C), dtype=dtype, device=dev)
    row = 0
    for g in gouts:
        n = g.numel() // C
        gout_rows[row:row + n].view(g.shape[0], g.shape[2], C).copy_(g.transpose(1, 2))
        row += n
    d_all = torch.empty((sum(t.numel() for t in tables) // C, C), dtype=dtype, device=dev)
    d_coords = ([torch.empty(c.shape, dtype=torch.float32, device=dev) for c in coords]
                if want_coords else None)
    dims = _multi_dims(spatials, coords)
    G = tables[0].shape[0]
    with torch.cuda.device(dev):
        workspace = torch.empty(_multi_fn("multilevel_gather3d_bwd_workspace")(
            len(tables), dims, G), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _multi_fn("multilevel_gather3d_bwd")(
            len(tables), _pointers(tables), _pointers(coords), gout_rows.data_ptr(),
            d_all.data_ptr(), None if d_coords is None else _pointers(d_coords),
            workspace.data_ptr(), dims, G, C, int(bool(align_corners)),
            _DTYPE_CODE[dtype], stream)
    if rc != 0:
        raise RuntimeError(f"multilevel_gather3d_bwd launch failed: cudaError {rc}")
    MULTI_BWD_LAUNCHES += 1
    return d_all, d_coords


@torch.library.custom_op(library.qualname("k4_fwd"), mutates_args=(), device_types="cuda")
def _k4_fwd(tables: List[torch.Tensor], coords: List[torch.Tensor], shapes: List[int],
            channels: int, align_corners: bool) -> List[torch.Tensor]:
    """K4 (the op's CUDA implementation)."""
    return _launch_multi_fwd(tables, _shapes(shapes), channels, coords, align_corners)


@_k4_fwd.register_kernel("cpu")
def _(tables, coords, shapes, channels, align_corners):
    return fused_multilevel_gather_plain(tables, _shapes(shapes), channels, coords,
                                         align_corners)


@_k4_fwd.register_fake
def _(tables, coords, shapes, channels, align_corners):
    return [t.new_empty((t.shape[0], channels, c.shape[1])) for t, c in zip(tables, coords)]


@torch.library.custom_op(library.qualname("k4_bwd"), mutates_args=(), device_types="cuda")
def _k4_bwd(tables: List[torch.Tensor], coords: List[torch.Tensor], gouts: List[torch.Tensor],
            shapes: List[int], channels: int, align_corners: bool,
            want_coords: bool) -> List[torch.Tensor]:
    """K4-bwd (the op's CUDA implementation): every level's d_table in one
    buffer of rows (``_split_rows``: an op's outputs may not share memory),
    then with ``want_coords`` the L d_coords."""
    d_all, d_coords = _launch_multi_bwd_rows(tables, _shapes(shapes), channels, coords, gouts,
                                             align_corners, want_coords)
    return [d_all] + (d_coords or [])


@_k4_bwd.register_kernel("cpu")
def _(tables, coords, gouts, shapes, channels, align_corners, want_coords):
    L = len(tables)
    grads = library.plain_grads(
        lambda *ts: fused_multilevel_gather_plain(ts[:L], _shapes(shapes), channels, ts[L:],
                                                  align_corners),
        tables + coords, [True] * L + [want_coords] * L, gouts)
    d_all = torch.cat([d.reshape(-1, channels) for d in grads[:L]])
    return [d_all] + (grads[L:] if want_coords else [])


@_k4_bwd.register_fake
def _(tables, coords, gouts, shapes, channels, align_corners, want_coords):
    rows = sum(t.numel() for t in tables) // channels
    return ([tables[0].new_empty((rows, channels))]
            + ([c.new_empty(c.shape, dtype=torch.float32) for c in coords]
               if want_coords else []))


def _k4_setup(ctx, inputs, output):
    tables, coords, shapes, channels, align_corners = inputs
    ctx.save_for_backward(*tables, *coords)
    ctx.opts = (shapes, channels, align_corners)
    ctx.autocast = library.autocast_state(tables[0].device.type)


def _k4_backward(ctx, gouts):
    shapes, channels, align_corners = ctx.opts
    L = len(shapes) // 3
    tensors = ctx.saved_tensors
    need_tables, need_coords = ctx.needs_input_grad[:2]  # a flag per level
    if not any(need_tables) and not any(need_coords):
        return [None] * L, [None] * L, None, None, None
    tables, coords = list(tensors[:L]), list(tensors[L:])
    gouts = [torch.zeros(t.shape[0], channels, c.shape[1], dtype=t.dtype, device=t.device)
             if g is None else g for g, t, c in zip(gouts, tables, coords)]
    with library.replay_autocast(tables[0].device.type, ctx.autocast):
        grads = _k4_bwd(tables, coords, gouts, shapes, channels, align_corners,
                        any(need_coords))
    d_tables = _split_rows(grads[0], tables)
    d_coords = grads[1:] or [None] * L
    return ([d if n else None for d, n in zip(d_tables, need_tables)],
            [d if n else None for d, n in zip(d_coords, need_coords)], None, None, None)


_k4_fwd.register_autograd(_k4_backward, setup_context=_k4_setup)


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
        return _k4_fwd(tables, coords, _flat_shapes(spatials), C, bool(align_corners))
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
    return _k4_fwd(tables, coords, _flat_shapes(spatials), C, bool(align_corners))
