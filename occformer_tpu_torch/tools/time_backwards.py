"""Time the redesigned gather kernels of a checkout of the port on the card.

    python3 occformer_tpu_torch/tools/time_backwards.py [--root DIR] [--label NAME]
        [--only GROUPS] [--sweep]

K1 (``ops/trilerp_fused.py:_launch_fwd``) at the flagship's deformable
attention shapes in bf16 and float32 and K1-bwd (``_launch_bwd``) in bf16,
each at uniform and at local locations (``flagship_gather_inputs``, which
``chip_smoke.py`` draws its K1 inputs from too); K2-bwd (``ops/trilerp.py:_launch_bwd``) at the per-layer loss
route's candidate (150528 points) and random-fill (17 x 12544 points)
readouts of the bf16 feature ``[1, 128, 128, 16, 192]``, border,
align_corners=False; K2 (``ops/trilerp.py:_launch_fwd``) at that candidate
readout, at the per-layer route's GT masks (bool ``[17, 256, 256, 32, 1]``,
17 x 12544 points) and GT table (bool ``[1, 256, 256, 32, 17]`` at the
150528 candidates), and at the batched route's match (bf16 ``[10, 128,
128, 16, 100]``, 10 x 50176 points) and per-slot (float32 C = 17 at 10 x
150528 points, C = 1 at 170 x 12544) volumes; and K4
(``ops/trilerp_fused.py:_launch_multi_fwd``) at the deformable attention's
pyramid (``k4_inputs``, bf16 and float32), and at bench.py's parity-gate
shapes by the profiler's device time; K2-bwd's narrow path at the batched
route's two differentiated readouts, at random points and at the same
points sorted by column (``k2_bwd_narrow_cases``), two calls compared bit
for bit; S1 (``ops/scatter.py:voxel_scatter_lifted``, sort included) at
the flagship's LSS shapes (``s1_inputs``) seen from a forward-looking
nuScenes rig (``NUSCENES_RIG``) and from ``make_train_batch``'s synthetic
cameras, with a digest of its volume (two checkouts' volumes are bit-equal
when their digests are), its peak memory beyond its inputs, and the valid
points, filled voxels and the largest voxel's points, and its backward
(autograd through S1 on a seeded volume gradient: S1-bwd, or the plain
gathers in a checkout without it; ``backward_record``) and, where the
checkout has S1-bwd, the kernel and its plain version in turns; K3
(``ops/loss_gather.py:sample_id_masks``) at the batched route's three GT
reads (``k3_cases``), with a digest of its masks, and at the candidates
with one slot and beside a plain write of its output (what holds it
back); K4-bwd (``_launch_multi_bwd``) at the deformable attention's shapes
beside the three ``F.grid_sample`` backwards; each backward's two calls
compared bit for bit, its device time by kernel and its peak memory
beyond its inputs; the flagship's train step on each loss route by the
profiler's device time, all kernels, K1-bwd's, K2-bwd's, the convolutions'
backward and the DCN's sampler, its peak memory and its host seconds
(``step_profile``); and the flagship's serving frame, its host ms, peak and
device ms (``serve_profile``).  Each kernel time is the
median ms of 30 CUDA-event timed launches, on the path the checkout picks;
K1 and K2 also by the profiler's device time.  ``--root`` names the checkout whose
``occformer_tpu_torch`` is imported (this one by default), so that two
versions can be timed in turns on one card:

    for r in parent . . parent; do python3 .../time_backwards.py --root $r; done

S1-rows (``ops/scatter.py:voxel_scatter``, the use_voxel_net splat, sort
included) at the use_voxel_net flagship's shapes, [1, 473,088, 128] rows in
bf16 and float32 at ``NUSCENES_RIG`` (``rows_inputs``), with a digest of
its volume, two calls compared bit for bit, its device time by kernel and
its peak memory beyond its inputs, and its backward as S1's (S1-rows-bwd
against the plain gather); FPS (``ops/pointcloud.py:
furthest_point_sample``) at VoteNet's SA1 size [8, 20000, 3] -> 2048
(``fps_inputs``), with and without invalid points: a digest of its indices,
its device ms, its microseconds a step and the cluster size it took.

K1's and K4's other rows (``K1.other``, ``K4.other``: ``K1_OTHER_ROWS``,
``K4_OTHER_ROWS``, rows that are not whole 16-byte vectors at 16-byte
aligned pointers) on the path the checkout picks, by events and device
time, beside their bounds (K4's beside ``F.grid_sample``), a misaligned
input also with its copy to an aligned buffer inside the timed call; the
flagship's K1 and K4 outputs also as digests (two checkouts give the same
bits when their digests agree) and K4's by device time.

``--only`` names the groups to time (K1, K1.other, K1-bwd, K2-bwd,
K2-bwd.narrow, S1, S1-rows, FPS, K2, K3, K4, K4.other, K4-bwd, step,
step.r101 (the R101-DCN 896x1600's train step on the per-layer route, as
``step_profile``); all by default), and the sweeps of those groups.

``--sweep`` also times both of K2-bwd's paths, and both of K2's forward
paths, at the candidate readout's shape over row widths C = 8 ... 192, in
turns (the measurements behind ``ops/trilerp.py:SEGMENTED_MIN_C`` and
``fwd_path``), K2's row-wide path at C = 192 over its lane-group sizes
1 ... 32, K2's narrow path at the batched route's C = 17 and C = 100 over
and the GT table's C = 17 over its lane-group sizes and at C = 1 (the GT
masks, the random fill) over its
points per lane (``NARROW_CHUNKS_PER_LANE``, ``NARROW_POINTS_PER_LANE``),
K2-bwd's narrow path over its lanes per column (``column_lanes``),
K1 over its lanes per row at the uniform and local locations in bf16 and
float32 and at its other rows (``ROW_LANES``), and FPS at
each cluster size its launcher can take, forced (1, 2, 4, 8, 16 CTAs a
cloud; it needs a checkout whose ``_launch_fps`` takes ``cluster``).  It prints
one JSON line and exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import sys
import time

SWEEP_WIDTHS = (8, 16, 32, 40, 48, 56, 64, 128, 192)
LANE_SWEEP = (1, 2, 4, 8, 16, 32)
POINTS_SWEEP = (1, 2, 4)
# the pyramid of the deformable attention, largest level first, as bench.py
K4_PYRAMID = [(64, 64, 8), (32, 32, 4), (16, 16, 2)]


def flagship_gather_inputs(dtype, local, seed=0, hd=24, offset=0):
    """K1's inputs at the flagship's shapes on the card: B=1, H=8, hd=24 (or
    ``hd``), P=4, levels (16,16,2), (32,32,4), (64,64,8), Nq = 37376.
    ``local=False``: locations uniform over [-a, 1+a]^3 with a = 0.018, so
    that about 10% of samples have a coordinate outside [0, 1];
    ``local=True``: each query's own grid center plus up to +-2 voxels, the
    spread of the model's radial offset init.  ``offset``: the value starts
    that many bytes past a 16-byte boundary (a view into a larger buffer).
    Returns (value, shapes, locs, weights)."""
    import numpy as np
    import torch

    from occformer_tpu_torch.models.pixel_decoder import reference_points

    shapes = [(16, 16, 2), (32, 32, 4), (64, 64, 8)]
    B, H, L, P = 1, 8, 3, 4
    Nq = sum(x * y * z for x, y, z in shapes)
    rng = np.random.RandomState(seed)
    value = rng.randn(B, Nq, H, hd).astype(np.float32)
    if local:
        ref = reference_points(shapes)[None, :, None, None, None, :]
        norm = np.asarray(shapes, np.float32)[None, None, None, :, None, :]
        locs = ref + rng.uniform(-2, 2, (B, Nq, H, L, P, 3)) / norm
    else:
        locs = rng.uniform(-0.018, 1.018, (B, Nq, H, L, P, 3))
    w = rng.rand(B, Nq, H, L * P)
    w = (w / w.sum(-1, keepdims=True)).reshape(B, Nq, H, L, P)
    dev = torch.device("cuda")
    return (misaligned(torch.from_numpy(value).to(dev, dtype), offset), shapes,
            torch.from_numpy(locs.astype(np.float32)).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev, dtype))


def misaligned(t, offset):
    """``t``'s values in a view that starts ``offset`` bytes past a 16-byte
    boundary (``t`` itself for 0)."""
    import torch

    if offset == 0:
        return t
    k = offset // t.element_size()
    buf = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)
    out = buf[k:].view(t.shape).copy_(t)
    assert out.data_ptr() % 16 == offset % 16
    return out


def k4_inputs(case, dtype=None, seed=6, C=24, offset=0):
    """K4's inputs on the card: (a) "gate", bench.py's _kernel_parity shapes:
    G = 8, C = 24, S = 512 per level, coords uniform in [-1.1, 1.1], float32;
    (b) "flagship", the deformable attention's: G = B * H = 8, C = hd = 24
    (or ``C``), S_l = Nq * P = 37376 * 4, bf16 tables (or ``dtype``),
    locations uniform over [-0.018, 1.018] as ``flagship_gather_inputs`` draws
    them (2 * loc - 1 in [-1, 1] terms); ``offset``: each table starts that
    many bytes past a 16-byte boundary.  Returns (tables [G, X*Y, Z*C],
    coords, C)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    G = 8
    if case == "gate":
        S, dtype = 512, dtype or torch.float32
        draw = [rng.uniform(-1.1, 1.1, (G, S, 3)) for _ in K4_PYRAMID]
    else:
        S, dtype = 37376 * 4, dtype or torch.bfloat16
        draw = [2.0 * rng.uniform(-0.018, 1.018, (G, S, 3)) - 1.0 for _ in K4_PYRAMID]
    dev = torch.device("cuda")
    tables = [misaligned(torch.from_numpy(rng.randn(G, X * Y, Z * C).astype(np.float32)).to(
        dev, dtype), offset) for X, Y, Z in K4_PYRAMID]
    coords = [torch.from_numpy(c.astype(np.float32)).to(dev) for c in draw]
    return tables, coords, C


# K1's and K4's other rows: rows that are not whole 16-byte vectors at 16-byte
# aligned pointers, at the flagship's pyramid, P and Nq (K1) and at
# K4_PYRAMID's deformable-attention shapes (K4): (name, dtype name, row
# width, bytes past a 16-byte boundary)
K1_OTHER_ROWS = (("hd12_bf16", "bfloat16", 12, 0), ("hd24_f32_off4", "float32", 24, 4),
                 ("hd6_f32", "float32", 6, 0), ("hd7_bf16", "bfloat16", 7, 0))
K4_OTHER_ROWS = (("C6_f32", "float32", 6, 0), ("C12_bf16", "bfloat16", 12, 0),
                 ("C24_bf16_off4", "bfloat16", 24, 4))


def k1_other_rows(device_ms):
    """K1 at ``K1_OTHER_ROWS`` on the path the checkout picks: ms by events
    and by the profiler's device time, the plain version's ms, the path,
    the bound (every input read once, the output written once, over 3.35
    TB/s; 16 float32 operations per (sample, channel) over 67 TFLOP/s), the
    output's bytes and two calls compared bit for bit; a misaligned value also with the
    copy to an aligned buffer timed as part of the call and, where the
    checkout can force a width, read with the narrower vector its address
    allows (the two ways to take such a value)."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.utils.timing import bound, nbytes, time_cuda

    recs = {}
    for name, dt, hd, offset in K1_OTHER_ROWS:
        dtype = getattr(torch, dt)
        value, shapes, locs, w = flagship_gather_inputs(dtype, False, hd=hd, offset=offset)

        def call():
            return k1._launch_fwd(value, shapes, locs, w)

        out = call()
        ref = k1.ms_deform_gather_3d_plain(value.float(), shapes, locs, w.float())
        B, Nq, H, L, P = w.shape
        rec = {"path": str(k1.ms_deform_fwd_path(hd, dtype, (value.data_ptr(), out.data_ptr()))),
               "row_path": str(k1.ms_deform_fwd_path(hd, dtype)),
               "bit_equal_calls": bool(torch.equal(out, call())),
               "max_abs_err": (out.float() - ref).abs().max().item(),
               "max_abs_plain": ref.abs().max().item(),
               "ms": time_cuda(call), "device_ms": device_ms(call),
               "plain_ms": time_cuda(lambda: k1.ms_deform_gather_3d_plain(value, shapes, locs, w),
                                     iters=10),
               "out_bytes": nbytes(out),
               **bound(nbytes(value, locs, w, out), B * Nq * H * L * P * hd * 8 * 2)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
        del ref
        if offset:
            rec["copy_ms"] = time_cuda(lambda: k1._launch_fwd(value.clone(), shapes, locs, w))
            rec["copy_device_ms"] = device_ms(
                lambda: k1._launch_fwd(value.clone(), shapes, locs, w))
            if "vec" in inspect.signature(k1._launch_fwd).parameters:
                # the other way: the narrower vector the value's address allows
                rec["narrow_device_ms"] = device_ms(
                    lambda: k1._launch_fwd(value, shapes, locs, w, vec=int(rec["path"])))
        recs[name] = rec
        del value, locs, w, out
    return recs


def k1_other_sweep(device_ms, lanes=(1, 2, 4, 8)):
    """K1 at ``K1_OTHER_ROWS``' aligned rows over lanes per row, on the
    row's vector width: device ms twice each, in turns."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k1

    recs = {}
    for name, dt, hd, offset in K1_OTHER_ROWS:
        if offset:
            continue
        dtype = getattr(torch, dt)
        value, shapes, locs, w = flagship_gather_inputs(dtype, False, hd=hd)
        ms = {str(n): [] for n in lanes}
        for n in lanes + lanes[::-1]:
            ms[str(n)].append(device_ms(lambda: k1._launch_fwd(value, shapes, locs, w, lanes=n)))
        recs[name] = {"device_ms_by_lanes": ms, "default": k1.ROW_LANES}
        del value, locs, w
    return recs


def k4_other_rows(device_ms):
    """K4 at ``K4_OTHER_ROWS`` on the path the checkout picks, as
    ``k1_other_rows`` times K1 (8 FMAs per (sample, channel)), beside the
    library's three F.grid_sample calls on channels-first copies of the
    levels (grids in the tables' dtype); misaligned tables also with their
    copies to aligned buffers timed as part of the call and, where the
    checkout can force a width, read with the narrower vector."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp_fused as k4
    from occformer_tpu_torch.utils.timing import bound, nbytes, time_cuda

    recs = {}
    for name, dt, C, offset in K4_OTHER_ROWS:
        dtype = getattr(torch, dt)
        tables, coords, _ = k4_inputs("flagship", dtype, C=C, offset=offset)
        G = tables[0].shape[0]

        def call():
            return k4._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False)

        outs = call()
        ref = k4.fused_multilevel_gather_plain(tables, K4_PYRAMID, C, coords)
        S_tot = sum(c.shape[1] for c in coords)
        rec = {"path": str(k4.multi_fwd_path(C, dtype, [t.data_ptr() for t in tables])),
               "row_path": str(k4.multi_fwd_path(C, dtype)),
               "bit_equal_calls": all(torch.equal(a, b) for a, b in zip(outs, call())),
               "max_abs_err": max((a.float() - b.float()).abs().max().item()
                                  for a, b in zip(outs, ref)),
               "max_abs_plain": max(b.float().abs().max().item() for b in ref),
               "ms": time_cuda(call), "device_ms": device_ms(call),
               "plain_ms": time_cuda(lambda: k4.fused_multilevel_gather_plain(
                   tables, K4_PYRAMID, C, coords), iters=10),
               "out_bytes": nbytes(*outs),
               **bound(nbytes(*tables, *coords, *outs), G * S_tot * C * 8 * 2)}
        rec["share_of_bound"] = rec["bound_ms"] / rec["device_ms"]
        del ref
        vols = [t.reshape(G, X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous()
                for t, (X, Y, Z) in zip(tables, K4_PYRAMID)]
        grids = [c.flip(-1).reshape(G, -1, 1, 1, 3).to(dtype).contiguous() for c in coords]

        def library():
            return [F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                  align_corners=False) for v, g in zip(vols, grids)]

        rec["library_ms"] = time_cuda(library)
        rec["library_device_ms"] = device_ms(library)
        del vols, grids
        if offset:
            def copied():
                return k4._launch_multi_fwd([t.clone() for t in tables], K4_PYRAMID, C, coords,
                                            False)

            rec["copy_ms"] = time_cuda(copied)
            rec["copy_device_ms"] = device_ms(copied)
            if "vec" in inspect.signature(k4._launch_multi_fwd).parameters:
                rec["narrow_device_ms"] = device_ms(lambda: k4._launch_multi_fwd(
                    tables, K4_PYRAMID, C, coords, False, vec=int(rec["path"])))
        recs[name] = rec
        del tables, coords, outs
    return recs


# the flagship DepthNet's deformable convolution: 6 cameras, 512 channels on
# the 16 x 44 feature map, 3 x 3 taps (models/dcn.py)
DCN_SHAPE = (6, 512, 16, 44)


def dcn_inputs(dtype=None, seed=7, shape=DCN_SHAPE, max_offset=1.5):
    """K4's inputs as the DCN sends them (``models/dcn.py``): the feature
    map [B, C, H, W] channels-last as one level of Z = 1, ``[B, H*W, C]``
    (bf16 as under the flagship's autocast, or ``dtype``), and each output
    pixel's 9 taps at random offsets of up to ``max_offset`` pixels as
    (y, x, 0) in [-1, 1] under align_corners=True, ``[B, 9*H*W, 3]``
    float32.  Returns (tables, coords, C, spatials)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    B, C, H, W = shape
    ky, kx = np.divmod(np.arange(9), 3)
    py = (np.arange(H) - 1)[None, :, None] + ky[:, None, None] \
        + rng.uniform(-max_offset, max_offset, (B, 9, H, W))
    px = (np.arange(W) - 1)[None, None, :] + kx[:, None, None] \
        + rng.uniform(-max_offset, max_offset, (B, 9, H, W))
    coords = np.stack([py / (H - 1) * 2 - 1, px / (W - 1) * 2 - 1, np.zeros_like(py)], -1)
    dev = torch.device("cuda")
    table = torch.from_numpy(rng.randn(B, H * W, C).astype(np.float32)).to(
        dev, dtype or torch.bfloat16)
    return ([table], [torch.from_numpy(coords.reshape(B, -1, 3).astype(np.float32)).to(dev)],
            C, [(H, W, 1)])


def k3_cases(seed=4):
    """K3's inputs on the card, as the batched loss route reads the GT at
    the flagship: an int32 label grid [1, 256, 256, 32] (labels 0-16, 10%
    255), slot ids 0-16 (G = 17), and N = 10 layers' points in [0, 1]: the
    150528 candidates and the 50176 matching points (shared, [10, S, 3]) and
    the 12544 random-fill points of each slot ([10, 17, 12544, 3]).  Yields
    (name, grid, ids, pts)."""
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    G, N = 17, 10
    grid = torch.randint(0, G, (1, 256, 256, 32), device=dev, generator=g, dtype=torch.int32)
    grid[torch.rand(grid.shape, device=dev, generator=g) < 0.1] = 255
    ids = torch.arange(G, device=dev, dtype=torch.int32)[None]
    for name, shape in (("candidates", (N, 150528, 3)), ("matching", (N, 50176, 3)),
                        ("random_fill", (N, G, 12544, 3))):
        yield name, grid, ids, torch.rand(shape, device=dev, generator=g)


def backward_record(key, call, device_ms):
    """A backward wrapper's two calls compared bit for bit, its ms by events
    and by the profiler's device time (all kernels, and by kernel name), and
    its peak memory beyond what was allocated before the call."""
    import torch

    from occformer_tpu_torch.utils.timing import time_cuda

    a, b = call(), call()
    flat = [t for x in (a, b) for t in (x if isinstance(x, (list, tuple)) else [x])
            for t in (t if isinstance(t, (list, tuple)) else [t]) if t is not None]
    half = len(flat) // 2
    rec = {f"{key}_bit_equal_calls": all(torch.equal(x, y)
                                         for x, y in zip(flat[:half], flat[half:]))}
    del a, b, flat
    rec[f"{key}_ms"] = time_cuda(call)
    rec[f"{key}_device_ms"] = device_ms(call)
    rec[f"{key}_device_ms_by_kernel"] = device_ms_by_kernel(call)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    call()
    torch.cuda.synchronize()
    rec[f"{key}_peak_bytes_over_inputs"] = torch.cuda.max_memory_allocated() - base
    return rec


def k4_library_bwd_ms(tables, coords, gouts, C):
    """The library's counterpart of K4-bwd: autograd through one
    F.grid_sample per level on a channels-first copy of the level, the grids
    in the tables' dtype (as chip_smoke.py:phase_k4 times it)."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.utils.timing import time_cuda

    G = tables[0].shape[0]
    vols = [t.reshape(G, X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous().requires_grad_(True)
            for t, (X, Y, Z) in zip(tables, K4_PYRAMID)]
    grids = [c.flip(-1).reshape(G, -1, 1, 1, 3).to(t.dtype).contiguous().requires_grad_(True)
             for c, t in zip(coords, tables)]
    outs = [F.grid_sample(v, x, mode="bilinear", padding_mode="zeros", align_corners=False)
            for v, x in zip(vols, grids)]
    gos = [go.reshape(o.shape) for go, o in zip(gouts, outs)]
    return time_cuda(lambda: torch.autograd.grad(outs, vols + grids, gos, retain_graph=True),
                     iters=10)


def k2_fwd_cases(seed=2):
    """K2's readouts on the card, by name: (table, coords) of the per-layer
    route's candidates, its per-slot GT masks at the random fill and its GT
    table (17 class slots as channels) at the candidates, and the batched
    route's three volumes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = (("candidates", (1, 128, 128, 16, 192), torch.bfloat16, (1, 150528)),
              ("gt_masks", (17, 256, 256, 32, 1), torch.bool, (17, 12544)),
              ("gt_table_candidates", (1, 256, 256, 32, 17), torch.bool, (1, 150528)),
              ("batched_matching", (10, 128, 128, 16, 100), torch.bfloat16, (10, 50176)),
              ("batched_candidates", (10, 128, 128, 16, 17), torch.float32, (10, 150528)),
              ("batched_random_fill", (170, 128, 128, 16, 1), torch.float32, (170, 12544)))
    for name, tshape, dtype, cshape in shapes:
        if dtype == torch.bool:
            table = (torch.rand(tshape, device="cuda", generator=g) < 0.06).view(torch.uint8)
        else:
            table = torch.randn(tshape, device="cuda", generator=g).to(dtype)
        coords = torch.rand((*cshape, 3), device="cuda", generator=g) * 2 - 1
        yield name, table, coords
        del table, coords


def k2_fwd_path_sweep(widths=SWEEP_WIDTHS, lanes=LANE_SWEEP, seed=10):
    """Both K2 forward paths at the candidate readout's shape (bf16 table [1,
    128, 128, 16, C], 150528 points, border) for each row width C, in turns
    (scalar, row, row, scalar), with the path ``fwd_path`` picks; and the
    row-wide path at C = 192 for each lane-group size."""
    import torch

    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.utils.timing import time_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    coords = torch.rand((1, 150528, 3), device="cuda", generator=g) * 2 - 1
    recs = {}
    for C in widths:
        table = torch.randn((1, 128, 128, 16, C), device="cuda", generator=g).to(torch.bfloat16)
        ms = {"scalar": [], "row": []}
        for path in ("scalar", "row", "row", "scalar"):
            ms[path].append(time_cuda(lambda: k2._launch_fwd(
                table, coords, False, "border", path=path)))
        recs[str(C)] = {"scalar_ms": ms["scalar"], "row_ms": ms["row"],
                        "chosen": k2.fwd_path(table.shape, table.dtype, table.data_ptr()),
                        "lanes": k2.row_lanes(C, table.dtype)}
        if C == widths[-1]:
            recs[f"{C}_by_lanes"] = {str(n): [time_cuda(lambda: k2._launch_fwd(
                table, coords, False, "border", path="row", lanes=n)) for _ in range(2)]
                for n in lanes}
        del table
    return recs


def k2_narrow_sweep(lanes=LANE_SWEEP, points=POINTS_SWEEP):
    """K2's narrow forward at the GT and the batched route's readouts
    (``k2_fwd_cases``): over lane-group sizes at C = 17 and C = 100, over
    points per lane at C = 1; ms twice each, in turns over the settings."""
    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.utils.timing import time_cuda

    recs = {}
    for name, table, coords in k2_fwd_cases():
        C = table.shape[-1]
        if name == "candidates":
            continue
        if C == 1:
            key, opts = "points", [{"points": n} for n in points]
        else:
            key, opts = "lanes", [{"lanes": n} for n in lanes]
        ms = {str(o[key]): [] for o in opts}
        for o in opts + opts[::-1]:
            ms[str(o[key])].append(time_cuda(lambda: k2._launch_fwd(
                table, coords, False, "border", path="scalar", **o)))
        vec = k2.narrow_vec(C, table.dtype, table.data_ptr())
        recs[name] = {"C": C, "vec": vec, f"ms_by_{key}": ms,
                      "default_lanes": k2.narrow_lanes(C, vec),
                      "default_points": k2.NARROW_POINTS_PER_LANE}
    return recs


def k1_row_sweep(lanes=LANE_SWEEP):
    """K1 at the flagship's shapes over lanes per row, at uniform and local
    locations, bf16 and float32: ms twice each, in turns."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.utils.timing import time_cuda

    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for where, local in (("uniform", False), ("local", True)):
            value, shapes, locs, w = flagship_gather_inputs(dtype, local)
            ms = {str(n): [] for n in lanes}
            for n in lanes + lanes[::-1]:
                ms[str(n)].append(time_cuda(lambda: k1._launch_fwd(value, shapes, locs, w,
                                                                   lanes=n)))
            recs[f"{str(dtype)[6:]}_{where}"] = {"ms_by_lanes": ms}
            del value, locs, w
    recs["default"] = k1.ROW_LANES
    return recs


def digest(*tensors):
    """sha256 of the tensors' bytes: two checkouts' outputs are bit-equal
    when their digests are."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def device_ms_by_kernel(fn, iters=20):
    """Device ms per call of ``fn()`` by kernel name (its first 80
    characters), from the profiler, as ``utils/timing.py:device_ms`` sums
    them, the trace opened by 16 spin kernels of about 4 ms that the sums
    leave out, as ``utils/timing.py:lead_in`` does (kept here: ``--root``
    may import a checkout without either)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(16):
            torch.cuda._sleep(8_000_000)
        torch.cuda.synchronize()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = {e.key for e in events if e.device_type.name == "CPU" and e.is_user_annotation}
    return {e.key[:80]: e.self_device_time_total / 1e3 / iters for e in events
            if e.device_type.name == "CUDA" and not (e.is_user_annotation or e.key in ranges
                                                     or "spin_kernel" in e.key)}


# A forward-looking six-camera rig in nuScenes' layout, in the flagship's
# camera order: the optical axis's yaw from the ego x axis (degrees, to the
# left positive), the camera's position in the ego frame (m: forward, left,
# up) and its focal length on the 1600 x 900 sensor (px).  Rounded from the
# calibrated_sensor records of nuScenes v1.0 (vehicle n015): yaw to 5
# degrees, position to the cm, focal length to the pixel; pitch and roll 0,
# principal point at the sensor's centre.  The repo holds no nuScenes files
# to read the exact values from.
NUSCENES_RIG = (("CAM_FRONT_LEFT", 55.0, (1.52, 0.49, 1.51), 1273.0),
                ("CAM_FRONT", 0.0, (1.70, 0.02, 1.51), 1266.0),
                ("CAM_FRONT_RIGHT", -55.0, (1.55, -0.49, 1.50), 1261.0),
                ("CAM_BACK_LEFT", 110.0, (1.04, 0.48, 1.59), 1257.0),
                ("CAM_BACK", 180.0, (0.03, 0.00, 1.58), 809.0),
                ("CAM_BACK_RIGHT", -110.0, (1.01, -0.48, 1.56), 1260.0))
NUSCENES_SENSOR = (900, 1600)  # H, W


def nuscenes_rig_cameras(input_size, rig=NUSCENES_RIG, sensor=NUSCENES_SENSOR):
    """Batch-1 camera geometry of ``rig`` at the network input ``input_size``
    (H, W), as ``make_train_batch`` lays it out (rots, trans, intrins,
    post_rots, post_trans, bda; numpy float32).  Camera axes: x right, y
    down, z along the optical axis.  The image is resized by W / sensor W
    and its top rows cropped to H, the flagship's test-time augmentation
    (``data_config``'s ``resize_test`` 0, ``crop_h`` (0, 0))."""
    import numpy as np

    H, W = input_size
    scale = W / sensor[1]
    N = len(rig)
    rots = np.zeros((1, N, 3, 3), np.float32)
    trans = np.zeros((1, N, 3), np.float32)
    intrins = np.zeros((1, N, 3, 3), np.float32)
    for i, (_, yaw, pos, f) in enumerate(rig):
        c, s = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
        # columns: the camera's x (right), y (down) and z (forward) in the ego frame
        rots[0, i] = [[s, 0.0, c], [-c, 0.0, s], [0.0, -1.0, 0.0]]
        trans[0, i] = pos
        intrins[0, i] = [[f, 0.0, sensor[1] / 2], [0.0, f, sensor[0] / 2], [0.0, 0.0, 1.0]]
    post_rots = np.tile(np.diag([scale, scale, 1.0]).astype(np.float32), (1, N, 1, 1))
    post_trans = np.zeros((1, N, 3), np.float32)
    post_trans[..., 1] = -(int(sensor[0] * scale) - H)
    return {"rots": rots, "trans": trans, "intrins": intrins, "post_rots": post_rots,
            "post_trans": post_trans, "bda": np.eye(3, dtype=np.float32)[None]}


def s1_geometry(rig="nuscenes", seed=0, device="cuda"):
    """S1's voxel coordinates at the flagship's LSS geometry (frustum [112,
    16, 44] over 6 cameras, 128 x 128 x 16 voxels): ``rig="nuscenes"`` the
    forward-looking rig above (``NUSCENES_RIG``), ``"synthetic"``
    ``make_train_batch(cfg, seed)``'s cameras (identity rotations: every
    camera looks straight up, so few points fall inside the grid).  Returns
    (coords, valid, nx, frustum shape)."""
    import numpy as np
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_train_batch
    from occformer_tpu_torch.ops.geometry import (compute_voxel_coords, create_frustum,
                                                  gen_dx_bx, get_geometry)

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "occformer_nusc_r50_256x704.py"))
    vt = cfg["model"]["img_view_transformer"]
    gc = vt["grid_config"]
    dx, bx, nx = gen_dx_bx(gc["xbound"], gc["ybound"], gc["zbound"])
    input_size = tuple(vt["data_config"]["input_size"])
    frustum = create_frustum(gc, input_size, vt.get("downsample", 16))
    b = (nuscenes_rig_cameras(input_size) if rig == "nuscenes"
         else make_train_batch(cfg, seed=seed))
    cams = [torch.from_numpy(b[k]).to(device)
            for k in ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")]
    geom = get_geometry(torch.from_numpy(frustum).to(device), *cams)
    coords, valid = compute_voxel_coords(geom, dx, bx, nx)
    return coords, valid, tuple(int(n) for n in np.asarray(nx)), frustum.shape[:3]


def s1_inputs(rig="nuscenes", seed=0):
    """S1's inputs at the flagship's shapes on the card: ``s1_geometry(rig)``,
    a depth softmax over random logits and random context features [1, 6,
    16, 44, 128], both bf16 as under the flagship's autocast.  Returns
    (depth, ctx, coords, valid, nx)."""
    import torch

    coords, valid, nx, (D, fH, fW) = s1_geometry(rig, seed)
    N = coords.shape[1]
    g = torch.Generator(device="cuda").manual_seed(seed)
    depth = torch.softmax(torch.randn((1, N, D, fH, fW), device="cuda", generator=g), 2)
    ctx = torch.randn((1, N, fH, fW, 128), device="cuda", generator=g)
    return depth.to(torch.bfloat16), ctx.to(torch.bfloat16), coords, valid, nx


def rows_inputs(dtype, seed=5):
    """S1-rows' inputs as the use_voxel_net flagship sends them
    (``chip_smoke.py:phase_voxnet_kernels``): the ``NUSCENES_RIG`` frustum's
    473,088 points in the view transformer's order (camera, row, column,
    depth bin), coords int32 [1, P, 3] and valid [1, P], and seeded random
    rows [1, P, 128] in ``dtype``.  Returns (feats, coords, valid, nx)."""
    import torch

    coords, valid, nx, _ = s1_geometry("nuscenes")
    order = (0, 1, 3, 4, 2)  # [B, N, D, fH, fW] -> (camera, row, column, depth bin)
    coords = coords.permute(*order, 5).reshape(1, -1, 3).to(torch.int32).contiguous()
    valid = valid.permute(*order).reshape(1, -1).contiguous()
    feats = torch.randn((1, coords.shape[1], 128), device="cuda",
                        generator=torch.Generator(device="cuda").manual_seed(seed))
    return feats.to(dtype), coords, valid, nx


# FPS at VoteNet's PointNet++ SA1 on ScanNet (chip_smoke.py:PC_FPS): 8 rooms
# of 20,000 points in 8 x 8 x 3 m, 2048 samples each
FPS_SIZE = (8, 20000, 2048)


def fps_inputs(seed=3):
    """FPS's inputs at ``FPS_SIZE`` on the card: seeded uniform rooms
    [8, 20000, 3] and a mask with about 30% of the points invalid."""
    import torch

    B, N, _ = FPS_SIZE
    g = torch.Generator(device="cuda").manual_seed(seed)
    rooms = torch.rand((B, N, 3), device="cuda", generator=g) * torch.tensor(
        [8.0, 8.0, 3.0], device="cuda")
    return rooms, torch.rand((B, N), device="cuda", generator=g) > 0.3


def segment_stats(coords, valid, nx):
    """Valid points, filled voxels and the largest voxel's points of S1's
    sort."""
    import torch

    from occformer_tpu_torch.ops.scatter import voxel_rows

    counts = torch.bincount(voxel_rows(coords, valid, nx).reshape(-1))[:-1]
    return {"points": int(valid.numel()), "points_valid": int(valid.sum()),
            "voxels": int(counts.numel()), "voxels_filled": int((counts > 0).sum()),
            "largest_voxel_points": int(counts.max())}


def splat_backward_record(key, splat, leaves, kernel=None, plain=None, seed=17):
    """A splat's backward in this checkout: autograd through ``splat()``'s
    volume read channels-first, as the occupancy encoder reads it
    (``volume.permute(0, 4, 1, 2, 3)``), on a seeded gradient
    (``backward_record``: S1-bwd / S1-rows-bwd where the checkout has them,
    else the plain gathers), with a digest of the gradients; and, given
    ``kernel`` and ``plain`` (functions of that gradient as rows), the kernel
    alone and its plain version in turns (kernel, plain, plain, kernel) by
    events."""
    import torch

    from occformer_tpu_torch.utils.timing import device_ms, time_cuda

    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    vol = splat(*leaves).permute(0, 4, 1, 2, 3)
    g = torch.randn(vol.shape, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(seed)).to(vol.dtype)

    def call():
        return torch.autograd.grad(vol, leaves, g, retain_graph=True)

    rec = {f"{key}_grads_sha256": digest(*call())}
    rec.update(backward_record(f"{key}_backward", call, device_ms))
    if kernel is not None:
        gout = g.permute(0, 2, 3, 4, 1).reshape(-1, g.shape[1])
        ms = {"kernel": [], "plain": []}
        for name in ("kernel", "plain", "plain", "kernel"):
            ms[name].append(time_cuda(lambda: (kernel if name == "kernel" else plain)(gout)))
        rec[f"{key}_backward_in_turns_ms"] = ms
    del leaves, vol, g
    return rec


def step_profile(route, steps=3, config="occformer_nusc_r50_256x704.py", prefix=""):
    """Device time of ``config``'s train step (the flagship's by default;
    its keys start with ``prefix``) on a loss route
    (``mxu_readout`` "off": the per-layer route, "on": the batched one;
    float32 parameters, bf16 autocast, ``make_train_batch(cfg, seed=0)``,
    random weights), ``steps`` steps after two warm ones under the profiler:
    ms a step of all kernels, of K1-bwd's kernels (every function named
    ``ms_deform_gather3d_bwd*`` / ``ms_deform_bwd*`` or binning
    ``K1Keys``/``K1Geo``/``K1Cand``; a zero-fill or cast around it runs under
    a generic name and is not counted), of K2-bwd's (every function
    named ``trilerp_bwd*`` or sorting ``ColumnKeys``/``CornerKeys``), of the
    convolutions' backward (cuDNN's ``dgrad``/``wgrad`` functions and the
    im2col of ``models/layers.py:Conv2dIm2colBackward``), of the DCN's
    sampler (K4 and K4-bwd's ``multilevel_*`` functions and the ``K4Keys`` /
    ``K4Geo`` steps, or ``F.grid_sample``'s 2-D kernels), of the 20
    costliest functions, the step's peak memory, and the host seconds of
    ``steps`` more steps, each ended by a synchronize."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_train_batch
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", config))
    m = cfg["model"]
    model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout=route),
                              m["train_cfg"]["pts"])
    opt = build_optimizer_from_config(model, cfg, 28130)
    step = build_train_step(model, opt, loss_cfg, device="cuda",
                            compute_dtype=getattr(torch, cfg["compute_dtype"]))
    batch = make_train_batch(cfg, seed=0)
    g = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        step(batch, g)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(batch, g)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    step_s = []
    for _ in range(steps):
        t = time.perf_counter()
        step(batch, g)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step(batch, g)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = {e.key for e in events if e.device_type.name == "CPU" and e.is_user_annotation}
    kernels = {e.key[:100]: e.self_device_time_total / 1e3 / steps for e in events
               if e.device_type.name == "CUDA" and not (e.is_user_annotation
                                                        or e.key in ranges)}
    groups = {"K1-bwd": ("ms_deform_gather3d_bwd", "ms_deform_bwd", "K1Keys", "K1Geo", "K1Cand"),
              "K2-bwd": ("trilerp_bwd", "ColumnKeys", "CornerKeys"),
              "conv_backward": ("dgrad", "wgrad", "im2col"),
              "dcn_sampler": ("multilevel_", "K4Keys", "K4Geo", "grid_sampler_2d")}
    del model, opt, step, batch
    torch.cuda.empty_cache()
    key = prefix + ("step_batched" if route == "on" else "step_per_layer")
    rec = {f"{key}_device_ms": sum(kernels.values()), f"{key}_peak_bytes": peak,
           f"{key}_s": step_s}
    for name, marks in groups.items():
        fns = {k: v for k, v in kernels.items() if any(x in k for x in marks)}
        rec[f"{key}_{name}_device_ms"] = sum(fns.values())
        rec[f"{key}_{name}_by_function"] = fns
    rec[f"{key}_top_functions"] = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:20])
    return rec


def serve_profile(frames=3):
    """The flagship's serving frame (float32 parameters, bf16 autocast,
    ``make_serving_batch(cfg, seed=0)``, random weights): host ms of
    ``frames`` frames after two warm ones, each ended by a synchronize, the
    peak, and by the profiler over ``frames`` more the device ms a frame of
    all kernels and of the DCN's sampler (as ``step_profile`` names it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_serving_batch
    from occformer_tpu_torch.engine.eval import build_eval_step
    from occformer_tpu_torch.models.detector import build_model

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(root, "configs", "occformer_nusc_r50_256x704.py"))
    model = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=0)
    step = build_eval_step(model, tuple(cfg["occ_size"]), cfg["num_class"],
                           getattr(torch, cfg["compute_dtype"]))
    batch = make_serving_batch(cfg, seed=0)
    for _ in range(2):
        step(batch)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    frame_ms = []
    for _ in range(frames):
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            step(batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = {e.key for e in events if e.device_type.name == "CPU" and e.is_user_annotation}
    kernels = {e.key[:100]: e.self_device_time_total / 1e3 / frames for e in events
               if e.device_type.name == "CUDA" and not (e.is_user_annotation
                                                        or e.key in ranges)}
    del model, step, batch
    torch.cuda.empty_cache()
    return {"serve_frame_ms": frame_ms, "serve_peak_bytes": peak,
            "serve_device_ms": sum(kernels.values()),
            "serve_dcn_sampler_device_ms": sum(v for k, v in kernels.items() if any(
                x in k for x in ("multilevel_", "grid_sampler_2d")))}


def k2_bwd_narrow_cases(seed=12):
    """K2-bwd's narrow path at the batched route's two differentiated
    readouts (float32 [10, 128, 128, 16, 17] at 10 x 150528 candidates and
    [170, 128, 128, 16, 1] at 170 x 12544 random-fill points, border), with
    the points in random order and sorted by column as the loss sends them
    (``sort_points_by_row``): yields (name, table, coords, gout)."""
    import torch

    from occformer_tpu_torch.ops.loss_gather import sort_points_by_row

    g = torch.Generator(device="cuda").manual_seed(seed)
    for name, tshape, cshape in (("candidates", (10, 128, 128, 16, 17), (10, 150528)),
                                 ("random_fill", (170, 128, 128, 16, 1), (170, 12544))):
        table = torch.randn(tshape, device="cuda", generator=g)
        pts = torch.rand((*cshape, 3), device="cuda", generator=g)
        gout = torch.randn((*cshape, tshape[-1]), device="cuda", generator=g)
        yield name, table, (pts * 2 - 1).contiguous(), gout
        yield f"{name}_by_column", table, (sort_points_by_row(pts, tshape[1:4]) * 2
                                           - 1).contiguous(), gout
        del table, pts, gout


def k2_bwd_narrow_lanes_sweep(lanes=LANE_SWEEP):
    """K2-bwd's narrow path over lanes per column at the batched readouts,
    points sorted by column: ms twice each, in turns over the settings."""
    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.utils.timing import time_cuda

    recs = {}
    for name, table, coords, gout in k2_bwd_narrow_cases():
        if not name.endswith("by_column"):
            continue
        ms = {str(n): [] for n in lanes}
        for n in lanes + lanes[::-1]:
            ms[str(n)].append(time_cuda(lambda: k2._launch_bwd(
                table, coords, gout, False, "border", False, path="narrow", lanes=n)))
        recs[name] = {"ms_by_lanes": ms, "default": k2.column_lanes(table.shape[-1])}
    return recs


def k2_bwd_path_sweep(widths=SWEEP_WIDTHS, seed=9):
    """Both K2-bwd paths at the candidate readout's shape (bf16 table [1,
    128, 128, 16, C], 150528 points, border) for each row width C: ms lists
    per path and the path ``bwd_path`` picks."""
    import torch

    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.utils.timing import time_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    coords = torch.rand((1, 150528, 3), device="cuda", generator=g) * 2 - 1
    recs = {}
    for C in widths:
        table = torch.randn((1, 128, 128, 16, C), device="cuda", generator=g).to(torch.bfloat16)
        gout = torch.randn((1, coords.shape[1], C), device="cuda", generator=g).to(torch.bfloat16)
        ms = {"narrow": [], "segmented": []}
        for path in ("narrow", "segmented", "segmented", "narrow"):
            ms[path].append(time_cuda(lambda: k2._launch_bwd(
                table, coords, gout, False, "border", want_coords=False, path=path)))
        recs[str(C)] = {"narrow_ms": ms["narrow"], "segmented_ms": ms["segmented"],
                        "chosen": k2.bwd_path(table.shape, coords.shape[1])}
        del table, gout
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the checkout whose port is timed")
    p.add_argument("--label", default=None, help="a name for the run in the output")
    p.add_argument("--sweep", action="store_true",
                   help="also time both paths of K2-bwd and of K2 over row widths 8-192, "
                        "the lane groups of K2's, K2-bwd's narrow and K1's paths, and FPS's "
                        "cluster sizes")
    p.add_argument("--only", default=None,
                   help="comma-separated groups to time (K1, K1.other, K1-bwd, K2-bwd, K2, "
                        "K3, K4, K4.other, K4-bwd, S1, S1-rows, FPS, K2-bwd.narrow, step, "
                        "step.r101, serve); all by default")
    args = p.parse_args(argv)
    only = None if args.only is None else set(args.only.split(","))

    def want(group):
        return only is None or group in only

    import torch

    if not torch.cuda.is_available():
        print("time_backwards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.utils.timing import device_ms, time_cuda

    rec = {"label": args.label or args.root, "root": os.path.abspath(args.root),
           "package": os.path.dirname(k1.__file__), "device": torch.cuda.get_device_name(0)}
    for dtype in (torch.bfloat16, torch.float32) if want("K1") else ():
        for where, local in (("uniform", False), ("local", True)):
            value, shapes, locs, w = flagship_gather_inputs(dtype, local)
            rec[f"K1_{str(dtype)[6:]}_{where}_sha256"] = digest(
                k1._launch_fwd(value, shapes, locs, w))
            rec[f"K1_{str(dtype)[6:]}_{where}_ms"] = time_cuda(
                lambda: k1._launch_fwd(value, shapes, locs, w))
            rec[f"K1_{str(dtype)[6:]}_{where}_device_ms"] = device_ms(
                lambda: k1._launch_fwd(value, shapes, locs, w))
            del value, locs, w
    gen = torch.Generator(device="cuda").manual_seed(1)
    for where, local in (("uniform", False), ("local", True)) if want("K1-bwd") else ():
        value, shapes, locs, w = flagship_gather_inputs(torch.bfloat16, local)
        gout = torch.randn((1, locs.shape[1], 8, 24), device="cuda",
                           generator=gen).to(torch.bfloat16)

        def call():
            return k1._launch_bwd(value, shapes, locs, w, gout)

        key = f"K1-bwd_{where}"
        rec.update(backward_record(key, call, device_ms))
        del value, locs, w, gout
    if want("K4-bwd"):
        tables, coords, C = k4_inputs("flagship")
        g = torch.Generator(device="cuda").manual_seed(8)
        gouts = [torch.randn((t.shape[0], C, c.shape[1]), device="cuda", generator=g).to(t.dtype)
                 for t, c in zip(tables, coords)]

        def call():
            return k1._launch_multi_bwd(tables, K4_PYRAMID, C, coords, gouts, False, True)

        rec.update(backward_record("K4-bwd", call, device_ms))
        rec["K4-bwd_without_d_coords_ms"] = time_cuda(lambda: k1._launch_multi_bwd(
            tables, K4_PYRAMID, C, coords, gouts, False, False))
        rec["K4-bwd_library_ms"] = k4_library_bwd_ms(tables, coords, gouts, C)
        del tables, coords, gouts
    if want("K3"):
        from occformer_tpu_torch.ops import loss_gather as k3

        for name, grid, ids, pts in k3_cases():
            def call():
                return k3.sample_id_masks(grid, ids, pts, False, "border")

            out = call()
            rec[f"K3_{name}_sha256"] = hashlib.sha256(
                out.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            rec[f"K3_{name}_ms"] = time_cuda(call)
            rec[f"K3_{name}_device_ms"] = device_ms(call)
            if name == "candidates":
                # what holds it back: the same points with one slot (the
                # corner reads and one store a point) and a plain write of
                # the output's bytes
                one = ids[:, :1].contiguous()
                rec["K3_candidates_one_slot_device_ms"] = device_ms(
                    lambda: k3.sample_id_masks(grid, one, pts, False, "border"))
                rec["K3_candidates_write_only_device_ms"] = device_ms(lambda: out.fill_(1.0))
            del out
    if want("K2-bwd"):
        g = torch.Generator(device="cuda").manual_seed(2)
        table = torch.randn((1, 128, 128, 16, 192), device="cuda",
                            generator=g).to(torch.bfloat16)
        for where, S in (("candidates", 150528), ("random_fill", 17 * 12544)):
            coords = torch.rand((1, S, 3), device="cuda", generator=g) * 2 - 1
            gout = torch.randn((1, S, 192), device="cuda", generator=g).to(torch.bfloat16)
            rec[f"K2-bwd_{where}_ms"] = time_cuda(lambda: k2._launch_bwd(
                table, coords, gout, False, "border", want_coords=False))
        del table, coords, gout
    if want("K2-bwd.narrow"):
        for name, table, coords, gout in k2_bwd_narrow_cases():
            def call():
                return k2._launch_bwd(table, coords, gout, False, "border", False,
                                      path="narrow")
            a, b = call()[0], call()[0]
            rec[f"K2-bwd.narrow_{name}_bit_equal_calls"] = bool(torch.equal(a, b))
            del a, b
            rec[f"K2-bwd.narrow_{name}_ms"] = time_cuda(call)
            rec[f"K2-bwd.narrow_{name}_device_ms"] = device_ms(call)
            rec[f"K2-bwd.narrow_{name}_device_ms_by_kernel"] = device_ms_by_kernel(call)
        del table, coords, gout
    for rig in ("nuscenes", "synthetic") if want("S1") else ():
        from occformer_tpu_torch.ops import scatter

        depth, ctx, coords, valid, nx = s1_inputs(rig)
        key = f"S1_{rig}"

        def call():
            return scatter.voxel_scatter_lifted(depth, ctx, coords, valid, nx)

        with torch.no_grad():
            vol = call()
            # two checkouts' volumes are bit-equal when their digests are
            rec[f"{key}_volume_sha256"] = hashlib.sha256(
                vol.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            rec[f"{key}_volume_dtype"] = str(vol.dtype)
            rec[f"{key}_ms"] = time_cuda(call)
            rec[f"{key}_device_ms"] = device_ms(call)
            rec[f"{key}_device_ms_by_kernel"] = device_ms_by_kernel(call)
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            call()
            rec[f"{key}_peak_bytes_over_inputs"] = torch.cuda.max_memory_allocated() - base
        rec[f"{key}_segments"] = segment_stats(coords, valid, nx)
        kernel = plain = None
        if hasattr(scatter, "_launch_bwd"):  # a checkout with S1-bwd
            def kernel(g):
                return scatter._launch_bwd(depth, ctx, coords, valid, g, nx)

            def plain(g):
                return scatter.voxel_scatter_backward_plain(depth, ctx, coords, valid, g, nx)
        rec.update(splat_backward_record(
            key, lambda d, c: scatter.voxel_scatter_lifted(d, c, coords, valid, nx), (depth, ctx),
            kernel, plain))
        del depth, ctx, coords, valid, vol
    if want("S1-rows"):
        from occformer_tpu_torch.ops import scatter

        for dtype in (torch.bfloat16, torch.float32):
            feats, coords, valid, nx = rows_inputs(dtype)
            key = f"S1-rows_{str(dtype)[6:]}"

            def call():
                return scatter.voxel_scatter(feats, coords, valid, nx)

            with torch.no_grad():
                vol = call()
                rec[f"{key}_volume_sha256"] = hashlib.sha256(
                    vol.contiguous().view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
                rec[f"{key}_bit_equal_calls"] = bool(torch.equal(vol, call()))
                rec[f"{key}_ms"] = time_cuda(call)
                rec[f"{key}_device_ms"] = device_ms(call)
                rec[f"{key}_device_ms_by_kernel"] = device_ms_by_kernel(call)
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                call()
                rec[f"{key}_peak_bytes_over_inputs"] = torch.cuda.max_memory_allocated() - base
            rec["S1-rows_segments"] = segment_stats(coords, valid, nx)
            kernel = plain = None
            if hasattr(scatter, "_launch_rows_bwd"):  # a checkout with S1-rows-bwd
                def kernel(g):
                    return scatter._launch_rows_bwd(g, coords, valid, nx)

                def plain(g):
                    return scatter.voxel_scatter_rows_backward_plain(g, coords, valid, nx)
            rec.update(splat_backward_record(
                key, lambda f: scatter.voxel_scatter(f, coords, valid, nx), (feats,), kernel,
                plain, seed=7))
            del feats, coords, valid, vol
    if want("FPS"):
        from occformer_tpu_torch.ops import pointcloud as pc

        rooms, vmask = fps_inputs()
        npoint = FPS_SIZE[2]
        for name, v in (("", None), ("_with_invalid", vmask)):
            def call():
                return pc.furthest_point_sample(rooms, npoint, v)

            idx = call()
            rec[f"FPS{name}_indices_sha256"] = hashlib.sha256(
                idx.cpu().numpy().tobytes()).hexdigest()
            rec[f"FPS{name}_ms"] = time_cuda(call, iters=10, warmup=2)
            rec[f"FPS{name}_device_ms"] = device_ms(call, 10)
            rec[f"FPS{name}_us_per_step"] = rec[f"FPS{name}_device_ms"] * 1e3 / (npoint - 1)
            rec[f"FPS{name}_cluster"] = getattr(pc, "FPS_CLUSTER", None)
        rec["FPS_device_ms_by_kernel"] = device_ms_by_kernel(
            lambda: pc.furthest_point_sample(rooms, npoint), 10)
        if args.sweep and "cluster" in inspect.signature(pc._launch_fps).parameters:
            rec["FPS_cluster_sweep"] = {}
            for cl in (1, 2, 4, 8, 16):
                ms = device_ms(lambda: pc._launch_fps(rooms, npoint, None, cl), 10)
                rec["FPS_cluster_sweep"][cl] = {"device_ms": ms,
                                               "us_per_step": ms * 1e3 / (npoint - 1)}
        del rooms, vmask
    if want("step"):
        rec.update(step_profile("on"))
        rec.update(step_profile("off"))
    if want("step.r101"):
        rec.update(step_profile("off", config="occformer_nusc_r101_896x1600.py",
                                prefix="r101_"))
    if want("serve"):
        rec.update(serve_profile())
    if want("K2"):
        for name, table, coords in k2_fwd_cases():
            rec[f"K2_{name}_ms"] = time_cuda(lambda: k2._launch_fwd(
                table, coords, False, "border"))
            # the events also time the wrapper's host work, most of a short launch
            rec[f"K2_{name}_device_ms"] = device_ms(
                lambda: k2._launch_fwd(table, coords, False, "border"))
        del table, coords
    if want("K4"):
        for dtype in (torch.bfloat16, torch.float32):
            tables, coords, C = k4_inputs("flagship", dtype)
            rec[f"K4_{str(dtype)[6:]}_sha256"] = digest(
                *k1._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False))
            rec[f"K4_{str(dtype)[6:]}_ms"] = time_cuda(
                lambda: k1._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False))
            rec[f"K4_{str(dtype)[6:]}_device_ms"] = device_ms(
                lambda: k1._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False))
        tables, coords, C = k4_inputs("gate")
        rec["K4_gate_f32_device_ms"] = device_ms(
            lambda: k1._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False))
    if want("K1.other"):
        rec["K1.other"] = k1_other_rows(device_ms)
    if want("K4.other"):
        rec["K4.other"] = k4_other_rows(device_ms)
    if args.sweep:
        if want("K2-bwd.narrow") and hasattr(k2, "column_lanes"):
            rec["K2-bwd.narrow_lanes_sweep"] = k2_bwd_narrow_lanes_sweep()
        if want("K2-bwd"):
            rec["K2-bwd_path_sweep"] = k2_bwd_path_sweep()
        if want("K2"):
            rec["K2_path_sweep"] = k2_fwd_path_sweep()
            rec["K2_narrow_sweep"] = k2_narrow_sweep()
        if want("K1"):
            rec["K1_row_sweep"] = k1_row_sweep()
        if want("K1.other"):
            rec["K1.other_sweep"] = k1_other_sweep(device_ms)
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
