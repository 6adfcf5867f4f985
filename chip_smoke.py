#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (occformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  0. probe:      the backend viability probe
                 (occformer_tpu_torch.tools.probe_viability): builds only
                 csrc/probe.cu and holds P1 (add_one) and P2 (row_gather)
                 exactly against their plain versions, then times them, x + 1
                 and index_select (by events and by the profiler's device
                 time) and torch.gather; a broken toolchain fails here in
                 seconds.
  1. build:      compile every other CUDA kernel of the package from its
                 sources, one nvcc per source, all started together.
  2. serve:      the flagship config (occformer_nusc_r50_256x704) at full
                 width and depth, random weights from a seeded
                 torch.Generator, float32 parameters with the forward under
                 bfloat16 autocast (as the JAX package serves), through
                 build_eval_step on a synthetic 6-camera batch with 35000
                 LiDAR points: 1 warm-up frame, then 3 timed frames, and a
                 torch.profiler summary of one more frame (its ``stage:*``
                 ranges, kernels, operators); then, once, the route served
                 before (every tensor cast to bf16) on the same weights: its
                 frames, peak, point-prediction agreement and largest score
                 gap.  It runs before any backward: a backward leaves the
                 cuBLAS workspaces of autograd's threads resident (65 MiB),
                 which a serving process never holds and its peak would
                 count.
  3. kernels:    hold each kernel against its plain PyTorch version at the
                 shapes the flagship's main paths give it, and time both (CUDA
                 events, median of 30 after warm-up) beside the one PyTorch
                 call that computes the same function, where there is one
                 (each backward checked through the autograd Function the
                 train step runs, timed at its launch alone; the redesigned
                 forwards also by the profiler's device time):
                 K1 (ms_deform_gather_3d) and K1-bwd at the pixel decoder's
                 shapes in float32 and bfloat16, at uniform and at local
                 locations (K1's row-wide path, two calls held bit-equal,
                 and its scalar path held and timed beside it); K2
                 (trilerp_sample) and K2-bwd at the per-layer loss's
                 candidate readout (bf16 feature table, border,
                 align_corners=False; K2's row-wide path, two calls held
                 bit-equal, and its narrow ("scalar") path timed beside it;
                 the narrow path at the per-slot GT masks and the GT table
                 too, beside F.grid_sample with and without the bool ->
                 float cast), K2-bwd's segmented path also
                 at its random fill, two of its calls held bit-equal, and
                 its narrow path timed at the candidate readout too (the
                 kernel the segmented one replaced there; the sweep over row
                 widths behind the path threshold is tools/time_backwards.py
                 --sweep); K2 on the per-slot GT masks and a zeros /
                 align_corners=True case; K2 (its narrow path) / K2-bwd
                 (its narrow path) at the batched loss's three readouts; K3
                 (sample_id_masks) at the batched loss's three GT reads and
                 a zeros / align_corners=True case on a 40x24x12 grid; the
                 K4 parity gate, K4 at its small shapes also by device time,
                 and at the flagship's shapes K4's row-wide path (two calls
                 bit-equal) beside its scalar path, in bf16 and float32.
  4. tiny:       the tiny test model's forward on the card (kernels) against
                 the same model on the CPU (plain versions), float32.
  5. tiny_train: the tiny model's train step on the card against the same
                 step on the CPU, from the same state with the same draws:
                 losses, every gradient and every updated parameter; on the
                 per-layer loss route, on the batched route, and with
                 accum_steps=2 on a 2-sample batch (batched route).
  5b. reload_determinism: pairs of train steps from one reloaded state,
                 on the tiny CLI model and on the flagship, with the LSS
                 scatter's atomic order and with only the scatter in
                 deterministic mode (the default): losses, LSS volumes and
                 the loss's uncertainty top-k compared bit for bit; the
                 deterministic mode must repeat them; and the scatter's cost
                 per step in both modes.
  6. train:      the flagship's train step at full width and depth, float32
                 parameters under bfloat16 autocast, batch 1, through
                 build_train_step on the per-layer loss route: 1 warm-up
                 step, then 3 timed steps, and a torch.profiler summary of
                 one more step (with each port kernel's device ms and
                 launches).
  7. train_batched: the same on the all-layer batched loss route
                 (mxu_readout="on"), plus both routes' losses and Hungarian
                 assignments on one float32 copy of a step's model outputs
                 with one set of draws.
  8. cli:        the train and test CLIs at the flagship's full width on
                 SyntheticOccDataset (--cfg-options), as subprocesses in a
                 temporary work directory outside the repo: 2 steps, then a
                 resume at step 2 to step 4, then tools.test on step_4 over 2
                 samples; in process, step_2 loaded into a fresh model and
                 optimizer and held bit-equal to the saved file.
In phases 0, 2, 6 and 7 and in the K4 parity gate every kernel's launch
count is set to 0 just before the path is driven and read just after; each
must match its per-frame, per-step or per-run count.  The CLIs report their
own counts, which must show their kernels.  Then the card's name and power
limit (nvidia-smi), one JSON line of kernel records (K1's, K2's and K2-bwd's
two paths as two records each; S1, the LSS splat, which has no Pallas
original, last), and last ``{"ok": true, "device": {...}}``.  Any
failed check exits non-zero before that line.  Without a CUDA device, or
without the package beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")

# kernel launches per serving frame and per train step of the flagship
# (6 deformable encoder layers; the per-layer loss route reads 10 supervised
# decoder outputs with 6 K2 launches each, 2 of them differentiated; the
# batched route reads all 10 at once: K2 at the matching points, the
# candidates and the random fill, the last two differentiated, and K3 at the
# same three point sets); PERF.md states the same counts.  "K2-bwd" counts
# both of its paths, "K2-bwd.narrow" the narrow one: the per-layer route's
# C = 192 feature takes the segmented path, the batched route's C = 17 and
# C = 1 per-slot volumes the narrow one
_NONE = {"K1": 0, "K1.row": 0, "K1-bwd": 0, "K2": 0, "K2.row": 0, "K2-bwd": 0,
         "K2-bwd.narrow": 0, "K3": 0, "K4": 0, "K4.row": 0, "K4-bwd": 0, "P1": 0, "P2": 0,
         "S1": 0}
# "K1.row": the deformable attention's hd = 24 rows take K1's row-wide path
SERVE_LAUNCHES = dict(_NONE, **{"K1": 6, "K1.row": 6, "S1": 1})
# "K2.row": the per-layer route's 30 readouts of the bf16 C = 192 feature
# take K2's row-wide path, its 30 GT-mask readouts (bool, C = 1) the narrow
# ("scalar") one; the batched route's C = 100 bf16 and C = 17 / 1 float32
# volumes all take the narrow path
TRAIN_LAUNCHES = {"off": dict(_NONE, **{"K1": 6, "K1.row": 6, "K1-bwd": 6, "K2": 60,
                                        "K2.row": 30, "K2-bwd": 20, "S1": 1}),
                  "on": dict(_NONE, **{"K1": 6, "K1.row": 6, "K1-bwd": 6, "K2": 3,
                                       "K2-bwd": 2, "K2-bwd.narrow": 2, "K3": 3, "S1": 1})}
# the K4 parity gate: bench.py's shapes at both align_corners and the
# flagship shapes, one forward (the row-wide path: C = 24 rows) and one
# backward each; the probe: P1 and P2 once
K4_GATE_LAUNCHES = dict(_NONE, **{"K4": 3, "K4.row": 3, "K4-bwd": 3})
PROBE_LAUNCHES = dict(_NONE, P1=1, P2=1)
# the pyramid of the deformable attention, largest level first, as bench.py
# (tools/time_backwards.py:K4_PYRAMID)
K4_PYRAMID = [(64, 64, 8), (32, 32, 4), (16, 16, 2)]
# the outermost torch.profiler ranges of a frame and of a train step
SERVE_STAGES = ("upload", "image_encoder", "view_transformer", "occupancy_encoder",
                "pixel_decoder", "head", "readout")
TRAIN_STAGES = ("forward", "loss", "backward", "optimizer")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def time_cuda(fn, iters=30, warmup=5):
    """Median ms of ``fn()`` over CUDA-event timed calls (the port's
    ``utils/timing.py``)."""
    from occformer_tpu_torch.utils.timing import time_cuda as timed

    return timed(fn, iters, warmup)


def nbytes(*tensors):
    from occformer_tpu_torch.utils.timing import nbytes as total

    return total(*tensors)


def device_ms(fn, iters=20):
    """Device ms per call of ``fn()`` from the profiler
    (``utils/timing.py:device_ms``)."""
    from occformer_tpu_torch.utils.timing import device_ms as on_device

    return on_device(fn, iters)


def bound(n_bytes, flops):
    """The least time the card could take (``utils/timing.py:bound``)."""
    from occformer_tpu_torch.utils.timing import bound as least

    return least(n_bytes, flops)


def launches():
    from occformer_tpu_torch.ops import launch_counts

    return launch_counts()


def reset_launches():
    from occformer_tpu_torch.ops import reset_launch_counts

    reset_launch_counts()


def free_memory():
    """Frees what earlier phases left behind (autograd graphs hold reference
    cycles), so that a phase's peak memory counts only its own tensors."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def compare(got, ref, rel, name):
    """max |got - ref| within ``rel * max|ref|``; returns the record."""
    scale = ref.float().abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    limit = rel * scale
    check(bool(got.float().isfinite().all()), f"{name}: non-finite values")
    check(err <= limit, f"{name}: max|diff| {err} > {limit}")
    return {"max_abs_err": err, "max_abs_plain": scale, "limit": limit}


def phase_k1():
    """K1 and K1-bwd against the plain version and its autograd, each at the
    uniform and at the local locations: K1 on its row-wide path (the
    flagship's), two calls held bit-equal, and on its scalar path beside it,
    each timed by CUDA events and by the profiler's device time.
    Tolerances relative to max |plain|: float32 1e-5 forward and 1e-4
    backward (the same float32 sums in another order; the backward's d_value
    takes 8 * hd / 4 vector reductions per sample in an order that changes
    from run to run), bfloat16 1e-2 (outputs rounded to bf16; the plain
    version runs in float32 on the same bf16-rounded inputs)."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.tools.time_backwards import flagship_gather_inputs

    fwd, bwd = {}, {}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        value, shapes, locs, w = flagship_gather_inputs(dtype, local=False)
        lv, _, ll, lw = flagship_gather_inputs(dtype, local=True)
        check(k1.ms_deform_fwd_path(value.shape[-1], dtype, (value.data_ptr(),)) == "row",
              f"K1 {name}: not the row-wide path")
        rel = 1e-5 if dtype == torch.float32 else 1e-2
        r = {"path": "row", "lanes": k1.ROW_LANES, "samples_per_lane": k1.ROW_SAMPLES_PER_LANE}
        for where, (v_, l_, w_) in (("", (value, locs, w)), ("local_locs ", (lv, ll, lw))):
            got = k1.ms_deform_gather_3d(v_, shapes, l_, w_)
            again = k1.ms_deform_gather_3d(v_, shapes, l_, w_)
            torch.cuda.synchronize()
            check(torch.equal(got, again), f"K1 {name} {where}row path: two calls differ")
            ref = k1.ms_deform_gather_3d_plain(v_.float(), shapes, l_, w_.float())
            r[where + "values"] = compare(got, ref, rel, f"K1 {name} {where}row path")
            r[where + "scalar_path"] = compare(k1._launch_fwd(v_, shapes, l_, w_, path="scalar"),
                                               ref, rel, f"K1 {name} {where}scalar path")
            del again, ref
        got = k1.ms_deform_gather_3d(value, shapes, locs, w)
        r["bit_identical_calls"] = True
        r["max_abs_err"] = max(r[k]["max_abs_err"] for k in ("values", "local_locs values"))
        r["share_outside_01"] = ((locs < 0) | (locs > 1)).any(-1).float().mean().item()
        r["kernel_ms"] = time_cuda(lambda: k1.ms_deform_gather_3d(value, shapes, locs, w))
        r["device_ms"] = device_ms(lambda: k1.ms_deform_gather_3d(value, shapes, locs, w))
        r["plain_ms"] = time_cuda(
            lambda: k1.ms_deform_gather_3d_plain(value, shapes, locs, w), iters=20)
        r["kernel_ms_local_locs"] = time_cuda(lambda: k1.ms_deform_gather_3d(lv, shapes, ll, lw))
        # the scalar path (one thread per output channel, the K1 the
        # row-wide path replaced here) on the same inputs
        r["scalar_path_ms"] = time_cuda(lambda: k1._launch_fwd(value, shapes, locs, w,
                                                               path="scalar"))
        r["scalar_path_device_ms"] = device_ms(lambda: k1._launch_fwd(value, shapes, locs, w,
                                                                      path="scalar"))
        r["scalar_path_ms_local_locs"] = time_cuda(lambda: k1._launch_fwd(lv, shapes, ll, lw,
                                                                          path="scalar"))
        B, Nq, H, L, P = w.shape
        hd = value.shape[-1]
        # every input read once, the output written once; the function needs
        # 8 corner FMAs per (sample, channel), with the attention weight
        # folded into the 8 corner weights once per sample
        r.update(bound(nbytes(value, locs, w, got), B * Nq * H * L * P * hd * 8 * 2))
        r["roofline_share"] = r["bound_ms"] / r["kernel_ms"]
        # the corner rows the gather reads (from L2: value fits in it), the
        # traffic that sets the row-wide path's pace
        r["corner_row_bytes"] = B * Nq * H * L * P * 8 * hd * value.element_size()
        fwd[name] = r

        # K1-bwd, through the autograd Function the train step runs, at the
        # uniform and at the local locations
        rel = 1e-4 if dtype == torch.float32 else 1e-2
        rb = {}
        for where, (v_, l_, w_) in (("", (value, locs, w)), ("local_locs ", (lv, ll, lw))):
            gout = torch.randn(got.shape, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(1)).to(dtype)
            k_leaves = [t.detach().clone().requires_grad_(True) for t in (v_, l_, w_)]
            k1.ms_deform_gather_3d(k_leaves[0], shapes, k_leaves[1], k_leaves[2]).backward(gout)
            torch.cuda.synchronize()
            leaves = [t.detach().float().requires_grad_(True) for t in (v_, l_, w_)]
            out = k1.ms_deform_gather_3d_plain(leaves[0], shapes, leaves[1], leaves[2])
            refs = torch.autograd.grad(out, leaves, gout.float())
            for g, a, b in zip(("d_value", "d_locs", "d_weights"), k_leaves, refs):
                rb[where + g] = compare(a.grad, b, rel, f"K1-bwd {name} {where}{g}")
            check(all(a.grad.dtype == a.dtype for a in k_leaves),
                  f"K1-bwd {name}: gradient dtypes {[a.grad.dtype for a in k_leaves]}")
            del k_leaves, leaves, out, refs
        rb["max_abs_err"] = max(v["max_abs_err"] for v in rb.values())
        rb["kernel_ms"] = time_cuda(lambda: k1._launch_bwd(value, shapes, locs, w, gout))
        rb["kernel_ms_local_locs"] = time_cuda(lambda: k1._launch_bwd(lv, shapes, ll, lw, gout))
        plain_leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, w)]
        plain_out = k1.ms_deform_gather_3d_plain(plain_leaves[0], shapes, plain_leaves[1],
                                                 plain_leaves[2])
        rb["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
            plain_out, plain_leaves, gout, retain_graph=True), iters=20)
        # inputs value, locs, weights, gout; outputs d_value (value's dtype),
        # d_locs (f32), d_weights (weights' dtype).  The function needs, per
        # corner and channel, one FMA of the dot sum_c gout * value[corner]
        # (which d_weights and the three d_locs slopes share through per-sample
        # corner weights) and the d_value product and add: 8 x 4 operations
        # per (sample, channel)
        rb.update(bound(nbytes(value, locs, w, gout, value, locs, w),
                        B * Nq * H * L * P * hd * 8 * 4))
        rb["roofline_share"] = rb["bound_ms"] / rb["kernel_ms"]
        bwd[name] = rb
        del plain_out
    return fwd, bwd


def phase_k2():
    """K2 and K2-bwd against the plain version (F.grid_sample on the permuted
    table) and its autograd, at the loss's shapes: K2's row-wide path at the
    per-layer route's candidate readout (bf16 feature, C = 192), two calls
    held bit-equal, its narrow ("scalar") path beside it there, at the
    per-slot GT masks (C = 1) and at the GT table (C = 17), where the kernel
    and F.grid_sample are also timed by the profiler's device time, the
    library call both on a float copy made beforehand and with the bool ->
    float cast included; K2-bwd's segmented
    path at the candidate and random-fill readouts, with two calls held
    bit-equal, and its narrow path timed at the candidates beside it.
    Tolerances relative to max |plain|: bfloat16 1e-2 (bf16 output), float32
    1e-5 forward and 1e-4 backward (float32 sums in another order)."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp as k2

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    # the candidate readout: the mask feature [1, 128, 128, 16, 192] bf16 at
    # 3 x 50176 candidates, border padding, align_corners=False
    table = torch.randn((1, 128, 128, 16, 192), device=dev, generator=g).to(torch.bfloat16)
    coords = torch.rand((1, 150528, 3), device=dev, generator=g) * 2 - 1
    check(k2.fwd_path(table.shape, table.dtype, table.data_ptr()) == "row",
          "K2 candidates: not the row-wide path")
    got = k2.trilerp_sample(table, coords, False, "border")
    again = k2.trilerp_sample(table, coords, False, "border")
    torch.cuda.synchronize()
    ref = k2.trilerp_sample_plain(table, coords, False, "border")
    fwd = compare(got, ref, 1e-2, "K2 candidates")
    check(torch.equal(got, again), "K2 row path: two calls differ")
    fwd["bit_identical_calls"] = True
    fwd["lanes"] = k2.row_lanes(table.shape[-1], table.dtype)
    fwd["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(table, coords, False, "border"))
    fwd["device_ms"] = device_ms(lambda: k2.trilerp_sample(table, coords, False, "border"))
    fwd["plain_ms"] = time_cuda(lambda: k2.trilerp_sample_plain(table, coords, False, "border"))
    vol = table.permute(0, 4, 1, 2, 3).contiguous()  # the library call's layout
    grid = coords.flip(-1).reshape(1, -1, 1, 1, 3).to(torch.bfloat16)

    def library():
        return F.grid_sample(vol, grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    fwd["library_ms"] = time_cuda(library)
    fwd["library_device_ms"] = device_ms(library)
    # the narrow path (the one fwd_path calls "scalar") on the same inputs
    fwd["scalar_path"] = compare(k2._launch_fwd(table, coords, False, "border", path="scalar"),
                                 ref, 1e-2, "K2 scalar path candidates")
    fwd["scalar_path_ms"] = time_cuda(lambda: k2._launch_fwd(
        table, coords, False, "border", path="scalar"))
    del again, ref
    S, C = coords.shape[1], table.shape[-1]
    fwd.update(bound(nbytes(table, coords, got), S * C * 8 * 2))
    fwd["roofline_share"] = fwd["bound_ms"] / fwd["kernel_ms"]
    # the table is twice L2, and the points spread over it: each point reads
    # its 8 corner rows whole
    fwd["realistic_floor_ms"] = (S * 8 * C * table.element_size() + nbytes(coords, got)) \
        / 3.35e12 * 1e3

    # the per-slot GT readout (bool masks [17, 256, 256, 32, 1]) and a
    # zeros / align_corners=True case on a float32 table
    gt = torch.rand((17, 256, 256, 32, 1), device=dev, generator=g) < 0.06
    rc = torch.rand((17, 12544, 3), device=dev, generator=g) * 2 - 1
    check(k2.fwd_path(gt.shape, torch.uint8, gt.data_ptr()) == "scalar",
          "K2 per-slot GT: not the narrow path")
    gt_out = k2.trilerp_sample(gt, rc, False, "border")
    again = k2.trilerp_sample(gt, rc, False, "border")
    rec = compare(gt_out, k2.trilerp_sample_plain(gt, rc, False, "border"), 1e-5,
                  "K2 per-slot GT")
    check(torch.equal(gt_out, again), "K2 narrow path: two calls differ")
    rec["bit_identical_calls"] = True
    rec["points_per_lane"] = k2.NARROW_POINTS_PER_LANE
    rec["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(gt, rc, False, "border"))
    rec["device_ms"] = device_ms(lambda: k2.trilerp_sample(gt, rc, False, "border"))
    rec["plain_ms"] = time_cuda(lambda: k2.trilerp_sample_plain(gt, rc, False, "border"))
    gt_vol = gt.permute(0, 4, 1, 2, 3).float().contiguous()  # the library call's input
    gt_grid = rc.flip(-1).reshape(17, -1, 1, 1, 3).contiguous()

    def gt_library():
        return F.grid_sample(gt_vol, gt_grid, mode="bilinear", padding_mode="border",
                             align_corners=False)

    def gt_library_with_cast():  # the kernel reads the bool masks as they are
        return F.grid_sample(gt.permute(0, 4, 1, 2, 3).float(), gt_grid, mode="bilinear",
                             padding_mode="border", align_corners=False)

    rec["library_ms"] = time_cuda(gt_library)
    rec["library_device_ms"] = device_ms(gt_library)
    rec["library_with_cast_ms"] = time_cuda(gt_library_with_cast)
    rec["library_with_cast_device_ms"] = device_ms(gt_library_with_cast)
    rec.update(bound(nbytes(gt, rc, gt_out), rc.shape[0] * rc.shape[1] * 8 * 2))
    del again
    # the per-layer route's GT table (bool [1, 256, 256, 32, 17], the 17
    # class slots as channels) at the 150528 candidates, the narrow path too
    gtt = torch.rand((1, 256, 256, 32, 17), device=dev, generator=g) < 0.06
    gtt_out = k2.trilerp_sample(gtt, coords, False, "border")
    rt = compare(gtt_out, k2.trilerp_sample_plain(gtt, coords, False, "border"), 1e-5,
                 "K2 per-layer GT table")
    rt["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(gtt, coords, False, "border"))
    rt["device_ms"] = device_ms(lambda: k2.trilerp_sample(gtt, coords, False, "border"))
    rt["plain_ms"] = time_cuda(lambda: k2.trilerp_sample_plain(gtt, coords, False, "border"),
                               iters=10)
    gtt_vol = gtt.permute(0, 4, 1, 2, 3).float().contiguous()
    gtt_grid = coords.flip(-1).reshape(1, -1, 1, 1, 3).contiguous()
    rt["library_ms"] = time_cuda(lambda: F.grid_sample(
        gtt_vol, gtt_grid, mode="bilinear", padding_mode="border", align_corners=False))
    rt["library_device_ms"] = device_ms(lambda: F.grid_sample(
        gtt_vol, gtt_grid, mode="bilinear", padding_mode="border", align_corners=False))
    rt["library_with_cast_device_ms"] = device_ms(lambda: F.grid_sample(
        gtt.permute(0, 4, 1, 2, 3).float(), gtt_grid, mode="bilinear", padding_mode="border",
        align_corners=False))
    rt.update(bound(nbytes(gtt, coords, gtt_out), coords.shape[1] * 17 * 8 * 2))
    rec["gt_table"] = rt
    del gtt, gtt_out, gtt_vol
    fwd["per_slot_gt"] = rec
    del gt_vol, gt_out
    t32 = torch.randn((2, 64, 64, 8, 40), device=dev, generator=g)
    c32 = torch.rand((2, 20000, 3), device=dev, generator=g) * 2.4 - 1.2
    fwd["zeros_align"] = compare(k2.trilerp_sample(t32, c32, True, "zeros"),
                                 k2.trilerp_sample_plain(t32, c32, True, "zeros"), 1e-5,
                                 "K2 zeros/align_corners")

    # K2-bwd at the candidate readout, through the autograd Function the
    # train step runs (coordinates without grad, as in the loss: d_table), on
    # the segmented path; two calls must give the same bits
    check(k2.bwd_path(table.shape, S) == "segmented", "K2-bwd candidates: not segmented")
    gout = torch.randn(got.shape, device=dev, generator=g).to(torch.bfloat16)
    k_leaf = table.detach().clone().requires_grad_(True)
    k2.trilerp_sample(k_leaf, coords, False, "border").backward(gout)
    torch.cuda.synchronize()
    leaf = table.detach().float().requires_grad_(True)
    ref = torch.autograd.grad(k2.trilerp_sample_plain(leaf, coords, False, "border"), leaf,
                              gout.float())[0]
    check(k_leaf.grad.dtype == table.dtype, f"K2-bwd d_table dtype {k_leaf.grad.dtype}")
    bwd = compare(k_leaf.grad, ref, 1e-2, "K2-bwd candidates d_table")
    again, _ = k2._launch_bwd(table, coords, gout, False, "border", want_coords=False)
    check(torch.equal(again, k_leaf.grad), "K2-bwd: two calls differ")
    bwd["bit_identical_calls"] = True
    del k_leaf, leaf, ref, again
    t_c = t32.detach().clone().requires_grad_(True)
    c_c = c32.detach().clone().requires_grad_(True)
    go32 = torch.randn((2, 20000, 40), device=dev, generator=g)
    k2.trilerp_sample(t_c, c_c, True, "zeros").backward(go32)
    t_r = t32.detach().clone().requires_grad_(True)
    c_r = c32.detach().clone().requires_grad_(True)
    k2.trilerp_sample_plain(t_r, c_r, True, "zeros").backward(go32)
    bwd["zeros_align_d_table"] = compare(t_c.grad, t_r.grad, 1e-4, "K2-bwd d_table f32")
    bwd["zeros_align_d_coords"] = compare(c_c.grad, c_r.grad, 1e-4, "K2-bwd d_coords f32")
    bwd["kernel_ms"] = time_cuda(lambda: k2._launch_bwd(
        table, coords, gout, False, "border", want_coords=False))
    # the narrow atomic path (the K2-bwd this path replaced at C = 192) here
    bwd["narrow_path_ms"] = time_cuda(lambda: k2._launch_bwd(
        table, coords, gout, False, "border", want_coords=False, path="narrow"))
    p_leaf = table.detach().clone().requires_grad_(True)
    p_out = k2.trilerp_sample_plain(p_leaf, coords, False, "border")
    bwd["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
        p_out, p_leaf, gout, retain_graph=True), iters=20)
    del p_out
    l_vol = vol.detach().clone().requires_grad_(True)
    l_out = F.grid_sample(l_vol, grid, mode="bilinear", padding_mode="border",
                          align_corners=False)
    l_gout = gout.transpose(1, 2).reshape(l_out.shape).contiguous()
    bwd["library_ms"] = time_cuda(lambda: torch.autograd.grad(
        l_out, l_vol, l_gout, retain_graph=True), iters=20)
    del l_out, l_vol
    # gout and coords read once, d_table (the table's dtype) written once;
    # one product per corner and channel
    bwd.update(bound(nbytes(gout, coords, table), S * C * 8 * 2))
    bwd["roofline_share"] = bwd["bound_ms"] / bwd["kernel_ms"]

    # the per-layer route's random-fill readout: 17 x 12544 points on the
    # same table, the segmented path
    rf = torch.rand((1, 17 * 12544, 3), device=dev, generator=g) * 2 - 1
    rf_gout = torch.randn((1, rf.shape[1], C), device=dev, generator=g).to(torch.bfloat16)
    rf_got, _ = k2._launch_bwd(table, rf, rf_gout, False, "border", want_coords=False)
    leaf = table.detach().float().requires_grad_(True)
    ref = torch.autograd.grad(k2.trilerp_sample_plain(leaf, rf, False, "border"), leaf,
                              rf_gout.float())[0]
    rec = compare(rf_got, ref, 1e-2, "K2-bwd random fill d_table")
    del leaf, ref, rf_got
    rec["kernel_ms"] = time_cuda(lambda: k2._launch_bwd(
        table, rf, rf_gout, False, "border", want_coords=False))
    rec.update(bound(nbytes(rf_gout, rf, table), rf.shape[1] * C * 8 * 2))
    bwd["random_fill"] = rec
    return fwd, bwd


def phase_k2_batched():
    """K2 and K2-bwd at the batched loss route's readouts of the flagship (10
    layers x 1 sample, mask volumes 128x128x16, border, align_corners=False):
    the per-query match volumes [10, 128, 128, 16, 100] bf16 at 50176 points
    each (forward only, detached), and the float32 per-slot volumes at the
    150528 candidates ([10, ..., 17]) and at the 12544 random-fill points of
    each slot ([170, ..., 1]).  All three forwards take K2's narrow
    ("scalar") path, two calls held bit-equal, timed by CUDA events and by
    the profiler's device time beside F.grid_sample on a channels-first
    copy.  Both backwards take K2-bwd's narrow path, timed beside the plain
    version's autograd and autograd through F.grid_sample.  Tolerances as in
    phase_k2."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp as k2

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    cases = (("matching", (10, 128, 128, 16, 100), torch.bfloat16, (10, 50176), False),
             ("candidates", (10, 128, 128, 16, 17), torch.float32, (10, 150528), True),
             ("random_fill", (170, 128, 128, 16, 1), torch.float32, (170, 12544), True))
    fwd, bwd = {}, {}
    for name, tshape, dtype, cshape, grad in cases:
        table = torch.randn(tshape, device=dev, generator=g).to(dtype)
        coords = torch.rand((*cshape, 3), device=dev, generator=g) * 2 - 1
        got = k2.trilerp_sample(table, coords, False, "border")
        again = k2.trilerp_sample(table, coords, False, "border")
        torch.cuda.synchronize()
        rel = 1e-2 if dtype == torch.bfloat16 else 1e-5
        r = compare(got, k2.trilerp_sample_plain(table, coords, False, "border"), rel,
                    f"K2 batched {name}")
        check(torch.equal(got, again), f"K2 batched {name}: two calls differ")
        del again
        r["path"] = k2.fwd_path(table.shape, table.dtype, table.data_ptr())
        check(r["path"] == "scalar", f"K2 batched {name}: not the narrow path")
        r["vec"] = k2.narrow_vec(tshape[-1], dtype, table.data_ptr())
        r["lanes"] = k2.narrow_lanes(tshape[-1], r["vec"])
        r["kernel_ms"] = time_cuda(lambda: k2.trilerp_sample(table, coords, False, "border"))
        r["device_ms"] = device_ms(lambda: k2.trilerp_sample(table, coords, False, "border"))
        r["plain_ms"] = time_cuda(
            lambda: k2.trilerp_sample_plain(table, coords, False, "border"), iters=10)
        f_vol = table.permute(0, 4, 1, 2, 3).contiguous()
        f_grid = coords.flip(-1).reshape(cshape[0], -1, 1, 1, 3).to(dtype).contiguous()

        def library():
            return F.grid_sample(f_vol, f_grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        r["library_ms"] = time_cuda(library, iters=10)
        r["library_device_ms"] = device_ms(library, iters=10)
        del f_vol, f_grid
        S, C = cshape[0] * cshape[1], tshape[-1]
        r.update(bound(nbytes(table, coords, got), S * C * 8 * 2))
        fwd[name] = r
        if not grad:
            continue
        gout = torch.randn(got.shape, device=dev, generator=g)
        leaf = table.detach().clone().requires_grad_(True)
        k2.trilerp_sample(leaf, coords, False, "border").backward(gout)
        torch.cuda.synchronize()
        ref_leaf = table.detach().clone().requires_grad_(True)
        k2.trilerp_sample_plain(ref_leaf, coords, False, "border").backward(gout)
        rb = compare(leaf.grad, ref_leaf.grad, 1e-4, f"K2-bwd batched {name} d_table")
        del leaf, ref_leaf
        check(k2.bwd_path(table.shape, cshape[1]) == "narrow", f"K2-bwd {name}: not narrow")
        rb["kernel_ms"] = time_cuda(lambda: k2._launch_bwd(
            table, coords, gout, False, "border", want_coords=False))
        p_leaf = table.detach().clone().requires_grad_(True)
        p_out = k2.trilerp_sample_plain(p_leaf, coords, False, "border")
        rb["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
            p_out, p_leaf, gout, retain_graph=True), iters=10)
        del p_out, p_leaf
        # the library call: autograd through F.grid_sample on the
        # channels-first copy of the volumes
        l_vol = table.permute(0, 4, 1, 2, 3).contiguous().requires_grad_(True)
        l_grid = coords.flip(-1).reshape(cshape[0], -1, 1, 1, 3).contiguous()
        l_out = F.grid_sample(l_vol, l_grid, mode="bilinear", padding_mode="border",
                              align_corners=False)
        l_gout = gout.transpose(1, 2).reshape(l_out.shape).contiguous()
        rb["library_ms"] = time_cuda(lambda: torch.autograd.grad(
            l_out, l_vol, l_gout, retain_graph=True), iters=10)
        del l_out, l_vol, l_gout
        rb.update(bound(nbytes(gout, coords, table), S * C * 8 * 2))
        bwd[name] = rb
        del gout
    return fwd, bwd


def phase_k3():
    """K3 (sample_id_masks) against its plain version at the batched loss
    route's three GT reads of the flagship (N = 10 layers x 1 sample, int32
    label grid [1, 256, 256, 32] with 10% of voxels 255, G = 17 class slots,
    border, align_corners=False): the 150528 candidates and the 50176
    matching points (shared points, [10, 17, S] out) and the 12544
    random-fill points of each slot ([10, 17, 12544, 3] per-slot points);
    and zeros / align_corners=True on a 40x24x12 grid (B = 2, N = 4) with
    points in [-0.15, 1.15].  Tolerance 1e-6 absolute: the kernel adds the
    plain version's float32 terms in its order.  The library call that
    computes the same function is ``F.grid_sample`` over a float one-hot
    volume [1, 17, 256, 256, 32] (built beforehand, its build timed apart),
    with every layer's points in one grid (per slot for the random fill)."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import loss_gather as k3

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    G, N = 17, 10
    grid = torch.randint(0, G, (1, 256, 256, 32), device=dev, generator=g, dtype=torch.int32)
    grid[torch.rand(grid.shape, device=dev, generator=g) < 0.1] = 255
    ids = torch.arange(G, device=dev, dtype=torch.int32)[None]
    onehot_ms = time_cuda(lambda: (grid[:, None] == ids[0].view(1, G, 1, 1, 1)).float(),
                          iters=10)
    onehot = (grid[:, None] == ids[0].view(1, G, 1, 1, 1)).float()  # [1, G, X, Y, Z]
    recs = {}
    for name, shape in (("candidates", (N, 150528, 3)), ("matching", (N, 50176, 3)),
                        ("random_fill", (N, G, 12544, 3))):
        pts = torch.rand(shape, device=dev, generator=g)
        got = k3.sample_id_masks(grid, ids, pts, False, "border")
        torch.cuda.synchronize()
        ref = k3.sample_id_masks_plain(grid, ids, pts, False, "border")
        r = compare(got, ref, 1e-6, f"K3 {name}")
        del ref
        r["kernel_ms"] = time_cuda(lambda: k3.sample_id_masks(grid, ids, pts, False, "border"))
        r["plain_ms"] = time_cuda(
            lambda: k3.sample_id_masks_plain(grid, ids, pts, False, "border"), iters=10)
        if pts.dim() == 3:  # every layer's points in one grid
            lib_in = onehot
            lib_grid = (pts.reshape(1, -1, 1, 1, 3) * 2 - 1).flip(-1)
        else:               # slot g's volume at slot g's points of every layer
            lib_in = onehot.transpose(0, 1)
            lib_grid = (pts.transpose(0, 1).reshape(G, -1, 1, 1, 3) * 2 - 1).flip(-1)
        lib_grid = lib_grid.contiguous()

        def library():
            return F.grid_sample(lib_in, lib_grid, mode="bilinear", padding_mode="border",
                                 align_corners=False)

        r["library_ms"] = time_cuda(library)
        r["library_onehot_build_ms"] = onehot_ms
        lib = library().reshape(G, N, -1).transpose(0, 1)  # [N, G, S]
        r["library_max_abs_diff"] = (lib - got.reshape(N, G, -1)).abs().max().item()
        del lib
        # points and the grid read once, the output written once; per point
        # and slot 8 compares and 8 adds
        r.update(bound(nbytes(pts, grid, ids, got), got.numel() * 16))
        r["roofline_share"] = r["bound_ms"] / r["kernel_ms"]
        recs[name] = r
    # zeros padding, align_corners=True, sides not powers of two, labels 255
    g2 = torch.Generator(device=dev).manual_seed(5)
    small = torch.randint(0, G + 2, (2, 40, 24, 12), device=dev, generator=g2,
                          dtype=torch.int32)
    small[:, :3] = 255
    sids = torch.stack([torch.arange(G), torch.arange(G).flip(0)]).to(dev, torch.int32)
    for mode, shape in (("shared", (4, 20000, 3)), ("per_slot", (4, G, 1000, 3))):
        pts = torch.rand(shape, device=dev, generator=g2) * 1.3 - 0.15
        recs[f"zeros_align_{mode}"] = compare(
            k3.sample_id_masks(small, sids, pts, True, "zeros"),
            k3.sample_id_masks_plain(small, sids, pts, True, "zeros"), 1e-6,
            f"K3 zeros/align_corners {mode}")
    return recs


def phase_probe():
    """The viability probe (P1, P2) as its CLI runs it: build csrc/probe.cu
    alone, hold both kernels exactly against their plain versions, then
    time them and torch.gather."""
    import torch

    from occformer_tpu_torch.tools.probe_viability import probe_check, probe_time

    dev = torch.device("cuda")
    reset_launches()  # the probe's path starts here
    rec = {"phase": "probe", **probe_check(dev)}
    rec["launches"] = launches()  # ... and ends here
    emit(rec)
    check(rec["add_one"] == "ok" and rec["row_gather"] == "ok",
          f"probe: add_one {rec['add_one']}, row_gather {rec['row_gather']}")
    check(rec["launches"] == PROBE_LAUNCHES, f"probe launches {rec['launches']}")
    rec["timing"] = probe_time(dev)
    emit({"phase": "probe_timing", **rec["timing"]})
    return rec


def k4_inputs(case, dtype=None):
    """K4's inputs (``tools/time_backwards.py:k4_inputs``): bench.py's
    parity-gate shapes ("gate", float32) or the deformable attention's
    ("flagship", bf16 unless ``dtype``)."""
    from occformer_tpu_torch.tools.time_backwards import k4_inputs as inputs

    return inputs(case, dtype)


def k4_check(tables, coords, C, align_corners, name):
    """K4 and K4-bwd through the autograd Function against the plain
    version's autograd: values, d_tables and d_coords of a random linear
    probe.  Tolerances relative to max |plain|: float32 1e-5 values and 1e-4
    gradients (d_table adds up to 8 * C float32 atomics per element in an
    order that changes from run to run), bf16 1e-2 (outputs and d_tables
    rounded to bf16; the plain version runs in float32 on the same
    bf16-rounded inputs)."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k4

    dtype = tables[0].dtype
    tl = [t.detach().clone().requires_grad_(True) for t in tables]
    cl = [c.detach().clone().requires_grad_(True) for c in coords]
    got = k4.fused_multilevel_gather(tl, K4_PYRAMID, C, cl, align_corners)
    g = torch.Generator(device="cuda").manual_seed(7)
    gouts = [torch.randn(o.shape, device="cuda", generator=g).to(dtype) for o in got]
    torch.autograd.backward(got, gouts)
    torch.cuda.synchronize()
    pl = [t.detach().float().requires_grad_(True) for t in tables]
    pc = [c.detach().clone().requires_grad_(True) for c in coords]
    ref = k4.fused_multilevel_gather_plain(pl, K4_PYRAMID, C, pc, align_corners)
    torch.autograd.backward(ref, [x.float() for x in gouts])
    f32 = dtype == torch.float32
    rec = {"values": [compare(a, b, 1e-5 if f32 else 1e-2, f"K4 {name} level {l}")
                      for l, (a, b) in enumerate(zip(got, ref))],
           "d_tables": [compare(a.grad, b.grad, 1e-4 if f32 else 1e-2,
                                f"K4-bwd {name} level {l} d_table")
                        for l, (a, b) in enumerate(zip(tl, pl))],
           "d_coords": [compare(a.grad, b.grad, 1e-4 if f32 else 1e-2,
                                f"K4-bwd {name} level {l} d_coords")
                        for l, (a, b) in enumerate(zip(cl, pc))]}
    check(all(o.dtype == dtype for o in got) and all(a.grad.dtype == dtype for a in tl)
          and all(a.grad.dtype == torch.float32 for a in cl),
          f"K4 {name}: dtypes {[o.dtype for o in got]}, {[a.grad.dtype for a in tl]}")
    return rec


def phase_k4():
    """The K4 parity gate (bench.py:_kernel_parity's counterpart): K4 and
    K4-bwd at (a) bench.py's shapes in float32 at both align_corners and (b)
    the deformable attention's flagship shapes in bf16, each held against
    the plain version (k4_check); then the times at (b) of K4, K4-bwd, the
    plain version and its autograd, and of the library reference, which
    takes three calls: one F.grid_sample per level on a channels-first copy
    of the level (bf16 grid), and their backward."""
    import torch
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import trilerp_fused as k4

    gate = k4_inputs("gate")
    flag = k4_inputs("flagship")
    reset_launches()  # the parity gate's path starts here
    rec = {"gate_f32": {f"align_corners={a}": k4_check(*gate, a, f"gate align_corners={a}")
                        for a in (False, True)},
           "flagship_bf16": k4_check(*flag, False, "flagship bf16")}
    rec["launches"] = launches()  # ... and ends here
    check(rec["launches"] == K4_GATE_LAUNCHES, f"K4 gate launches {rec['launches']}")

    tables, coords, C = flag
    G = tables[0].shape[0]
    S_tot = sum(c.shape[1] for c in coords)
    check(k4.multi_fwd_path(C, tables[0].dtype, [t.data_ptr() for t in tables]) == "row",
          "K4 flagship: not the row-wide path")
    outs = k4.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    again = k4.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    check(all(torch.equal(a, b) for a, b in zip(outs, again)), "K4 row path: two calls differ")
    del again
    fwd = {"max_abs_err": max(r["max_abs_err"] for r in rec["flagship_bf16"]["values"]),
           "bit_identical_calls": True}
    fwd["kernel_ms"] = time_cuda(lambda: k4._launch_multi_fwd(tables, K4_PYRAMID, C, coords,
                                                              False))
    # the scalar path (the per-channel loop the row-wide path replaced) on
    # the same inputs, held against the plain version too
    ref = k4.fused_multilevel_gather_plain(tables, K4_PYRAMID, C, coords)
    fwd["scalar_path"] = [compare(a, b, 1e-2, f"K4 scalar path level {l}") for l, (a, b) in
                          enumerate(zip(k4._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False,
                                                             path="scalar"), ref))]
    del ref
    fwd["scalar_path_ms"] = time_cuda(lambda: k4._launch_multi_fwd(
        tables, K4_PYRAMID, C, coords, False, path="scalar"))
    # float32 tables at the same shapes: both paths, the plain version and
    # the library's three calls
    t32, c32, _ = k4_inputs("flagship", torch.float32)
    ref = k4.fused_multilevel_gather_plain(t32, K4_PYRAMID, C, c32)
    fwd["f32"] = {"values": [compare(a, b, 1e-5, f"K4 f32 level {l}") for l, (a, b) in
                             enumerate(zip(k4.fused_multilevel_gather(t32, K4_PYRAMID, C, c32),
                                           ref))]}
    del ref
    v32 = [t.reshape(G, X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous()
           for t, (X, Y, Z) in zip(t32, K4_PYRAMID)]
    g32 = [c.flip(-1).reshape(G, -1, 1, 1, 3).contiguous() for c in c32]
    fwd["f32"].update(
        kernel_ms=time_cuda(lambda: k4._launch_multi_fwd(t32, K4_PYRAMID, C, c32, False)),
        scalar_path_ms=time_cuda(lambda: k4._launch_multi_fwd(t32, K4_PYRAMID, C, c32, False,
                                                              path="scalar")),
        plain_ms=time_cuda(lambda: k4.fused_multilevel_gather_plain(t32, K4_PYRAMID, C, c32),
                           iters=10),
        library_ms=time_cuda(lambda: [F.grid_sample(v, gr, mode="bilinear",
                                                    padding_mode="zeros", align_corners=False)
                                      for v, gr in zip(v32, g32)]))
    fwd["f32"].update(bound(nbytes(*t32, *c32) + G * S_tot * C * 4, G * S_tot * C * 8 * 2))
    del t32, c32, v32, g32
    fwd["kernel_ms_gate_f32"] = time_cuda(lambda: k4._launch_multi_fwd(
        gate[0], K4_PYRAMID, C, gate[1], False))
    # at the gate's small shapes the events also time the launch's host
    # work: the profiler's device time of the kernel alone, and of the
    # library's three grid_sample calls there
    fwd["kernel_device_ms_gate_f32"] = device_ms(lambda: k4._launch_multi_fwd(
        gate[0], K4_PYRAMID, C, gate[1], False))
    g_vols = [t.reshape(t.shape[0], X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous()
              for t, (X, Y, Z) in zip(gate[0], K4_PYRAMID)]
    g_grids = [c.flip(-1).reshape(c.shape[0], -1, 1, 1, 3).contiguous() for c in gate[1]]

    def gate_library():
        return [F.grid_sample(v, gr, mode="bilinear", padding_mode="zeros", align_corners=False)
                for v, gr in zip(g_vols, g_grids)]

    fwd["library_ms_gate_f32"] = time_cuda(gate_library)
    fwd["library_device_ms_gate_f32"] = device_ms(gate_library)
    fwd["plain_ms"] = time_cuda(lambda: k4.fused_multilevel_gather_plain(
        tables, K4_PYRAMID, C, coords), iters=10)
    vols = [t.reshape(G, X, Y, Z, C).permute(0, 4, 1, 2, 3).contiguous()
            for t, (X, Y, Z) in zip(tables, K4_PYRAMID)]
    grids = [c.flip(-1).reshape(G, -1, 1, 1, 3).to(torch.bfloat16).contiguous() for c in coords]

    def library():
        return [F.grid_sample(v, gr, mode="bilinear", padding_mode="zeros", align_corners=False)
                for v, gr in zip(vols, grids)]

    fwd["library_ms"] = time_cuda(library)
    fwd["library_calls"] = len(K4_PYRAMID)
    # every input read once, every output written once; 8 corner FMAs per
    # (sample, channel)
    fwd.update(bound(nbytes(*tables, *coords, *outs), G * S_tot * C * 8 * 2))
    fwd["roofline_share"] = fwd["bound_ms"] / fwd["kernel_ms"]

    g = torch.Generator(device="cuda").manual_seed(8)
    gouts = [torch.randn(o.shape, device="cuda", generator=g).to(o.dtype) for o in outs]
    d_tables, d_coords = k4._launch_multi_bwd(tables, K4_PYRAMID, C, coords, gouts, False, True)
    bwd = {"max_abs_err": max(r["max_abs_err"] for k in ("d_tables", "d_coords")
                              for r in rec["flagship_bf16"][k])}
    bwd["kernel_ms"] = time_cuda(lambda: k4._launch_multi_bwd(
        tables, K4_PYRAMID, C, coords, gouts, False, True))
    bwd["kernel_ms_without_d_coords"] = time_cuda(lambda: k4._launch_multi_bwd(
        tables, K4_PYRAMID, C, coords, gouts, False, False))
    pl = [t.detach().clone().requires_grad_(True) for t in tables]
    pc = [c.detach().clone().requires_grad_(True) for c in coords]
    p_out = k4.fused_multilevel_gather_plain(pl, K4_PYRAMID, C, pc)
    bwd["plain_ms"] = time_cuda(lambda: torch.autograd.grad(
        p_out, pl + pc, gouts, retain_graph=True), iters=10)
    del p_out
    lv = [v.detach().clone().requires_grad_(True) for v in vols]
    lg = [x.detach().clone().requires_grad_(True) for x in grids]
    l_out = [F.grid_sample(v, x, mode="bilinear", padding_mode="zeros", align_corners=False)
             for v, x in zip(lv, lg)]
    l_gout = [go.reshape(o.shape) for go, o in zip(gouts, l_out)]
    bwd["library_ms"] = time_cuda(lambda: torch.autograd.grad(
        l_out, lv + lg, l_gout, retain_graph=True), iters=10)
    bwd["library_calls"] = len(K4_PYRAMID)
    del l_out
    # tables, coords and gout read once; d_tables (the tables' dtype) and
    # d_coords (float32) written once.  Per corner and channel the d_table
    # product and add and one FMA of the dot that d_coords needs: 8 x 4
    # operations per (sample, channel)
    bwd.update(bound(nbytes(*tables, *coords, *gouts, *tables, *d_coords),
                     G * S_tot * C * 8 * 4))
    bwd["roofline_share"] = bwd["bound_ms"] / bwd["kernel_ms"]
    rec["K4"], rec["K4-bwd"] = fwd, bwd
    return rec


def phase_kernels():
    k1_fwd, k1_bwd = phase_k1()
    k2_fwd, k2_bwd = phase_k2()
    k2_fwd["batched"], k2_bwd["batched"] = phase_k2_batched()
    rec = {"phase": "kernels", "K1": k1_fwd, "K1-bwd": k1_bwd, "K2": k2_fwd,
           "K2-bwd": k2_bwd, "K3": phase_k3()}
    free_memory()
    rec["K4_gate"] = phase_k4()
    rec["K4"], rec["K4-bwd"] = rec["K4_gate"].pop("K4"), rec["K4_gate"].pop("K4-bwd")
    emit(rec)
    return rec


def phase_tiny():
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import tiny_cfg

    from occformer_tpu_torch.models.detector import build_model

    cfg = tiny_cfg.model_cfg()
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = tiny_cfg.make_batch(np.random.RandomState(0))
    before = launches()
    with torch.inference_mode():
        ref = cpu({k: torch.from_numpy(v) for k, v in batch.items()})
        got = gpu({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    n = {k: v - before[k] for k, v in launches().items()}
    # 2 deformable encoder layers; hd = 12 float32 rows take K1's row-wide path
    rec = {"phase": "tiny", "k1_launches": n["K1"], "k1_row_launches": n["K1.row"]}
    check(n["K1"] == n["K1.row"] == 2, f"tiny: K1 launched {n['K1']} times "
          f"({n['K1.row']} on the row-wide path), want 2 (2)")
    for k, r in ref.items():
        g = got[k].float().cpu()
        err = (g - r).abs().max().item()
        tol = 1e-3 * r.abs().max().item() + 1e-4
        rec[k] = {"max_abs_err": err, "tol": tol}
        check(err <= tol, f"tiny {k}: max|diff| {err} > {tol}")
    emit(rec)


def tiny_train_batch(rng, B=1):
    """The tiny train batch of tests/test_torch_train.py, with B samples."""
    import numpy as np

    import tiny_cfg

    batch = tiny_cfg.make_batch(rng, B=B)
    N, (H, W) = tiny_cfg.NUM_CAMS, tiny_cfg.INPUT_SIZE
    X, Y, Z = tiny_cfg.OCC_SIZE
    gt_occ = rng.randint(0, tiny_cfg.NUM_CLASSES, size=(B, X, Y, Z)).astype(np.int32)
    gt_occ[:, :2] = 255
    depth = rng.uniform(0, 10, size=(B, N, H, W)).astype(np.float32)
    depth[depth < 3] = 0.0
    P = 128
    batch.update(gt_occ=gt_occ, gt_depth=depth,
                 lidar_xyz=rng.uniform(0, 1, size=(B, P, 3)).astype(np.float32),
                 lidar_valid=np.arange(P)[None].repeat(B, 0) < 100,
                 lidar_label=rng.randint(0, tiny_cfg.NUM_CLASSES, (B, P)).astype(np.int32))
    return batch


def phase_tiny_train(mxu_readout="off", accum_steps=1):
    """One tiny train step in train mode (BatchNorm batch statistics,
    drop-path) on the card with the kernels and on the CPU with the plain
    versions, float32, from the same state with the same draws (drop-path
    from identically seeded CPU generators, the loss draws made once), on
    the loss route ``mxu_readout`` with ``accum_steps`` micro-batches of one
    sample each.

    Tolerances.  The tiny step is ill-conditioned in places: train-mode
    BatchNorm over 4 values per channel (ResNet layer4 is 1x2 on 2 cameras)
    amplifies a change of the images a hundredfold, and the gradients that
    reach the DepthNet through the mask loss cancel to a small share of
    their terms (a conv bias in front of a train-mode BatchNorm has a true
    gradient of 0).  So on the CPU alone, images scaled by 1 +- 1e-6 move
    grad_norm by up to about 2e-3 and dozens of gradients by more than 1% of
    their max, and whether a scaling does so is a matter of rounding
    (``cpu_moves_by_image_scale`` in the record).  No float32
    implementation can agree closer than that.  So the phase measures that
    spread anew, over the CPU step on images scaled by 1 +- 1, 2, 3, 5 e-6,
    and holds each number to its plain tolerance plus twice its largest
    move there: losses, total_loss and grad_norm 1e-3 relative; every
    gradient 1e-2 * max|ref| + 1e-6; every parameter after the update
    1e-3 * max|ref| + 1e-6 where the CPU gradient lies outside its tolerance
    of 0, and 2 * lr + 1e-6 where it does not (Adam's first step is
    lr * sign(g), whose sign such a gradient does not fix)."""
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import tiny_cfg

    from occformer_tpu_torch.engine.optim import build_optimizer
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.losses.mask2former_loss import make_loss_draws
    from occformer_tpu_torch.models.detector import build_model

    cfg = tiny_cfg.model_cfg()
    loss_cfg = build_loss_cfg(dict(cfg["pts_bbox_head"], mxu_readout=mxu_readout), dict(
        num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75))
    batch = tiny_train_batch(np.random.RandomState(0), B=accum_steps)
    L = cfg["pts_bbox_head"]["transformer_decoder"]["num_layers"] + 1
    gen = torch.Generator().manual_seed(4)
    draws = [make_loss_draws(gen, loss_cfg, torch.from_numpy(batch["lidar_valid"][m:m + 1]), L)
             for m in range(accum_steps)]
    lr = 1e-4

    def run(dev, scale=1.0):
        model = build_model(cfg, device="cpu", seed=0).to(dev).train()
        opt = build_optimizer(model, lr=lr, grad_clip=5.0)
        step = build_train_step(model, opt, loss_cfg, device=dev, accum_steps=accum_steps)
        before = launches()
        b = dict(batch, imgs=(batch["imgs"] * scale).astype(np.float32))
        metrics = step(b, torch.Generator().manual_seed(3), draws=draws)
        n = {k: v - before[k] for k, v in launches().items()}
        return ({k: float(v) for k, v in metrics.items()},
                {"grad": {k: p.grad.detach().float().cpu()
                          for k, p in model.named_parameters()},
                 "param": {k: v.detach().float().cpu()
                           for k, v in model.state_dict().items() if v.is_floating_point()}},
                n)

    m_got, t_got, n_got = run("cuda")
    m_ref, t_ref, _ = run("cpu")
    spread_m = {k: 0.0 for k in m_ref}
    spread_t = {w: {k: 0.0 for k in t_ref[w]} for w in t_ref}
    moves = {}  # per scaling: grad_norm's relative move, gradients moved > 1% of max
    for e in (1, -1, 2, -2, 3, -3, 5, -5):
        m_sc, t_sc, _ = run("cpu", 1 + e * 1e-6)
        for k in m_ref:
            spread_m[k] = max(spread_m[k], abs(m_sc[k] - m_ref[k]))
        moved = 0
        for w in t_ref:
            for k, r in t_ref[w].items():
                d = (t_sc[w][k] - r).abs().max().item()
                spread_t[w][k] = max(spread_t[w][k], d)
                moved += w == "grad" and d > 1e-2 * r.abs().max().item() + 1e-6
        moves[f"{1 + e * 1e-6:.6f}"] = {
            "grad_norm": abs(m_sc["grad_norm"] / m_ref["grad_norm"] - 1),
            "grads_moved_over_1e-2_of_max": moved}
    rec = {"phase": "tiny_train", "mxu_readout": mxu_readout, "accum_steps": accum_steps,
           "launches": n_got, "metrics_cuda": m_got, "metrics_cpu": m_ref,
           "metrics_cpu_spread": spread_m, "cpu_moves_by_image_scale": moves}
    failed = []
    # 2 deformable encoder layers (hd = 12 float32: K1's row-wide path), 4
    # supervised decoder outputs; the tiny feature's C = 48 (float32) takes
    # K2's row-wide path and K2-bwd's segmented one, the GT masks (C = 5 and
    # 1) K2's narrow path; on the batched route the match volumes' C = 8
    # queries take K2's row-wide path, the per-slot volumes (C = 5 and 1)
    # K2's narrow path and K2-bwd's narrow one
    per_micro = (dict(_NONE, **{"K1": 2, "K1.row": 2, "K1-bwd": 2, "K2": 3, "K2.row": 1,
                                "K2-bwd": 2, "K2-bwd.narrow": 2, "K3": 3, "S1": 1})
                 if loss_cfg.batched_readout else
                 dict(_NONE, **{"K1": 2, "K1.row": 2, "K1-bwd": 2, "K2": 24, "K2.row": 12,
                                "K2-bwd": 8, "S1": 1}))
    if n_got != {k: v * accum_steps for k, v in per_micro.items()}:
        failed.append(f"launches {n_got}")
    for k, r in m_ref.items():
        if k != "point_mean_iou" and \
                abs(m_got[k] - r) > 1e-3 * abs(r) + 1e-6 + 2 * spread_m[k]:
            failed.append(f"{k}: {m_got[k]} vs {r} (CPU spread {spread_m[k]})")
    worst = {}
    for what, rel in (("grad", 1e-2), ("param", 1e-3)):
        shares = []
        for k, r in t_ref[what].items():
            err = (t_got[what][k] - r).abs()
            base = torch.full_like(r, rel * r.abs().max().item() + 1e-6)
            if what == "param" and k in t_ref["grad"]:  # parameters take the Adam step
                g = t_ref["grad"][k].abs()
                g_tol = 1e-2 * g.max().item() + 1e-6 + 2 * spread_t["grad"][k]
                base = torch.where(g <= g_tol, torch.full_like(base, 2 * lr + 1e-6), base)
            share = (err / (base + 2 * spread_t[what][k])).max().item()
            shares.append((share, k, err.max().item(), (err / base).max().item()))
            if share > 1:
                failed.append(f"{what} {k}: max|diff| {err.max().item()} over its "
                              f"tolerance by {share:.3g}x")
        top = max(shares)
        # tensors that needed the measured spread, by module
        over = {}
        for s in shares:
            if s[3] > 1:
                mod = ".".join(s[1].split(".")[:2])
                over[mod] = over.get(mod, 0) + 1
        worst[what] = {"tensors": len(shares), "worst_share_of_tol": top[0], "worst": top[1],
                       "max_abs_err": top[2], "over_plain_tol": over}
    rec["compare"] = worst
    emit(rec)
    check(not failed, f"tiny_train {mxu_readout} x{accum_steps}: " + "; ".join(failed[:10]))


def point_scores(model, batch, compute_dtype):
    """Per-point class scores [1, P, C] float32 of the eval step's readout
    (``engine/eval.py``), the forward under autocast when ``compute_dtype``
    is given."""
    import torch

    from occformer_tpu_torch.engine.eval import lidarseg_point_logits, to_device_batch
    from occformer_tpu_torch.models.mask2former_head import (
        format_results,
        mask_logits_from_embeds,
    )

    b = to_device_batch(batch, torch.device("cuda"))
    with torch.inference_mode(), torch.autocast("cuda", dtype=compute_dtype or torch.float32,
                                                enabled=compute_dtype is not None):
        out = model(b)
        voxels = format_results(out["cls_preds"][-1], mask_logits_from_embeds(
            out["mask_embeds"][-1], out["mask_feature"]))
        return lidarseg_point_logits(voxels, b["lidar_xyz"]).float()


def serve_frames(step, batch, frames=4):
    """``frames`` calls of ``step`` (the first a warm-up): (ms of each, peak
    bytes over them, resident bytes before them, the last output)."""
    import torch

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    frames_ms = []
    for _ in range(frames):
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        frames_ms.append((time.perf_counter() - t) * 1e3)
    return frames_ms, torch.cuda.max_memory_allocated(), resident, out


def phase_determinism():
    """Whether the LSS scatter's atomic order is what makes a reloaded train
    step on the card differ (ops/scatter.py).  A model, optimizer, batch and
    step seed are fixed; each pair of steps starts from one saved state
    (model and optimizer reloaded bit for bit) and records every loss, the
    LSS volume and every uncertainty top-k index set of the per-layer loss.
    Pairs run with the scatter's atomic order (its plain version,
    ``index_add_``), then with only the scatter deterministic (S1, the
    default),
    on the tiny CLI model (synthetic_tiny, frozen stem) and on the flagship
    at full width.  In deterministic mode every pair must repeat its losses,
    volumes and top-k bit for bit.  Then S1 (the splat kernel behind the
    deterministic mode) on the flagship's captured inputs: held against the
    plain version, two calls bit-equal, and one call of
    ``voxel_scatter_lifted`` (one per frame or train step) timed in both
    modes in turns, beside one ``index_add_`` of the whole lift."""
    import copy

    import numpy as np
    import torch

    import occformer_tpu_torch.losses.mask2former_loss as loss_mod
    import occformer_tpu_torch.models.lss as lss_mod
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset
    from occformer_tpu_torch.data.synthetic import make_train_batch
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.ops import scatter

    topks, volumes, captured = [], [], []
    orig_topk, orig_scatter = loss_mod.uncertainty_topk, lss_mod.voxel_scatter_lifted

    def rec_topk(logits, n):
        idx = orig_topk(logits, n)
        topks.append(idx.detach().clone())
        return idx

    def atomic_scatter(depth, ctx, coords, valid, nx):
        """The scatter through its plain version: atomic index_add_."""
        B, n_rows = depth.shape[0], depth.shape[0] * int(np.prod(nx))
        return scatter.voxel_scatter_plain(depth, ctx, scatter.voxel_rows(coords, valid, nx),
                                           n_rows).reshape(B, *nx, -1).to(depth.dtype)

    mode = {"atomic": False}

    def rec_scatter(*args):
        if not captured:
            captured.append([a.detach().clone() if torch.is_tensor(a) else a for a in args])
        out = (atomic_scatter if mode["atomic"] else orig_scatter)(*args)
        volumes.append(out.detach().clone())
        return out

    def pairs(cfg_path, options, batch, n_pairs, warm_step, compute_dtype):
        cfg = load_config(cfg_path, options)
        m = cfg["model"]
        model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
        opt = build_optimizer_from_config(model, cfg, 16)
        step = build_train_step(model, opt, build_loss_cfg(m["pts_bbox_head"],
                                                           m["train_cfg"]["pts"]),
                                device="cuda", compute_dtype=compute_dtype)
        if batch is None:
            batch = next(iter(build_dataloader(build_dataset(cfg["data"]["train"]),
                                               max_points=512)))
            batch.pop("_meta")
        if warm_step:
            step(batch, torch.Generator(device="cuda").manual_seed(0))
        state = copy.deepcopy((model.state_dict(), opt.state_dict()))

        def run():
            model.load_state_dict(state[0])
            opt.load_state_dict(state[1])
            topks.clear()
            volumes.clear()
            metrics = step(batch, torch.Generator(device="cuda").manual_seed(1))
            return ({k: float(v) for k, v in metrics.items()}, list(topks), list(volumes))

        rec = {}
        for name, atomic in (("atomic_scatter", True), ("deterministic_scatter", False)):
            mode["atomic"] = atomic
            counts = {"pairs": n_pairs, "losses_differ": 0, "volumes_differ": 0,
                      "topk_differ": 0, "topk_sets_differing": 0, "grad_norm_differs": 0,
                      "max_rel_loss_diff": 0.0}
            for _ in range(n_pairs):
                (ma, ta, va), (mb, tb, vb) = run(), run()
                losses = [k for k in ma if "loss" in k]
                counts["losses_differ"] += any(ma[k] != mb[k] for k in losses)
                counts["max_rel_loss_diff"] = max(
                    [counts["max_rel_loss_diff"]] + [abs(ma[k] - mb[k]) / max(abs(ma[k]), 1e-12)
                                                     for k in losses])
                counts["volumes_differ"] += not all(torch.equal(a, b) for a, b in zip(va, vb))
                differing = sum(not torch.equal(a, b) for a, b in zip(ta, tb))
                counts["topk_differ"] += differing > 0
                counts["topk_sets_differing"] += differing
                counts["grad_norm_differs"] += ma["grad_norm"] != mb["grad_norm"]
            counts["topk_sets_per_step"] = len(ta)
            rec[name] = counts
        del model, opt, step, state
        return rec

    loss_mod.uncertainty_topk, lss_mod.voxel_scatter_lifted = rec_topk, rec_scatter
    try:
        tiny = os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py")
        rec = {"phase": "reload_determinism",
               "tiny": pairs(tiny, {"model.img_backbone.frozen_stages": 0}, None, 5, True,
                             None)}
        free_memory()
        captured.clear()  # keep the flagship's inputs
        cfg = load_config(CONFIG)
        rec["flagship"] = pairs(CONFIG, {}, make_train_batch(cfg, seed=0), 2, False,
                                getattr(torch, cfg["compute_dtype"]))
    finally:
        loss_mod.uncertainty_topk, lss_mod.voxel_scatter_lifted = orig_topk, orig_scatter
    free_memory()

    # S1 on the flagship's captured inputs against the plain version (the
    # atomic index_add_), both timed in turns, beside one index_add_ of the
    # whole lift (the library call)
    depth, ctx, coords, valid, nx = captured[0]
    captured.clear()
    got = scatter.voxel_scatter_lifted(depth, ctx, coords, valid, nx)
    again = scatter.voxel_scatter_lifted(depth, ctx, coords, valid, nx)
    ref = atomic_scatter(depth.float(), ctx.float(), coords, valid, nx)
    s1 = compare(got, ref, 1e-5 if got.dtype == torch.float32 else 1e-2, "S1 flagship")
    check(torch.equal(got, again), "S1: two calls differ")
    s1["bit_identical_calls"] = True
    s1["dtypes"] = [str(depth.dtype), str(ctx.dtype)]
    del again, ref
    ms = {"atomic_scatter": [], "deterministic_scatter": []}
    with torch.no_grad():
        for name in ("atomic_scatter", "deterministic_scatter", "deterministic_scatter",
                     "atomic_scatter"):
            fn = atomic_scatter if name == "atomic_scatter" else scatter.voxel_scatter_lifted
            ms[name].append(time_cuda(lambda: fn(depth, ctx, coords, valid, nx)))
        rows = scatter.voxel_rows(coords, valid, nx).reshape(-1)
        lift = (depth[..., None] * ctx[:, :, None]).reshape(rows.shape[0], -1).float()
        vol = torch.zeros((depth.shape[0] * int(nx[0]) * int(nx[1]) * int(nx[2]) + 1,
                           lift.shape[1]), device=lift.device)
        s1["library_ms"] = time_cuda(lambda: vol.index_add_(0, rows, lift))
        del rows, lift, vol
    s1["kernel_ms"] = sum(ms["deterministic_scatter"]) / 2
    s1["plain_ms"] = sum(ms["atomic_scatter"]) / 2
    # the function's inputs read once and its volume written once; a
    # product and an add per (point, channel)
    s1.update(bound(nbytes(depth, ctx, coords, valid, got), depth.numel() * ctx.shape[-1] * 2))
    rec["S1"] = s1
    rec["flagship_scatter_ms"] = ms
    rec["flagship_scatter_shapes"] = [list(a.shape) for a in (depth, ctx, coords, valid)]
    rec["deterministic_cost_ms_per_step"] = s1["kernel_ms"] - s1["plain_ms"]
    del depth, ctx, coords, valid, got
    emit(rec)
    for size in ("tiny", "flagship"):
        r = rec[size]["deterministic_scatter"]
        check(r["losses_differ"] == r["volumes_differ"] == r["topk_differ"] == 0,
              f"reload_determinism {size}: a deterministic-scatter pair differs: {r}")
    return rec


def phase_serve():
    """Serving as the JAX package serves: float32 parameters, the forward
    under bf16 autocast (``build_eval_step(..., compute_dtype)``).  Then,
    once, the route the port served before (every parameter and buffer cast
    to bf16, no autocast) on the same weights and frame: its ms/frame and
    peak, and how far its predictions stand from the served ones (share of
    equal ``point_pred``, largest gap of the per-point class scores)."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_serving_batch
    from occformer_tpu_torch.engine.eval import build_eval_step
    from occformer_tpu_torch.models.detector import build_model

    cfg = load_config(CONFIG)
    compute_dtype = getattr(torch, cfg["compute_dtype"])
    t0 = time.perf_counter()
    model = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    num_classes = cfg["model"]["pts_bbox_head"]["num_occupancy_classes"]
    occ_size = tuple(cfg["occ_size"])
    batch = make_serving_batch(cfg, seed=0)
    step = build_eval_step(model, occ_size, num_classes, compute_dtype)

    reset_launches()  # the main path's run starts here
    frames_ms, peak, resident, out = serve_frames(step, batch)
    n = launches()  # ... and ends here

    P = batch["lidar_xyz"].shape[1]
    rec = {"phase": "serve", "config": "occformer_nusc_r50_256x704",
           "param_dtype": "float32", "autocast": cfg["compute_dtype"], "model_build_s": build_s,
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_frame_ms": frames_ms[0], "frame_ms": frames_ms[1:],
           "frames_run": len(frames_ms), "launches": n,
           "peak_memory_bytes": peak, "resident_bytes_at_start": resident,
           "voxel_pred": list(out["voxel_pred"].shape),
           "point_pred": list(out["point_pred"].shape)}
    want = {k: v * len(frames_ms) for k, v in SERVE_LAUNCHES.items()}
    check(n == want, f"serve launches {n} in {len(frames_ms)} frames, want {want}")
    check(rec["voxel_pred"] == [1, *occ_size], f"voxel_pred {rec['voxel_pred']}")
    check(rec["point_pred"] == [1, P], f"point_pred {rec['point_pred']}")
    cm = out["confusion"]
    check(list(cm.shape) == [num_classes] * 2 and int(cm.sum()) == P,
          f"confusion {list(cm.shape)} sums to {int(cm.sum())}, want {P}")
    check(int(out["voxel_pred"].max()) < num_classes
          and int(out["point_pred"].min()) >= 1, "predicted labels out of range")
    with torch.inference_mode(), torch.autocast("cuda", dtype=compute_dtype):
        raw = model({k: torch.as_tensor(v).cuda() for k, v in batch.items()})
    finite = {k: bool(torch.isfinite(v.float()).all()) for k, v in raw.items()}
    rec["finite"] = finite
    rec["shapes"] = {k: list(v.shape) for k, v in raw.items()}
    check(all(finite.values()), f"non-finite outputs: {finite}")
    rec["profile"] = profile(lambda: step(batch), SERVE_STAGES)

    # the route served before: the same weights, every tensor in bf16
    pred = out["point_pred"].clone()
    scores = point_scores(model, batch, compute_dtype)
    old = build_model(cfg["model"], device="cuda", dtype=torch.bfloat16, seed=1)
    old.load_state_dict(model.state_dict())  # cast to each of its tensors' dtypes
    del model, step, raw, out
    free_memory()
    old_step = build_eval_step(old, occ_size, num_classes)
    old_ms, old_peak, old_resident, old_out = serve_frames(old_step, batch)
    old_scores = point_scores(old, batch, None)
    rec["bf16_parameter_route"] = {
        "warmup_frame_ms": old_ms[0], "frame_ms": old_ms[1:], "peak_memory_bytes": old_peak,
        "resident_bytes_at_start": old_resident,
        "point_pred_agreement": (old_out["point_pred"] == pred).float().mean().item(),
        "distinct_point_classes": [len(torch.unique(pred)), len(torch.unique(old_out["point_pred"]))],
        "max_abs_point_score_gap": (old_scores - scores).abs().max().item(),
        "max_abs_point_score": scores.abs().max().item()}
    del old, old_step, old_out
    free_memory()
    emit(rec)
    return n


def phase_train(mxu_readout="off"):
    """The flagship's train step: float32 parameters, bfloat16 autocast,
    batch 1, random weights, ``make_train_batch(cfg, seed=0)``, on the loss
    route ``mxu_readout`` ("off" the per-layer route, "on" the batched
    one)."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_train_batch
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    cfg = load_config(CONFIG)
    m = cfg["model"]
    t0 = time.perf_counter()
    model = build_model(m, device="cuda", dtype=torch.float32, seed=0).train()
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout=mxu_readout),
                              m["train_cfg"]["pts"])
    opt = build_optimizer_from_config(model, cfg, 28130)  # nuScenes' train samples
    step = build_train_step(model, opt, loss_cfg, device="cuda",
                            compute_dtype=getattr(torch, cfg["compute_dtype"]))
    batch = make_train_batch(cfg, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    watch = {k: p.detach().clone() for k, p in model.named_parameters()
             if k in ("img_backbone.layer1.0.conv1.weight", "img_backbone.conv1.weight",
                      "img_bev_encoder_neck.encoder.layers.0.attentions.0.value_proj.weight",
                      "pts_bbox_head.query_feat.weight")}
    g = torch.Generator(device="cuda").manual_seed(0)

    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    reset_launches()  # the main path's run starts here
    steps_s, history = [], []
    for _ in range(4):  # 1 warm-up + 3 timed
        t = time.perf_counter()
        metrics = step(batch, g)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t)
        history.append({k: float(v) for k, v in metrics.items()})
    n = launches()  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    name = "train" if mxu_readout == "off" else "train_batched"
    want = {k: v * len(steps_s) for k, v in TRAIN_LAUNCHES[mxu_readout].items()}
    check(n == want, f"{name} launches {n} in {len(steps_s)} steps, want {want}")
    for h in history:
        check(all(v == v and abs(v) != float("inf") for k, v in h.items()
                  if k != "point_mean_iou"), f"non-finite train metrics {h}")
    moved = {k: (p.detach() - watch[k]).abs().max().item()
             for k, p in model.named_parameters() if k in watch}
    check(moved["img_backbone.conv1.weight"] == 0.0, "the frozen stem moved")
    check(all(v > 0 for k, v in moved.items() if k != "img_backbone.conv1.weight"),
          f"parameters did not move: {moved}")
    rec = {"phase": name, "mxu_readout": mxu_readout,
           "config": "occformer_nusc_r50_256x704",
           "param_dtype": "float32", "autocast": cfg["compute_dtype"],
           "params": sum(p.numel() for p in model.parameters()),
           "setup_s": build_s, "warmup_step_s": steps_s[0], "step_s": steps_s[1:],
           "steps_run": len(steps_s), "launches": n, "peak_memory_bytes": peak,
           "resident_bytes_at_start": resident,
           "metrics": history, "max_param_change": moved,
           "loss_points": {"matching": loss_cfg.num_match_points,
                           "candidates": loss_cfg.num_candidates,
                           "supervised": loss_cfg.num_points}}
    rec["profile"] = profile(lambda: step(batch, g), TRAIN_STAGES)
    if loss_cfg.batched_readout:
        rec["routes"] = compare_routes(model, batch, loss_cfg)
    emit(rec)
    return n


def compare_routes(model, batch, loss_cfg):
    """Both loss routes on one float32 copy of a step's model outputs (the
    train-mode forward under bf16 autocast, no grad) with one set of draws:
    every loss, and the Hungarian assignments.  A layer whose assignments
    agree must agree in its losses within 1e-4 relative (+1e-6): the two
    routes contract the volume and the feature sides in another order, and
    a candidate whose |logit| sits at the uncertainty top-k's boundary may
    swap in or out.  A layer whose assignments differ (near-tied costs can
    flip one) is reported, not held to that."""
    import dataclasses

    import torch

    from occformer_tpu_torch.engine.eval import to_device_batch
    from occformer_tpu_torch.losses.mask2former_loss import (
        make_loss_draws,
        mask2former_loss,
        match_assignments,
    )
    from occformer_tpu_torch.models.layers import drop_path_generator

    b = to_device_batch(batch, torch.device("cuda"))
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16), \
            drop_path_generator(torch.Generator(device="cuda").manual_seed(6)):
        out = model(b)
    out = {k: out[k].float() for k in ("cls_preds", "mask_embeds", "mask_feature")}
    L = out["cls_preds"].shape[0]
    draws = make_loss_draws(torch.Generator(device="cuda").manual_seed(7), loss_cfg,
                            b["lidar_valid"], L)
    args = (out["cls_preds"], out["mask_embeds"], out["mask_feature"], b["gt_occ"])
    res = {}
    for route in ("off", "on"):
        cfg = dataclasses.replace(loss_cfg, mxu_readout=route)
        rest = (cfg, b["lidar_xyz"], b["lidar_valid"], draws)
        with torch.no_grad():
            losses = {k: float(v) for k, v in mask2former_loss(*args, *rest).items()}
            res[route] = (losses, match_assignments(*args, *rest).cpu())
    (ref, a_ref), (got, a_got) = res["off"], res["on"]
    differ = (a_ref != a_got).nonzero().tolist()  # [layer, sample, slot]
    layers_differ = sorted({d[0] for d in differ})
    rel = {k: abs(got[k] - r) / max(abs(r), 1e-12) for k, r in ref.items()}
    rec = {"losses_per_layer_route": ref, "losses_batched_route": got, "rel_diff": rel,
           "max_rel_diff": max(rel.values()), "assignments_differ": differ,
           "layers_with_differing_assignments": layers_differ}
    for k, r in ref.items():
        layer = L - 1 if not k.startswith("d") else int(k[1:k.index(".")])
        if k != "unassigned_gt" and layer not in layers_differ:
            check(abs(got[k] - r) <= 1e-4 * abs(r) + 1e-6,
                  f"routes: {k} {got[k]} (batched) vs {r} (per layer)")
    check(got["unassigned_gt"] == ref["unassigned_gt"] == 0.0, "routes: unassigned GT")
    return rec



def phase_cli():
    """The train and test CLIs at the flagship's full width and depth on
    SyntheticOccDataset (6 cameras at 256x704, 17 classes, 35000 LiDAR
    points, 4 samples), as subprocesses in a temporary work directory that
    is deleted afterwards: tools.train to step 2, the same command resumed
    to step 4, and tools.test on step_4 over 2 samples.  Between the two
    train runs, step_2 is loaded in process into a fresh model and
    optimizer on the card and every tensor held bit-equal to the saved
    file; the load and a save of that state are timed."""
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.engine.checkpoint import (
        load_checkpoint,
        read_checkpoint,
        save_checkpoint,
    )
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.models.detector import build_model

    data = dict(type="SyntheticOccDataset", num_samples=4, num_cams=6, input_size=[256, 704],
                num_classes=17, num_lidar_points=35000)
    opts = [f"data.{split}.{k}={v!r}".replace(" ", "") for split in ("train", "val", "test")
            for k, v in data.items()] + ["log_config.interval=1"]
    work = tempfile.mkdtemp(prefix="occformer_cli_")
    rec = {"phase": "cli", "config": "occformer_nusc_r50_256x704", "cfg_options": opts}

    def run(module, *args):
        t = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", f"occformer_tpu_torch.tools.{module}",
                            CONFIG, *args, "--cfg-options", *opts],
                           cwd=REPO, capture_output=True, text=True, timeout=600)
        seconds = time.perf_counter() - t
        check(r.returncode == 0, f"tools.{module} {' '.join(args)} exited {r.returncode}:\n"
              f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
        lines = [json.loads(ln) for ln in r.stdout.splitlines() if ln.startswith("{")]
        return r.stdout, lines, seconds

    try:
        ckpts = os.path.join(work, "ckpts")
        out1, logs1, rec["train_to_2_s"] = run("train", "--work-dir", work, "--max-steps", "2")
        check("training done at step 2" in out1, f"train to step 2:\n{out1[-2000:]}")
        step2 = os.path.join(ckpts, "step_2")
        rec["checkpoint_bytes"] = os.path.getsize(os.path.join(step2, "state.pt"))

        saved = read_checkpoint(step2)
        cfg = load_config(CONFIG)
        model = build_model(cfg["model"], device="cuda", dtype=torch.float32, seed=1)
        opt = build_optimizer_from_config(model, cfg, 4)
        torch.cuda.synchronize()
        t = time.perf_counter()
        step = load_checkpoint(step2, model, opt)
        torch.cuda.synchronize()
        rec["load_s"] = time.perf_counter() - t
        check(step == 2, f"step_2 holds step {step}")
        differ = [k for k, v in saved["model"].items()
                  if not torch.equal(model.state_dict()[k].cpu(), v)]
        o_saved, o_got = saved["optimizer"], opt.state_dict()
        n_opt = 0
        for i, st in o_saved["adamw"]["state"].items():
            for k, v in st.items():
                n_opt += 1
                if not torch.equal(o_got["adamw"]["state"][i][k].cpu(), v):
                    differ.append(f"optimizer {i}.{k}")
        check(not differ and o_got["step_count"] == o_saved["step_count"] == 2,
              f"step_2 reload differs: {differ[:10]}")
        rec["reload_bit_equal"] = {"model_tensors": len(saved["model"]),
                                   "optimizer_tensors": n_opt,
                                   "params": sum(p.numel() for p in model.parameters())}
        t = time.perf_counter()
        save_checkpoint(os.path.join(work, "save_timing"), model, opt, 2)
        rec["save_s"] = time.perf_counter() - t
        del saved, model, opt, o_got
        free_memory()

        out2, logs2, rec["train_2_to_4_s"] = run("train", "--work-dir", work, "--max-steps", "4")
        check(f"resumed from {step2} at step 2" in out2 and "training done at step 4" in out2,
              f"resume:\n{out2[-2000:]}")
        steps = [ln for ln in logs1 + logs2 if "step" in ln]
        check([ln["step"] for ln in steps] == [1, 2, 3, 4], f"steps {[ln['step'] for ln in steps]}")
        for ln in steps:
            check(all(v == v and abs(v) != float("inf") for k, v in ln.items()
                      if k not in ("point_mean_iou", "epoch")), f"non-finite train log {ln}")
        rec["sec_per_iter"] = [ln["sec/iter"] for ln in steps]
        rec["total_loss"] = [ln["total_loss"] for ln in steps]
        rec["train_launches"] = [ln["kernel_launches"] for ln in logs1 + logs2
                                 if "kernel_launches" in ln]
        check(all(n[k] > 0 for n in rec["train_launches"] for k in ("K1", "K1-bwd", "K2", "K2-bwd")),
              f"train CLI launches {rec['train_launches']}")

        out3, logs3, rec["test_s"] = run("test", "--checkpoint", os.path.join(ckpts, "step_4"),
                                         "--max-samples", "2")
        timing, results = logs3[0], logs3[-1]
        rec["test_sec_per_sample"] = timing["sec/sample"]
        rec["test_launches"] = timing["kernel_launches"]
        rec["test_results"] = results
        check(timing["samples"] == 2 and timing["kernel_launches"]["K1"] == 2 * 6,
              f"test CLI: {timing}")
        mean = results.get("nuScenes_lidarseg_mean")
        check(mean is not None and 0.0 <= mean <= 1.0, f"test CLI results {results}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    emit(rec)
    return rec


# the port's CUDA kernels by function name -> the kernel they belong to;
# K2-bwd's segmented path runs the seven K2-bwd functions per launch, and
# its gather (one per launch) counts the launches
PORT_KERNELS = {"ms_deform_gather3d_kernel": "K1", "ms_deform_gather3d_rows_kernel": "K1.row",
                "ms_deform_gather3d_bwd_kernel": "K1-bwd",
                "trilerp_fwd_narrow_kernel": "K2", "trilerp_fwd_rows_kernel": "K2.row",
                "trilerp_bwd_kernel": "K2-bwd.narrow",
                "seg_count_kernel": "K2-bwd", "scan_tiles_kernel": "K2-bwd",
                "scan_sums_kernel": "K2-bwd", "add_tile_offsets_kernel": "K2-bwd",
                "seg_fill_kernel": "K2-bwd", "seg_rank_kernel": "K2-bwd",
                "trilerp_bwd_gather_kernel": "K2-bwd",
                "label_shared_kernel": "K3", "label_per_slot_kernel": "K3",
                "multilevel_fwd_kernel": "K4", "multilevel_fwd_rows_kernel": "K4.row",
                "multilevel_bwd_kernel": "K4-bwd",
                "add_one_kernel": "P1", "row_gather_kernel": "P2",
                "voxel_splat_kernel": "S1"}
_SEGMENTED_STEPS = {"seg_count_kernel", "scan_tiles_kernel", "scan_sums_kernel",
                    "add_tile_offsets_kernel", "seg_fill_kernel", "seg_rank_kernel"}


def port_kernel_ms(kernels):
    """Device ms and launches of the port's kernels among profiled kernel
    events, by kernel (K2's forward apart by path and table type: the bf16
    feature on the row-wide path, the bool GT, float32 volumes; K2-bwd's
    segmented path summed over its seven functions) and by CUDA function."""
    import re

    by_kernel, by_function = {}, {}
    for e in kernels:
        m = re.match(r"(?:void )?(\w+)(<[^(]*>)?\(", e.key)
        if not m or m.group(1) not in PORT_KERNELS:
            continue
        name = PORT_KERNELS[m.group(1)] + (" " + m.group(2) if m.group(1).startswith(
            "trilerp_fwd") else "")
        for key, table, n in ((name, by_kernel, m.group(1) not in _SEGMENTED_STEPS),
                              (m.group(1) + (m.group(2) or ""), by_function, True)):
            r = table.setdefault(key, {"launches": 0, "device_ms": 0.0})
            r["launches"] += e.count if n else 0
            r["device_ms"] += e.self_device_time_total / 1e3
    return {"by_kernel": by_kernel, "by_function": by_function}


def profile(run, outer, top=12):
    """torch.profiler over one more call of ``run``: host and device time of
    each ``stage:*`` range (``outer`` names the outermost ones, which must
    all appear), device time by kernel name and by operator and input shape,
    and the device's busy share of the call's wall time (the profiler's own
    overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile as torch_profile

    run()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                       record_shapes=True) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    stages = {e.key[len("stage:"):]: {"host_ms": e.cpu_time_total / 1e3,
                                      "device_ms": e.device_time_total / 1e3}
              for e in events
              if e.device_type.name == "CPU" and e.key.startswith("stage:")}
    missing = [k for k in outer if k not in stages]
    check(not missing, f"profiled stages {sorted(stages)} lack {missing}")
    # device rows of annotated ranges (the stages, torch.optim's
    # ``Optimizer.step#...``) span kernels; they are not kernels
    ranges = {e.key for e in events if e.device_type.name == "CPU" and e.is_user_annotation}
    kernels = [e for e in events if e.device_type.name == "CUDA"
               and not (e.is_user_annotation or e.key in ranges)]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type.name == "CPU" and e.key.startswith("aten::")]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    # kernels that no outermost stage launched from the calling thread: for
    # the train step, the backward's, which autograd launches from its own
    # thread
    outside = device_ms - sum(stages[k]["device_ms"] for k in outer if k in stages)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "stages": stages, "device_ms_outside_outer_stages": outside,
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in kernels[:top]],
            "top_ops": [{"name": e.key, "shapes": str(e.input_shapes)[:120],
                         "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                        for e in ops[:top]],
            "port_kernels": port_kernel_ms(kernels)}


def kernel_records(kern, probe, det, paths):
    """One record per kernel path; ``paths`` maps each driven path (serve,
    train, train_batched, the K4 gate, the probe) to its launch counts, and
    a record's ``launches`` sums them.  K1, K2 and K2-bwd each have two
    paths, two records (K1's scalar path is launched on no driven path: it
    is held against the plain version and timed in the kernels phase; K2's
    "scalar" record is its narrow kernel at the GT masks, with the GT table
    and the batched readouts under ``readouts``); K4's scalar path is launched on
    no driven path either.  Records carry the profiler's device ms beside
    the event times where the kernels phase took them."""
    src = "occformer_tpu_torch/csrc/"
    timing = probe["timing"]
    paths = {p: dict(n, **{"K1.scalar": n["K1"] - n["K1.row"],
                           "K2.scalar": n["K2"] - n["K2.row"],
                           "K2-bwd.segmented": n["K2-bwd"] - n["K2-bwd.narrow"]})
             for p, n in paths.items()}
    k1 = kern["K1"]["bf16"]
    k1_scalar = dict(k1, max_abs_err=k1["scalar_path"]["max_abs_err"],
                     kernel_ms=k1["scalar_path_ms"], device_ms=k1["scalar_path_device_ms"])
    readouts = dict(kern["K2"]["batched"], gt_table=kern["K2"]["per_slot_gt"]["gt_table"])
    k2_narrow = dict(kern["K2"]["per_slot_gt"], readouts={
        name: {k: r[k] for k in ("max_abs_err", "kernel_ms", "device_ms", "plain_ms",
                                 "bound_ms", "library_ms", "library_device_ms")}
        for name, r in readouts.items()})
    rows = [
        ("ms_deform_gather_3d", "row", "K1.row", src + "ms_deform_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:284", k1),
        ("ms_deform_gather_3d", "scalar", "K1.scalar", src + "ms_deform_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:284", k1_scalar),
        ("ms_deform_gather_3d_bwd", "", "K1-bwd", src + "ms_deform_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:354", kern["K1-bwd"]["bf16"]),
        ("trilerp_sample", "row", "K2.row", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:476", kern["K2"]),
        ("trilerp_sample", "scalar", "K2.scalar", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:476", k2_narrow),
        ("trilerp_sample_bwd", "segmented", "K2-bwd.segmented", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:493", kern["K2-bwd"]),
        ("trilerp_sample_bwd", "narrow", "K2-bwd.narrow", src + "trilerp_sample3d.cu",
         "occformer_tpu/ops/trilerp.py:493", kern["K2-bwd"]["batched"]["candidates"]),
        ("sample_id_masks", "", "K3", src + "label_gather3d.cu",
         "occformer_tpu/ops/loss_gather.py:127", kern["K3"]["candidates"]),
        ("fused_multilevel_gather", "row", "K4.row", src + "multilevel_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:495", kern["K4"]),
        ("fused_multilevel_gather_bwd", "", "K4-bwd", src + "multilevel_gather3d.cu",
         "occformer_tpu/ops/trilerp_fused.py:511", kern["K4-bwd"]),
        ("add_one", "", "P1", src + "probe.cu", "tools/probe_pallas_viability.py:41",
         dict(timing["add_one"], kernel_ms=timing["add_one"]["ms"],
              max_abs_err=probe["add_one_max_abs_err"])),
        ("row_gather", "", "P2", src + "probe.cu", "tools/probe_pallas_viability.py:67",
         dict(timing["row_gather"], kernel_ms=timing["row_gather"]["ms"],
              max_abs_err=probe["row_gather_max_abs_err"])),
        # not a Pallas kernel's port: the JAX package leaves the splat to XLA
        ("voxel_scatter_lifted", "", "S1", src + "voxel_splat.cu",
         "occformer_tpu/ops/scatter.py:55", det["S1"]),
    ]
    return [{"name": name + (f".{path}" if path else ""), "path": path or None, "route": "cuda",
             "source": source, "replaces": replaces,
             "launches": sum(n[key] for n in paths.values()),
             **{f"launches_{p}": n[key] for p, n in paths.items()},
             "max_abs_err": r["max_abs_err"], "ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
             "library_ms": r.get("library_ms"),
             **{k: r[k] for k in ("device_ms", "library_device_ms", "readouts") if k in r}}
            for name, path, key, source, replaces, r in rows]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from occformer_tpu_torch.ops import cuda_build
    except ImportError as e:
        print(f"chip_smoke: the port package is missing: {e}", file=sys.stderr)
        return 2
    # float32 references: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    probe = phase_probe()  # before any other build: a broken toolchain fails here
    t0 = time.perf_counter()
    report = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"],
                          "ptxas": [ln for ln in v["log"].splitlines() if "ptxas" in ln]}
                      for k, v in report.items()}})
    serve_n = phase_serve()
    kern = phase_kernels()
    phase_tiny()
    phase_tiny_train("off")
    phase_tiny_train("on")
    phase_tiny_train("on", accum_steps=2)
    free_memory()
    det = phase_determinism()
    free_memory()
    train_n = phase_train("off")
    free_memory()
    train_batched_n = phase_train("on")
    free_memory()
    phase_cli()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    emit({"kernels": kernel_records(kern, probe, det, {
        "serve": serve_n, "train": train_n, "train_batched": train_batched_n,
        "k4_gate": kern["K4_gate"]["launches"], "probe": probe["launches"]})})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
