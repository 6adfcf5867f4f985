#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (occformer_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing one JSON line:
  1. build:   compile every CUDA kernel of the package from its sources.
  2. kernels: hold K1 (ms_deform_gather_3d) against its plain PyTorch version
              at the flagship's shapes in float32 and bfloat16, and time both.
  3. tiny:    the tiny test model on the card (kernel) against the same model
              on the CPU (plain version), float32.
  4. serve:   the flagship config (occformer_nusc_r50_256x704) at full width,
              random weights from a seeded torch.Generator, bfloat16, through
              build_eval_step on a synthetic 6-camera batch with 35000 LiDAR
              points: 1 warm-up frame, then 3 timed frames.  Every kernel's
              launch count is set to 0 just before and read just after.
              Then, outside that count, a torch.profiler summary of one more
              frame: its stages (the ``stage:*`` ranges that the eval step
              and the model's forward name), kernels and operators.
Then the card's name and power limit (nvidia-smi), one JSON line of kernel
records, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before that line.  Without a CUDA device, or without the package
beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # float32 outside the tensor cores


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
        sys.exit(1)


def time_cuda(fn, iters=30, warmup=5):
    """Median milliseconds of ``fn()`` over ``iters`` CUDA-event timed calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def flagship_gather_inputs(dtype, local, seed=0):
    """K1's inputs at the flagship's shapes: B=1, H=8, hd=24, P=4, levels
    (16,16,2), (32,32,4), (64,64,8), Nq = 37376.  ``local=False``: locations
    uniform over [-a, 1+a]^3 with a = 0.018, so that about 10% of samples have
    a coordinate outside [0, 1]; ``local=True``: each query's own grid center
    plus up to +-2 voxels, the spread of the model's radial offset init."""
    import numpy as np
    import torch

    from occformer_tpu_torch.models.pixel_decoder import reference_points

    shapes = [(16, 16, 2), (32, 32, 4), (64, 64, 8)]
    B, H, hd, L, P = 1, 8, 24, 3, 4
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
    return (torch.from_numpy(value).to(dev, dtype), shapes,
            torch.from_numpy(locs.astype(np.float32)).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev, dtype))


def phase_kernels():
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k1

    rec = {"phase": "kernels", "kernel": "ms_deform_gather_3d"}
    for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        value, shapes, locs, w = flagship_gather_inputs(dtype, local=False)
        got = k1.ms_deform_gather_3d(value, shapes, locs, w)
        torch.cuda.synchronize()
        # plain version in float32 on the same (for bf16: bf16-rounded) inputs
        ref = k1.ms_deform_gather_3d_plain(value.float(), shapes, locs, w.float())
        err = (got.float() - ref).abs().max().item()
        scale = ref.abs().max().item()
        limit = (1e-5 if dtype == torch.float32 else 1e-2) * scale
        check(torch.isfinite(got.float()).all().item(), f"K1 {name}: non-finite output")
        check(err <= limit, f"K1 {name}: max|diff| {err} > {limit}")
        outside = ((locs < 0) | (locs > 1)).any(-1).float().mean().item()
        rec[name] = {
            "max_abs_err": err, "max_abs_plain": scale, "limit": limit,
            "share_outside_01": outside,
            "kernel_ms": time_cuda(lambda: k1.ms_deform_gather_3d(value, shapes, locs, w)),
            "plain_ms": time_cuda(
                lambda: k1.ms_deform_gather_3d_plain(value, shapes, locs, w), iters=20),
        }
        lv, _, ll, lw = flagship_gather_inputs(dtype, local=True)
        rec[name]["kernel_ms_local_locs"] = time_cuda(
            lambda: k1.ms_deform_gather_3d(lv, shapes, ll, lw))
        # the bound: every input read once, the output written once
        nbytes = sum(t.numel() * t.element_size() for t in (value, locs, w))
        nbytes += got.numel() * got.element_size()
        B, Nq, H, L, P = w.shape
        flops = B * Nq * H * L * P * value.shape[-1] * 18  # 8 corner FMAs + weight FMA
        rec[name].update(bytes=nbytes, flops=flops,
                         bound_ms=max(nbytes / H100_BYTES_PER_S,
                                      flops / H100_F32_FLOP_PER_S) * 1e3)
        rec[name]["bound_by"] = ("bytes" if nbytes / H100_BYTES_PER_S
                                 >= flops / H100_F32_FLOP_PER_S else "operations")
        rec[name]["bound_us"] = rec[name]["bound_ms"] * 1e3
        rec[name]["roofline_share"] = rec[name]["bound_ms"] / rec[name]["kernel_ms"]
    emit(rec)
    return rec


def phase_tiny():
    import numpy as np
    import torch

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import tiny_cfg

    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.ops import trilerp_fused as k1

    cfg = tiny_cfg.model_cfg()
    cpu = build_model(cfg, device="cpu")
    gpu = build_model(cfg, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    batch = tiny_cfg.make_batch(np.random.RandomState(0))
    before = k1.LAUNCHES
    with torch.inference_mode():
        ref = cpu({k: torch.from_numpy(v) for k, v in batch.items()})
        got = gpu({k: torch.from_numpy(v).cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    rec = {"phase": "tiny", "k1_launches": k1.LAUNCHES - before}
    check(rec["k1_launches"] == 2, f"tiny: K1 launched {rec['k1_launches']} times, want 2")
    for k, r in ref.items():
        g = got[k].float().cpu()
        err = (g - r).abs().max().item()
        tol = 1e-3 * r.abs().max().item() + 1e-4
        rec[k] = {"max_abs_err": err, "tol": tol}
        check(err <= tol, f"tiny {k}: max|diff| {err} > {tol}")
    emit(rec)


def phase_serve():
    import torch

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_serving_batch
    from occformer_tpu_torch.engine.eval import build_eval_step
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.ops import trilerp_fused as k1

    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", "configs",
                                   "occformer_nusc_r50_256x704.py"))
    dtype = getattr(torch, cfg["compute_dtype"])
    t0 = time.perf_counter()
    model = build_model(cfg["model"], device="cuda", dtype=dtype, seed=0)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    num_classes = cfg["model"]["pts_bbox_head"]["num_occupancy_classes"]
    occ_size = tuple(cfg["occ_size"])
    batch = make_serving_batch(cfg, seed=0)
    step = build_eval_step(model, occ_size, num_classes)
    n_layers = cfg["model"]["img_bev_encoder_neck"]["encoder"]["num_layers"]

    torch.cuda.reset_peak_memory_stats()
    k1.LAUNCHES = 0  # the main path's run starts here
    frames_ms = []
    for _ in range(4):  # 1 warm-up + 3 timed
        t = time.perf_counter()
        out = step(batch)
        torch.cuda.synchronize()
        frames_ms.append((time.perf_counter() - t) * 1e3)
    launches = {"ms_deform_gather_3d": k1.LAUNCHES}  # ... and ends here
    peak = torch.cuda.max_memory_allocated()

    P = batch["lidar_xyz"].shape[1]
    rec = {"phase": "serve", "config": "occformer_nusc_r50_256x704",
           "dtype": cfg["compute_dtype"], "model_build_s": build_s,
           "params": sum(p.numel() for p in model.parameters()),
           "warmup_frame_ms": frames_ms[0], "frame_ms": frames_ms[1:],
           "frames_run": len(frames_ms), "launches": launches,
           "peak_memory_bytes": peak,
           "voxel_pred": list(out["voxel_pred"].shape),
           "point_pred": list(out["point_pred"].shape)}
    check(launches["ms_deform_gather_3d"] == n_layers * len(frames_ms),
          f"K1 launched {launches['ms_deform_gather_3d']} times in "
          f"{len(frames_ms)} frames, want {n_layers} per frame")
    check(rec["voxel_pred"] == [1, *occ_size], f"voxel_pred {rec['voxel_pred']}")
    check(rec["point_pred"] == [1, P], f"point_pred {rec['point_pred']}")
    cm = out["confusion"]
    check(list(cm.shape) == [num_classes] * 2 and int(cm.sum()) == P,
          f"confusion {list(cm.shape)} sums to {int(cm.sum())}, want {P}")
    check(int(out["voxel_pred"].max()) < num_classes
          and int(out["point_pred"].min()) >= 1, "predicted labels out of range")
    with torch.inference_mode():
        raw = model({k: torch.as_tensor(v).cuda() for k, v in batch.items()})
    finite = {k: bool(torch.isfinite(v.float()).all()) for k, v in raw.items()}
    rec["finite"] = finite
    rec["shapes"] = {k: list(v.shape) for k, v in raw.items()}
    check(all(finite.values()), f"non-finite outputs: {finite}")
    rec["profile"] = profile_frame(step, batch)
    emit(rec)
    return rec, launches


def profile_frame(step, batch, top=12):
    """torch.profiler over one serving frame: host and device time of each
    stage (the eval step's and the model's ``stage:*`` ranges), device time by
    kernel name and by operator and input shape, and the device's busy share
    of the frame's wall time (the profiler's own overhead included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t = time.perf_counter()
        step(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    events = prof.key_averages()
    stages = {e.key[len("stage:"):]: {"host_ms": e.cpu_time_total / 1e3,
                                      "device_ms": e.device_time_total / 1e3}
              for e in events
              if e.device_type.name == "CPU" and e.key.startswith("stage:")}
    check(len(stages) == 7, f"profiled stages: {sorted(stages)}, want 7")
    # device rows of the stage ranges span kernels; they are not kernels
    kernels = [e for e in events
               if e.device_type.name == "CUDA" and not e.key.startswith("stage:")]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    ops = [e for e in prof.key_averages(group_by_input_shape=True)
           if e.device_type.name == "CPU" and e.key.startswith("aten::")]
    ops.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "device_busy_share": device_ms / wall_ms,
            "stages": stages,
            "host_ms_outside_stages": wall_ms - sum(v["host_ms"] for v in stages.values()),
            "top_kernels": [{"name": e.key[:90], "calls": e.count,
                             "device_ms": e.self_device_time_total / 1e3}
                            for e in kernels[:top]],
            "top_ops": [{"name": e.key, "shapes": str(e.input_shapes)[:120],
                         "calls": e.count, "device_ms": e.self_device_time_total / 1e3}
                        for e in ops[:top]]}


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

    t0 = time.perf_counter()
    report = cuda_build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {k: {"seconds": v["seconds"],
                          "ptxas": [ln for ln in v["log"].splitlines() if "ptxas" in ln]}
                      for k, v in report.items()}})
    kern = phase_kernels()
    phase_tiny()
    serve, launches = phase_serve()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.stdout.strip()
          else f"nvidia-smi: {smi.stderr.strip()}", flush=True)
    bf = kern["bf16"]
    emit({"kernels": [{
        "name": "ms_deform_gather_3d", "route": "cuda",
        "source": "occformer_tpu_torch/csrc/ms_deform_gather3d.cu",
        "replaces": "occformer_tpu/ops/trilerp_fused.py:284",
        "launches": launches["ms_deform_gather_3d"],
        "max_abs_err": bf["max_abs_err"], "ms": bf["kernel_ms"],
        "plain_ms": bf["plain_ms"], "bound_ms": bf["bound_ms"],
        "bound_by": bf["bound_by"], "library_ms": bf["plain_ms"]}]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
