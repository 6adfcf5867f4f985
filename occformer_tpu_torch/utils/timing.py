"""Kernel timing on the card and the least time the card could take.

``time_cuda`` times a callable with CUDA events (median over calls, after a
warm-up); ``device_ms`` takes the device time of its kernels alone from
``torch.profiler``; ``bound`` is the larger of the bytes a function must
move over the memory rate and its float32 operations over the float32 peak,
the rates of one H100 SXM from NVIDIA's data sheet (at its full 700 W power
limit).
"""
from __future__ import annotations

import statistics

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # float32 outside the tensor cores


def time_cuda(fn, iters: int = 30, warmup: int = 5) -> float:
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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn()``: the self device time of the
    kernels, copies and fills it launches (``torch.profiler``, CUPTI),
    summed over ``iters`` calls.  Unlike CUDA events around the call, it
    leaves out the host work between launches, which dominates calls of a
    few microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranges = {e.key for e in events if e.device_type.name == "CPU" and e.is_user_annotation}
    total = sum(e.self_device_time_total for e in events if e.device_type.name == "CUDA"
                and not (e.is_user_annotation or e.key in ranges))
    return total / 1e3 / iters


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or float32
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOP_PER_S
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
