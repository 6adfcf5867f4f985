"""Kernel timing on the card and the least time the card could take.

``time_cuda`` times a callable with CUDA events (median over calls, after a
warm-up); ``device_ms`` takes the device time of its kernels alone from
``torch.profiler`` (``device_trace`` also returns the trace's kernel rows); ``bound`` is the larger of the bytes a function must
move over the memory rate and its float32 operations over the float32 peak,
the rates of one H100 SXM from NVIDIA's data sheet (at its full 700 W power
limit).
"""
from __future__ import annotations

import statistics

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOP_PER_S = 67e12     # float32 outside the tensor cores
H100_BF16_FLOP_PER_S = 989.4e12  # dense bf16 on the tensor cores, H100 SXM data sheet


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


# The profiler can lose a trace's first device records: on an H100 machine
# late in a long process it dropped the first 3-5 kernel records of most
# traces as outside its capture window (kineto's "Out-of-range" count), the
# first 30 ms of them in a trace of 7.7 ms kernels, and on others about 35
# ms three minutes into a run (one kernel past eight spin kernels of 4 ms).
# Every trace therefore opens with LEAD_IN spin kernels of LEAD_IN_CYCLES
# clock cycles (about 4 ms each at 1.98 GHz, 64 ms in all) and a
# synchronize, and its sums leave them out.
LEAD_IN = 16
LEAD_IN_CYCLES = 8_000_000
LEAD_IN_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel


def lead_in() -> None:
    """The spin kernels that open a trace (see ``LEAD_IN``)."""
    import torch

    for _ in range(LEAD_IN):
        torch.cuda._sleep(LEAD_IN_CYCLES)
    torch.cuda.synchronize()


def device_kernels(events) -> list:
    """The kernel, copy and fill rows of ``prof.key_averages()``: device
    rows that are neither annotated ranges (they span kernels) nor the
    lead-in's spin kernels."""
    ranges = {e.key for e in events if e.device_type.name == "CPU" and e.is_user_annotation}
    return [e for e in events if e.device_type.name == "CUDA"
            and not (e.is_user_annotation or e.key in ranges or LEAD_IN_KERNEL in e.key)]


def device_trace(fn, iters: int = 20, warmup: int = 3) -> tuple:
    """(device milliseconds per call of ``fn()``, the trace's kernel rows):
    the self device time of the kernels, copies and fills it launches
    (``torch.profiler``, CUPTI), summed over ``iters`` calls after the
    lead-in.  Unlike CUDA events around the call, it leaves out the host
    work between launches, which dominates calls of a few microseconds."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        lead_in()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = device_kernels(prof.key_averages())
    return sum(e.self_device_time_total for e in kernels) / 1e3 / iters, kernels


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn()`` (``device_trace``)."""
    return device_trace(fn, iters, warmup)[0]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or float32
    operations over the float32 peak, whichever is larger."""
    t_bytes, t_ops = n_bytes / H100_BYTES_PER_S, flops / H100_F32_FLOP_PER_S
    return {"bytes": n_bytes, "flops": flops, "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
