"""Profiling utilities: per-stage timers, ``torch.profiler`` traces and the
card's memory counters.

Port of ``occformer_tpu/utils/profiling.py`` (the reference's
``record_time`` + ``cuda.synchronize`` timers, detectors/occupancyformer.py:
19-57, and its commented-out profiler hook, apis/mmdet_train.py:146-149).

* ``StageTimer``: on the card each ``stage`` records a CUDA event pair on
  the current stream and does not synchronize; ``report()`` (and reading
  ``times``) synchronizes once and reads every pair's ``elapsed_time``.  On
  the CPU (``device="cpu"``) a stage is ``perf_counter`` around the block.
  ``report()`` prints JAX's format, ``"name: X ms (Y%)"`` joined by ``", "``.
* ``trace(log_dir)``: a ``torch.profiler`` trace of the block (CPU and, on
  the card, CUDA activity), written as a Chrome trace into ``log_dir``; on
  the card it opens with ``utils/timing.py:lead_in``, whose spin kernels
  keep kineto from dropping the block's first device records.
* ``device_memory_stats()``: per card, ``bytes_in_use_gib`` and
  ``peak_bytes_gib`` of PyTorch's caching allocator (JAX's keys); ``{}``
  without a card.
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from collections import defaultdict
from typing import Dict, List, Union

import torch


class StageTimer:
    """Accumulating stage timer.

    Usage::

        timer = StageTimer()              # the card; StageTimer("cpu")
        with timer.stage("img_encoder"):
            feats = model.image_encoder(imgs)
        print(timer.report())

    On the card a stage's time is the device time between its two events on
    the current stream, so a stage must launch its work on that stream; the
    host does not wait inside a stage.
    """

    def __init__(self, device: Union[str, torch.device] = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to time "
                               "stages on the host clock")
        self._times: Dict[str, List[float]] = defaultdict(list)
        self._pending = []  # (name, start event, end event) not read yet

    @contextlib.contextmanager
    def stage(self, name: str):
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield
            end.record()
            self._pending.append((name, start, end))
        else:
            t0 = time.perf_counter()
            yield
            self._times[name].append(time.perf_counter() - t0)

    @property
    def times(self) -> Dict[str, List[float]]:
        """Seconds of every call of each stage, in call order."""
        if self._pending:
            torch.cuda.synchronize(self.device)
            for name, start, end in self._pending:
                self._times[name].append(start.elapsed_time(end) / 1e3)
            self._pending = []
        return self._times

    def report(self) -> str:
        times = self.times
        rows = []
        total = sum(sum(v) / max(len(v), 1) for v in times.values())
        for k, v in times.items():
            avg = sum(v) / max(len(v), 1)
            frac = avg / total if total > 0 else 0.0
            rows.append(f"{k}: {avg * 1000:.2f} ms ({frac:.1%})")
        return ", ".join(rows)

    def reset(self):
        self._times.clear()
        self._pending = []


@contextlib.contextmanager
def trace(log_dir: str = os.path.join(tempfile.gettempdir(), "occformer_trace"),
          device: Union[str, torch.device] = "cuda"):
    """A ``torch.profiler`` trace of the block, written to
    ``log_dir/trace.json`` (Chrome's format; Perfetto reads it)."""
    from torch.profiler import ProfilerActivity, profile

    from .timing import lead_in

    on_card = torch.device(device).type == "cuda"
    if on_card and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to trace the "
                           "host alone")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    with profile(activities=activities) as prof:
        if on_card:
            lead_in()
        yield log_dir
        if on_card:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> Dict[str, Dict[str, float]]:
    """Per card, the caching allocator's bytes in use and their peak, GiB."""
    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        s = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use_gib": s.get("allocated_bytes.all.current", 0) / 2**30,
            "peak_bytes_gib": s.get("allocated_bytes.all.peak", 0) / 2**30,
        }
    return out
