"""Backend viability probe: can the port build and run its kernels here?

    python3 -m occformer_tpu_torch.tools.probe_viability [--out report.json]

The port's counterpart of ``tools/probe_pallas_viability.py``.  It answers,
on the card:

  1. does a trivial kernel build (``nvcc`` -> ``sm_90a`` -> ctypes, from
     ``csrc/probe.cu`` alone) and run: P1, ``x + 1`` on [8, 128] float32;
  2. does a dynamic row gather give the right values: P2,
     ``out[s, :] = table[idx[s], :]`` with table [1024, 128] float32 and
     2048 int32 indices, the JAX probe's shape;
  3. how fast are P1, P2, ``x + 1`` and ``index_select`` at those shapes,
     by CUDA events around each call and by the profiler's device time of
     its kernel alone; and the library's
     gather (``torch.gather``) along the last axis of an [8, 32, 36864]
     bfloat16 volume at 147456 indices per row, the JAX probe's part 3.

Both checks are exact (a copy and one float32 add).  It prints one JSON
report and writes it only where ``--out`` says; it exits 1 if a check fails
and 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import probe as kp
from ..utils.timing import bound, device_ms, nbytes, time_cuda


def probe_inputs(device) -> Dict[str, torch.Tensor]:
    """P1's and P2's inputs, drawn as the JAX probe draws them."""
    rng = np.random.RandomState(0)
    table = rng.randn(1024, 128).astype(np.float32)
    idx = rng.randint(0, 1024, size=(2048,)).astype(np.int32)
    return {"x": torch.arange(8 * 128, dtype=torch.float32, device=device).reshape(8, 128),
            "table": torch.from_numpy(table).to(device),
            "idx": torch.from_numpy(idx).to(device)}


def probe_check(device) -> dict:
    """Builds ``csrc/probe.cu``, runs P1 and P2 once each and holds them
    exactly against their plain versions."""
    t0 = time.perf_counter()
    log = cuda_build.build(["probe"])["probe"]["log"]
    report = {"build_s": time.perf_counter() - t0,
              "ptxas": [ln for ln in log.splitlines() if "ptxas" in ln]}
    inp = probe_inputs(device)
    y = kp.add_one(inp["x"])
    g = kp.row_gather(inp["table"], inp["idx"])
    torch.cuda.synchronize()
    for name, got, ref in (("add_one", y, kp.add_one_plain(inp["x"])),
                           ("row_gather", g, kp.row_gather_plain(inp["table"], inp["idx"]))):
        err = (got - ref).abs().max().item()
        report[name] = "ok" if err == 0.0 else "WRONG VALUES"
        report[f"{name}_max_abs_err"] = err
    return report


def probe_time(device) -> dict:
    """Times P1, P2, their plain versions (which are also the library calls)
    and ``torch.gather`` at the JAX probe's part-3 shape; with each kernel's
    bound (the indices' distinct rows are what P2 must read)."""
    inp = probe_inputs(device)
    x, table, idx = inp["x"], inp["table"], inp["idx"]
    rows = int(torch.unique(idx).numel())
    out = {"add_one": {"ms": time_cuda(lambda: kp.add_one(x)),
                       "plain_ms": time_cuda(lambda: kp.add_one_plain(x)),
                       **bound(2 * nbytes(x), x.numel())},
           "row_gather": {"ms": time_cuda(lambda: kp.row_gather(table, idx)),
                          "plain_ms": time_cuda(lambda: kp.row_gather_plain(table, idx)),
                          "distinct_rows": rows,
                          # the named rows and the indices read, the output written
                          **bound((rows + idx.numel()) * table.shape[1] * 4 + nbytes(idx),
                                  0)}}
    # the plain versions are single PyTorch calls that compute the same
    # function: they are the library calls too.  At these sizes the events
    # also time the host work of a launch; the device times do not
    for r, kernel, plain in ((out["add_one"], lambda: kp.add_one(x), lambda: kp.add_one_plain(x)),
                             (out["row_gather"], lambda: kp.row_gather(table, idx),
                              lambda: kp.row_gather_plain(table, idx))):
        r["library_ms"] = r["plain_ms"]
        r["device_ms"] = device_ms(kernel)
        r["plain_device_ms"] = r["library_device_ms"] = device_ms(plain)
    rng = np.random.RandomState(0)
    BH, hd, Nv, S = 8, 32, 36864, 147456
    vol = torch.from_numpy(rng.randn(BH, hd, Nv).astype(np.float32)).to(device, torch.bfloat16)
    lin = torch.from_numpy(rng.randint(0, Nv, size=(BH, S))).to(device)
    index = lin[:, None, :].expand(BH, hd, S)
    out["torch_gather_last_axis"] = {
        "shape": [BH, hd, Nv], "indices_per_row": S,
        "ms": time_cuda(lambda: torch.gather(vol, 2, index)),
        **bound(nbytes(vol, lin) + BH * hd * S * 2, 0)}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--out", default=None, help="also write the JSON report here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("probe_viability: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    report = {"device_kind": torch.cuda.get_device_name(0)}
    try:
        report.update(probe_check(dev))
    except RuntimeError as e:  # a failed build or launch is the probe's answer
        report["error"] = f"{type(e).__name__}: {e}"
    ok = report.get("add_one") == "ok" and report.get("row_gather") == "ok"
    if ok:
        report["timing"] = probe_time(dev)
    text = json.dumps(report)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
