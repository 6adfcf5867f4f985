"""Plot the train CLI's JSON-line logs (reference
tools/analysis_tools/analyze_logs.py; port of ``tools/analyze_logs.py``).

The train CLI prints one JSON object per log interval (``step``, the
losses, ``sec/iter``); this renders the chosen keys against the step and
prints each key's first, last and least value.

Usage:
  python3 -m occformer_tpu_torch.tools.train <config> ... | tee train.log
  python3 -m occformer_tpu_torch.tools.analyze_logs train.log
      [--keys total_loss loss_depth] [--out curves.png]
"""
from __future__ import annotations

import argparse
import json
import sys


def load_records(path: str) -> list:
    """The JSON objects with a ``step`` among the log's lines."""
    records = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if "step" in rec:
                records.append(rec)
    return records


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log")
    p.add_argument("--keys", nargs="*", default=["total_loss"])
    p.add_argument("--out", default="curves.png")
    args = p.parse_args(argv)
    records = load_records(args.log)
    if not records:
        print("no json records found")
        sys.exit(1)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 5))
    steps = [r["step"] for r in records]
    for key in args.keys:
        ys = [r.get(key) for r in records]
        if any(y is not None for y in ys):
            ax.plot(steps, ys, label=key)
    ax.set_xlabel("step")
    ax.legend()
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(args.out, dpi=110)
    plt.close(fig)
    print("wrote", args.out)
    for key in args.keys:
        ys = [r[key] for r in records if key in r]
        if ys:
            print(f"{key}: first={ys[0]:.4f} last={ys[-1]:.4f} min={min(ys):.4f}")


if __name__ == "__main__":
    main()
