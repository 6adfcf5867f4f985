"""Inspect one sample of a config's data pipeline (reference
tools/debug_dataset.py; port of ``tools/debug_dataset.py``).

Prints the shape, dtype and statistics of every field of the sample and
optionally writes the augmented camera images with their sparse depth maps
and the GT's BEV class map as PNGs.

Usage:
  python3 -m occformer_tpu_torch.tools.debug_dataset <config> [--index 0]
      [--split train] [--dump-dir viz/] [--cfg-options a.b=value ...]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ..config import load_config, parse_cfg_options
from ..data.loader import build_dataset


def describe(sample: dict) -> list:
    """One line a field: shape, dtype and min/max/mean (floats) or the
    number of distinct values."""
    lines = []
    for k, v in sample.items():
        if isinstance(v, np.ndarray):
            stats = ""
            if np.issubdtype(v.dtype, np.floating) and v.size:
                stats = f" min={v.min():.3f} max={v.max():.3f} mean={v.mean():.3f}"
            elif v.size:
                stats = f" unique={len(np.unique(v))}"
            lines.append(f"  {k}: {v.shape} {v.dtype}{stats}")
        else:
            lines.append(f"  {k}: {type(v).__name__} = {str(v)[:80]}")
    return lines


def dump(sample: dict, out_dir: str) -> list:
    """cameras.png (images over their depth maps) and gt_occ.png; returns
    the paths written."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from .visualize import render

    os.makedirs(out_dir, exist_ok=True)
    written = []
    if "imgs" in sample:
        imgs = np.asarray(sample["imgs"])
        n = imgs.shape[0]
        fig, axes = plt.subplots(2, n, figsize=(4 * n, 7), squeeze=False)
        for i in range(n):
            img = imgs[i]
            axes[0][i].imshow((img - img.min()) / max(img.max() - img.min(), 1e-6))
            axes[0][i].axis("off")
            if "gt_depth" in sample:
                d = np.asarray(sample["gt_depth"])[i]
                axes[1][i].imshow(np.where(d > 0, d, np.nan), cmap="turbo")
            axes[1][i].axis("off")
        fig.tight_layout()
        path = os.path.join(out_dir, "cameras.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        written.append(path)
    if sample.get("gt_occ") is not None:
        occ = np.asarray(sample["gt_occ"])
        path = os.path.join(out_dir, "gt_occ.png")
        render(np.where(occ == 255, 0, occ), out_path=path)
        written.append(path)
    return written


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("--index", type=int, default=0)
    p.add_argument("--split", default="train")
    p.add_argument("--dump-dir", default=None)
    p.add_argument("--cfg-options", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = load_config(args.config, parse_cfg_options(args.cfg_options))
    dataset = build_dataset(cfg["data"][args.split])
    print(f"dataset: {type(dataset).__name__}, {len(dataset)} samples")
    sample = dataset[args.index]
    print("\n".join(describe(sample)))
    if args.dump_dir:
        for path in dump(sample, args.dump_dir):
            print("wrote", path)


if __name__ == "__main__":
    main()
