"""Bake the BatchNorm statistics into the conv kernels of a checkpoint
(reference tools/misc/fuse_conv_bn.py; port of ``tools/fuse_conv_bn.py``).

Reads a ``step_N`` checkpoint of the train CLI (or a ``.pt`` state dict),
builds the config's model on the ``meta`` device for its structure, applies
``engine/fuse.py:fuse_conv_bn`` and writes the fused checkpoint as a
``step_N`` directory (its step kept, no optimizer state), which loads
strictly into the same model.  Inference only: a train step on a fused
checkpoint would learn through a degenerate BatchNorm.

Usage:
  python3 -m occformer_tpu_torch.tools.fuse_conv_bn <config> <src> <dst_step_dir>
      [--cfg-options a.b=value ...]
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from ..config import load_config, parse_cfg_options
from ..engine.checkpoint import STATE_FILE, read_checkpoint
from ..engine.fuse import fuse_conv_bn
from ..models.detector import build_model


def fuse_checkpoint(cfg: dict, src: str, dst: str) -> dict:
    """Fuse ``src`` (a ``step_N`` directory or a state-dict file) into the
    ``step_N`` directory ``dst``; returns the report that the CLI prints."""
    if os.path.isdir(src):
        state = read_checkpoint(src)
        sd, step = state["model"], int(state["step"])
    else:
        sd, step = torch.load(src, map_location="cpu", weights_only=True), 0
    model = build_model(cfg["model"], device="meta")
    fused, pairs, unpaired = fuse_conv_bn(model, sd)
    os.makedirs(dst, exist_ok=True)
    torch.save({"step": step, "model": fused, "optimizer": None},
               os.path.join(dst, STATE_FILE))
    return {"fused_pairs": len(pairs), "dst": dst, "unpaired_convs": unpaired,
            "pairs": pairs[:10] + (["..."] if len(pairs) > 10 else [])}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config")
    p.add_argument("src", help="a step_N checkpoint directory or a .pt state dict")
    p.add_argument("dst", help="the fused checkpoint's step_N directory")
    p.add_argument("--cfg-options", nargs="*", default=[])
    args = p.parse_args(argv)
    cfg = load_config(args.config, parse_cfg_options(args.cfg_options))
    print(json.dumps(fuse_checkpoint(cfg, args.src, args.dst)))


if __name__ == "__main__":
    main()
