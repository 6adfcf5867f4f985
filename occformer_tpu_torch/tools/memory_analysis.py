"""Device memory of a config's training step, by component and by stage.

    python3 -m occformer_tpu_torch.tools.memory_analysis [CONFIG]
        [--num-points N] [--match-num-points M] [--max-lidar P]
        [--batch-size B] [--accum-steps A] [--mxu-readout on|off]
        [--cfg-options a.b=value ...] [--cpu]

The port of ``tools/memory_analysis.py``.  JAX's tool reads XLA's
ahead-of-time ``memory_analysis()`` of the compiled step; PyTorch compiles
no program to ask, so on the card this tool runs the step: the config's
model (float32 parameters, random weights from seed 0), its optimizer
(``build_optimizer_from_config``) and ``engine/train.py:build_train_step``
under the config's autocast, on ``data/synthetic.py:make_train_batch`` (the
batch ``chip_smoke.py``'s ``train`` phase drives; ``--batch-size B``
concatenates seeds 0..B-1).  A first step allocates the gradients and the
AdamW state; the second is measured.  Prints one JSON line:

* the counted parts, in GiB: ``param_gib`` (parameters), ``buffer_gib``
  (BatchNorm statistics and other buffers), ``grad_gib`` (one gradient a
  parameter: the optimizer gives every parameter one), ``opt_state_gib``
  (AdamW's two moments a parameter; its per-parameter step counters,
  host scalars, are left out), ``batch_gib``;
* ``argument_gib``: what is resident before the step, batch included (on
  the card ``torch.cuda.memory_allocated``, the gradients of the step
  before freed; with ``--cpu`` the sum of parameters, buffers, optimizer
  state and batch);
* ``stage_peak_gib``: the peak of each stage (``forward``, ``loss``,
  ``backward``, ``optimizer``; ``torch.cuda.reset_peak_memory_stats`` at the
  stage's start, ``max_memory_allocated`` at its end), ``total_gib`` (the
  step's peak, the largest of them) and ``temp_gib`` (the peak less the
  argument); ``null`` with ``--cpu``, which runs no step.

JAX's TPU-only knobs (``--gt-chunks``, ``--point-chunks``,
``--feature-readout``, ``--mxu-readout interpret``, ``--no-donate``) and its
XLA-only keys (``alias_gib``, ``code_gib``, ``compile_s``, ``output_gib``)
have no counterpart here.  Without a card and without ``--cpu`` it raises.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "configs", "occformer_nusc_r50_256x704.py")
STAGES = ("forward", "loss", "backward", "optimizer")
GIB = 2.0 ** 30


def _bytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def train_batch(cfg, batch_size: int = 1) -> dict:
    """``make_train_batch`` of seeds 0..B-1, concatenated on the batch axis."""
    from ..data.synthetic import make_train_batch

    parts = [make_train_batch(cfg, seed=i) for i in range(batch_size)]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}


def analyze(cfg_path: str = DEFAULT_CONFIG, num_points: Optional[int] = None,
            match_num_points: Optional[int] = None, max_lidar: Optional[int] = None,
            batch_size: int = 1, accum_steps: int = 1, mxu_readout: Optional[str] = None,
            overrides: Optional[dict] = None, device: str = "cuda") -> dict:
    """The report (module docstring) of the config at ``cfg_path``."""
    from ..config import load_config
    from ..engine.eval import to_device_batch
    from ..engine.optim import build_optimizer_from_config
    from ..engine.train import build_loss_cfg, build_train_step
    from ..models.detector import build_model

    cfg = load_config(cfg_path, overrides)
    if max_lidar is not None:
        cfg["max_lidar_points"] = int(max_lidar)
    m = cfg["model"]
    head = dict(m["pts_bbox_head"])
    if mxu_readout is not None:
        head["mxu_readout"] = mxu_readout
    pts = dict(m.get("train_cfg", {}).get("pts", {}))
    if num_points is not None:
        pts["num_points"] = int(num_points)
    if match_num_points is not None:
        pts["match_num_points"] = int(match_num_points)
    loss_cfg = build_loss_cfg(head, pts)
    compute_dtype = getattr(torch, cfg["compute_dtype"]) if cfg.get("compute_dtype") else None

    model = build_model(m, device=device, dtype=torch.float32, seed=0).train()
    opt = build_optimizer_from_config(model, cfg, 28130)  # nuScenes' train samples
    batch = train_batch(cfg, batch_size)
    params = list(model.parameters())
    adam_params = [p for g in opt.adamw.param_groups for p in g["params"]]
    counted = {"param_gib": _bytes(params) / GIB,
               "buffer_gib": _bytes(model.buffers()) / GIB,
               "grad_gib": _bytes(params) / GIB,
               "opt_state_gib": 2 * _bytes(adam_params) / GIB,
               "batch_gib": sum(v.nbytes for v in batch.values()) / GIB}
    report = {"config": os.path.basename(cfg_path), "device": device,
              "num_points": loss_cfg.num_points, "batch_size": batch_size,
              "accum_steps": accum_steps, "mxu_readout": loss_cfg.batched_readout,
              "params": sum(p.numel() for p in params), **counted}
    if device == "cpu":
        report.update(argument_gib=counted["param_gib"] + counted["buffer_gib"]
                      + counted["opt_state_gib"] + counted["batch_gib"],
                      stage_peak_gib=None, temp_gib=None, total_gib=None)
        return report

    peaks = {}

    @contextlib.contextmanager
    def peak_of(name):
        torch.cuda.reset_peak_memory_stats()
        yield
        peaks[name] = max(peaks.get(name, 0), torch.cuda.max_memory_allocated())

    step = build_train_step(model, opt, loss_cfg, device=device, compute_dtype=compute_dtype,
                            accum_steps=accum_steps, stage_hook=peak_of)
    batch = to_device_batch(batch, torch.device(device))
    g = torch.Generator(device=device).manual_seed(0)
    step(batch, g)  # allocates the gradients and the AdamW state
    measured_opt = _bytes(t for s in opt.adamw.state.values() for t in s.values()
                          if torch.is_tensor(t) and t.device.type == "cuda")
    opt.zero_grad()
    torch.cuda.synchronize()
    peaks.clear()
    argument = torch.cuda.memory_allocated()
    metrics = step(batch, g)
    torch.cuda.synchronize()
    total = max(peaks.values())
    report.update(argument_gib=argument / GIB,
                  stage_peak_gib={k: peaks[k] / GIB for k in STAGES},
                  temp_gib=(total - argument) / GIB, total_gib=total / GIB,
                  measured_grad_gib=_bytes(p.grad for p in params if p.grad is not None) / GIB,
                  measured_opt_state_gib=measured_opt / GIB,
                  total_loss=float(metrics["total_loss"]))
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    p.add_argument("--num-points", type=int, default=None)
    p.add_argument("--match-num-points", type=int, default=None)
    p.add_argument("--max-lidar", type=int, default=None,
                   help="LiDAR points a sample (the config's max_lidar_points by default)")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--accum-steps", type=int, default=1)
    p.add_argument("--mxu-readout", default=None, choices=("on", "off"),
                   help="the loss route: batched (on) or per-layer (off)")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="dot-path config overrides, e.g. model.img_backbone.with_cp=True")
    p.add_argument("--cpu", action="store_true",
                   help="count the parts on the CPU and run no step")
    args = p.parse_args(argv)
    from ..config import parse_cfg_options

    print(json.dumps(analyze(
        args.config, num_points=args.num_points, match_num_points=args.match_num_points,
        max_lidar=args.max_lidar, batch_size=args.batch_size, accum_steps=args.accum_steps,
        mxu_readout=args.mxu_readout, overrides=parse_cfg_options(args.cfg_options),
        device="cpu" if args.cpu else "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
