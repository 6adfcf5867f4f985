"""Model analysis: parameters, the analytic FLOP count and MFU for a config.

    python3 -m occformer_tpu_torch.tools.model_analysis [CONFIG] [--train]
        [--fps F] [--step-sec S] [--peak-tflops P] [--device cuda|cpu]

The port of ``tools/model_analysis.py``: it builds the config's model
through the port's config loader and registry (random weights; the count
does not depend on them) and prints one JSON report:

* ``total_params_M`` and ``params_M/<component>`` (the model's top-level
  modules: ``img_backbone``, ``img_neck``, ...);
* ``analytic_fwd_TFLOP_per_frame`` and its ``/conv``, ``/dot`` and
  ``/scatter`` parts: ``utils/flops.py:count_flops`` of the deployment
  forward (the model, then the final layer's voxel scores through
  ``format_results``, the program ``build_eval_step`` serves) on
  ``data/synthetic.py:make_serving_batch``;
* with ``--train`` (or ``--step-sec``) ``analytic_train_TFLOP_per_step``
  and ``train_fwd_ratio``: the count of one ``engine/train.py:
  build_train_step`` step (forward, losses with matching, backward, the
  optimizer; the config's optimizer, loss and autocast) on
  ``make_train_batch``;
* ``inference_mfu`` with ``--fps`` (a measured frame rate) and
  ``train_mfu`` with ``--step-sec`` (a measured step time), against
  ``--peak-tflops`` (the H100 SXM's dense bf16 data-sheet peak,
  ``utils/flops.py:H100_PEAK_BF16``, by default).

The JAX tool's ``--xla-flops`` (XLA's ``cost_analysis`` beside the count)
has no counterpart: PyTorch runs eagerly and compiles no program to ask.
Unlike the JAX tool, which traces, this one runs the model once: on the
card by default (the kernels report the counted operators their plain
versions run, so the count is the CPU's), on the CPU with ``--device
cpu``.  A CUDA device that is absent raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Dict, Optional

import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "configs", "occformer_nusc_r50_256x704.py")


def param_report(model: torch.nn.Module) -> Dict[str, float]:
    """Parameters in millions, in all and by top-level component."""
    report = {"total_params_M": round(sum(p.numel() for p in model.parameters()) / 1e6, 3)}
    for name, child in model.named_children():
        report[f"params_M/{name}"] = round(sum(p.numel() for p in child.parameters()) / 1e6, 3)
    return report


def deployment_forward(model, batch, compute_dtype: Optional[torch.dtype] = None):
    """The served program's model work: the model on ``batch`` (tensors on
    the model's device) under ``compute_dtype``'s autocast, then the final
    layer's per-class voxel scores (``format_results``); without gradients
    (``no_grad``: ``inference_mode`` hides the operators from a dispatch
    mode entered before it)."""
    from ..models.mask2former_head import format_results, mask_logits_from_embeds

    dev = next(model.parameters()).device
    autocast = (torch.autocast(dev.type, dtype=compute_dtype) if compute_dtype is not None
                else torch.autocast(dev.type, enabled=False))
    with torch.no_grad(), autocast:
        out = model(batch)
        return format_results(out["cls_preds"][-1],
                              mask_logits_from_embeds(out["mask_embeds"][-1],
                                                      out["mask_feature"]))


def forward_flops(model, batch, compute_dtype: Optional[torch.dtype] = None) -> dict:
    """``count_flops`` of ``deployment_forward`` on a batch of numpy arrays
    or tensors."""
    from ..engine.eval import to_device_batch
    from ..utils.flops import count_flops

    dev = next(model.parameters()).device
    batch = to_device_batch({k: v for k, v in batch.items() if not k.startswith("lidar")}, dev)
    return count_flops(deployment_forward, model, batch, compute_dtype)


def analyze(cfg_path: str = DEFAULT_CONFIG, train: bool = False, fps: Optional[float] = None,
            step_sec: Optional[float] = None, peak: Optional[float] = None,
            device: str = "cuda") -> dict:
    """The report (module docstring) of the config at ``cfg_path``."""
    from ..config import load_config
    from ..data.synthetic import make_serving_batch, make_train_batch
    from ..engine.optim import build_optimizer_from_config
    from ..engine.train import build_loss_cfg, build_train_step
    from ..models.detector import build_model
    from ..utils.flops import H100_PEAK_BF16, count_flops

    cfg = load_config(cfg_path)
    m = cfg["model"]
    compute_dtype = getattr(torch, cfg["compute_dtype"]) if cfg.get("compute_dtype") else None
    if device == "cpu":
        compute_dtype = None  # the count does not depend on the dtype
    model = build_model(m, device=device, dtype=torch.float32, seed=0)
    report = {"config": os.path.basename(cfg_path), "device": device, **param_report(model)}

    batch = make_serving_batch(cfg, seed=0)
    B = batch["imgs"].shape[0]
    f = forward_flops(model, batch, compute_dtype)
    report["analytic_fwd_TFLOP_per_frame"] = round(f["total"] / B / 1e12, 4)
    for k in ("conv", "dot", "scatter"):
        report[f"analytic_fwd_TFLOP_per_frame/{k}"] = round(f[k] / B / 1e12, 4)

    if train or step_sec:
        model.train()
        step = build_train_step(
            model, build_optimizer_from_config(model, cfg, 28130),
            build_loss_cfg(m["pts_bbox_head"], m.get("train_cfg", {}).get("pts")),
            device=device, compute_dtype=compute_dtype)
        t = count_flops(step, make_train_batch(cfg, seed=0),
                        torch.Generator(device=device).manual_seed(0))
        report["analytic_train_TFLOP_per_step"] = round(t["total"] / 1e12, 4)
        report["train_fwd_ratio"] = round(t["total"] / f["total"], 2)

    peak = peak or H100_PEAK_BF16
    report["peak_TFLOPs_assumed"] = peak / 1e12
    if fps:
        report["inference_mfu"] = round(f["total"] / B * fps / peak, 4)
    if step_sec:
        report["train_mfu"] = round(report["analytic_train_TFLOP_per_step"] * 1e12
                                    / step_sec / peak, 4)
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    p.add_argument("--train", action="store_true", help="also count the full train step")
    p.add_argument("--fps", type=float, default=None,
                   help="measured inference frames/s -> inference MFU")
    p.add_argument("--step-sec", type=float, default=None,
                   help="measured train s/step -> training MFU")
    p.add_argument("--peak-tflops", type=float, default=None,
                   help="the card's peak in TFLOP/s (default: H100 SXM dense bf16, 989.4)")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                   help="where the model runs for the count (the card by default)")
    args = p.parse_args(argv)
    peak = args.peak_tflops * 1e12 if args.peak_tflops else None
    print(json.dumps(analyze(args.config, train=args.train, fps=args.fps,
                             step_sec=args.step_sec, peak=peak, device=args.device), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
