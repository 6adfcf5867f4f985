"""N-process data-parallel train steps against the one-process step.

    torchrun --nproc_per_node=N -m occformer_tpu_torch.tools.ddp_parity --out DIR
    python3 -m occformer_tpu_torch.tools.ddp_parity --reference N --out DIR

The first command runs ``--steps`` train steps of the config (the flagship
by default: float32 parameters under its bf16 autocast, random weights
from seed 0, the per-layer loss route) under ``DistributedDataParallel``,
each rank on ``cuda:LOCAL_RANK`` taking its row of every global batch of N
samples (``data/synthetic.py:make_train_batch`` with seeds 100 + N * k +
r); rank 0 writes each step's metrics and the final parameters to
``DIR/ddp.pt``.  The second runs the same steps in one process on the
global batches of N and compares: each step's metrics and every parameter,
printed as one JSON line of the largest differences beside their limits
(the first step's losses 1e-2 relative, as bf16 autocast reassociates;
every parameter within 2 * lr * steps plus 1e-6, Adam's sign-flip bound;
exit 1 beyond them).  ``--cpu`` runs both on the CPU (gloo).
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from ..config import load_config
from ..data.synthetic import make_train_batch
from ..engine.eval import to_device_batch
from ..engine.optim import build_optimizer_from_config
from ..engine.train import build_loss_cfg, build_train_step, wrap_ddp
from ..models.detector import build_model
from ..parallel.distributed import maybe_init_distributed, rank, world_size
from .train import pick_device, step_generator

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")


def global_batch(cfg, n: int, k: int):
    """Global batch ``k`` of ``n`` samples (row r from seed 100 + n * k + r)."""
    rows = [make_train_batch(cfg, seed=100 + n * k + r) for r in range(n)]
    return {key: np.concatenate([b[key] for b in rows]) for key in rows[0]}


def train(cfg, n: int, steps: int, device: torch.device, rows=None):
    """``steps`` steps on the global batches of ``n`` (or on their ``rows``,
    under DDP): each step's metrics and the final parameters on the CPU."""
    m = cfg["model"]
    model = build_model(m, device=device, dtype=torch.float32, seed=0).train()
    opt = build_optimizer_from_config(model, cfg, 28130)
    step = build_train_step(wrap_ddp(model) if rows is not None else model, opt,
                            build_loss_cfg(m["pts_bbox_head"], m["train_cfg"]["pts"]),
                            device=device,
                            compute_dtype=torch.bfloat16
                            if cfg.get("compute_dtype") == "bfloat16" else None)
    metrics = []
    for k in range(steps):
        batch = global_batch(cfg, n, k)
        if rows is not None:
            batch = {key: v[rows] for key, v in batch.items()}
        out = step(to_device_batch(batch, device), step_generator(0, k, device))
        metrics.append({key: float(v) for key, v in out.items()})
    return metrics, {k: p.detach().cpu() for k, p in model.named_parameters()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", default=CONFIG)
    p.add_argument("--steps", type=int, default=2)
    p.add_argument("--reference", type=int, default=0,
                   help="run the one-process steps on global batches of this many samples "
                        "and compare with --out/ddp.pt")
    p.add_argument("--out", required=True)
    p.add_argument("--cpu", action="store_true", help="run on the CPU (gloo)")
    args = p.parse_args(argv)
    device = pick_device(args.cpu)
    cfg = load_config(args.config)
    path = os.path.join(args.out, "ddp.pt")
    if not args.reference:
        maybe_init_distributed(args.cpu)
        n = world_size()
        try:
            metrics, params = train(cfg, n, args.steps, device, rows=slice(rank(), rank() + 1))
            if rank() == 0:
                os.makedirs(args.out, exist_ok=True)
                torch.save({"world_size": n, "metrics": metrics, "params": params}, path)
                print(json.dumps({"world_size": n, "metrics": metrics}), flush=True)
        finally:
            if torch.distributed.is_initialized():
                torch.distributed.destroy_process_group()
        return 0
    got = torch.load(path, weights_only=False)
    if got["world_size"] != args.reference:
        raise ValueError(f"{path} holds {got['world_size']} ranks, not {args.reference}")
    metrics, params = train(cfg, args.reference, args.steps, device)
    lr = cfg.get("optimizer", {}).get("lr", 1e-4)
    param_limit = 2 * lr * args.steps + 1e-6
    rel = [{k: abs(g[k] - r[k]) / max(abs(r[k]), 1e-12) for k in r if k != "point_mean_iou"}
           for g, r in zip(got["metrics"], metrics)]
    param_diff = max((got["params"][k] - v).abs().max().item() for k, v in params.items())
    rec = {"world_size": args.reference, "steps": args.steps,
           "loss_rel_diff_by_step": [max(v for k, v in r.items() if "loss" in k) for r in rel],
           "grad_norm_rel_diff_by_step": [r["grad_norm"] for r in rel],
           "step1_loss_limit": 1e-2, "max_param_diff": param_diff,
           "param_limit": param_limit, "total_loss": [m["total_loss"] for m in metrics],
           "ddp_total_loss": [m["total_loss"] for m in got["metrics"]],
           "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}
    print(json.dumps(rec), flush=True)
    ok = rec["loss_rel_diff_by_step"][0] <= 1e-2 and param_diff <= param_limit
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
