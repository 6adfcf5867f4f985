"""Held-out geometric accuracy on box scenes: the flagship trained on the card.

    python3 -m occformer_tpu_torch.tools.synthetic_geo_benchmark [--steps 1500]
        [--train-scenes 10] [--test-scenes 3] [--eval-every N] [--seed 0]
        [--mxu-readout auto|on] [--out result.json]

The port of ``tools/synthetic_geo_benchmark.py``: box scenes rendered
through a nuScenes-like 6-camera rig at 256x704 into both the images and
the 256x256x32 grid (``data/geo_scenes.py``), the flagship config
(``configs/occformer_nusc_r50_256x704.py``, float32 parameters under the
config's bf16 autocast, random weights from ``--seed``) trained on the
training scenes in turn (AdamW at a constant 2e-4, gradient clip 5, one
scene a step), then the held-out scenes predicted in eval mode: held-out
SC IoU and class mIoU (over the classes present) beside chance (the
occupied share of the held-out grids).  Images and GT share the camera
geometry exactly, so held-out accuracy above chance needs the whole camera
-> LSS -> voxel -> head chain to be spatially consistent: the closest
accuracy evidence available without the real datasets.

It prints one JSON line every ``--eval-every`` steps and one final JSON line
(also written to ``--out``): the steps, s/step p50 and p95 (host clock
around each step, which ends when its loss reaches the host), the peak
device memory, the loss trajectory's first and last values, the held-out
metrics and the card's name.  ``--mxu-readout on`` trains on the batched
loss route.  It runs on the card (no card raises); ``train_geo`` also
serves the tiny rig (``tests/test_torch_geometric_learnability.py`` and
``chip_smoke.py``'s ``learn`` phase).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..config import load_config
from ..data.geo_scenes import NuscRig, TinyRig, heldout_iou, nusc_scene_batch, tiny_scene_batch
from ..engine.eval import to_device_batch
from ..engine.optim import build_optimizer
from ..engine.train import build_loss_cfg, build_train_step
from ..models.detector import build_model
from ..models.mask2former_head import format_results, mask_logits_from_embeds
from .train import step_generator

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")
RIGS = {"tiny": (TinyRig, tiny_scene_batch), "nusc": (NuscRig, nusc_scene_batch)}


def render(rig: str, train_scenes: int, test_scenes: int, seed: int = 0):
    """(train batches, held-out batches) of ``rig``'s scenes, drawn in that
    order from ``np.random.default_rng(seed)``."""
    make = RIGS[rig][1]
    rng = np.random.default_rng(seed)
    train = [make(rng) for _ in range(train_scenes)]
    return train, [make(rng) for _ in range(test_scenes)]


@torch.no_grad()
def predict_grid(model, batch: Dict[str, torch.Tensor], occ, compute_dtype=None) -> np.ndarray:
    """The eval-mode forward's per-voxel argmax class [X, Y, Z] of the first
    sample, repeated up to the GT grid ``occ``."""
    was_training = model.training
    model.eval()
    dev = batch["imgs"].device
    with torch.autocast(dev.type, dtype=compute_dtype, enabled=compute_dtype is not None):
        out = model(batch)
    scores = format_results(out["cls_preds"][-1],
                            mask_logits_from_embeds(out["mask_embeds"][-1], out["mask_feature"]))
    model.train(was_training)
    pred = scores.argmax(-1)[0].cpu().numpy()
    for axis, (g, p) in enumerate(zip(occ, pred.shape)):
        pred = pred.repeat(g // p, axis)
    return pred


def heldout(model, test, rig, compute_dtype=None) -> Dict[str, float]:
    """``data/geo_scenes.py:heldout_iou`` of the model's predictions on the
    held-out batches (on the model's device), under the record's names."""
    r = RIGS[rig][0]
    preds = [predict_grid(model, b, r.OCC, compute_dtype) for b in test]
    got = heldout_iou(preds, [b["gt_occ"][0].cpu().numpy() for b in test], r.NCLS)
    return {"heldout_SC_IoU": got["sc_iou"], "heldout_mIoU": got["miou"],
            "heldout_mIoU_all_classes": got["miou_all_classes"],
            "chance_SC_IoU": got["chance_sc_iou"]}


def train_geo(model_cfg: Dict, loss_cfg, rig: str, steps: int, train_scenes: int,
              test_scenes: int, device, lr: float, seed: int = 0,
              compute_dtype: Optional[torch.dtype] = None, eval_every: int = 0,
              log: Callable[[Dict], None] = lambda rec: None) -> Dict:
    """Train a model of ``model_cfg`` (random weights from ``seed``) on
    ``rig``'s training scenes in turn for ``steps`` steps (AdamW at ``lr``,
    clip 5, step k's draws from ``tools/train.py:step_generator(seed, k)``)
    and evaluate it on the held-out scenes; ``log`` gets the record of each
    intermediate evaluation.  Returns the run's record."""
    dev = torch.device(device)
    train, test = render(rig, train_scenes, test_scenes, seed)
    train = [to_device_batch(b, dev) for b in train]  # staged once
    test = [to_device_batch(b, dev) for b in test]
    model = build_model(model_cfg, device=dev, dtype=torch.float32, seed=seed).train()
    opt = build_optimizer(model, lr=lr, grad_clip=5.0)
    step = build_train_step(model, opt, loss_cfg, device=dev, compute_dtype=compute_dtype)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    losses: List[float] = []
    secs: List[float] = []
    evals: List[Dict] = []
    for it in range(steps):
        t = time.perf_counter()
        metrics = step(train[it % len(train)], step_generator(seed, it, dev))
        losses.append(float(metrics["total_loss"]))  # waits for the step
        secs.append(time.perf_counter() - t)
        if not np.isfinite(losses[-1]):
            raise FloatingPointError(f"non-finite total_loss at step {it + 1}: {losses[-1]}")
        if eval_every and (it + 1) % eval_every == 0 and it + 1 < steps:
            rec = {"step": it + 1, "loss": losses[-1],
                   **heldout(model, test, rig, compute_dtype)}
            evals.append(rec)
            log(rec)
    final = heldout(model, test, rig, compute_dtype)
    timed = np.asarray(secs[1:] or secs)  # the first step builds and warms up
    quarter = max(1, steps // 4)
    return {
        "metric": "synthetic_geo_heldout", "rig": rig, "steps": steps,
        "train_scenes": train_scenes, "test_scenes": test_scenes, "seed": seed,
        "mxu_readout": loss_cfg.mxu_readout, "lr": lr,
        "first_step_s": secs[0], "sec_per_step_p50": float(np.percentile(timed, 50)),
        "sec_per_step_p95": float(np.percentile(timed, 95)),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
        "loss_first": losses[0], "loss_last": losses[-1],
        "loss_first_quarter_mean": float(np.mean(losses[:quarter])),
        "loss_last_quarter_mean": float(np.mean(losses[-quarter:])),
        **final, "evals": evals,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--train-scenes", type=int, default=10)
    p.add_argument("--test-scenes", type=int, default=3)
    p.add_argument("--eval-every", type=int, default=0, help="0 = only the final evaluation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mxu-readout", default="auto", choices=("auto", "on"),
                   help="the loss route: auto the per-layer one, on the batched one")
    p.add_argument("--out", default=None, help="also write the final record here")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the geometry benchmark trains the flagship on the card; no CUDA "
                           "device is available")
    cfg = load_config(CONFIG)
    m = cfg["model"]
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout=args.mxu_readout),
                              m["train_cfg"]["pts"])
    rec = train_geo(m, loss_cfg, "nusc", args.steps, args.train_scenes, args.test_scenes,
                    "cuda", lr=2e-4, seed=args.seed,
                    compute_dtype=getattr(torch, cfg["compute_dtype"]),
                    eval_every=args.eval_every,
                    log=lambda r: print(json.dumps(r), flush=True))
    rec["config"] = os.path.basename(CONFIG)
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
