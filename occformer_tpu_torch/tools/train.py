"""Training CLI: config -> model + loader + train loop, checkpoints, eval.

    python3 -m occformer_tpu_torch.tools.train <config> [--work-dir DIR]
        [--resume-from CKPT] [--load-from CKPT] [--seed N] [--max-steps N]
        [--cfg-options a.b=value ...] [--cpu]

The port of ``tools/train.py``: a plain epoch loop around the port's train
step (``engine/train.py:build_train_step``), with the same behaviour:

* the step LR schedule of ``lr_config.step`` (epochs) and AdamW with the
  decay and freeze masks and the gradient clip of ``optimizer_config``;
  ``optimizer_config.cumulative_iters`` as ``accum_steps``;
* float32 parameters, the forward under bf16 autocast when
  ``compute_dtype`` is ``bfloat16``; a config's ``fp16`` (the R101-DCN's
  ``loss_scale="dynamic"``, the reference's fp16 training) is not read: bf16
  has float32's exponent range and the gradients are float32, so no loss
  scaler is needed;
* the pretrained init the config declares (``engine/pretrained.py``):
  ``img_backbone.pretrained`` (the torchvision R50 file),
  ``img_backbone.init_cfg`` (SemanticKITTI's mmcls EfficientNet-B7
  classifier, its ``backbone.*`` keys) and a raw ``.pth`` ``--load-from``
  (or ``load_from``), loaded non-strictly as mmcv's
  ``strict=False`` does, with a report of what was loaded, skipped and
  kept; a missing file keeps the random init with a warning;
* auto-resume from the newest ``work_dir/ckpts/step_{N}`` (or
  ``--resume-from``) at the batch after step N: the resumed epoch skips
  its first ``N % steps_per_epoch`` batches without building them, so a
  resumed run takes the uninterrupted run's steps, schedule included (the
  JAX CLI restarts the epoch instead); a ``--load-from`` checkpoint of this
  CLI loads its weights strictly, with the step at 0;
* a checkpoint at each epoch's end and at ``--max-steps``, and on SIGTERM
  or SIGINT a checkpoint and a clean exit;
* data parallelism under ``torchrun --nproc_per_node=N -m
  occformer_tpu_torch.tools.train ...`` (``parallel/distributed.py``):
  each rank on ``cuda:LOCAL_RANK`` (gloo on the CPU with ``--cpu``), its
  shard of each epoch, the model in ``DistributedDataParallel``, the step
  the one-process step on the global batch of ``N * samples_per_gpu``
  (``engine/train.py:build_train_step``); rank 0 prints and writes the
  checkpoints, every rank loads them;
* with ``evaluation.interval``, evaluation on ``data.val`` every that many
  epochs (not with ``--max-steps``) and ``evaluation.save_best`` kept under
  ``work_dir/best`` (SemanticKITTI's ``semkitti_SSC_mIoU`` turns on the SSC
  metrics);
* one JSON line per ``log_config.interval`` steps with ``sec/iter`` and the
  step's metrics; at the end one JSON line with the launches of each CUDA
  kernel of the port in this run (all 0 on the CPU) and ``training done at
  step N``.

The data come from the config's ``data.train`` through the registry: the
flagship's ``CustomNuScenesOccLSSDataset`` and its pipeline
(``data/nuscenes.py``) on a nuScenes tree that ``--cfg-options`` points at
(``data.train.data_root``, ``data.train.ann_file`` and the annotation
step's ``data.train.pipeline.2.data_root``), SemanticKITTI's
``CustomSemanticKITTILssDataset`` (``data/semantic_kitti.py``) on a KITTI
tree (``data.train.data_root``), or ``SyntheticOccDataset``.
The random draws of step k (drop-path masks, the loss's point draws) come
from a ``torch.Generator`` seeded from (seed, k) alone, and the pipeline's
augmentation draws of sample i in epoch e from a ``RandomState`` addressed
by (seed, e, i) (``data/nuscenes.py:sample_rng``; the JAX pipeline's are
unseeded), so a rerun or a resumed run draws what an uninterrupted one
draws.  It runs on ``cuda``, and on the CPU only with ``--cpu``.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import load_config, parse_cfg_options
from ..data.loader import build_dataloader, build_dataset, prefetch_to_device
from ..engine.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..engine.eval import evaluate, format_iou_table
from ..engine.optim import build_optimizer_from_config
from ..engine.pretrained import format_report, init_from_pretrained
from ..engine.train import build_loss_cfg, build_train_step, wrap_ddp
from ..models.detector import build_model
from ..ops import launch_counts
from ..parallel.distributed import (
    any_rank,
    is_main_process,
    local_rank,
    maybe_init_distributed,
    rank,
    world_size,
)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Train a config with the PyTorch port.")
    p.add_argument("config")
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume-from", default=None)
    p.add_argument("--load-from", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--max-steps", type=int, default=None, help="cap total steps (debug)")
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    return p.parse_args(argv)


def pick_device(cpu: bool) -> torch.device:
    """``cuda`` (``cuda:LOCAL_RANK`` under torchrun), or the CPU when asked;
    no card without ``--cpu`` raises."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run on the CPU")
    return torch.device("cuda", local_rank())


def step_generator(seed: int, step: int, device: torch.device) -> torch.Generator:
    """Step ``step``'s generator: seeded from (seed, step) alone."""
    s = int(np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(s)


def log(*args, **kwargs):
    """``print`` on rank 0 only."""
    if is_main_process():
        print(*args, **kwargs)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = pick_device(args.cpu)
    owned = not torch.distributed.is_initialized()
    maybe_init_distributed(args.cpu)
    try:
        return _train(args, device)
    finally:
        if owned and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _train(args, device: torch.device) -> int:
    cfg = load_config(args.config, parse_cfg_options(args.cfg_options))
    work_dir = args.work_dir or os.path.join(
        "work_dirs", os.path.splitext(os.path.basename(args.config))[0])
    os.makedirs(work_dir, exist_ok=True)
    ckpt_dir = os.path.join(work_dir, "ckpts")
    max_keep = cfg.get("checkpoint_config", {}).get("max_keep_ckpts", 1)
    compute_dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None
    m = cfg["model"]

    train_cfg = dict(cfg["data"]["train"])
    train_cfg.setdefault("seed", args.seed)  # the pipeline's augmentation draws
    dataset = build_dataset(train_cfg)
    loader = build_dataloader(dataset, samples_per_gpu=cfg["data"].get("samples_per_gpu", 1),
                              seed=args.seed, num_hosts=world_size(), host_id=rank(),
                              max_points=cfg.get("max_lidar_points", 35000))
    steps_per_epoch = len(loader)
    max_epochs = cfg.get("runner", {}).get("max_epochs", 24)

    model = build_model(m, device=device, dtype=torch.float32, seed=args.seed).train()
    load_from = args.load_from or cfg.get("load_from")
    for report in init_from_pretrained(model, m, load_from=load_from):
        log(format_report(report))
    if load_from and not str(load_from).endswith((".pth", ".pt")):
        lf = latest_checkpoint(load_from) or load_from
        if os.path.isdir(lf):
            load_checkpoint(lf, model)
            log(f"loaded model weights from {lf}")
        else:
            log(f"WARNING: load_from={load_from} not found; training from random init")

    optimizer = build_optimizer_from_config(model, cfg, steps_per_epoch)
    step = 0
    resume = args.resume_from or latest_checkpoint(ckpt_dir)
    if resume:
        step = load_checkpoint(resume, model, optimizer)
    # the step's epoch, and the batches of it that ran before the checkpoint
    first_epoch, start_batch = divmod(step, max(steps_per_epoch, 1))
    if resume:
        log(f"resumed from {resume} at step {step} (epoch {first_epoch} from batch "
            f"{start_batch})")

    # mmcv GradientCumulativeOptimizerHook: optimizer_config.cumulative_iters
    accum = int(cfg.get("optimizer_config", {}).get("cumulative_iters", 1))
    train_step = build_train_step(
        wrap_ddp(model) if world_size() > 1 else model, optimizer,
        build_loss_cfg(m["pts_bbox_head"], m.get("train_cfg", {}).get("pts")),
        device=device, compute_dtype=compute_dtype, accum_steps=accum)

    # per-epoch evaluation and the best checkpoint (reference OccDistEvalHook,
    # core/evaluation/eval_hooks.py:27-88, with evaluation.save_best)
    eval_cfg = cfg.get("evaluation", {}) or {}
    eval_every = eval_cfg.get("interval", 0)
    save_best_key = eval_cfg.get("save_best")
    best_metric = -float("inf")

    def run_eval():
        val_cfg = cfg.get("data", {}).get("val")
        if not val_cfg:
            return None
        val_loader = build_dataloader(build_dataset(val_cfg, test_mode=True),
                                      samples_per_gpu=1, shuffle=False,
                                      num_hosts=world_size(), host_id=rank(),
                                      max_points=cfg.get("max_lidar_points", 35000))
        model.eval()
        results = evaluate(model, val_loader, tuple(cfg.get("occ_size", (32, 32, 16))),
                           cfg.get("num_class", 17), class_names=cfg.get("class_names"),
                           compute_ssc="semkitti" in str(save_best_key).lower(),
                           panoptic=m["pts_bbox_head"].get("type")
                           == "Mask2FormerNuscPanopticOccHead",
                           thing_indices=m["pts_bbox_head"].get("thing_indices"),
                           compute_dtype=compute_dtype)
        model.train()
        log(format_iou_table(results))
        return results

    # preemption: SIGTERM / SIGINT ask for a checkpoint and a clean exit
    stop_requested = {"flag": False}

    def _graceful_stop(signum, frame):
        stop_requested["flag"] = True

    previous = {}
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            previous[sig] = signal.signal(sig, _graceful_stop)
        except ValueError:
            pass  # not the main thread
    try:
        log_every = cfg.get("log_config", {}).get("interval", 50)
        for epoch in range(first_epoch, max_epochs):
            loader.set_epoch(epoch, start_batch if epoch == first_epoch else 0)
            t0 = time.time()
            for batch in prefetch_to_device(loader, device):
                # every rank stops at the same step (the signal may reach
                # the ranks between two of them)
                if any_rank(stop_requested["flag"]):
                    save_checkpoint(ckpt_dir, model, optimizer, step, max_keep)
                    log(f"preempted: checkpoint saved at step {step}", flush=True)
                    return 0
                metrics = train_step(batch, step_generator(args.seed, step, device))
                step += 1
                if step % log_every == 0:
                    m_host = {k: float(v) for k, v in metrics.items()}
                    dt = (time.time() - t0) / log_every
                    t0 = time.time()
                    log(json.dumps({"step": step, "epoch": epoch, "sec/iter": dt, **m_host}),
                        flush=True)
                if args.max_steps and step >= args.max_steps:
                    break
            save_checkpoint(ckpt_dir, model, optimizer, step, max_keep)
            if eval_every and (epoch + 1) % eval_every == 0 and not args.max_steps:
                results = run_eval()
                if results and save_best_key and save_best_key in results \
                        and results[save_best_key] > best_metric:
                    best_metric = results[save_best_key]
                    save_checkpoint(os.path.join(work_dir, "best"), model, optimizer, step, 1)
                    log(f"new best {save_best_key}={best_metric:.4f}")
            if args.max_steps and step >= args.max_steps:
                break
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    log(json.dumps({"kernel_launches": launch_counts()}))
    log("training done at step", step, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
