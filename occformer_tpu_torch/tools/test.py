"""Evaluation / submission CLI.

    python3 -m occformer_tpu_torch.tools.test <config> [--checkpoint CKPT]
        [--test-save DIR] [--max-samples N] [--cfg-options a.b=value ...] [--cpu]

The port of ``tools/test.py`` (reference tools/test.py + apis/test.py):
float32 parameters, the forward under bf16 autocast when
the config's ``compute_dtype`` is ``bfloat16`` (as the JAX package serves,
and as the train CLI's per-epoch evaluation runs), its weights from
``--checkpoint`` (a ``step_{N}`` directory of the train CLI, loaded
strictly, or a reference ``.pth``, loaded as mmcv's ``strict=False`` with a
report; random weights without it, for debugging), evaluated over
``data.test`` in order: the flagship's ``CustomNuScenesOccLSSDataset`` on
a nuScenes tree that ``--cfg-options`` points at (``data.test.data_root``,
``data.test.ann_file`` and ``data.test.pipeline.1.data_root``), a
SemanticKITTI config's ``CustomSemanticKITTILssDataset`` on a KITTI tree
(``data.test.data_root``; its SSC metrics, ``semkitti_SC_IoU`` and
``semkitti_SSC_mIoU``, from the 256 x 256 x 32 ``voxel_pred``, label 255
ignored), or ``SyntheticOccDataset``.  It prints one JSON line with the
sample count, the seconds per sample and the launches of each CUDA kernel
of the port, the IoU table, and one JSON line of results.
``--test-save`` writes the submission: for nuScenes one
``lidarseg/test/<token>_lidarseg.bin`` of uint8 labels per sample (its
valid points) and ``test/submission.json``; for SemanticKITTI one
``sequences/<seq>/predictions/<frame>.label`` of raw uint16 ids per frame
(``occformer_kitti_submit.py`` runs the unlabelled test-submit split).  The
panoptic configuration (``LoadNuscPanopticOccupancyAnnotations``'s panoptic
LiDAR labels) also gets ``nuScenes_panoptic_PQ``, ``_SQ`` and ``_RQ``, its
head's ``thing_indices`` naming the classes whose queries become
instances.  It runs on ``cuda``, and on the CPU
only with ``--cpu``.  Under ``torchrun --nproc_per_node=N`` each rank
evaluates its shard of the split on ``cuda:LOCAL_RANK`` (``--max-samples``
caps each rank's share), the counters are summed over ranks
(``parallel/distributed.py:host_allreduce_sum``) and rank 0 prints.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import load_config, parse_cfg_options
from ..data.loader import build_dataloader, build_dataset
from ..engine.checkpoint import load_checkpoint
from ..engine.eval import evaluate, format_iou_table
from ..engine.pretrained import format_report, partial_load_torch
from ..models.detector import build_model
from ..ops import launch_counts
from ..parallel.distributed import (
    host_allreduce_sum,
    is_main_process,
    maybe_init_distributed,
    rank,
    world_size,
)
from ..utils.semkitti_io import write_nusc_lidarseg_bin, write_submission_label
from .train import log, pick_device


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Evaluate a config with the PyTorch port.")
    p.add_argument("config")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--test-save", default=None, help="write leaderboard submission files here")
    p.add_argument("--max-samples", type=int, default=None)
    p.add_argument("--cfg-options", nargs="*", default=[])
    p.add_argument("--cpu", action="store_true", help="run on the CPU (plain versions)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> int:
    args = parse_args(argv)
    device = pick_device(args.cpu)
    owned = not torch.distributed.is_initialized()
    maybe_init_distributed(args.cpu)
    try:
        return _test(args, device)
    finally:
        if owned and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()


def _test(args, device: torch.device) -> int:
    cfg = load_config(args.config, parse_cfg_options(args.cfg_options))
    is_kitti = "SemanticKITTI" in cfg["data"]["test"]["type"]
    m = cfg["model"]
    compute_dtype = torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None
    model = build_model(m, device=device, dtype=torch.float32, seed=0)
    if args.checkpoint and os.path.isdir(args.checkpoint):
        step = load_checkpoint(args.checkpoint, model)
        log(f"loaded {args.checkpoint} (step {step})")
    elif args.checkpoint:
        report = partial_load_torch(model, args.checkpoint)
        log(format_report(report))

    dataset = build_dataset(cfg["data"]["test"], test_mode=True)
    loader = build_dataloader(dataset, samples_per_gpu=1, shuffle=False,
                              num_hosts=world_size(), host_id=rank(),
                              max_points=cfg.get("max_lidar_points", 35000))
    n = len(loader) if args.max_samples is None else min(len(loader), args.max_samples)

    save_cb = None
    if args.test_save:
        def save_cb(out, meta, batch):
            for bi, mt in enumerate(meta or []):
                if is_kitti:
                    write_submission_label(out["voxel_pred"][bi].cpu().numpy(), os.path.join(
                        args.test_save, "sequences", mt.get("sequence", "00"), "predictions",
                        mt.get("frame_id", "000000") + ".label"))
                    continue
                token = mt.get("lidar_token", mt.get("sample_idx", f"s{bi}"))
                valid = torch.as_tensor(batch["lidar_valid"][bi]).cpu().numpy()
                preds = out["point_pred"][bi].cpu().numpy()[valid]
                write_nusc_lidarseg_bin(preds, os.path.join(
                    args.test_save, "lidarseg", "test", f"{token}_lidarseg.bin"))

    t0 = time.perf_counter()
    results = evaluate(model, itertools.islice(loader, n), tuple(cfg["occ_size"]),
                       cfg["num_class"], class_names=cfg.get("class_names"),
                       compute_ssc=is_kitti, save_cb=save_cb, compute_dtype=compute_dtype,
                       panoptic=m["pts_bbox_head"].get("type") == "Mask2FormerNuscPanopticOccHead",
                       thing_indices=m["pts_bbox_head"].get("thing_indices"))
    seconds = time.perf_counter() - t0
    n = int(host_allreduce_sum({"samples": np.int64(n)})["samples"])
    if not is_main_process():
        return 0
    if args.test_save and not is_kitti:
        meta_file = os.path.join(args.test_save, "test", "submission.json")
        os.makedirs(os.path.dirname(meta_file), exist_ok=True)
        with open(meta_file, "w") as f:
            json.dump({"meta": dict(use_lidar=False, use_camera=True, use_radar=False,
                                    use_map=False, use_external=False)}, f)
    print(json.dumps({"samples": n, "sec/sample": seconds / max(n, 1),
                      "kernel_launches": launch_counts()}))
    print(format_iou_table(results))
    print(json.dumps(results), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
