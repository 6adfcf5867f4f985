"""Serving frames a second, with a per-stage breakdown.

    python3 -m occformer_tpu_torch.tools.benchmark [CONFIG] [--iters 6]
        [--warmup 1] [--batch-size B] [--stage-breakdown]
        [--stage img|feat|full] [--cfg-options a.b=value ...] [--cpu]

The port of ``tools/benchmark.py`` (reference
tools/analysis_tools/benchmark.py:21-80, the record_time timers of
detectors/occupancyformer.py:19-57).  It builds the config's model through
``build_model`` (random weights from seed 0, float32 parameters; the
config's ``compute_dtype`` as autocast, the port's serving route) on JAX's
benchmark batch (``__graft_entry__.py:_flagship_model_and_batch``: seeded
images, identity rotations, focal 1266, ``post_rots`` 0.44) and times three
programs as JAX does:

* ``img``: the image encoder (backbone and neck);
* ``feat``: through the pixel decoder (JAX's ``extract_feat``: the image
  encoder, the view transformer, the occupancy encoder and the pixel
  decoder);
* ``full``: the forward, then ``mask_logits_from_embeds`` and
  ``format_results`` (JAX's ``full``).

Each runs under ``inference_mode``, as ``engine/eval.py:build_eval_step``
serves.

Each program runs once (its outputs' checksum must be finite), ``--warmup``
times, then ``--iters`` times, each call timed by ``utils/profiling.py:
StageTimer`` (CUDA events on the current stream on the card, the host clock
with ``--cpu``); the minimum is reported.  One JSON line:
``fps_per_chip``, ``sec_per_frame``, ``method`` and, with
``--stage-breakdown``, ``img_encoder_ms``, ``through_neck_ms`` and
``full_ms``; with ``--stage``, ``{"stage", "ms_per_call"}`` alone.
Unlike JAX's tool, which always loads the flagship, this one honours
``CONFIG``.  Without a card and without ``--cpu`` it raises.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
from typing import Callable, Dict, Optional

import numpy as np
import torch

DEFAULT_CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                              "configs", "occformer_nusc_r50_256x704.py")
STAGE_KEYS = {"img": "img_encoder_ms", "feat": "through_neck_ms", "full": "full_ms"}


def benchmark_batch(cfg, batch_size: int = 1) -> Dict[str, np.ndarray]:
    """JAX's benchmark frame (``__graft_entry__.py:120-137``) at the config's
    cameras and input size."""
    B, N = batch_size, cfg["data_config"].get("Ncams", 6)
    H, W = cfg["data_config"]["input_size"]
    rng = np.random.RandomState(0)
    intrins = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intrins[..., 0, 0] = 1266.0
    intrins[..., 1, 1] = 1266.0
    intrins[..., 0, 2] = W / 2
    intrins[..., 1, 2] = H / 2
    batch = {
        "imgs": rng.randn(B, N, H, W, 3).astype(np.float32),
        "rots": np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1)),
        "trans": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        "intrins": intrins,
        "post_rots": np.tile(np.eye(3, dtype=np.float32) * 0.44, (B, N, 1, 1)),
        "post_trans": np.zeros((B, N, 3), np.float32),
        "bda": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
    }
    batch["post_rots"][..., 2, 2] = 1.0
    return batch


def _checksum(tree) -> float:
    """The float32 sum of every tensor in ``tree`` (JAX's ``_ck``)."""
    if torch.is_tensor(tree):
        return float(tree.float().sum())
    if isinstance(tree, dict):
        tree = list(tree.values())
    return sum(_checksum(t) for t in tree)


def programs(model, batch: Dict[str, torch.Tensor],
             compute_dtype: Optional[torch.dtype]) -> Dict[str, Callable]:
    """The three timed programs (module docstring) on tensors on the
    model's device, each under ``inference_mode`` as ``build_eval_step``
    serves."""
    from ..models.mask2former_head import format_results, mask_logits_from_embeds
    from .export_model import autocast as autocast_of

    dev = next(model.parameters()).device

    def autocast():
        return autocast_of(dev.type, compute_dtype)

    @torch.inference_mode()
    def img():
        with autocast():
            return model.image_encoder(batch["imgs"])

    @torch.inference_mode()
    def feat():
        with autocast():
            volume, _ = model.extract_volume(batch)
            scales = model.img_bev_encoder_backbone(volume.permute(0, 4, 1, 2, 3))
            return model.img_bev_encoder_neck(list(scales))

    @torch.inference_mode()
    def full():
        with autocast():
            out = model(batch)
            return format_results(out["cls_preds"][-1],
                                  mask_logits_from_embeds(out["mask_embeds"][-1],
                                                          out["mask_feature"]))

    return {"img": img, "feat": feat, "full": full}


def time_program(fn: Callable, name: str, iters: int, warmup: int, timer) -> float:
    """Minimum seconds of ``fn()`` over ``iters`` calls, each a stage of
    ``timer``, after a checked first call and ``warmup`` more."""
    value = _checksum(fn())
    if not math.isfinite(value):
        raise RuntimeError(f"{name}: non-finite checksum {value}")
    for _ in range(warmup):
        fn()
    for _ in range(iters):
        with timer.stage(name):
            fn()
    return min(timer.times[name])


def run(cfg_path: str = DEFAULT_CONFIG, iters: int = 6, warmup: int = 1, batch_size: int = 1,
        stage_breakdown: bool = False, stage: Optional[str] = None,
        overrides: Optional[dict] = None, device: str = "cuda") -> dict:
    """The report (module docstring) of the config at ``cfg_path``."""
    from ..config import load_config
    from ..engine.eval import to_device_batch
    from ..models.detector import build_model
    from ..utils.profiling import StageTimer
    from .export_model import compute_dtype_of

    cfg = load_config(cfg_path, overrides)
    compute_dtype = compute_dtype_of(cfg)
    timer = StageTimer(device)
    model = build_model(cfg["model"], device=device, dtype=torch.float32, seed=0)
    batch = to_device_batch(benchmark_batch(cfg, batch_size), torch.device(device))
    progs = programs(model, batch, compute_dtype)

    def timeit(name):
        return time_program(progs[name], name, iters, warmup, timer)

    if stage:
        return {"stage": stage, "ms_per_call": timeit(stage) * 1e3}
    sec = timeit("full")
    report = {"fps_per_chip": batch_size / sec, "sec_per_frame": sec / batch_size,
              "method": ("CUDA events around each call on the current stream (StageTimer), "
                         "min over iters" if timer.device.type == "cuda" else
                         "host clock around each call (StageTimer), min over iters")}
    if stage_breakdown:
        # separately timed prefixes of the forward
        report["img_encoder_ms"] = timeit("img") * 1e3
        report["through_neck_ms"] = timeit("feat") * 1e3
        report["full_ms"] = sec * 1e3
    return report


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config", nargs="?", default=DEFAULT_CONFIG)
    p.add_argument("--iters", type=int, default=6, help="timed repeats (min is reported)")
    p.add_argument("--warmup", type=int, default=1)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--stage-breakdown", action="store_true")
    p.add_argument("--stage", choices=sorted(STAGE_KEYS), default=None,
                   help="time ONE stage program")
    p.add_argument("--cfg-options", nargs="*", default=[],
                   help="a.b.c=value config overrides (for A/B runs)")
    p.add_argument("--cpu", action="store_true", help="run on the CPU (host clock)")
    args = p.parse_args(argv)
    from ..config import parse_cfg_options

    print(json.dumps(run(args.config, iters=args.iters, warmup=args.warmup,
                         batch_size=args.batch_size, stage_breakdown=args.stage_breakdown,
                         stage=args.stage, overrides=parse_cfg_options(args.cfg_options),
                         device="cpu" if args.cpu else "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
