"""Training soak on the card: many flagship steps with a mid-run checkpoint.

    python3 -m occformer_tpu_torch.tools.soak [CONFIG] [--steps 120]
        [--ckpt-at 60] [--flush-every 20] [--mxu-readout auto|on] [--seed 0]
        [--work-dir DIR] [--resume] [--tag NAME] [--out f.json]

The port of ``tools/soak.py``: ``--steps`` consecutive train steps of the
config (the flagship by default, full width and depth, float32 parameters
under its bf16 autocast, random weights from ``--seed``) on one fixed
``data/synthetic.py:make_train_batch`` batch, so the loss must fall; step
k's draws come from ``tools/train.py:step_generator(seed, k)``.  Per step:
the wall time (host clock; the step ends when its loss reaches the host)
and the losses and grad_norm.  At ``--ckpt-at`` the state is saved through
``engine/checkpoint.py``, loaded into a fresh model and optimizer, every
parameter, buffer and optimizer tensor compared bit for bit with the live
state, and training goes on from the loaded state.

Progress (the trajectory so far) and a checkpoint are written every
``--flush-every`` steps under ``--work-dir``; ``--resume`` carries on from
the last flush.  The train step repeats itself bit for bit on the card
(ROADMAP C.1-C.8), so the soak then runs the same steps again from the
same seed without the checkpoint and says whether the two trajectories
(every logged loss and grad_norm, and the final parameters) are equal:
they should be.  The record (s/step p50 and p95
without the first step, the peak device memory, the first and last
losses, the checkpoint's check, the replay's) is printed as the last JSON
line and, with ``--out``, merged into that JSON file under ``--tag``.
The JAX tool's ``--window`` and its notes on the TPU backend are left out.
It runs on the card (no card raises).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import load_config
from ..data.synthetic import make_train_batch
from ..engine.checkpoint import latest_checkpoint, load_checkpoint, save_checkpoint
from ..engine.eval import to_device_batch
from ..engine.optim import build_optimizer_from_config
from ..engine.train import build_loss_cfg, build_train_step
from ..models.detector import build_model
from .train import step_generator

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")
STEPS_PER_EPOCH = 28130  # nuScenes' train samples: the schedule's milestones lie far out


def _atomic_write(path: str, obj):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=1)
    os.replace(tmp, path)


class Trainer:
    """A model, its optimizer and its train step, built from the config."""

    def __init__(self, cfg: Dict, loss_cfg, seed: int, device: torch.device):
        self.model = build_model(cfg["model"], device=device, dtype=torch.float32,
                                 seed=seed).train()
        self.optimizer = build_optimizer_from_config(self.model, cfg, STEPS_PER_EPOCH)
        self.step = build_train_step(
            self.model, self.optimizer, loss_cfg, device=device,
            compute_dtype=torch.bfloat16 if cfg.get("compute_dtype") == "bfloat16" else None)


def differing_tensors(a: Trainer, b: Trainer) -> List[str]:
    """Names of the parameters, buffers and optimizer tensors that differ
    between two trainers (bitwise)."""
    sd_b = b.model.state_dict()
    out = [k for k, v in a.model.state_dict().items() if not torch.equal(v, sd_b[k])]
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    if sa["step_count"] != sb["step_count"]:
        out.append("optimizer step_count")
    for i, st in sa["adamw"]["state"].items():
        for k, v in st.items():
            if not torch.equal(torch.as_tensor(v), torch.as_tensor(sb["adamw"]["state"][i][k])):
                out.append(f"optimizer {i}.{k}")
    return out


def run(cfg: Dict, loss_cfg, batch: Dict[str, torch.Tensor], steps: int, seed: int,
        device: torch.device, ckpt_at: int = 0, flush_every: int = 0, work_dir: str = "",
        progress: Optional[Dict] = None, log=print) -> Tuple[Trainer, Dict]:
    """Train ``steps`` steps on ``batch``: with ``ckpt_at`` a checkpoint,
    reload and bit-compare at that step, with ``flush_every`` a progress
    file and a checkpoint every that many steps under ``work_dir``.  A
    ``progress`` of an earlier run of the same soak resumes it from its
    last flush.  Returns the trainer and the progress record."""
    trainer = Trainer(cfg, loss_cfg, seed, device)
    ckpt_dir = os.path.join(work_dir, "ckpts")
    prog_path = os.path.join(work_dir, "progress.json")
    start = 0
    if progress is None:
        progress = {"metrics": [], "step_secs": [], "events": [], "resume_bit_equal": None}
    else:
        ck = latest_checkpoint(ckpt_dir)
        start = load_checkpoint(ck, trainer.model, trainer.optimizer)
        progress["metrics"] = progress["metrics"][:start]
        progress["step_secs"] = progress["step_secs"][:start]
        progress["events"].append(f"resumed at step {start}")
        log(f"resumed from {ck} at step {start}")
    for i in range(start, steps):
        t = time.perf_counter()
        metrics = trainer.step(batch, step_generator(seed, i, device))
        host = {k: float(v) for k, v in metrics.items()}  # waits for the step
        progress["step_secs"].append(time.perf_counter() - t)
        progress["metrics"].append(host)
        if not all(np.isfinite(v) for k, v in host.items() if k != "point_mean_iou"):
            raise FloatingPointError(f"non-finite metrics at step {i + 1}: {host}")
        if i + 1 == ckpt_at:
            t = time.perf_counter()
            path = save_checkpoint(os.path.join(work_dir, "mid"), trainer.model,
                                   trainer.optimizer, i + 1)
            loaded = Trainer(cfg, loss_cfg, seed + 1, device)
            load_checkpoint(path, loaded.model, loaded.optimizer)
            differ = differing_tensors(trainer, loaded)
            progress["resume_bit_equal"] = not differ
            progress["ckpt_s"] = time.perf_counter() - t
            progress["events"].append(f"checkpoint and reload at step {i + 1}: "
                                      f"{len(differ)} tensors differ {differ[:5]}")
            log(progress["events"][-1])
            if differ:
                raise RuntimeError(f"the reloaded state differs: {differ[:10]}")
            trainer = loaded  # training goes on from the loaded state
        if flush_every and ((i + 1) % flush_every == 0 or i + 1 == steps):
            save_checkpoint(ckpt_dir, trainer.model, trainer.optimizer, i + 1)
            _atomic_write(prog_path, progress)
            log(f"step {i + 1}/{steps} total_loss={host['total_loss']:.4f} "
                f"{progress['step_secs'][-1]:.3f} s/step")
    return trainer, progress


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def summary(progress: Dict, device: torch.device) -> Dict:
    """The soak's record from its progress."""
    totals = [m["total_loss"] for m in progress["metrics"]]
    secs = np.asarray(progress["step_secs"][1:] or progress["step_secs"])
    n = len(totals)
    quarter = max(1, n // 4)
    return {
        "steps_completed": n, "first_step_s": progress["step_secs"][0],
        "step_sec_p50": float(np.percentile(secs, 50)),
        "step_sec_p95": float(np.percentile(secs, 95)),
        "loss_first": totals[0], "loss_last": totals[-1],
        "loss_first_quarter_mean": float(np.mean(totals[:quarter])),
        "loss_last_quarter_mean": float(np.mean(totals[-quarter:])),
        "loss_falls": bool(np.mean(totals[-quarter:]) < np.mean(totals[:quarter])),
        "grad_norm_first": progress["metrics"][0]["grad_norm"],
        "grad_norm_last": progress["metrics"][-1]["grad_norm"],
        "mid_run_reload_bit_equal": progress["resume_bit_equal"],
        "ckpt_s": progress.get("ckpt_s"), "events": progress["events"],
        "device": device_name(device),
    }


def soak(cfg: Dict, mxu_readout: str, steps: int, ckpt_at: int, seed: int, work_dir: str,
         flush_every: int = 0, resume: bool = False, log=print, device="cuda") -> Dict:
    """The whole soak on ``device`` (the card unless the caller asks for the
    CPU): the run, then the same steps without the checkpoint, compared.
    Returns its record."""
    device = torch.device(device)
    m = cfg["model"]
    loss_cfg = build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout=mxu_readout),
                              m["train_cfg"]["pts"])
    batch = to_device_batch(make_train_batch(cfg, seed=seed), device)
    progress = None
    prog_path = os.path.join(work_dir, "progress.json")
    if resume and os.path.exists(prog_path) and latest_checkpoint(os.path.join(work_dir, "ckpts")):
        with open(prog_path) as f:
            progress = json.load(f)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    trainer, progress = run(cfg, loss_cfg, batch, steps, seed, device, ckpt_at, flush_every,
                            work_dir, progress, log)
    rec = dict(summary(progress, device), mxu_readout=mxu_readout, steps=steps,
               ckpt_at=ckpt_at, seed=seed,
               peak_memory_bytes=torch.cuda.max_memory_allocated(device) if cuda else None)
    again, plain = run(cfg, loss_cfg, batch, steps, seed, device, log=log)
    # point_mean_iou is NaN where no class is predicted: NaN != NaN
    traj = [{k: m[k] for k in m if k != "point_mean_iou"} for m in progress["metrics"]]
    traj_again = [{k: m[k] for k in m if k != "point_mean_iou"} for m in plain["metrics"]]
    differ = differing_tensors(trainer, again)
    rec["replay"] = {"trajectory_equal": traj == traj_again,
                     "steps_differing": [i + 1 for i, (a, b) in enumerate(
                         zip(traj, traj_again)) if a != b][:10],
                     "final_state_equal": not differ, "tensors_differing": differ[:10]}
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("config", nargs="?", default=CONFIG)
    p.add_argument("--tag", default=None, help="the record's key in --out (default: "
                   "soak_<loss route>)")
    p.add_argument("--steps", type=int, default=120)
    p.add_argument("--ckpt-at", type=int, default=60,
                   help="the step at which to checkpoint, reload, compare and go on")
    p.add_argument("--flush-every", type=int, default=20)
    p.add_argument("--mxu-readout", default="auto", choices=("auto", "on"),
                   help="the loss route: auto the per-layer one, on the batched one")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--work-dir", default=None)
    p.add_argument("--resume", action="store_true", help="carry on from the last flush")
    p.add_argument("--out", default=None, help="JSON file the record is merged into")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("the soak trains on the card; no CUDA device is available")
    tag = args.tag or f"soak_{args.mxu_readout}"
    work_dir = args.work_dir or os.path.join("work_dirs", tag)
    os.makedirs(work_dir, exist_ok=True)
    cfg = load_config(args.config)
    t0 = time.perf_counter()
    rec = soak(cfg, args.mxu_readout, args.steps, args.ckpt_at, args.seed, work_dir,
               args.flush_every, args.resume)
    rec.update(config=os.path.basename(args.config), wall_s=time.perf_counter() - t0)
    if args.out:
        merged = {}
        if os.path.exists(args.out):
            with open(args.out) as f:
                merged = json.load(f)
        merged[tag] = rec
        _atomic_write(args.out, merged)
    print(json.dumps({tag: rec}), flush=True)
    ok = rec["mid_run_reload_bit_equal"] is not False and rec["replay"]["trajectory_equal"]
    return 0 if ok else 3


if __name__ == "__main__":
    sys.exit(main())
