"""Checkpoints: the train state on ``torch.save`` / ``torch.load``.

The port's counterpart of ``occformer_tpu/engine/checkpoint.py:
save_checkpoint`` / ``load_checkpoint`` / ``latest_checkpoint`` (:27-95),
with the same directory contract: a run's checkpoints live under
``ckpt_dir/step_{N}`` (a directory holding ``state.pt``), and ``max_keep``
prunes all but the newest.  A save is atomic: it writes a temporary
directory and renames it into place, and a save killed half-way leaves only
a temporary, which the next save sweeps (as orbax sweeps its own).

The state holds the model's ``state_dict`` (parameters and buffers, the
BatchNorm statistics among them), the optimizer's (AdamW's moments and step,
the schedule's step; ``engine/optim.py:TrainOptimizer.state_dict``) and the
step.  ``load_checkpoint`` loads only these ``step_{N}`` directories, and
strictly.  A reference ``.pth`` (an mmcv checkpoint or a bare state dict,
in the reference key space the port carries) goes through
``engine/pretrained.py:partial_load_torch``, non-strictly as mmcv loads it.
The JAX package's orbax checkpoints are not read: that needs orbax and JAX.
Under data parallelism rank 0 writes and every rank loads.
"""
from __future__ import annotations

import os
import shutil
from typing import Optional

import torch

from ..parallel.distributed import barrier, is_main_process

STATE_FILE = "state.pt"
_TMP = ".tmp-"


def _steps(ckpt_dir: str):
    return sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                  if d.startswith("step_") and d.split("_")[1].isdigit())


def save_checkpoint(ckpt_dir: str, model: torch.nn.Module, optimizer, step: int,
                    max_keep: int = 1) -> str:
    """Save the train state as ``ckpt_dir/step_{step}``; keep the newest
    ``max_keep``.  ``optimizer`` may be None (weights only).  Returns the
    checkpoint's path.  Under data parallelism every rank calls it: rank 0
    writes (every rank holds the same state) and the others wait for it at
    a barrier, as the JAX package's ``save_checkpoint`` does (:45)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step}")
    if is_main_process():
        _write(ckpt_dir, path, model, optimizer, step, max_keep)
    barrier()
    return path


def _write(ckpt_dir, path, model, optimizer, step, max_keep):
    os.makedirs(ckpt_dir, exist_ok=True)
    for d in os.listdir(ckpt_dir):  # a save killed half-way
        if _TMP in d:
            shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
    tmp = f"{path}{_TMP}{os.getpid()}"
    os.makedirs(tmp)
    state = {"step": int(step), "model": model.state_dict(),
             "optimizer": None if optimizer is None else optimizer.state_dict()}
    torch.save(state, os.path.join(tmp, STATE_FILE))
    if os.path.exists(path):  # a re-save of the same step
        shutil.rmtree(path)
    os.replace(tmp, path)
    for s in _steps(ckpt_dir)[:-max_keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s}"), ignore_errors=True)


def read_checkpoint(path: str) -> dict:
    """The saved state of ``path`` (a ``step_{N}`` directory), on the CPU."""
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def load_checkpoint(path: str, model: torch.nn.Module, optimizer=None) -> int:
    """Load the ``step_{N}`` directory ``path`` of ``save_checkpoint`` into
    ``model`` (strictly) and, when given and saved, ``optimizer``; returns
    the checkpoint's step.  A file (a reference ``.pth``) raises: it loads
    through ``engine/pretrained.py:partial_load_torch``."""
    if not os.path.isdir(path):
        raise ValueError(f"{path} is not a step_N checkpoint directory; a reference .pth "
                         "loads through engine/pretrained.py:partial_load_torch")
    state = read_checkpoint(path)
    model.load_state_dict(state["model"], strict=True)
    if optimizer is not None and state["optimizer"] is not None:
        optimizer.load_state_dict(state["optimizer"])
    return int(state["step"])


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    """The newest ``step_{N}`` under ``ckpt_dir``, or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{steps[-1]}") if steps else None
