"""Data parallelism over processes: the process group and host reductions.

The port's counterpart of ``occformer_tpu/parallel/mesh.py``
(``maybe_init_distributed``, ``host_allreduce_sum``), for the reference's
NCCL DDP launcher stack (tools/dist_train.sh, apis/mmdet_train.py:76-80):
one process per card under ``torchrun``, each loading its own shard of the
epoch (``data/loader.py:ShardedLoader``'s ``num_hosts`` / ``host_id``),
the gradients all-reduced by ``DistributedDataParallel``.  What makes the
processes' step the one-process step on the global batch lives with the
code it changes: BatchNorm's global statistics (``models/layers.py``), the
loss normalisers summed over ranks (``losses/mask2former_loss.py``,
``models/lss.py:depth_bce_loss``), and each rank's rows of the global
batch's draws (``global_rows``).  All of them are the identity while no
process group of more than one process is active.  The JAX package's 2-D
spatial sharding and mesh helpers are TPU-only and not ported.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist


def maybe_init_distributed(cpu: bool = False) -> bool:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` / ``MASTER_PORT`` in
    the environment): ``gloo`` when the caller asks for the CPU, else
    ``nccl`` with this process on ``cuda:LOCAL_RANK``.  Does nothing for a
    single process (no ``WORLD_SIZE``, or 1) or when a group is already
    active.  Returns whether a group of more than one process is active."""
    if dist.is_initialized():
        return world_size() > 1
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if not cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass --cpu to train over "
                               "gloo on the CPU")
        torch.cuda.set_device(local_rank())
    dist.init_process_group("gloo" if cpu else "nccl", init_method="env://",
                            world_size=world, rank=int(os.environ["RANK"]))
    return True


def rank() -> int:
    """This process's rank in the active group, 0 without one."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The active group's size, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This process's card on its host (``LOCAL_RANK``, 0 without it)."""
    return int(os.environ.get("LOCAL_RANK", "0"))


def is_main_process() -> bool:
    """Whether this process prints, logs and writes checkpoints (rank 0)."""
    return rank() == 0


def barrier():
    """Wait for every rank; nothing without a group."""
    if dist.is_initialized():
        dist.barrier()


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` holds on any rank (a stop request that every rank
    must act on at the same step); ``flag`` itself without a group."""
    if world_size() == 1:
        return flag
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def global_rows(n: int) -> slice:
    """This rank's rows of a global batch whose ranks hold ``n`` rows each,
    in rank order: ``slice(rank * n, (rank + 1) * n)``."""
    r = rank()
    return slice(r * n, (r + 1) * n)


def _device() -> torch.device:
    return (torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl" else torch.device("cpu"))


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, out of place and outside autograd
    (counts and normalisers through which no gradient flows); ``t`` itself
    without a group of more than one process."""
    if world_size() == 1:
        return t
    out = t.detach().clone()
    dist.all_reduce(out)
    return out


def host_allreduce_sum(state: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Sum a dict of host numpy arrays over every process (the reference's
    ``dist.all_reduce(evaluation_semantic)``, apis/test.py:209): each rank
    counts over its shard of the split, and the counters are summed before
    the metrics are derived.  The identity for one process.  Arrays travel
    in their own dtype, so int64 / float64 counters past 2**31 stay exact
    (the JAX package sends them as uint32 pairs, ``mesh.py:67-104``).  The
    caller's arrays are left as they were (under gloo a tensor made from
    them would share their memory, and the sum lands in place)."""
    if world_size() == 1:
        return state
    dev = _device()
    out = {}
    for k in sorted(state):  # one order on every rank
        v = np.asarray(state[k])
        t = torch.from_numpy(np.array(v, order="C", copy=True)).to(dev)
        dist.all_reduce(t)
        out[k] = t.cpu().numpy().reshape(v.shape).astype(v.dtype, copy=False)
    return out
