"""Export the serving forward to a ``torch.export`` archive.

    python3 -m occformer_tpu_torch.tools.export_model CONFIG --out model.pt2
        [--checkpoint work_dir/ckpts/step_N] [--batch-size B] [--verify] [--cpu]

The port of ``tools/export_model.py`` (JAX lowers the jitted forward to
StableHLO): the config's model, built through ``build_model`` (its ``type``
and keys honoured) with random weights from seed 0 or a port ``step_N``
checkpoint (``engine/checkpoint.py``), is exported by a non-strict
``torch.export.export`` of the serving function, the model, then
``mask_logits_from_embeds`` and ``format_results`` (JAX's ``forward``,
``tools/export_model.py:88-91``), on JAX's example batch (zero images,
identity rotations, focal 500), and written by ``torch.export.save``.

Every hand-written kernel is a ``torch.library`` custom op
(``ops/library.py``), so the exported graph holds one ``occformer::*``
node for each kernel call of the eager function, on the CPU (whose ops run
the plain versions) as on the card.  A process that loads the archive
imports ``occformer_tpu_torch.ops`` to register them and nothing else of
the port (``load_exported``).

The route.  The config's ``compute_dtype`` names it, as in JAX.  The port
serves float32 parameters under bf16 autocast.  An autocast block traced
into the graph (a ``wrap_with_autocast`` node that turns autocast on) does
not load back: ``torch.export.load`` raises ``SpecViolationError: Node.meta
wrap_with_autocast is missing val field``, and lowering it first with
``run_decompositions`` fails with a dtype error inside the node (torch
2.13 on the CPU).  So the function is traced with the autocast active
around ``torch.export.export``: the export traces above autocast's
dispatch, so the graph holds the operators before autocast casts them
(and the casts the forward makes itself, e.g. its float32 islands), and
the archive records the dtype (``extra_files["compute_dtype"]``).
``run_exported`` runs the program under that autocast, which casts at run
time where the eager forward casts.  ``--verify`` loads the archive in this
process, runs it on the
example batch and prints ``verify: output <shape> <dtype>`` and the largest
gap to the eager call.  JAX's ``--platform`` has no counterpart (a
``torch.export`` graph is not lowered for a platform).  Without a card and
without ``--cpu`` it raises.
"""
from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Tuple

import numpy as np
import torch

COMPUTE_DTYPE_FILE = "compute_dtype"


def example_batch(cfg, batch_size: int = 1) -> Dict[str, np.ndarray]:
    """JAX's example batch (``tools/export_model.py:64-80``)."""
    B = batch_size
    N = cfg["data_config"].get("Ncams", 1)
    H, W = cfg["data_config"]["input_size"]
    eye3 = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intrins = eye3.copy()
    intrins[..., 0, 0] = 500.0
    intrins[..., 1, 1] = 500.0
    return {
        "imgs": np.zeros((B, N, H, W, 3), np.float32),
        "rots": eye3,
        "trans": np.zeros((B, N, 3), np.float32),
        "intrins": intrins,
        "post_rots": eye3.copy(),
        "post_trans": np.zeros((B, N, 3), np.float32),
        "bda": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
    }


class ServingForward(torch.nn.Module):
    """The served function (JAX's ``forward``): the model on a batch dict,
    then the final layer's per-class voxel scores [B, X, Y, Z, C]."""

    def __init__(self, model):
        super().__init__()
        self.model = model

    def forward(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        from ..models.mask2former_head import format_results, mask_logits_from_embeds

        out = self.model(batch)
        final = mask_logits_from_embeds(out["mask_embeds"][-1], out["mask_feature"])
        return format_results(out["cls_preds"][-1], final)


def autocast(device_type: str, compute_dtype: Optional[torch.dtype]):
    """``compute_dtype``'s autocast on ``device_type``; off for None."""
    return torch.autocast(device_type, dtype=compute_dtype or torch.float32,
                          enabled=compute_dtype is not None)


def compute_dtype_of(cfg) -> Optional[torch.dtype]:
    """The config's autocast dtype, None for float32."""
    name = cfg.get("compute_dtype")
    return None if name in (None, "float32") else getattr(torch, name)


def export_serving(model, batch: Dict[str, torch.Tensor],
                   compute_dtype: Optional[torch.dtype] = None):
    """A non-strict ``torch.export`` of ``ServingForward(model)`` at
    ``batch`` (tensors on the model's device) under ``compute_dtype``'s
    autocast (module docstring), without gradients."""
    with torch.no_grad(), autocast(next(model.parameters()).device.type, compute_dtype):
        return torch.export.export(ServingForward(model).eval(), (batch,), strict=False)


def save_exported(ep, path: str, compute_dtype: Optional[torch.dtype]) -> int:
    """Writes the archive with its autocast dtype; returns its bytes."""
    name = str(compute_dtype).replace("torch.", "") if compute_dtype else "float32"
    torch.export.save(ep, path, extra_files={COMPUTE_DTYPE_FILE: name})
    return os.path.getsize(path)


def load_exported(path: str) -> Tuple[object, Optional[torch.dtype]]:
    """(the exported program, its autocast dtype or None); registers the
    port's ops (``occformer_tpu_torch.ops``) first."""
    from .. import ops  # noqa: F401  (registers the occformer ops)

    extra = {COMPUTE_DTYPE_FILE: ""}
    ep = torch.export.load(path, extra_files=extra)
    name = extra[COMPUTE_DTYPE_FILE] or "float32"
    return ep, (None if name == "float32" else getattr(torch, name))


def run_exported(ep, compute_dtype: Optional[torch.dtype],
                 batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The exported program on ``batch`` under its autocast."""
    device_type = next(iter(batch.values())).device.type
    with torch.no_grad(), autocast(device_type, compute_dtype):
        return ep.module()(batch)


def eager_serving(model, batch: Dict[str, torch.Tensor],
                  compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """The eager served function on ``batch`` under ``compute_dtype``'s autocast."""
    with torch.no_grad(), autocast(next(model.parameters()).device.type, compute_dtype):
        return ServingForward(model)(batch)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("config")
    p.add_argument("--out", required=True)
    p.add_argument("--checkpoint", default=None, help="a port step_N checkpoint directory")
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--verify", action="store_true",
                   help="load the archive and re-run it on the example batch")
    p.add_argument("--cpu", action="store_true", help="export on the CPU")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..engine.checkpoint import load_checkpoint
    from ..engine.eval import to_device_batch
    from ..models.detector import build_model

    device = torch.device("cpu" if args.cpu else "cuda")
    cfg = load_config(args.config)
    compute_dtype = compute_dtype_of(cfg)
    model = build_model(cfg["model"], device=device, dtype=torch.float32, seed=0)
    if args.checkpoint:
        load_checkpoint(args.checkpoint, model)
    batch = to_device_batch(example_batch(cfg, args.batch_size), device)
    ep = export_serving(model, batch, compute_dtype)
    size = save_exported(ep, args.out, compute_dtype)
    route = f"{compute_dtype or torch.float32} autocast" if compute_dtype else "float32"
    print(f"wrote {args.out} ({size / 1e6:.2f} MB torch.export archive, {route}, "
          f"torch {torch.__version__})", flush=True)

    if args.verify:
        ep2, dtype = load_exported(args.out)
        out = run_exported(ep2, dtype, batch)
        ref = eager_serving(model, batch, compute_dtype)
        print("verify: output", tuple(out.shape), out.dtype,
              "max_abs_gap_to_eager", (out.float() - ref.float()).abs().max().item(),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
