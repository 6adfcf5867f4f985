"""Pretrained init from torch checkpoints: the backbone's ``pretrained`` and
mmcv's non-strict ``load_from``.

Port of ``occformer_tpu/engine/pretrained.py`` for the three cases of the
reference's configs:

* ``img_backbone.pretrained`` (a torchvision ResNet file, e.g.
  ``ckpts/resnet50-0676ba61.pth``): ``load_backbone_pretrained`` loads its
  keys into ``model.img_backbone``; the classifier's ``fc.*`` stays unused,
  as mmcv's ``strict=False`` leaves it.
* ``img_backbone.init_cfg=dict(type="Pretrained", checkpoint=...,
  prefix="backbone")`` (SemanticKITTI's mmcls EfficientNet-B7 classifier):
  the same, on the file's keys under ``prefix + "."`` with the prefix
  stripped (mmcv's ``init_cfg.prefix``); the classifier's ``head.*`` falls
  outside it, and stages past ``max(out_indices)``, which the backbone
  does not build, are reported unused (reference efficientnet.py:455).
* ``load_from=<raw .pth>`` (e.g. the FCOS3D R101 file, ``img_backbone.*``
  plus an FPN ``img_neck.*``): ``partial_load_torch`` loads every top-level
  subtree whose keys name-match the model and skips the rest, as mmcv's
  ``load_checkpoint(strict=False)`` does.

The port's modules carry the reference's key space, so no conversion is
needed: a load is a name match plus a non-strict ``load_state_dict``.  Each
returns a report: the subtrees loaded and skipped, ``kept_init`` (the
model's keys in a loaded subtree that the file did not fill, a key whose
shape differs among them) and ``unused_keys`` (the file's keys that filled
nothing).  ``init_from_pretrained`` applies what a config declares; a
missing file gives a ``found: False`` report and keeps the random init.
Nothing is downloaded.
"""
from __future__ import annotations

import os
from typing import Any, Dict, List, Optional

import torch


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A torch checkpoint's state dict (``{"state_dict": ...}`` or bare), on
    the CPU.  Reference checkpoints carry mmcv metadata objects beside the
    tensors, so the file is unpickled in full: load only trusted files."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    sd = obj.get("state_dict", obj) if isinstance(obj, dict) else obj
    return {k: torch.as_tensor(v) for k, v in sd.items()}


def _load_matching(module: torch.nn.Module, state_dict: Dict[str, Any], prefix: str = ""):
    """Load the entries of ``state_dict`` whose names and shapes match
    ``module``'s; returns (kept_init, unused_keys), each key with ``prefix``."""
    own = module.state_dict()
    matched, kept, unused = {}, [], []
    for k, v in state_dict.items():
        v = torch.as_tensor(v)
        if k not in own:
            unused.append(prefix + k)
        elif tuple(v.shape) != tuple(own[k].shape):
            kept.append(f"{prefix}{k}: shape {tuple(v.shape)} in the file, "
                        f"{tuple(own[k].shape)} in the model")
            unused.append(prefix + k)
        else:
            matched[k] = v
    kept += [f"{prefix}{k}: not in the file" for k in own if k not in state_dict
             and not k.endswith("num_batches_tracked")]  # a counter, not a weight
    module.load_state_dict(matched, strict=False)
    return kept, unused


def load_backbone_pretrained(model: torch.nn.Module, ckpt_path: str,
                             state_dict: Optional[Dict[str, Any]] = None,
                             prefix: Optional[str] = None) -> Dict[str, Any]:
    """Initialize ``model.img_backbone`` from a standalone backbone
    checkpoint: torchvision-keyed (``conv1.weight``,
    ``layer1.0.bn1.running_mean``, ...) or, with ``prefix``, the keys under
    ``prefix + "."`` with the prefix stripped (an mmcls classifier's
    ``backbone.*``; none there raises).  The file's other keys (a
    classifier's ``fc.*``) are reported as unused."""
    if state_dict is None:
        state_dict = load_torch_state_dict(ckpt_path)
    if prefix:
        p = prefix.rstrip(".") + "."
        state_dict = {k[len(p):]: v for k, v in state_dict.items() if k.startswith(p)}
        if not state_dict:
            raise ValueError(f"prefix {prefix!r} matched no keys in {ckpt_path}")
    kept, unused = _load_matching(model.img_backbone, state_dict)
    return {"source": ckpt_path, "kind": "backbone_init",
            "backbone_type": type(model.img_backbone).__name__, "prefix": prefix,
            "kept_init": kept, "unused_keys": unused}


def partial_load_torch(model: torch.nn.Module, ckpt_path: str,
                       state_dict: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """mmcv's ``load_from=<model>.pth`` with ``strict=False``: every
    top-level subtree of the file (``img_backbone``, ``img_neck``, ...) that
    is a child of ``model`` and fills at least one of its tensors is loaded
    non-strictly; the others are skipped, their keys reported unused."""
    if state_dict is None:
        state_dict = load_torch_state_dict(ckpt_path)
    children = dict(model.named_children())
    groups: Dict[str, Dict[str, Any]] = {}
    for k, v in state_dict.items():
        top, _, rest = k.partition(".")
        groups.setdefault(top, {})[rest] = v
    loaded, skipped, kept, unused = [], [], [], []
    for top in sorted(groups):
        sub = groups[top]
        own = children[top].state_dict() if top in children else {}
        if any(k in own and tuple(torch.as_tensor(v).shape) == tuple(own[k].shape)
               for k, v in sub.items()):
            k_sub, u_sub = _load_matching(children[top], sub, top + ".")
            kept += k_sub
            unused += u_sub
            loaded.append(top)
        else:
            skipped.append(top)
            unused += [f"{top}.{k}" for k in sub]
    return {"source": ckpt_path, "kind": "partial_load", "loaded_subtrees": loaded,
            "skipped_subtrees": skipped, "kept_init": kept, "unused_keys": unused}


def init_from_pretrained(model: torch.nn.Module, model_cfg: Dict,
                         load_from: Optional[str] = None,
                         base_dir: str = ".") -> List[Dict[str, Any]]:
    """Apply every pretrained init the config declares, in mmcv's order:
    ``img_backbone.init_cfg`` (``type="Pretrained"``, its ``checkpoint``
    and ``prefix``) or ``img_backbone.pretrained`` (or the model's
    ``pretrained``), then
    ``load_from`` when it names a raw torch file (``.pth`` / ``.pt``; a
    ``step_N`` directory of the train CLI is a checkpoint, loaded strictly
    by ``engine/checkpoint.py``).  Returns one report per declared file; a
    missing file gives ``{"source", "kind", "found": False}``."""
    reports: List[Dict[str, Any]] = []
    bb = dict(model_cfg.get("img_backbone") or {})
    init_cfg = dict(bb.get("init_cfg") or {})
    if init_cfg and init_cfg.get("type") != "Pretrained":
        raise NotImplementedError(f"img_backbone.init_cfg of type {init_cfg.get('type')!r}")
    ckpt = init_cfg.get("checkpoint") or bb.get("pretrained") or model_cfg.get("pretrained")
    prefix = init_cfg.get("prefix")

    def backbone_init(m, path):
        return load_backbone_pretrained(m, path, prefix=prefix)

    for source, kind, fn in ((ckpt, "backbone_init", backbone_init),
                             (load_from if str(load_from).endswith((".pth", ".pt")) else None,
                              "partial_load", partial_load_torch)):
        if not source:
            continue
        path = source if os.path.isabs(source) else os.path.join(base_dir, source)
        if os.path.isfile(path):
            reports.append(fn(model, path))
        else:
            reports.append({"source": source, "kind": kind, "found": False})
    return reports


def format_report(report: Dict[str, Any]) -> str:
    """The lines a CLI prints for one report."""
    if report.get("found") is False:
        return (f"WARNING: pretrained init {report['source']} not found; keeping the "
                "random init for that part")
    lines = [f"pretrained init from {report['source']} ({report['kind']}): "
             f"loaded {report.get('loaded_subtrees', ['img_backbone'])}, "
             f"skipped {report.get('skipped_subtrees', [])}, "
             f"kept_init={len(report['kept_init'])}, unused_keys={len(report['unused_keys'])}"]
    lines += ["  kept init: " + msg for msg in report["kept_init"]]
    return "\n".join(lines)
