"""Conv + BatchNorm fusion over a state dict (reference
tools/misc/fuse_conv_bn.py).

Port of ``occformer_tpu/engine/fuse.py``, on a torch state dict: each
BatchNorm that normalizes a convolution's output is folded into that
convolution, and the BatchNorm becomes an exact add, so that the fused
state dict loads strictly into the same model and its eval-mode outputs
equal the unfused model's up to float32 rounding:

  weight' = weight * s,  bias' = bias * s  (per output channel),
  s = gamma / sqrt(var + eps)
  BN      = {weight: 1, bias: beta - mean * s, running_mean: 0,
             running_var: 1 - eps}

so BN(y) = (y - 0) / sqrt((1 - eps) + eps) * 1 + bias' = y + bias'.  (mmcv
rewrites the conv and swaps the BatchNorm for an Identity, which changes the
model's keys.)  Only eval-mode inference is valid afterwards: a train step
would learn through a degenerate BatchNorm.

Pairing, the naming of the reference's (and the port's) modules, as the
JAX package pairs its siblings: a sibling of conv module ``X`` named
``X.replace("conv", "bn")`` or ``X.replace("conv", "norm")``
(conv1 -> bn1 / norm1, reduce_conv -> reduce_bn), or in a Sequential the
module after it (``downsample.0`` -> ``downsample.1``), when that sibling
is a BatchNorm over the conv's output channels.  A conv module is any
module with a ``weight`` of 3 or more dimensions (``nn.Conv*``, the DCN);
a transposed conv (one group) scales its weight's second axis.  Convs with "conv" in
their name and no such BatchNorm are left untouched and reported.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn as nn
from torch.nn.modules.batchnorm import _BatchNorm
from torch.nn.modules.conv import _ConvTransposeNd


def _is_conv(m: nn.Module) -> bool:
    w = getattr(m, "weight", None)
    return isinstance(w, torch.Tensor) and w.dim() >= 3 and not isinstance(m, _BatchNorm)


def conv_bn_pairs(model: nn.Module) -> Tuple[List[Tuple[str, str]], List[str]]:
    """([(conv name, BatchNorm name)], unpaired conv names) of ``model``."""
    pairs, unpaired = [], []
    for parent_name, parent in model.named_modules():
        children = dict(parent.named_children())
        names = list(children)
        for i, name in enumerate(names):
            conv = children[name]
            if not _is_conv(conv):
                continue
            cands = [name.replace("conv", "bn"), name.replace("conv", "norm")]
            if isinstance(parent, nn.Sequential) and i + 1 < len(names):
                cands.append(names[i + 1])
            transposed = isinstance(conv, _ConvTransposeNd)
            if transposed and conv.groups != 1:
                continue
            out_ch = conv.weight.shape[1 if transposed else 0]
            bn = next((c for c in cands if c != name and isinstance(children.get(c), _BatchNorm)
                       and children[c].affine and children[c].num_features == out_ch), None)
            prefix = f"{parent_name}." if parent_name else ""
            if bn is not None:
                pairs.append((prefix + name, prefix + bn))
            elif "conv" in name:
                unpaired.append(prefix + name)
    return pairs, unpaired


def fuse_conv_bn(model: nn.Module, state_dict: Optional[Dict[str, torch.Tensor]] = None
                 ) -> Tuple[Dict[str, torch.Tensor], List[str], List[str]]:
    """Fold every paired BatchNorm of ``model`` into its conv.

    ``state_dict`` (default ``model.state_dict()``) holds the values; the
    model gives the structure and each BatchNorm's eps, so a model built on
    the ``meta`` device serves.  Returns (fused copy of the state dict,
    ``"conv<->bn"`` pairs, unpaired conv names); the input is not changed."""
    sd = {k: v.clone() for k, v in (state_dict or model.state_dict()).items()}
    pairs, unpaired = conv_bn_pairs(model)
    modules = dict(model.named_modules())
    for conv_name, bn_name in pairs:
        conv, bn = modules[conv_name], modules[bn_name]
        w = sd[conv_name + ".weight"]
        mean = sd[bn_name + ".running_mean"].double()
        var = sd[bn_name + ".running_var"].double()
        gamma, beta = sd[bn_name + ".weight"].double(), sd[bn_name + ".bias"].double()
        s = gamma / torch.sqrt(var + bn.eps)
        if isinstance(conv, _ConvTransposeNd):  # weight (in, out, *k), one group
            scale = s.view(1, -1, *[1] * (w.dim() - 2))
        else:                                   # weight (out, in / groups, *k)
            scale = s.view(-1, *[1] * (w.dim() - 1))
        sd[conv_name + ".weight"] = (w.double() * scale).to(w.dtype)
        if conv_name + ".bias" in sd and sd[conv_name + ".bias"] is not None:
            b = sd[conv_name + ".bias"]
            sd[conv_name + ".bias"] = (b.double() * s).to(b.dtype)
        sd[bn_name + ".weight"] = torch.ones_like(sd[bn_name + ".weight"])
        sd[bn_name + ".bias"] = (beta - mean * s).to(sd[bn_name + ".bias"].dtype)
        sd[bn_name + ".running_mean"] = torch.zeros_like(sd[bn_name + ".running_mean"])
        sd[bn_name + ".running_var"] = torch.full_like(sd[bn_name + ".running_var"],
                                                       1.0 - bn.eps)
    return sd, [f"{c}<->{b}" for c, b in pairs], unpaired
