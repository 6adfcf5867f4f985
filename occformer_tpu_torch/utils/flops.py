"""Analytic FLOP count of a PyTorch call, and MFU.

Port of ``occformer_tpu/utils/flops.py``.  ``count_flops(fn, *args)`` runs
``fn(*args)`` under a ``TorchDispatchMode`` and sums, over every
compute-bearing aten operator it dispatches (forward and, where ``fn``
differentiates, backward), the JAX package's textbook formula at the
operator's shapes:

  * matrix products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, ``mv``,
    ``addmv``, ``dot``; ``linear``, ``matmul`` and ``einsum`` reach aten as
    these):  2·B·M·N·K
  * convolutions (``convolution``, grouped, dilated and transposed ones
    alike):  2·|out|·(kernel volume)·C_in/groups, and their backward
    (``convolution_backward``) as JAX's VJP counts its two transposed
    convolutions: the input's gradient 2·|input|·(kernel volume)·C_out/groups,
    the kernel's gradient the forward's count
  * scatter-adds (``index_add``, ``scatter_add``, ``index_put`` with
    ``accumulate``):  the number of updates

Like JAX's, it counts only the MAC-bearing operators (the MFU convention:
elementwise, softmax and norm FLOPs are left out).  The count does not
depend on the route: the port's kernels are ``torch.library`` ops inside
which no dispatch mode sees (on the card a ctypes launch, on the CPU the
plain version), so the wrappers whose plain versions reach a counted
operator report that operator's count themselves (``add``) and code that runs a
counted operator as an implementation detail of an uncounted function
holds it out (``uncounted``), so that a call counted on the card with the
kernels gives the CPU's count with the plain versions.  The forward that
the backward reruns for a ``with_cp`` block (``models/layers.py:checkpoint``)
is held out too: a step counts the same model FLOPs with checkpointing as
without, as JAX's count of ``nn.remat`` does.

Unlike JAX's, which traces, the count runs ``fn``: on the card or the CPU,
with the inputs' values (a data-dependent shape counts what this call ran).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from .timing import H100_BF16_FLOP_PER_S

aten = torch.ops.aten
CATEGORIES = ("dot", "conv", "scatter")


def _numel(shape) -> int:
    return int(math.prod(shape))


def _mm(args, kwargs, out):  # [M, K] @ [K, N]
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * b.shape[1]


def _addmm(args, kwargs, out):  # c + [M, K] @ [K, N]
    return _mm(args[1:], kwargs, out)


def _bmm(args, kwargs, out):  # [B, M, K] @ [B, K, N]
    a, b = args[0], args[1]
    return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]


def _baddbmm(args, kwargs, out):
    return _bmm(args[1:], kwargs, out)


def _mv(args, kwargs, out):  # [M, K] @ [K]
    return 2 * args[0].shape[0] * args[0].shape[1]


def _addmv(args, kwargs, out):
    return _mv(args[1:], kwargs, out)


def _dot(args, kwargs, out):
    return 2 * args[0].shape[0]


def _conv_flops(out_shape, weight_shape, transposed: bool, groups: int) -> int:
    """2·|out|·(kernel volume)·C_in/groups; ``weight_shape`` is
    [C_out, C_in/groups, *k], or [C_in, C_out/groups, *k] when
    ``transposed``."""
    k = _numel(weight_shape[2:])
    c_in_per_group = weight_shape[0] // groups if transposed else weight_shape[1]
    return 2 * _numel(out_shape) * k * c_in_per_group


def _convolution(args, kwargs, out):
    # input, weight, bias, stride, padding, dilation, transposed, output_padding, groups
    return _conv_flops(out.shape, args[1].shape, bool(args[6]), int(args[8]))


def convolution_backward_flops(grad_out_shape, input_shape, weight_shape, transposed: bool,
                               groups: int, input_grad: bool, weight_grad: bool) -> int:
    """``aten.convolution_backward``'s count: the input's gradient, a
    convolution back to the input's shape, 2·|input|·(kernel
    volume)·C_out/groups; the kernel's gradient the forward's count."""
    n = 0
    if input_grad:
        k = _numel(weight_shape[2:])
        c_out_per_group = weight_shape[1] if transposed else weight_shape[0] // groups
        n += 2 * _numel(input_shape) * k * c_out_per_group
    if weight_grad:
        n += _conv_flops(grad_out_shape, weight_shape, transposed, groups)
    return n


def _convolution_backward(args, kwargs, out):
    # grad_output, input, weight, bias_sizes, stride, padding, dilation,
    # transposed, output_padding, groups, output_mask
    mask = args[10]
    return convolution_backward_flops(args[0].shape, args[1].shape, args[2].shape,
                                      bool(args[7]), int(args[9]), mask[0], mask[1])


def _index_add(args, kwargs, out):  # self, dim, index, source
    return args[3].numel() if args[3].dim() else args[2].numel()


def _scatter_add(args, kwargs, out):  # self, dim, index, src
    return args[2].numel()


def _index_put(args, kwargs, out):  # self, indices, values, accumulate
    accumulate = args[3] if len(args) > 3 else kwargs.get("accumulate", False)
    if not accumulate:
        return 0
    self, indices = args[0], [i for i in args[1] if i is not None]
    if indices and indices[0].dtype == torch.bool:
        lead = int(indices[0].sum())
        rest = self.shape[indices[0].dim():]
    else:
        lead = _numel(torch.broadcast_shapes(*[i.shape for i in indices]))
        rest = self.shape[len(args[1]):]
    return lead * _numel(rest)


_RULES: Dict[Any, tuple] = {
    aten.mm: ("dot", _mm), aten.addmm: ("dot", _addmm), aten.bmm: ("dot", _bmm),
    aten.baddbmm: ("dot", _baddbmm), aten.mv: ("dot", _mv), aten.addmv: ("dot", _addmv),
    aten.dot: ("dot", _dot), aten.vdot: ("dot", _dot),
    aten.convolution: ("conv", _convolution),
    aten.convolution_backward: ("conv", _convolution_backward),
    aten.index_add: ("scatter", _index_add), aten.index_add_: ("scatter", _index_add),
    aten.scatter_add: ("scatter", _scatter_add), aten.scatter_add_: ("scatter", _scatter_add),
    aten.index_put: ("scatter", _index_put), aten.index_put_: ("scatter", _index_put),
    aten._index_put_impl_: ("scatter", _index_put),
}


class FlopCounter(TorchDispatchMode):
    """Sums the counted operators' FLOPs by category while active (also in
    a backward that autograd runs on its own threads, which inherit the
    mode)."""

    def __init__(self):
        super().__init__()
        self.counts = dict.fromkeys(CATEGORIES, 0)
        self.held_out = 0  # > 0 inside ``uncounted``

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        rule = _RULES.get(func.overloadpacket)
        if rule is not None and not self.held_out:
            self.counts[rule[0]] += rule[1](args, kwargs, out)
        return out


def _active():
    return [m for m in _get_current_dispatch_mode_stack() if isinstance(m, FlopCounter)]


def add(category: str, flops: int) -> None:
    """Adds ``flops`` of ``category`` to every active count: for a kernel
    whose plain version reaches a counted operator, the count of that
    operator."""
    if category not in CATEGORIES:
        raise ValueError(f"category must be one of {CATEGORIES}; got {category!r}")
    for m in _active():
        if not m.held_out:
            m.counts[category] += int(flops)


@contextlib.contextmanager
def uncounted():
    """Holds the operators run inside out of every active count."""
    active = _active()
    for m in active:
        m.held_out += 1
    try:
        yield
    finally:
        for m in active:
            m.held_out -= 1


def count_flops(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Runs ``fn(*args, **kwargs)`` and returns its analytic FLOP breakdown:
    ``{"dot", "conv", "scatter", "total", "notes"}``."""
    counter = FlopCounter()
    with counter:
        fn(*args, **kwargs)
    counts = dict(counter.counts)
    counts["total"] = sum(counts.values())
    return {**counts, "notes": []}


# Dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet, at its
# full 700 W power limit): MFU = achieved model FLOP/s over this.
H100_PEAK_BF16 = H100_BF16_FLOP_PER_S


def mfu(model_flops_per_step: float, steps_per_sec: float,
        peak: float = H100_PEAK_BF16) -> float:
    return model_flops_per_step * steps_per_sec / peak
