"""The port's kernels as ``torch.library`` custom ops, namespace ``occformer``.

Every hand-written kernel is one op (``OPS``: kernel -> op).  An op has a
CUDA implementation, the kernel's launcher (its vector width, workspace,
aligned copy and launch count live there), a CPU implementation, the
kernel's plain version, and a fake implementation that gives the output's
shape, dtype and strides, so that ``torch.export`` and ``opcheck`` see the
op without running it.  The op a tensor takes follows its device: a CUDA
tensor never reaches a plain version.  The forwards that train (K1, K2, K4,
S1, S1-rows) link to their backward op (K1-bwd, K2-bwd, K4-bwd, S1-bwd,
S1-rows-bwd) through ``register_autograd``.

A backward op's CPU implementation differentiates the plain version with
autograd (``plain_grads``).  An op's implementation runs below autograd,
so ``plain_grads`` turns autograd back on for its own recompute; it replays
the forward's autocast (``autocast_state``, ``replay_autocast``) and takes
the gradients with autocast off, as a backward outside autocast does, so
that its result has the bits of autograd through the plain version.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

NAMESPACE = "occformer"

# kernel (the launch counts' name) -> its op; a backward op's kernel
# differentiates the forward's
OPS = {"K1": "k1_fwd", "K1-bwd": "k1_bwd", "K2": "k2_fwd", "K2-bwd": "k2_bwd",
       "K3": "k3", "K4": "k4_fwd", "K4-bwd": "k4_bwd", "S1": "s1", "S1-bwd": "s1_bwd",
       "S1-rows": "s1_rows", "S1-rows-bwd": "s1_rows_bwd", "FPS": "fps", "P1": "p1",
       "P2": "p2"}


def qualname(op: str) -> str:
    return f"{NAMESPACE}::{op}"


def autocast_state(device_type: str):
    """(enabled, dtype) of ``device_type``'s autocast."""
    return torch.is_autocast_enabled(device_type), torch.get_autocast_dtype(device_type)


def replay_autocast(device_type: str, state) -> contextlib.AbstractContextManager:
    """A context with ``device_type``'s autocast as ``state`` had it."""
    enabled, dtype = state
    return torch.autocast(device_type, dtype=dtype, enabled=enabled)


@contextlib.contextmanager
def _autograd_on():
    """Autograd for the CPU inside an op's implementation, which runs with
    the autograd dispatch keys excluded."""
    K = torch._C.DispatchKey
    keys = torch._C.DispatchKeySet(K.AutogradCPU) | torch._C.DispatchKeySet(K.ADInplaceOrView)
    with torch._C._ForceDispatchKeyGuard(torch._C._dispatch_tls_local_include_set(),
                                         torch._C._dispatch_tls_local_exclude_set() - keys), \
            torch.enable_grad():
        yield


def plain_grads(fn: Callable, inputs: Sequence[torch.Tensor], wanted: Sequence[bool],
                grads: Sequence[Optional[torch.Tensor]]) -> List[torch.Tensor]:
    """The gradients of ``fn(*inputs)`` (a tensor or a list of them) for the
    ``wanted`` inputs, given the outputs' ``grads``, by autograd through
    ``fn``; an input not wanted, or one the outputs do not reach, gets
    zeros.  ``fn`` reruns under the caller's autocast; the gradients are
    taken with autocast off."""
    with _autograd_on():
        xs = [x.detach().requires_grad_(w) for x, w in zip(inputs, wanted)]
        outs = fn(*xs)
        outs = [outs] if isinstance(outs, torch.Tensor) else list(outs)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        leaves = [x for x, w in zip(xs, wanted) if w]
        got = []
        if pairs and leaves:
            with torch.autocast(inputs[0].device.type, enabled=False):
                got = torch.autograd.grad([o for o, _ in pairs], leaves,
                                          [g for _, g in pairs], allow_unused=True)
    it = iter(got)
    out = []
    for x, w in zip(inputs, wanted):
        g = next(it, None) if w else None
        out.append(torch.zeros_like(x) if g is None else g)
    return out


# the ops without a derivative: the backward ops, K3 (a GT read), P1, P2
NO_DERIVATIVE = ("k1_bwd", "k2_bwd", "k4_bwd", "s1_bwd", "s1_rows_bwd", "k3", "p1", "p2")


def example_inputs(op: str, device="cpu", seed: int = 0) -> tuple:
    """Arguments of ``op`` at a small shape that its CUDA implementation
    takes too (float32, contiguous), from a seeded generator; the floating
    inputs of a forward with a derivative require grad (``opcheck``)."""
    g = torch.Generator().manual_seed(seed)

    def u(*shape, lo=0.0, hi=1.0):
        return (torch.rand(*shape, generator=g) * (hi - lo) + lo).to(device)

    def ints(hi, *shape, dtype=torch.int64):
        return torch.randint(0, hi, shape, generator=g, dtype=dtype).to(device)

    def mask(*shape, p=0.3):
        return (torch.rand(*shape, generator=g) > p).to(device)

    grad = (lambda t: t) if op in NO_DERIVATIVE else (lambda t: t.requires_grad_())
    shapes = [2, 2, 2, 1, 1, 1]  # two levels of (X, Y, Z)
    if op in ("k1_fwd", "k1_bwd"):
        args = (grad(u(1, 9, 2, 8)), grad(u(1, 3, 2, 2, 2, 3)), grad(u(1, 3, 2, 2, 2)))
        return args + ((u(1, 3, 2, 8),) if op == "k1_bwd" else ()) + (shapes,)
    if op == "k2_fwd":
        return grad(u(2, 3, 3, 3, 4)), grad(u(2, 5, 3, lo=-1.1, hi=1.1)), False, "zeros"
    if op == "k2_bwd":
        return u(2, 3, 3, 3, 4), u(2, 5, 3, lo=-1.1, hi=1.1), u(2, 5, 4), True, "border", True
    if op == "k3":
        return (ints(4, 1, 4, 4, 4, dtype=torch.int32),
                torch.tensor([[0, 1, 3]], dtype=torch.int32, device=device), u(1, 5, 3),
                False, "border")
    if op in ("k4_fwd", "k4_bwd"):
        tables = [grad(u(2, 4, 8)), grad(u(2, 1, 4))]  # [G, X*Y, Z*C], C = 4
        coords = [grad(u(2, 5, 3, lo=-1, hi=1)), grad(u(2, 3, 3, lo=-1, hi=1))]
        if op == "k4_fwd":
            return tables, coords, shapes, 4, False
        return tables, coords, [u(2, 4, 5), u(2, 4, 3)], shapes, 4, False, True
    if op in ("s1", "s1_bwd"):
        args = (grad(u(1, 2, 3, 2, 2)), grad(u(1, 2, 2, 2, 4)), ints(2, 1, 2, 3, 2, 2, 3),
                mask(1, 2, 3, 2, 2))
        return args + ((u(8, 4),) if op == "s1_bwd" else ()) + ([2, 2, 2],)
    if op == "s1_rows":
        return grad(u(1, 6, 4)), ints(2, 1, 6, 3), mask(1, 6), [2, 2, 2]
    if op == "s1_rows_bwd":
        return u(8, 4), ints(2, 1, 6, 3), mask(1, 6), [2, 2, 2]
    if op == "fps":
        return u(2, 10, 3), 4, mask(2, 10, p=0.2)
    if op == "p1":
        return (u(5),)
    if op == "p2":
        return u(4, 3), torch.tensor([3, 0, 2, 2, 1], dtype=torch.int32, device=device)
    raise KeyError(op)


def opcheck(op: str, device="cpu", seed: int = 0) -> dict:
    """``torch.library.opcheck`` of ``op``'s implementation for ``device`` at
    ``example_inputs``: the schema, the autograd registration, the fake
    implementation against the real one and, for an op with a derivative,
    an AOT trace with dynamic shapes (which differentiates every floating
    output, so the ops in ``NO_DERIVATIVE`` skip it)."""
    utils = ("test_schema", "test_autograd_registration", "test_faketensor")
    if op not in NO_DERIVATIVE:
        utils += ("test_aot_dispatch_dynamic",)
    return torch.library.opcheck(getattr(getattr(torch.ops, NAMESPACE), op),
                                 example_inputs(op, device, seed), test_utils=utils)


class OpCalls(TorchDispatchMode):
    """Counts the calls of every ``occformer`` op while active, by kernel."""

    def __init__(self):
        super().__init__()
        self.by_op: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == NAMESPACE:
            name = func._schema.name.split("::")[1]
            self.by_op[name] = self.by_op.get(name, 0) + 1
        return func(*args, **(kwargs or {}))

    def counts(self) -> Dict[str, int]:
        """Calls by kernel name (``OPS``' keys), every kernel listed."""
        return {k: self.by_op.get(op, 0) for k, op in OPS.items()}


def graph_op_counts(graph_module) -> Dict[str, int]:
    """The ``occformer`` op call nodes of an exported program's graph (or
    any ``torch.fx.GraphModule``), by kernel name, every kernel listed."""
    by_op: Dict[str, int] = {}
    for node in graph_module.graph.nodes:
        t = node.target
        if node.op == "call_function" and getattr(t, "namespace", None) == NAMESPACE:
            name = t._schema.name.split("::")[1]
            by_op[name] = by_op.get(name, 0) + 1
    return {k: by_op.get(op, 0) for k, op in OPS.items()}
