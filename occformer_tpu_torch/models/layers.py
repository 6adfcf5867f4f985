"""Common building blocks of the port.

Port of ``occformer_tpu/models/layers.py``.  Convolutions, norms and linear
layers are torch's own (``nn.Conv2d``, ``nn.BatchNorm2d``, ...), created with
the reference's eps values: BatchNorm 1e-5 (flax ``momentum=0.9`` is torch
``momentum=0.1``), GroupNorm and LayerNorm 1e-5.  What is left here are the
composite bricks, named as the reference's checkpoints name them:

* ``FFN``: mmcv's ``layers.0.0`` (fc1) / ``layers.1`` (fc2);
* ``MultiheadAttention``: torch's packed ``in_proj_weight`` / ``in_proj_bias``
  and ``out_proj``, computed as plain matmuls and a float32 softmax;
* ``Mlp``, ``SELayer`` and ``BasicBlock2D`` of the DepthNet;
* the train-mode pieces: ``BatchNorm1d`` / ``2d`` / ``3d`` with flax's
  running-statistics update (over the global batch under data
  parallelism), ``DropPath`` drawing from an explicit
  generator (``drop_path_generator``), and ``checkpoint``, gradient
  checkpointing that replays those draws when it recomputes;
* ``Conv3dFixedOrderBackward``: an ``nn.Conv3d`` whose backward on the card
  runs cuDNN's deterministic algorithms, and ``Conv2dIm2colBackward``: an
  ``nn.Conv2d`` whose backward is im2col and matrix products, for the
  convolutions whose default backward algorithms vary from run to run
  (ROADMAP C.8).

Every module takes a ``dtype`` for its parameters, as the flax modules take a
compute dtype; float32 islands cast back to it.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from ..parallel.distributed import global_rows, world_size
from ..utils import flops


class _FlaxBatchNorm:
    """Train mode as flax ``nn.BatchNorm``: normalize with the batch's biased
    statistics and move the running mean and variance toward them by
    ``momentum`` (flax ``momentum=0.9`` is torch 0.1).  Torch's own update
    uses the unbiased variance, n / (n - 1) times larger: over the DepthNet's
    camera batch of 6 rows that is 20%.  Eval mode is torch's.

    While a process group of more than one process is active, the statistics
    are those of the global batch, as the JAX package's SPMD step computes
    them: each rank's count, sum and sum of squared deviations are summed
    over ranks by an all-reduce that autograd differentiates
    (``torch.distributed.nn.functional.all_reduce``).  ``nn.SyncBatchNorm``
    does not serve: it runs on CUDA only and moves the running variance
    toward the unbiased one."""

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0] + list(range(2, x.dim()))
        if world_size() > 1:
            return self._global_forward(x, dims)
        with torch.no_grad():
            var, mean = torch.var_mean(x.float(), dim=dims, unbiased=False)
            self.running_mean.lerp_(mean.to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        if x.numel() == x.shape[1]:
            # one value a channel (SemanticKITTI's camera embedding at batch 1,
            # one camera): flax normalizes it to 0, leaving the bias; torch's
            # batch_norm refuses it
            shape = [1, -1] + [1] * (x.dim() - 2)
            dev = x.float() - x.float().mean(dims, keepdim=True)
            y = dev * torch.rsqrt((dev * dev).mean(dims, keepdim=True) + self.eps)
            if self.weight is not None:
                y = y * self.weight.float().view(shape) + self.bias.float().view(shape)
            return y.to(x.dtype)
        return F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0, self.eps)

    def _global_forward(self, x, dims):
        from torch.distributed.nn.functional import all_reduce

        xf = x.float()
        shape = [1, -1] + [1] * (x.dim() - 2)
        count = torch.full((1,), xf.numel() // xf.shape[1], dtype=torch.float32,
                           device=x.device)
        # two passes (the mean, then the squared deviations from it): no
        # cancellation of E[x^2] - mean^2
        sums = all_reduce(torch.cat([xf.sum(dims), count]))
        n = sums[-1]
        mean = sums[:-1] / n
        dev = xf - mean.view(shape)
        var = all_reduce((dev * dev).sum(dims)) / n
        with torch.no_grad():
            self.running_mean.lerp_(mean.detach().to(self.running_mean.dtype), self.momentum)
            self.running_var.lerp_(var.detach().to(self.running_var.dtype), self.momentum)
            self.num_batches_tracked.add_(1)
        y = dev * torch.rsqrt(var + self.eps).view(shape)
        if self.weight is not None:
            y = y * self.weight.float().view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)


class BatchNorm1d(_FlaxBatchNorm, nn.BatchNorm1d):
    pass


class BatchNorm2d(_FlaxBatchNorm, nn.BatchNorm2d):
    pass


class BatchNorm3d(_FlaxBatchNorm, nn.BatchNorm3d):
    pass


_DROP_PATH_GENERATOR: Optional[torch.Generator] = None


@contextlib.contextmanager
def drop_path_generator(generator: Optional[torch.Generator]):
    """Within this context every ``DropPath`` in train mode draws its keep
    masks from ``generator`` (outside it, from torch's default generator)."""
    global _DROP_PATH_GENERATOR
    prev, _DROP_PATH_GENERATOR = _DROP_PATH_GENERATOR, generator
    try:
        yield
    finally:
        _DROP_PATH_GENERATOR = prev


class DropPath(nn.Module):
    """Per-sample stochastic depth (timm; JAX ``layers.py:216-231``): in
    train mode each entry of the leading axis is kept with probability
    1 - rate and scaled by 1 / (1 - rate), else zeroed.

    ``segments`` says how the leading axis holds the batch: blocks one after
    the other, block j holding ``segments[j]`` rows a sample, sample-major
    (the default ``(1,)``: one row a sample).  Under data parallelism each
    rank draws the masks of the global batch's rows, laid out the same way,
    and keeps its own samples' rows: the ranks' masks are one process's on
    the global batch."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x, segments: Sequence[int] = (1,)):
        if not self.training or self.rate == 0.0:
            return x
        keep = 1.0 - self.rate
        g = _DROP_PATH_GENERATOR
        world = world_size()
        shape = (x.shape[0] * world,) + (1,) * (x.dim() - 1)
        u = torch.rand(shape, generator=g, device=g.device if g is not None else x.device)
        if world > 1:
            B = x.shape[0] // sum(segments)
            rows, start = [], 0
            for s in segments:
                rows.append(torch.arange(start, start + world * B * s)[global_rows(B * s)])
                start += world * B * s
            u = u[torch.cat(rows).to(u.device)]
        mask = u.to(x.device) < keep
        return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def checkpoint(fn, *args):
    """``torch.utils.checkpoint`` (non-reentrant) of ``fn(*args)`` that
    replays the ``drop_path_generator`` draws when the backward recomputes
    ``fn``: the recomputation starts from the generator state the first run
    started from, and the generator is put back afterwards, so the masks and
    the rest of the step's draws are those of a run without checkpointing."""
    g = _DROP_PATH_GENERATOR
    if g is None:
        return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)
    start = g.get_state()
    first = [True]

    def run(*a):
        if first[0]:
            first[0] = False
            return fn(*a)
        live = g.get_state()
        g.set_state(start)
        with drop_path_generator(g):
            out = fn(*a)
        g.set_state(live)
        return out

    return torch.utils.checkpoint.checkpoint(run, *args, use_reentrant=False)


def activation(name: str) -> nn.Module:
    # the JAX package's FFN default is flax ``nn.gelu``, the tanh approximation
    if name == "gelu":
        return nn.GELU(approximate="tanh")
    if name == "relu":
        return nn.ReLU()
    raise ValueError(f"unknown activation {name}")


class FFN(nn.Module):
    """fc1 -> act -> fc2, with an optional identity add (mmcv FFN)."""

    def __init__(self, embed_dims: int, feedforward_channels: int, act: str = "gelu",
                 add_identity: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layers = nn.Sequential(
            nn.Sequential(nn.Linear(embed_dims, feedforward_channels, dtype=dtype),
                          activation(act)),
            nn.Linear(feedforward_channels, embed_dims, dtype=dtype),
        )
        self.add_identity = add_identity

    def forward(self, x, identity: Optional[torch.Tensor] = None):
        y = self.layers(x)
        if not self.add_identity:
            return y
        return y + (x if identity is None else identity)


class MultiheadAttention(nn.Module):
    """Batch-first dot-product MHA with torch's packed in-projection.

    ``attn_mask`` [B, 1 or H, Q, K] bool, True = masked out (torch
    convention).  The softmax runs in float32.
    """

    def __init__(self, embed_dims: int, num_heads: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.embed_dims = embed_dims
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dims, embed_dims, dtype=dtype))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dims, dtype=dtype))
        self.out_proj = nn.Linear(embed_dims, embed_dims, dtype=dtype)
        nn.init.xavier_uniform_(self.in_proj_weight)

    def forward(self, query, key, value, attn_mask=None):
        B, Q, C = query.shape
        H = self.num_heads
        hd = C // H
        wq, wk, wv = self.in_proj_weight.chunk(3)
        bq, bk, bv = self.in_proj_bias.chunk(3)
        q = F.linear(query, wq, bq).view(B, Q, H, hd).transpose(1, 2)
        k = F.linear(key, wk, bk).view(B, -1, H, hd).transpose(1, 2)
        v = F.linear(value, wv, bv).view(B, -1, H, hd).transpose(1, 2)
        logits = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd)
        logits = logits.float()
        if attn_mask is not None:
            logits = logits.masked_fill(attn_mask, torch.finfo(torch.float32).min)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, Q, C)
        return self.out_proj(out)


class Mlp(nn.Module):
    """fc -> relu -> fc (reference ViewTransformerLSSBEVDepth.py:410-432)."""

    def __init__(self, in_features: int, hidden_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = nn.Linear(in_features, hidden_features, dtype=dtype)
        self.fc2 = nn.Linear(hidden_features, out_features, dtype=dtype)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class SELayer(nn.Module):
    """``x * sigmoid(expand(relu(reduce(x_se))))`` with 1x1 convs
    (reference ViewTransformerLSSBEVDepth.py:435-447).  x [B, C, H, W],
    x_se [B, C]."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv_reduce = nn.Conv2d(channels, channels, 1, bias=True, dtype=dtype)
        self.conv_expand = nn.Conv2d(channels, channels, 1, bias=True, dtype=dtype)

    def forward(self, x, x_se):
        g = self.conv_expand(F.relu(self.conv_reduce(x_se[:, :, None, None])))
        return x * torch.sigmoid(g)


class BasicBlock2D(nn.Module):
    """conv3x3-BN-relu x 2 + skip (the DepthNet's mmdet BasicBlock)."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv1 = nn.Conv2d(channels, channels, 3, padding=1, bias=False, dtype=dtype)
        self.bn1 = BatchNorm2d(channels, dtype=dtype)
        self.conv2 = nn.Conv2d(channels, channels, 3, padding=1, bias=False, dtype=dtype)
        self.bn2 = BatchNorm2d(channels, dtype=dtype)

    def forward(self, x):
        y = F.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        return F.relu(y + x)


class _ConvFixedOrderBackward(torch.autograd.Function):
    """``F.conv3d`` forward; the backward through ``aten.convolution_backward``
    with ``torch.backends.cudnn.deterministic`` on for that call alone."""

    @staticmethod
    def forward(ctx, x, weight, bias, stride, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.conv = (None if bias is None else [bias.shape[0]], stride, padding, dilation, groups)
        return F.conv3d(x, weight, bias, stride, padding, dilation, groups)

    @staticmethod
    def backward(ctx, gout):
        x, weight = ctx.saved_tensors
        bias_sizes, stride, padding, dilation, groups = ctx.conv
        mask = [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                bias_sizes is not None and ctx.needs_input_grad[2]]
        before = torch.backends.cudnn.deterministic
        torch.backends.cudnn.deterministic = True
        try:
            dx, dw, db = torch.ops.aten.convolution_backward(
                gout, x, weight, bias_sizes, stride, padding, dilation, False,
                [0] * len(stride), groups, mask)
        finally:
            torch.backends.cudnn.deterministic = before
        return dx, dw, db, None, None, None, None


def _autocast_inputs(x, weight, bias):
    """The convolution's inputs as autocast would cast them, and the device
    type, whose autocast the caller then turns off."""
    dev = x.device.type
    if torch.is_autocast_enabled(dev):
        dt = torch.get_autocast_dtype(dev)
        x, weight = x.to(dt), weight.to(dt)
        bias = None if bias is None else bias.to(dt)
    return x, weight, bias, dev


def conv3d_fixed_order_backward(x, weight, bias=None, stride=(1, 1, 1), padding=(0, 0, 0),
                                dilation=(1, 1, 1), groups=1):
    """``F.conv3d(x, weight, bias, ...)`` whose backward takes cuDNN's
    deterministic algorithms (on any device; on the CPU the same
    ``convolution_backward`` as autograd's).  Under autocast its inputs are
    cast as autocast casts a convolution's."""
    x, weight, bias, dev = _autocast_inputs(x, weight, bias)
    with torch.autocast(dev, enabled=False):
        return _ConvFixedOrderBackward.apply(x, weight, bias, tuple(stride), tuple(padding),
                                             tuple(dilation), groups)


class Conv3dFixedOrderBackward(nn.Conv3d):
    """``nn.Conv3d`` (same parameters and names) whose backward on the card
    runs cuDNN's deterministic algorithms, scoped to this convolution: at
    some shapes cuDNN's default backward algorithms give other bits from run
    to run (ROADMAP C.8), while turning ``cudnn.deterministic`` on for the
    whole step sends other convolutions to much slower kernels.  On the CPU,
    and without autograd, it is ``nn.Conv3d``.  Zeros padding only."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self.padding_mode != "zeros":
            raise ValueError("Conv3dFixedOrderBackward takes zeros padding")

    def forward(self, x):
        if not (x.is_cuda and torch.is_grad_enabled()):
            return super().forward(x)
        return conv3d_fixed_order_backward(x, self.weight, self.bias, self.stride, self.padding,
                                           self.dilation, self.groups)


class _Conv2dIm2colBackward(torch.autograd.Function):
    """``F.conv2d`` forward (stride 1, one group, "same" padding); the
    backward as im2col (``F.unfold``) and matrix products, which sum in a
    fixed order: the input's gradient is the convolution of the output's
    gradient with the kernel flipped and transposed, the weight's the
    product of the output's gradient with the input's columns."""

    @staticmethod
    def forward(ctx, x, weight, bias, padding, dilation):
        ctx.save_for_backward(x, weight)
        ctx.conv = (padding, dilation, bias is not None)
        return F.conv2d(x, weight, bias, 1, padding, dilation)

    @staticmethod
    def backward(ctx, gout):
        x, weight = ctx.saved_tensors
        padding, dilation, has_bias = ctx.conv
        B, O, H, W = gout.shape
        kh, kw = weight.shape[2:]
        I = weight.shape[1]
        dx = dw = db = None
        need = ctx.needs_input_grad
        # the analytic count sees a convolution's backward, as on the CPU
        flops.add("conv", flops.convolution_backward_flops(
            gout.shape, x.shape, weight.shape, False, 1, need[0], need[1]))
        with flops.uncounted():
            if need[0]:
                w_t = weight.flip(2, 3).transpose(0, 1).reshape(I, O * kh * kw)
                cols = F.unfold(gout, (kh, kw), dilation=dilation, padding=padding)
                dx = torch.matmul(w_t, cols).reshape(B, I, H, W)
            if need[1]:
                cols = F.unfold(x, (kh, kw), dilation=dilation, padding=padding)  # [B, I*kh*kw, HW]
                g = gout.reshape(B, O, H * W).transpose(0, 1).reshape(O, B * H * W)
                dw = torch.matmul(g, cols.transpose(1, 2).reshape(B * H * W, I * kh * kw))
                dw = dw.reshape(O, I, kh, kw)
        if has_bias and ctx.needs_input_grad[2]:
            db = gout.sum((0, 2, 3))
        return dx, dw, db, None, None


def conv2d_im2col_backward(x, weight, bias=None, padding=(0, 0), dilation=(1, 1)):
    """``F.conv2d(x, weight, bias, 1, padding, dilation)`` for a stride-1,
    one-group convolution with "same" padding (``dilation * (k - 1) / 2``),
    whose backward is im2col and matrix products (on any device).  Under
    autocast its inputs are cast as autocast casts a convolution's."""
    x, weight, bias, dev = _autocast_inputs(x, weight, bias)
    with torch.autocast(dev, enabled=False):
        return _Conv2dIm2colBackward.apply(x, weight, bias, tuple(padding), tuple(dilation))


class Conv2dIm2colBackward(nn.Conv2d):
    """``nn.Conv2d`` (same parameters and names; stride 1, one group, odd
    kernel, "same" padding) whose backward on the card is im2col and matrix
    products: at the DepthNet's shapes cuDNN's default backward of its
    dilated convolutions gives other bits from run to run, and its
    deterministic one is several times slower (ROADMAP C.8).  On the CPU,
    and without autograd, it is ``nn.Conv2d``."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        same = all(p == d * (k - 1) // 2 and k % 2 == 1 for p, d, k in
                   zip(self.padding, self.dilation, self.kernel_size))
        if self.stride != (1, 1) or self.groups != 1 or not same \
                or self.padding_mode != "zeros":
            raise ValueError("Conv2dIm2colBackward takes stride 1, one group, an odd kernel "
                             "and zeros 'same' padding")

    def forward(self, x):
        if not (x.is_cuda and torch.is_grad_enabled()):
            return super().forward(x)
        return conv2d_im2col_backward(x, self.weight, self.bias, self.padding, self.dilation)
