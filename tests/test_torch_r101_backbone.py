"""The R101-DCN backbone's pieces in the port against the JAX package, on the CPU.

JAX's parameters are carried into the port by the port's converter
(``engine/convert_weights.py:flax_to_torch_state_dict``, which inverts the
forward conversion of a probe state dict: ``convert_dcn`` with mmcv's
``conv_offset`` channel order for a DCN, ``convert_resnet`` for a block or a
ResNet), and the inputs come from a seeded numpy generator:

* ``models/dcn.py:DeformConv2d`` against ``occformer_tpu/models/dcn.py`` at
  modulated / unmodulated x stride 1 / 2 x deform groups 1 / 2: the output
  within ``1e-5 * max|ref|`` and the gradients of the input, the weight and
  the offsets' conv within ``1e-4 * max|ref|`` (the same float32 math in
  another summation order); the carried ``conv_offset`` is mmcv's layout
  (interleaved (dy, dx) a tap, the mask third after all offsets), held
  against ``tests/test_dcn_convert.py:_mmcv_deform_conv_np``, mmcv's
  semantics in float64, within ``1e-4 * max|ref|``; at a one-row input the
  port's gradients are finite, where JAX's are NaN (its ``jnp.where`` over a
  division by H - 1 = 0, ``occformer_tpu/models/dcn.py:78``).
* A caffe-style ``Bottleneck`` (the stride on its first 1x1) and a
  ``BasicResBlock``, each with a DCNv2 ``conv2``, in eval and train mode:
  outputs within ``1e-5``, gradients within ``1e-4`` of max |ref|.
* ResNet-18 and ResNet-50 with ``dcn_stages=(2, 3)``, caffe style,
  ``frozen_stages=1``, ``norm_eval`` and ``with_cp``: in eval mode every
  stage's output within ``1e-4 * max|ref|``; in train mode the stages'
  outputs and every parameter's gradient of a probe loss within ``1e-4 *
  max|ref|`` (float32 through 16-33 layers), the frozen stem and layer1
  without gradient, every BatchNorm on its running statistics, which do
  not move.

One CPU thread, as the port's other DCN tests run: the gradients pass
thousands of ReLUs, and where a pre-activation lies within float32 rounding
of 0, a summation order that rounds it to the other side moves the
gradients behind it.  (On two threads the port's convolutions sum ResNet-50's
layer3 in another order, one of its ReLUs flips, and layer2's gradients move
by 1e-3 of their scale, while the port's float64 run agrees with JAX's
float32 one within 3e-6.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.models.dcn import DeformConv2d as JaxDCN
from occformer_tpu.models.resnet import BasicResBlock as JaxBasic
from occformer_tpu.models.resnet import Bottleneck as JaxBottleneck
from occformer_tpu.models.resnet import ResNet as JaxResNet
from occformer_tpu_torch.engine.convert_weights import (
    TreeBuilder,
    convert_dcn,
    flax_to_torch_state_dict,
    resnet_tree,
)
from occformer_tpu_torch.models.dcn import DeformConv2d
from occformer_tpu_torch.models.resnet import BasicResBlock, Bottleneck, ResNet
from test_dcn_convert import _mmcv_deform_conv_np


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rel * scale, f"{name}: max|diff| {err} > {rel} * {scale}"


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1)))


def _nhwc(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


class _Holder(torch.nn.Module):
    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


def _random_variables(variables, rng):
    """Random values for a JAX variable tree (given or only shaped):
    kernels scaled by 1/sqrt(fan_in), the DCN offsets' of a few pixels,
    BatchNorm statistics and affines away from their init (so that eval
    mode's normalization is exercised), embeddings and tables N(0, 0.25)."""
    def leaf(path, v):
        return np.asarray(draw(jax.tree_util.keystr(path), v), np.float32)

    def draw(name, v):
        if "conv_offset" in name:
            return rng.uniform(-0.1 if "kernel" in name else -1.5,
                               0.1 if "kernel" in name else 1.5, v.shape)
        if "'kernel'" in name or "'weight'" in name:
            return (rng.randn(*v.shape) / np.sqrt(np.prod(v.shape[:-1])))
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, v.shape)
        if "'mean'" in name or "'bias'" in name:
            return (0.2 * rng.randn(*v.shape))
        if "'scale'" in name:
            return rng.uniform(0.5, 1.5, v.shape)
        return 0.5 * rng.randn(*v.shape)  # embeddings and tables
    return jax.tree_util.tree_map_with_path(leaf, variables)


# ---------------------------------------------------------------------------
# DCNv2
# ---------------------------------------------------------------------------

C_IN, C_OUT, HW = 8, 6, (9, 11)


def _dcn_tree(modulated, deform_groups):
    """``convert_dcn`` of a ``_Holder(dcn=DeformConv2d)`` state dict."""
    def convert(sd):
        tb = TreeBuilder()
        convert_dcn(tb, sd, "dcn", "dcn", modulated=modulated, deform_groups=deform_groups)
        return {"params": tb.params["dcn"], "batch_stats": {}}
    return convert


def _dcn_pair(modulated, stride, deform_groups, seed=0, hw=HW):
    """JAX's DCN with random offsets of a few pixels (taps off the grid and
    outside it) and the port's, carried from it."""
    rng = np.random.RandomState(seed)
    x = rng.randn(2, *hw, C_IN).astype(np.float32)
    jm = JaxDCN(C_OUT, kernel_size=3, strides=(stride, stride), deform_groups=deform_groups,
                modulated=modulated)
    params = _random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x), rng)["params"]
    tm = _Holder(dcn=DeformConv2d(C_IN, C_OUT, 3, stride=stride, padding=1,
                                  deform_groups=deform_groups, modulated=modulated))
    tm.load_state_dict(flax_to_torch_state_dict(
        {"params": params}, tm, convert=_dcn_tree(modulated, deform_groups)), strict=True)
    return x, jm, params, tm.dcn


def _jax_grads(jm, variables, x, probe, **kw):
    """JAX's output and the gradients of sum(output * probe) in the
    parameters and the input, one compile."""
    def loss(params, xj):
        out = jm.apply(dict(variables, params=params), xj, **kw)
        out = out[0] if kw else out
        return jnp.sum(out * probe), out

    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(
        variables["params"], x)
    return out, grads


@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("modulated", [True, False])
def test_dcn_matches_jax(modulated, stride, deform_groups):
    x, jm, params, dcn = _dcn_pair(modulated, stride, deform_groups)
    oh, ow = ((n - 1) // stride + 1 for n in HW)
    probe = np.random.RandomState(1).randn(2, oh, ow, C_OUT).astype(np.float32)
    ref, (d_params, d_x) = _jax_grads(jm, {"params": params}, x, probe)

    xt = _nchw(x).requires_grad_(True)
    out = dcn(xt)
    (out * _nchw(probe)).sum().backward()
    _close(_nhwc(out), ref, 1e-5, "output")
    _close(_nhwc(xt.grad), d_x, 1e-4, "d_input")
    grads = _dcn_tree(modulated, deform_groups)(
        {"dcn." + k: p.grad.numpy() for k, p in dcn.named_parameters()})["params"]
    got = dict(jax.tree_util.tree_leaves_with_path(grads))
    want = jax.tree_util.tree_leaves_with_path(d_params)
    assert len(got) == len(want) == 3
    for path, g in want:
        _close(got[path], g, 1e-4, jax.tree_util.keystr(path))
    assert np.abs(dcn.conv_offset.weight.grad.numpy()).max() > 0


@pytest.mark.parametrize("deform_groups", [1, 2])
@pytest.mark.parametrize("modulated", [True, False])
def test_carried_conv_offset_is_mmcvs_layout(modulated, deform_groups):
    """The port's ``conv_offset`` as the converter fills it is mmcv's: the
    JAX kernel's [dy(K^2), dx(K^2), mask(K^2)] blocks a group land on
    channels ``g * 2K^2 + 2k + {0, 1}`` and ``2GK^2 + g * K^2 + k``, and the
    port's output equals mmcv's semantics on those weights (float64 numpy)."""
    stride = 2
    x, _, params, dcn = _dcn_pair(modulated, stride, deform_groups, seed=3)
    KK, G, T = 9, deform_groups, 3 if modulated else 2
    kernel = params["conv_offset"]["Conv_0"]["kernel"]  # [K, K, Cin, G*T*KK], JAX's order
    w = dcn.conv_offset.weight.detach().numpy()  # [G*T*KK, Cin, K, K], mmcv's order
    for g in range(G):
        for t in range(T):
            for k in range(KK):
                mmcv = g * 2 * KK + 2 * k + t if t < 2 else 2 * G * KK + g * KK + k
                np.testing.assert_array_equal(
                    w[mmcv], kernel[..., g * T * KK + t * KK + k].transpose(2, 0, 1))
    ref = _mmcv_deform_conv_np(
        np.moveaxis(x, -1, 1).astype(np.float64), dcn.weight.detach().numpy(), None,
        w.astype(np.float64), dcn.conv_offset.bias.detach().numpy().astype(np.float64),
        modulated, deform_groups=deform_groups, stride=stride)
    with torch.no_grad():
        got = dcn(_nchw(x)).numpy()
    _close(got, ref, 1e-4, "mmcv semantics")


def test_dcn_at_one_row_has_finite_gradients():
    """A 1 x W input: the forward equals JAX's; the port's gradients are
    finite (JAX's are NaN there: ``jnp.where`` differentiates both of its
    branches, one of them py / (H - 1))."""
    x, jm, params, dcn = _dcn_pair(True, 1, 1, seed=4, hw=(1, 5))
    ref, (_, d_x) = _jax_grads(jm, {"params": params}, x, np.ones((2, 1, 5, C_OUT), np.float32))
    xt = _nchw(x).requires_grad_(True)
    out = dcn(xt)
    _close(_nhwc(out), ref, 1e-5, "output")
    out.sum().backward()
    assert all(torch.isfinite(t).all() for t in [xt.grad] + [p.grad for p in dcn.parameters()])
    assert np.isnan(np.asarray(d_x)).any()  # the reference's fault, not copied


# ---------------------------------------------------------------------------
# blocks and the ResNet
# ---------------------------------------------------------------------------

def _block_tree(sd):
    """``convert_resnet`` of one block's state dict (as ``layer1.0``, with
    a stem of zeros that the block does not use)."""
    full = {"layer1.0." + k: v for k, v in sd.items()}
    full["conv1.weight"] = np.zeros((1, 3, 1, 1))
    for k in ("weight", "bias", "running_mean", "running_var"):
        full[f"bn1.{k}"] = np.zeros(1)
    tree = resnet_tree(full)
    return {"params": tree["params"]["layer1_0"], "batch_stats": tree["batch_stats"]["layer1_0"]}


def _grads_match(model, d_params, batch_stats, convert, rel, frozen=()):
    """Every parameter's gradient against JAX's (in the port's layout)."""
    want = flax_to_torch_state_dict({"params": d_params, "batch_stats": batch_stats}, model,
                                    convert=convert)
    for k, p in model.named_parameters():
        if k.split(".")[0] in frozen:
            assert p.grad is None, k
            assert np.abs(want[k].numpy()).max() == 0, k
            continue
        _close(p.grad.numpy(), want[k].numpy(), rel, k)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("kind", ["caffe_bottleneck", "basic"])
def test_dcn_blocks_match_jax(kind, train):
    rng = np.random.RandomState(5)
    planes, stride = 4, 2
    if kind == "basic":
        cin = 8
        jm = JaxBasic(planes, stride=stride, has_downsample=True, with_dcn=True, train=train)
        tm = BasicResBlock(cin, planes, stride=stride, downsample=True, with_dcn=True)
    else:
        cin = 8
        jm = JaxBottleneck(planes, stride=stride, has_downsample=True, with_dcn=True,
                           style="caffe", train=train)
        tm = Bottleneck(cin, planes, stride=stride, downsample=True, with_dcn=True,
                        style="caffe")
        assert tm.conv1.stride == (2, 2) and tm.conv2.stride == 1
    x = rng.randn(2, 10, 12, cin).astype(np.float32)
    variables = _random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(1), x), rng)
    tm.load_state_dict(flax_to_torch_state_dict(variables, tm, convert=_block_tree),
                       strict=True)
    tm.train(train)
    probe = rng.randn(2, 5, 6, planes * tm.expansion).astype(np.float32)
    ref, (d_params, d_x) = _jax_grads(jm, variables, x, probe, mutable=["batch_stats"])
    xt = _nchw(x).requires_grad_(True)
    out = tm(xt)
    (out * _nchw(probe)).sum().backward()
    _close(_nhwc(out), ref, 1e-5, "output")
    _close(_nhwc(xt.grad), d_x, 1e-4, "d_input")
    _grads_match(tm, d_params, variables["batch_stats"], _block_tree, 1e-4)


@pytest.mark.parametrize("depth", [18, 50])
def test_resnet_with_dcn_stages_matches_jax(depth):
    """Eval mode, then train mode with the R101-DCN config's settings:
    caffe style, ``frozen_stages=1``, ``norm_eval``, ``with_cp``."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    kw = dict(depth=depth, dcn_stages=(2, 3), style="caffe", frozen_stages=1, norm_eval=True)
    # JAX's with_cp is a remat: the same numbers, a longer compile
    jm = JaxResNet(**kw, train=True)
    variables = _random_variables(jax.eval_shape(jm.init, jax.random.PRNGKey(2), x), rng)
    tm = ResNet(**kw, with_cp=True)
    tm.load_state_dict(flax_to_torch_state_dict(variables, tm, convert=resnet_tree),
                       strict=True)
    assert [type(b.conv2).__name__ for b in tm.layer3] == ["DeformConv2d"] * len(tm.layer3)
    assert type(tm.layer2[0].conv2).__name__ == "Conv2d"
    widths = [c * (4 if depth == 50 else 1) for c in (64, 128, 256, 512)]
    probes = [rng.randn(1, 64 >> (i + 2), 96 >> (i + 2), c).astype(np.float32)
              for i, c in enumerate(widths)]

    def loss(params):
        outs, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           x, mutable=["batch_stats"])
        return sum(jnp.sum(o * p) for o, p in zip(outs, probes)), outs

    (_, refs), d_params = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    # under norm_eval every BatchNorm keeps its running statistics, so
    # JAX's train-mode stages are also its eval-mode ones
    tm.eval()
    with torch.no_grad():
        gots = tm(_nchw(x))
    assert len(gots) == len(refs) == 4
    for i, (g, r) in enumerate(zip(gots, refs)):
        _close(_nhwc(g), r, 1e-4, f"eval stage {i}")

    tm.train()
    assert not any(m.training for m in tm.modules() if isinstance(m, torch.nn.BatchNorm2d))
    stats = {k: v.clone() for k, v in tm.state_dict().items() if "running" in k}
    gots = tm(_nchw(x))
    sum((g * _nchw(p)).sum() for g, p in zip(gots, probes)).backward()
    for i, (g, r) in enumerate(zip(gots, refs)):
        _close(_nhwc(g), r, 1e-4, f"train stage {i}")
    assert gots[0].grad_fn is None  # layer1 is frozen
    _grads_match(tm, d_params, variables["batch_stats"], resnet_tree, 1e-4,
                 frozen=("conv1", "bn1", "layer1"))
    assert all(torch.equal(v, tm.state_dict()[k]) for k, v in stats.items())
