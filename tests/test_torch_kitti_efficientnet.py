"""The port's EfficientNet against the JAX package's, on the CPU.

``models/efficientnet.py:CustomEfficientNet`` and the JAX
``occformer_tpu/models/efficientnet.py:CustomEfficientNet`` on the same
weights (the port's, carried into the JAX variables by
``engine/convert_weights.py:convert_efficientnet`` from mmcls names; the
JAX model takes them as its own tree) and the same
images made with numpy from a seed: b0, a narrow width of the same table
(width 0.25, depth 0.4, registered in both packages' ``ARCH_SETTINGS`` for
the test) and the edge variant "es" (EdgeResidual blocks), at odd and even
input sides (the asymmetric "SAME" padding at stride 2), in eval mode and in
train mode (batch statistics; the updated running statistics too).  Every
output within ``1e-4 * max|ref| + 1e-6``: the same float32 convolutions in
other libraries.  Then the scaled layer table equals JAX's for every arch,
and a train-mode backward with ``with_cp`` (the per-block recomputation,
drop path at 0.2) gives the gradients of one without it, bit for bit.
"""
import numpy as np
import pytest
import torch

import jax

import occformer_tpu.models.efficientnet as jax_effnet
import occformer_tpu_torch.models.efficientnet as effnet
from occformer_tpu_torch.engine.convert_weights import TreeBuilder, convert_efficientnet
from occformer_tpu_torch.models.layers import drop_path_generator

OUT = (2, 3, 4, 5, 6)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def narrow_arch(monkeypatch):
    for table in (jax_effnet.ARCH_SETTINGS, effnet.ARCH_SETTINGS):
        monkeypatch.setitem(table, "bt", (0.25, 0.4))


def jax_variables(module, seed):
    """``module``'s weights, BatchNorm scales, biases and statistics set away
    from their init from ``seed`` (so that deep features keep their scale),
    and the same weights as the JAX model's variables through the
    converter (``convert_efficientnet``: mmcls names -> the flax tree)."""
    rng = np.random.RandomState(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.copy_(torch.from_numpy(rng.uniform(0.8, 1.6, m.weight.shape)))
                m.bias.copy_(torch.from_numpy(0.1 * rng.randn(*m.bias.shape)))
                m.running_mean.copy_(torch.from_numpy(0.1 * rng.randn(*m.bias.shape)))
                m.running_var.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, m.bias.shape)))
    tb = TreeBuilder()
    # copies: JAX may read numpy buffers in place while the port's forward
    # updates its running statistics
    convert_efficientnet(tb, {k: v.numpy().copy() for k, v in module.state_dict().items()},
                         "", "bb")
    return {"params": tb.params["bb"], "batch_stats": tb.stats["bb"]}


def _close(got, ref, name):
    ref = np.asarray(ref)
    got = got.detach().permute(0, 2, 3, 1).numpy() if got.dim() == 4 else got.detach().numpy()
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    tol = 1e-4 * np.abs(ref).max() + 1e-6
    err = np.abs(got - ref).max()
    assert err <= tol, f"{name}: max |diff| {err} > {tol}"


@pytest.mark.parametrize("arch", ["b0", "bt", "es"])
@pytest.mark.parametrize("hw", [(64, 96), (65, 95)], ids=["even", "odd"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_efficientnet_matches_jax(narrow_arch, arch, hw, train):
    H, W = hw
    x = np.random.RandomState(0).randn(2, H, W, 3).astype(np.float32)
    jm = jax_effnet.CustomEfficientNet(arch=arch, out_indices=OUT, train=train, with_cp=False)
    torch.manual_seed(0)
    tm = effnet.CustomEfficientNet(arch=arch, out_indices=OUT, with_cp=False)
    variables = jax_variables(tm, 1)
    tm.train(train)
    if train:
        ref, mutated = jax.jit(lambda v, x: jm.apply(v, x, mutable=["batch_stats"]))(
            variables, x)
    else:
        ref = jax.jit(jm.apply)(variables, x)
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(ref) == 5
    for i, (g, r) in enumerate(zip(got, ref)):
        _close(g, r, f"out {i}")
    if train:  # the running statistics after one step, through the converter too
        tb = TreeBuilder()
        convert_efficientnet(tb, {k: v.numpy() for k, v in tm.state_dict().items()}, "", "bb")
        want = jax.tree_util.tree_leaves(mutated["batch_stats"])
        got = jax.tree_util.tree_leaves(tb.stats["bb"])
        assert len(got) == len(want) > 0
        for i, (g, r) in enumerate(zip(got, want)):
            _close(torch.from_numpy(np.asarray(g)), r, f"running statistic {i}")


@pytest.mark.parametrize("arch", sorted(effnet.ARCH_SETTINGS))
def test_scaled_layer_settings_match_jax(arch):
    w, d = effnet.ARCH_SETTINGS[arch]
    assert (w, d) == jax_effnet.ARCH_SETTINGS[arch]
    table = arch[:1]
    assert effnet.scale_layer_settings(effnet.LAYER_SETTINGS[table], w, d) == \
        jax_effnet.scale_layer_settings(jax_effnet.LAYER_SETTINGS[table], w, d)


def test_b7_stages_have_the_kitti_channels():
    m = effnet.CustomEfficientNet(arch="b7", out_indices=OUT, drop_path_rate=0.2)
    with torch.device("meta"):
        outs = effnet.CustomEfficientNet(arch="b7", out_indices=OUT)(
            torch.empty(1, 3, 384, 1280))
    assert [tuple(o.shape[1:]) for o in outs] == [(48, 96, 320), (80, 48, 160),
                                                  (224, 24, 80), (640, 12, 40),
                                                  (2560, 12, 40)]
    assert sum(len(l) for l in m.layers[1:-1]) == 55  # blocks, each with drop path
    rates = [b.drop_path.rate for l in m.layers[1:-1] for b in l]
    assert rates[0] == 0.0 and abs(rates[-1] - 0.2) < 1e-12


def test_with_cp_gives_the_gradients_of_a_run_without_it(narrow_arch):
    """Train mode, drop path 0.2 from one generator state: the per-block
    recomputation replays the drop-path masks, so outputs and every
    gradient equal a run without checkpointing bit for bit."""
    x = torch.from_numpy(np.random.RandomState(2).randn(4, 3, 33, 47).astype(np.float32))
    runs = []
    for with_cp in (False, True):
        torch.manual_seed(0)
        m = effnet.CustomEfficientNet(arch="bt", out_indices=OUT, drop_path_rate=0.2,
                                      with_cp=with_cp).train()
        with drop_path_generator(torch.Generator().manual_seed(7)):
            outs = m(x)
            sum((o * (i + 1)).sum() for i, o in enumerate(outs)).backward()
        runs.append(([o.detach() for o in outs],
                     {k: p.grad.clone() for k, p in m.named_parameters()}))
    (o0, g0), (o1, g1) = runs
    assert all(torch.equal(a, b) for a, b in zip(o0, o1))
    assert g0.keys() == g1.keys() and all(torch.equal(g0[k], g1[k]) for k in g0)
    # the masks were drawn: some branch of a residual block was dropped
    assert any(b.drop_path.rate > 0 for l in m.layers[1:-1] for b in l)
