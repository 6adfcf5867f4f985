"""The port's analytic FLOP count (``occformer_tpu_torch/utils/flops.py``)
against the JAX package's (``occformer_tpu/utils/flops.py``).

First the hand-checked cases of ``tests/test_flops.py`` (a matmul, an
attention einsum, a grouped convolution, a loop, a scatter-add counting
updates, a gradient that includes the backward, ``mfu``), then convolutions'
forward and backward against JAX's count of ``jax.grad`` at the same shapes,
then the tiny model (``tests/tiny_cfg.py``) against JAX's ``count_flops`` on
the same configuration, with JAX on its CPU route (``gather_impl="auto"``
resolves to ``"xla"`` there): parameters by component, the deployment
forward (the model, then ``format_results`` of the final layer) and the
train step (``build_train_step`` on both sides).  Where a category cannot be
equal, the test names the difference and holds it to what explains it:

* the DepthNet's two squeeze-excite gates (``models/layers.py:SELayer``) are
  1x1 convolutions on a 1x1 map in the port, as in the reference, and dense
  products in JAX: the same MACs, counted as ``conv`` here and ``dot``
  there, forward and (three times over) in the train step;
* JAX rematerializes its pixel decoder's encoder layers and its head's
  decoder layers (``nn.remat``), so its train step's count repeats their
  forward; the port stores those activations.  The train step is compared
  with JAX's traced with ``nn.remat`` as the identity (the same step
  without the recompute);
* JAX's VJP of every gather (the trilinear corner reads of its XLA
  ``grid_sample_3d`` in the deformable attention and the loss's point
  readouts) is a scatter-add, which JAX counts as updates; the port's
  ``F.grid_sample`` backward is one fused operator that no category counts.
  Indexing's backward (``index_put`` with ``accumulate``) counts on both
  sides.  So the port's train-step scatter is below JAX's; the forward's,
  the LSS splat's updates, is equal.

The full-width flagship's comparison is ``-m slow``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.utils.flops import count_flops as jax_count_flops
from occformer_tpu_torch.utils import flops
from occformer_tpu_torch.utils.flops import H100_PEAK_BF16, count_flops, mfu

COMPONENTS = {"backbone": "img_backbone", "neck": "img_neck",
              "view_transformer": "img_view_transformer",
              "bev_backbone": "img_bev_encoder_backbone", "bev_neck": "img_bev_encoder_neck",
              "head": "pts_bbox_head"}


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# hand-checked formulas (tests/test_flops.py's cases)
# ---------------------------------------------------------------------------

def test_matmul():
    r = count_flops(lambda a, b: a @ b, torch.zeros(8, 16), torch.zeros(16, 32))
    assert r["dot"] == 2 * 8 * 32 * 16
    assert r["total"] == r["dot"]


def test_batched_einsum_attention_shape():
    # attention score einsum BHQD,BHKD->BHQK: 2*B*H*Q*K*D
    B, H, Q, K, D = 2, 4, 16, 24, 32
    r = count_flops(lambda q, k: torch.einsum("bhqd,bhkd->bhqk", q, k),
                    torch.zeros(B, H, Q, D), torch.zeros(B, H, K, D))
    assert r["dot"] == 2 * B * H * Q * K * D


def test_conv_with_groups():
    # grouped conv: 2*|out|*kH*kW*Cin/groups
    conv = torch.nn.Conv2d(8, 16, 3, padding=1, groups=4)
    r = count_flops(conv, torch.zeros(1, 8, 8, 8))
    assert r["conv"] == 2 * (8 * 8 * 16) * 3 * 3 * (8 // 4)


def test_loop_counts_every_iteration():
    # the port's counterpart of a scan: a Python loop runs its body 5 times
    def f(x):
        for _ in range(5):
            x = x @ x
        return x

    assert count_flops(f, torch.zeros(8, 8))["dot"] == 5 * 2 * 8 * 8 * 8


@pytest.mark.parametrize("op", ["index_add_", "index_put_", "scatter_add_"])
def test_scatter_add_counts_updates(op):
    x, i, u = torch.zeros(100, 4), torch.zeros(7, dtype=torch.long), torch.zeros(7, 4)
    call = {"index_add_": lambda: x.index_add_(0, i, u),
            "index_put_": lambda: x.index_put_((i,), u, accumulate=True),
            "scatter_add_": lambda: x.scatter_add_(0, i[:, None].expand(7, 4), u)}[op]
    assert count_flops(call)["scatter"] == 7 * 4
    # a plain index_put_ (no accumulate) is not a scatter-add
    assert count_flops(lambda: x.index_put_((i,), u))["scatter"] == 0


def test_grad_includes_backward():
    # d(xW)/dW backward adds one more matmul of the same size: 2x fwd
    W = torch.zeros(16, 16, requires_grad=True)
    x = torch.zeros(4, 16)

    def loss():
        return (x @ W).sum()

    fwd = count_flops(loss)["dot"]
    both = count_flops(lambda: loss().backward())["dot"]
    assert fwd == 2 * 4 * 16 * 16
    assert both == 2 * fwd  # fwd + dW (x carries no gradient)


def test_counts_the_branch_that_runs():
    # JAX's cond takes the costlier branch; the port runs one and counts it
    def f(p, x):
        return x @ x @ x if p else x

    assert count_flops(f, True, torch.zeros(8, 8))["dot"] == 2 * 2 * 8 * 8 * 8
    assert count_flops(f, False, torch.zeros(8, 8))["dot"] == 0


def test_mfu():
    assert mfu(2e12, 50.0, peak=200e12) == pytest.approx(0.5)
    assert H100_PEAK_BF16 == 989.4e12
    assert mfu(989.4e12, 1.0) == pytest.approx(1.0)


def test_add_and_uncounted_reach_every_active_count():
    """A kernel's wrapper reports its plain version's count (``add``) to
    each active counter, nested ones too; ``uncounted`` holds operators and
    reports out."""
    a = torch.zeros(4, 4)
    with flops.FlopCounter() as outer:
        with flops.FlopCounter() as inner:
            flops.add("dot", 10)
            a @ a
            with flops.uncounted():
                a @ a
                flops.add("scatter", 5)
    for c in (outer, inner):
        assert c.counts == {"dot": 10 + 2 * 4 * 4 * 4, "conv": 0, "scatter": 0}
    flops.add("dot", 1)  # no active count: nothing to do
    with pytest.raises(ValueError):
        flops.add("elementwise", 1)


@pytest.mark.parametrize("stride,groups,dilation,transposed", [
    (1, 1, 1, False), (2, 1, 1, False), (1, 4, 1, False), (1, 1, 2, False),
    (2, 2, 1, True)])
def test_convolution_and_its_backward_match_jax(stride, groups, dilation, transposed):
    """A 2-D convolution's forward and its gradient in the input and the
    kernel, counted as JAX counts ``jax.grad`` of the same convolution:
    strided (the input's gradient a dilated convolution over the input's
    shape), grouped, dilated and transposed."""
    B, C, O, H, W, k = 2, 8, 16, 9, 11, 3
    x = np.random.RandomState(0).randn(B, H, W, C).astype(np.float32)
    if transposed:
        # JAX: a convolution of the input dilated by the stride (lax's
        # conv_transpose); torch's kernel [C_in, C_out/g, k, k]
        jw = np.zeros((k, k, C // groups, O), np.float32)
        w = np.zeros((C, O // groups, k, k), np.float32)

        def jconv(x, w):
            return jax.lax.conv_general_dilated(
                x, w, (1, 1), [(k - 1, k - 1)] * 2, lhs_dilation=(stride, stride),
                dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups)

        def tconv(x, w):
            return torch.nn.functional.conv_transpose2d(x, w, stride=stride, groups=groups)
    else:
        jw = np.zeros((k, k, C // groups, O), np.float32)
        w = np.zeros((O, C // groups, k, k), np.float32)

        def jconv(x, w):
            return jax.lax.conv_general_dilated(
                x, w, (stride, stride), "VALID", rhs_dilation=(dilation, dilation),
                dimension_numbers=("NHWC", "HWIO", "NHWC"), feature_group_count=groups)

        def tconv(x, w):
            return torch.nn.functional.conv2d(x, w, stride=stride, dilation=dilation,
                                              groups=groups)

    ref_fwd = jax_count_flops(jconv, x, jw)["conv"]
    ref_grad = jax_count_flops(jax.grad(lambda x, w: jconv(x, w).sum(), (0, 1)), x, jw)["conv"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    assert count_flops(tconv, xt, wt)["conv"] == ref_fwd
    assert count_flops(lambda: tconv(xt, wt).sum().backward())["conv"] == ref_grad


# ---------------------------------------------------------------------------
# the tiny model against JAX's count
# ---------------------------------------------------------------------------

def _se_layer_flops(model, n_images):
    """The DepthNet's squeeze-excite gates' 1x1 convolutions on a 1x1 map
    (JAX: dense products), forward, for ``n_images`` images."""
    from occformer_tpu_torch.models.layers import SELayer

    return sum(2 * n_images * conv.in_channels * conv.out_channels
               for m in model.modules() if isinstance(m, SELayer)
               for conv in (m.conv_reduce, m.conv_expand))


def _jax_variables(jmodel, batch):
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b: jmodel.init({"params": key, "dropout": key}, b), batch)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), dict(shapes))


def _jax_model(cfg, train):
    from occformer_tpu.models.detector import OccupancyFormer

    return OccupancyFormer(**{k: cfg[k] for k in COMPONENTS.values()}, train=train)


def test_tiny_parameters_and_forward_match_jax():
    from occformer_tpu.models.mask2former_head import format_results as jax_format
    from occformer_tpu.models.mask2former_head import mask_logits_from_embeds as jax_logits
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.tools.model_analysis import forward_flops, param_report

    cfg = tiny_cfg.model_cfg()
    jmodel = _jax_model(cfg, train=False)
    batch = tiny_cfg.make_batch(np.random.RandomState(0))
    variables = _jax_variables(jmodel, batch)

    def fwd(v, b):
        out = jmodel.apply(v, b)
        return jax_format(out["cls_preds"][-1], jax_logits(out["mask_embeds"][-1],
                                                          out["mask_feature"]))

    ref = jax_count_flops(fwd, variables, batch)
    model = build_model(cfg, device="cpu")

    def n_params(tree):
        return sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(tree))

    assert sum(p.numel() for p in model.parameters()) == n_params(variables["params"])
    for jax_name, name in COMPONENTS.items():
        assert sum(p.numel() for p in getattr(model, name).parameters()) == n_params(
            variables["params"][jax_name]), name
    report = param_report(model)
    assert report["total_params_M"] == round(n_params(variables["params"]) / 1e6, 3)

    got = forward_flops(model, batch)
    se = _se_layer_flops(model, tiny_cfg.NUM_CAMS)
    assert se > 0
    assert got["conv"] - ref["conv"] == se and ref["dot"] - got["dot"] == se
    assert got["scatter"] == ref["scatter"] > 0  # the LSS splat's updates
    assert got["total"] == pytest.approx(ref["total"], rel=1e-2)


def test_tiny_train_step_matches_jax(monkeypatch):
    import flax.linen as nn

    from occformer_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from occformer_tpu.engine.optim import step_lr_schedule as jax_step_lr
    from occformer_tpu.engine.train import TrainState
    from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
    from occformer_tpu.engine.train import build_train_step as jax_build_train_step
    from occformer_tpu_torch.engine.optim import build_optimizer, step_lr_schedule
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model
    from test_torch_train import TRAIN_PTS, _train_batch

    cfg = tiny_cfg.model_cfg()
    batch = _train_batch(np.random.RandomState(0))
    # the same step without the recompute of the rematerialized layers
    monkeypatch.setattr(nn, "remat", lambda target, **kwargs: target)
    jmodel = _jax_model(cfg, train=True)
    variables = _jax_variables(jmodel, batch)
    tx = jax_build_optimizer(variables["params"], lr=jax_step_lr(1e-4, 10, [20, 23]),
                             grad_clip=5.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    jcfg = jax_build_loss_cfg(dict(cfg["pts_bbox_head"], mxu_readout="off"), TRAIN_PTS)
    ref = jax_count_flops(jax_build_train_step(jmodel, tx, jcfg), state, batch,
                          jax.random.PRNGKey(1))

    model = build_model(cfg, device="cpu").train()
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=5.0)
    step = build_train_step(model, opt, build_loss_cfg(cfg["pts_bbox_head"], TRAIN_PTS),
                            device="cpu")
    got = count_flops(step, batch, torch.Generator().manual_seed(0))

    se = _se_layer_flops(model, tiny_cfg.NUM_CAMS)
    # the gates' forward, the input's and the kernel's gradient
    assert got["conv"] - ref["conv"] == 3 * se
    assert got["conv"] == pytest.approx(ref["conv"], rel=1e-2)
    assert got["dot"] == pytest.approx(ref["dot"], rel=1e-2)
    assert 0 < got["scatter"] < ref["scatter"]
    assert got["total"] == pytest.approx(ref["total"], rel=1e-2)


@pytest.mark.slow
def test_flagship_forward_and_train_step_match_jax(monkeypatch):
    """The same comparison at the flagship's full width and depth (random
    weights; JAX traces, the port runs on the CPU): parameters, the
    deployment forward and one train step (JAX without the recompute)."""
    import flax.linen as nn

    from occformer_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from occformer_tpu.engine.optim import step_lr_schedule as jax_step_lr
    from occformer_tpu.engine.train import TrainState
    from occformer_tpu.models.mask2former_head import format_results as jax_format
    from occformer_tpu.models.mask2former_head import mask_logits_from_embeds as jax_logits
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.tools.model_analysis import DEFAULT_CONFIG, forward_flops
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_serving_batch, make_train_batch
    from tools.tpu_train_trial import build_trial

    cfg = load_config(DEFAULT_CONFIG)
    model = build_model(cfg["model"], device="cpu")
    jmodel, jbatch, jcfg, _ = build_trial("occformer_tpu/configs/occformer_nusc_r50_256x704.py")
    variables = _jax_variables(jmodel, jbatch)
    key = jax.random.PRNGKey(0)

    def fwd(v, b):
        out, _ = jmodel.apply(v, b, mutable=["batch_stats"], rngs={"dropout": key})
        return jax_format(out["cls_preds"][-1], jax_logits(out["mask_embeds"][-1],
                                                          out["mask_feature"]))

    ref = jax_count_flops(fwd, variables, jbatch)
    got = forward_flops(model, make_serving_batch(cfg, seed=0))
    se = _se_layer_flops(model, 6)
    assert got["conv"] - ref["conv"] == se and ref["dot"] - got["dot"] == se
    assert got["scatter"] == ref["scatter"]
    assert got["total"] == pytest.approx(ref["total"], rel=1e-2)

    monkeypatch.setattr(nn, "remat", lambda target, **kwargs: target)
    jmodel, jbatch, jcfg, _ = build_trial("occformer_tpu/configs/occformer_nusc_r50_256x704.py")
    tx = jax_build_optimizer(variables["params"], lr=jax_step_lr(1e-4, 28000, [20, 23]),
                             grad_clip=5.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    from occformer_tpu.engine.train import build_train_step as jax_build_train_step

    ref_t = jax_count_flops(jax_build_train_step(jmodel, tx, jcfg), state, jbatch, key)
    m = cfg["model"]
    model.train()
    step = build_train_step(model, build_optimizer_from_config(model, cfg, 28130),
                            build_loss_cfg(m["pts_bbox_head"], m["train_cfg"]["pts"]),
                            device="cpu")
    got_t = count_flops(step, make_train_batch(cfg, seed=0), torch.Generator().manual_seed(0))
    assert got_t["conv"] == pytest.approx(ref_t["conv"], rel=1e-2)
    assert got_t["dot"] == pytest.approx(ref_t["dot"], rel=1e-2)
