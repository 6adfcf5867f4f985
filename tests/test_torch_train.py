"""The port's train step against the JAX package, part by part and whole.

Tier-1 holds the step through its parts (the loss and its output gradients
are in tests/test_torch_loss.py; the deformable-attention layer's VJP in
tests/test_torch_deform_gather.py):

* the optimizer: the decay and freeze masks against ``_decay_mask`` and
  ``backbone_freeze_mask`` on the flagship's parameters, one AdamW + clip
  update against the optax chain, ``step_lr_schedule``;
* the train-mode modules: BatchNorm with batch statistics against flax's
  BatchNorm (outputs, VJP and updated running statistics), DropPath's keep
  masks from a fixed generator, gradient checkpointing replaying them, the
  frozen stem's stop-gradient;
* a few port-only tiny train steps: the loss falls, BatchNorm statistics
  move, the same seed gives the same step.

The whole tiny step against JAX's ``build_train_step`` is marked ``slow``:
it compiles the JAX step twice (about three minutes on one CPU core).
"""
import json
import os
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import tiny_cfg
from occformer_tpu.engine.optim import _decay_mask
from occformer_tpu.engine.optim import backbone_freeze_mask as jax_freeze_mask
from occformer_tpu.engine.optim import build_optimizer as jax_build_optimizer
from occformer_tpu.engine.optim import step_lr_schedule as jax_step_lr
from occformer_tpu.models.layers import BatchNorm as JaxBatchNorm
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.engine.convert_weights import build_export_permutation, convert_occformer
from occformer_tpu_torch.engine.optim import (
    backbone_freeze_mask,
    build_optimizer,
    decay_mask,
    step_lr_schedule,
)
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.models.layers import (
    BatchNorm1d,
    BatchNorm2d,
    DropPath,
    checkpoint,
    drop_path_generator,
)
from occformer_tpu_torch.models.resnet import ResNet

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN_PTS = dict(num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_batch(rng):
    """tests/test_train_step.py's tiny train batch."""
    batch = tiny_cfg.make_batch(rng)
    N, (H, W) = tiny_cfg.NUM_CAMS, tiny_cfg.INPUT_SIZE
    X, Y, Z = tiny_cfg.OCC_SIZE
    gt_occ = rng.randint(0, tiny_cfg.NUM_CLASSES, size=(1, X, Y, Z)).astype(np.int32)
    gt_occ[0, :2] = 255
    depth = rng.uniform(0, 10, size=(1, N, H, W)).astype(np.float32)
    depth[depth < 3] = 0.0
    P = 128
    lidar_valid = np.ones((1, P), bool)
    lidar_valid[:, 100:] = False
    batch.update(gt_occ=gt_occ, gt_depth=depth,
                 lidar_xyz=rng.uniform(0, 1, size=(1, P, 3)).astype(np.float32),
                 lidar_valid=lidar_valid,
                 lidar_label=rng.randint(0, tiny_cfg.NUM_CLASSES, size=(1, P)).astype(np.int32))
    return batch


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _flagship_masks():
    """JAX's masks on the flax tree converted from the flagship's key
    manifest, carried back to the port's parameter names."""
    path = os.path.join(REPO, "tests", "fixtures", "key_manifests",
                        "occformer_nusc_r50_256x704.json")
    with open(path) as f:
        manifest = json.load(f)["keys"]
    conv = convert_occformer({k: np.zeros(v) for k, v in manifest.items()})
    index_map, offsets, _ = build_export_permutation(manifest, conv)
    starts = sorted((start, k) for k, (start, _) in offsets.items())
    first = np.array([s for s, _ in starts])

    def torch_keys(flat_idx):
        return {starts[i][1] for i in np.unique(np.searchsorted(first, flat_idx, "right") - 1)}

    def carried(flax_mask):
        out = {}
        for p, v in jax.tree_util.tree_flatten_with_path(flax_mask)[0]:
            name = "params/" + "/".join(k.key for k in p)
            for key in torch_keys(index_map[name].ravel()):
                out.setdefault(key, set()).add(bool(v))
        assert all(len(v) == 1 for v in out.values()), "a torch key with mixed masks"
        return {k: v.pop() for k, v in out.items()}

    return conv, carried


def test_decay_and_freeze_masks_match_jax_on_the_flagship():
    """Equal on every parameter but the pixel decoder's encoder-layer
    LayerNorm scales: the JAX package scans those layers, so their scales
    are stacked [num_layers, C], and ``_decay_mask``'s ``ndim <= 1`` norm
    test then decays them, against its own rule (no decay on norm
    parameters).  The port keeps the rule."""
    conv, carried = _flagship_masks()
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", "configs",
                                   "occformer_nusc_r50_256x704.py"))
    model = build_model(cfg["model"], device="meta")
    mine = decay_mask(model)
    ref = carried(_decay_mask(conv["params"]))
    assert set(mine) == set(ref) and len(mine) > 800
    differ = sorted(k for k in mine if mine[k] != ref[k])
    assert differ == [f"img_bev_encoder_neck.encoder.layers.{i}.norms.{j}.weight"
                      for i in range(6) for j in range(2)]
    assert not any(mine[k] for k in differ)
    assert 0 < sum(mine.values()) < len(mine)
    for backbone in (cfg["model"]["img_backbone"],  # frozen_stages=0: the stem
                     dict(frozen_stages=2),
                     dict(norm_cfg=dict(type="BN", requires_grad=False))):
        got = backbone_freeze_mask(model, backbone)
        want = carried(jax_freeze_mask(conv["params"], backbone))
        assert got == want and any(got.values())
    assert sum(backbone_freeze_mask(model, cfg["model"]["img_backbone"]).values()) == 3
    assert backbone_freeze_mask(model, dict(frozen_stages=-1)) is None


class _Params(torch.nn.Module):
    """Parameters named to exercise every rule: decayed kernels, a no-decay
    embedding, a bias, a norm scale and a frozen stem kernel."""

    def __init__(self, rng):
        super().__init__()
        shapes = {"img_backbone.conv1.weight": (4, 3, 3, 3), "layer.weight": (6, 5),
                  "layer.bias": (6,), "norm.weight": (5,),
                  "pts_bbox_head.query_embed.weight": (3, 5)}
        for name, shape in shapes.items():
            mod = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, torch.nn.Parameter(
                torch.from_numpy(rng.randn(*shape).astype(np.float32))))


def test_adamw_and_clip_update_matches_optax():
    """Two updates (the first clipped at norm 5, the second not) against the
    JAX package's chain: freeze -> clip_by_global_norm -> adamw with the
    decay mask.  float32 both sides; rtol 1e-6."""
    rng = np.random.RandomState(0)
    model = _Params(rng)
    names = [n for n, _ in model.named_parameters()]
    params = {n: jnp.asarray(p.detach().numpy()) for n, p in model.named_parameters()}
    freeze = {n: n.startswith("img_backbone.conv1") for n in names}
    lr = jax_step_lr(1e-3, steps_per_epoch=1, milestones_epochs=[1])
    tx = jax_build_optimizer(params, lr=lr, grad_clip=5.0, freeze_mask=freeze)
    state = tx.init(params)
    opt = build_optimizer(model, lr=step_lr_schedule(1e-3, 1, [1]), grad_clip=5.0,
                          freeze_mask=freeze)
    for scale in (3.0, 0.01):
        grads = {n: (scale * rng.randn(*p.shape)).astype(np.float32) for n, p in params.items()}
        updates, state = tx.update({n: jnp.asarray(g) for n, g in grads.items()}, state, params)
        params = optax.apply_updates(params, updates)
        for n, p in model.named_parameters():
            p.grad = torch.from_numpy(grads[n].copy())
        norm = opt.step()
        np.testing.assert_allclose(float(norm), float(optax.global_norm(grads)), rtol=1e-6)
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[n]),
                                       rtol=1e-6, atol=1e-9, err_msg=n)
    assert torch.equal(model.img_backbone.conv1.weight,
                       _Params(np.random.RandomState(0)).img_backbone.conv1.weight)


def test_step_lr_schedule_matches_jax():
    for kw in (dict(), dict(gamma=0.5)):
        ref = jax_step_lr(1e-4, 10, [2, 3], **kw)
        got = step_lr_schedule(1e-4, 10, [2, 3], **kw)
        for step in (0, 3, 5, 19, 20, 29, 30, 100):
            np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6)


# ---------------------------------------------------------------------------
# train-mode modules
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(6, 7), (2, 5, 4, 3)])
def test_batchnorm_train_mode_matches_flax(shape):
    """Output, VJP and running statistics after one train-mode call.  (6, 7):
    the DepthNet's BatchNorm1d over 6 camera rows, where torch's unbiased
    running-variance update would be 20% off flax's."""
    rng = np.random.RandomState(1)
    C = shape[1]
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    scale, bias = rng.rand(C).astype(np.float32) + 0.5, rng.randn(C).astype(np.float32)
    mean, var = rng.randn(C).astype(np.float32), rng.rand(C).astype(np.float32) + 0.5
    gout = rng.randn(*shape).astype(np.float32)
    bn = (BatchNorm1d if len(shape) == 2 else BatchNorm2d)(C).train()
    with torch.no_grad():
        for t, v in ((bn.weight, scale), (bn.bias, bias), (bn.running_mean, mean),
                     (bn.running_var, var)):
            t.copy_(torch.from_numpy(v))
    x_t = torch.from_numpy(x).requires_grad_(True)
    out = bn(x_t)
    out.backward(torch.from_numpy(gout))

    last = lambda a: np.moveaxis(a, 1, -1)  # flax is channels-last
    jbn = JaxBatchNorm(use_running_average=False)
    variables = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
                 "batch_stats": {"BatchNorm_0": {"mean": mean, "var": var}}}

    def f(params, xx):
        return jbn.apply({"params": params, "batch_stats": variables["batch_stats"]},
                         xx, mutable=["batch_stats"])

    ref, vjp, stats = jax.vjp(f, variables["params"], jnp.asarray(last(x)), has_aux=True)
    d_params, d_x = vjp(jnp.asarray(last(gout)))
    np.testing.assert_allclose(last(out.detach().numpy()), np.asarray(ref), atol=1e-5)
    np.testing.assert_allclose(last(x_t.grad.numpy()), np.asarray(d_x), atol=1e-5)
    np.testing.assert_allclose(bn.weight.grad.numpy(), d_params["BatchNorm_0"]["scale"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.bias.grad.numpy(), d_params["BatchNorm_0"]["bias"],
                               rtol=1e-5, atol=1e-5)
    new = stats["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(bn.running_mean.numpy(), new["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), new["var"], rtol=1e-5, atol=1e-6)


def test_drop_path_keep_masks_come_from_the_generator():
    x = torch.randn(64, 3, 5)
    dp = DropPath(0.25).train()
    with drop_path_generator(torch.Generator().manual_seed(7)):
        y = dp(x)
    keep = torch.rand((64, 1, 1), generator=torch.Generator().manual_seed(7)) < 0.75
    torch.testing.assert_close(y, torch.where(keep, x / 0.75, torch.zeros(())))
    assert 0 < keep.sum() < 64  # some samples dropped, whole samples at a time
    with drop_path_generator(torch.Generator().manual_seed(7)):
        assert torch.equal(dp(x), y)
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(DropPath(0.0).train()(x), x)


def test_checkpoint_replays_the_drop_path_draws():
    """A checkpointed block's gradients and the generator's state after the
    step equal those of the same block run without checkpointing."""
    torch.manual_seed(0)
    block = torch.nn.Sequential(torch.nn.Linear(8, 8), DropPath(0.5)).train()
    x = torch.randn(32, 8)

    def run(use_cp):
        g = torch.Generator().manual_seed(3)
        xx = x.clone().requires_grad_(True)
        with drop_path_generator(g):
            out = checkpoint(block, xx) if use_cp else block(xx)
        (out ** 2).sum().backward()
        grads = [xx.grad] + [p.grad.clone() for p in block.parameters()]
        block.zero_grad()
        return out.detach(), grads, torch.rand(4, generator=g)

    ref, got = run(False), run(True)
    assert torch.equal(ref[0], got[0]) and torch.equal(ref[2], got[2])
    for a, b in zip(ref[1], got[1]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_frozen_stem_stops_the_gradient():
    """``frozen_stages=0`` (the flagship): nothing before the first stage is
    differentiated in train mode; ``norm_eval`` keeps the BatchNorms on their
    running statistics in train mode."""
    x = torch.randn(2, 3, 32, 32)
    for frozen, stem_grad in ((0, False), (-1, True)):
        net = ResNet(depth=18, frozen_stages=frozen).train()
        sum(o.sum() for o in net(x)).backward()
        assert (net.conv1.weight.grad is not None) == stem_grad
        assert net.layer1[0].conv1.weight.grad is not None
    net = ResNet(depth=18, norm_eval=True).train()
    assert net.training and not net.bn1.training and not net.layer2[0].bn1.training


@pytest.mark.parametrize("frozen", [0, 2])
def test_frozen_stages_batchnorms_keep_their_statistics(frozen):
    """mmdet's ``_freeze_stages`` (port only; the JAX package trains the
    frozen BatchNorms): after a train-mode forward, the BatchNorms of the
    stem and of ``layer1`` ... ``layer{frozen}`` hold their running
    statistics bit for bit, the later ones moved, and the frozen stem's
    output equals an eval-mode stem's."""
    torch.manual_seed(0)
    net = ResNet(depth=18, frozen_stages=frozen)
    for m in net.modules():  # running statistics away from (0, 1)
        if isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.uniform_(-0.5, 0.5)
            m.running_var.uniform_(0.5, 2.0)
    before = {k: v.clone() for k, v in net.state_dict().items() if "running" in k}
    x = torch.randn(2, 3, 32, 32)
    net.train()
    assert net.training and not net.bn1.training
    net(x)
    frozen_prefixes = ("bn1.",) + tuple(f"layer{i}." for i in range(1, frozen + 1))
    for k, v in net.state_dict().items():
        if "running" not in k:
            continue
        if k.startswith(frozen_prefixes):
            assert torch.equal(v, before[k]), k
        else:
            assert not torch.equal(v, before[k]), k
    assert net.layer3[0].bn1.training and net.layer2[0].bn1.training == (frozen < 2)
    stem = torch.nn.functional.relu(net.bn1(net.conv1(x)))
    net.eval()
    torch.testing.assert_close(stem, torch.nn.functional.relu(net.bn1(net.conv1(x))),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the port's own train steps
# ---------------------------------------------------------------------------

def _port_step(seed=0):
    cfg = tiny_cfg.model_cfg()
    model = build_model(cfg, device="cpu", seed=seed).train()
    loss_cfg = build_loss_cfg(cfg["pts_bbox_head"], TRAIN_PTS)
    opt = build_optimizer(model, lr=3e-4, grad_clip=5.0)
    return model, build_train_step(model, opt, loss_cfg, device="cpu")


def test_port_train_steps_learn_and_repeat():
    """Four steps on one batch: every loss finite, the total falls, the
    BatchNorm statistics move, and a second run from the same seeds
    repeats the first bit for bit."""
    batch = _train_batch(np.random.RandomState(0))
    runs = []
    for _ in range(2):
        model, step = _port_step()
        bn_before = model.img_backbone.bn1.running_mean.clone()
        g = torch.Generator().manual_seed(5)
        hist = [step(batch, g) for _ in range(4)]
        runs.append((hist, {k: v.clone() for k, v in model.state_dict().items()}))
    hist, state = runs[0]
    for m in hist:
        assert all(torch.isfinite(v) for v in m.values()), m
        assert {"loss_depth", "d0.loss_mask", "grad_norm", "point_mean_iou"} <= set(m)
        total = sum(v for k, v in m.items() if "loss" in k and k != "total_loss")
        torch.testing.assert_close(m["total_loss"], total)
    assert float(hist[-1]["total_loss"]) < float(hist[0]["total_loss"])
    assert not torch.equal(state["img_backbone.bn1.running_mean"], bn_before)
    assert int(state["img_backbone.bn1.num_batches_tracked"]) == 4
    hist2, state2 = runs[1]
    for a, b in zip(hist, hist2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(state[k], state2[k]) for k in state)


# ---------------------------------------------------------------------------
# the whole step against JAX
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_train_step_matches_jax_build_train_step():
    """One tiny step of the port (eval-mode forward, scipy matching, plain
    kernels) against JAX's ``build_train_step`` (``train=False``: the JAX
    model hard-codes drop-path 0.2 in train mode, and its draws cannot be
    reproduced) on the same weights and the same loss draws.  Losses,
    ``total_loss`` and ``grad_norm`` within 1e-4 relative.  Gradients (JAX's
    are read off a second step with ``optax.identity``: new - old
    parameters): all but at most 3 tensors within 1e-2 * max|ref| + 1e-6,
    and every tensor within 6e-2 * max|ref| + 1e-6.  The looser bound is for
    a ReLU kink: one pre-activation of the stage-2 ASPP branch (1 of 512)
    lies 3e-6 from zero, inside the port's float32 rounding there (3.5e-5
    against a float64 run of the port), so it takes the gradient on one side
    in JAX and on the other in the port; the port's float64 gradients agree
    with JAX's there.  That moves two ASPP tensors by 4.8e-2 * max|ref|.
    The parameter updates: Adam's first step is about -lr * sign(g), so
    where a gradient is within its tolerance of 0 the two updates may differ
    by up to 2 * lr; everywhere else (|g| >= 1e-2 * max|g|) they agree
    within 3e-6 = 3% of lr, which also covers the pixel decoder's stacked
    LayerNorm scales that the JAX package decays and the port does not
    (lr * wd * |p| = 1e-6, see test_decay_and_freeze_masks_match_jax)."""
    from occformer_tpu.engine.train import TrainState
    from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
    from occformer_tpu.engine.train import build_train_step as jax_build_train_step
    from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
    from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
    from test_torch_loss import jax_loss_draws

    cfg = tiny_cfg.model_cfg()
    comps = ("img_backbone", "img_neck", "img_view_transformer",
             "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in comps}, train=False)
    jcfg = jax_build_loss_cfg(dict(cfg["pts_bbox_head"], mxu_readout="off"), TRAIN_PTS)
    batch = _train_batch(np.random.RandomState(0))
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))

    def jax_step(tx):
        state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        return jax.jit(jax_build_train_step(jmodel, tx, jcfg))(
            state, batch, jax.random.PRNGKey(1))

    lr = jax_step_lr(1e-4, 10, [20, 23])
    new_state, metrics = jax_step(jax_build_optimizer(variables["params"], lr=lr,
                                                      grad_clip=5.0))
    plus, _ = jax_step(optax.identity())
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   plus.params, variables["params"])

    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    model.eval()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=5.0)
    step = build_train_step(model, opt, build_loss_cfg(cfg["pts_bbox_head"], TRAIN_PTS),
                            device="cpu")
    # train.py:204,166: fold_in(step), then split into the drop and loss keys
    _, loss_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    draws = jax_loss_draws(loss_rng, jcfg, batch["lidar_valid"], cfg["pts_bbox_head"][
        "transformer_decoder"]["num_layers"] + 1)
    got = step(batch, torch.Generator().manual_seed(0), draws=draws)

    for k in metrics:
        if k == "point_mean_iou":
            continue
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
    clip = min(1.0, 5.0 / float(got["grad_norm"]))
    want_grads = flax_to_torch_state_dict(
        {"params": grads, "batch_stats": variables["batch_stats"]}, model)
    want_params = flax_to_torch_state_dict(
        {"params": new_state.params, "batch_stats": new_state.batch_stats}, model)
    lr = 1e-4
    shares = {}
    for name, p in model.named_parameters():
        ref_g = want_grads[name].numpy()
        err_g = np.abs(p.grad.numpy() / clip - ref_g).max()
        old = before[name].numpy()
        d_upd = np.abs((p.detach().numpy() - old) - (want_params[name].numpy() - old))
        big = np.abs(ref_g) >= 1e-2 * np.abs(ref_g).max()
        shares[name] = (err_g / (1e-2 * np.abs(ref_g).max() + 1e-6),
                        err_g / (6e-2 * np.abs(ref_g).max() + 1e-6),
                        d_upd[big].max(initial=0.0) / 3e-6, d_upd.max() / (2.02 * lr))
    assert len(shares) == len(list(model.parameters()))
    loose = sorted(k for k, v in shares.items() if v[0] > 1.0)
    assert len(loose) <= 3, loose
    worst = max(shares, key=lambda k: max(shares[k][1:]))
    assert max(shares[worst][1:]) <= 1.0, (worst, shares[worst])
