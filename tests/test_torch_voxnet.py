"""The two model branches the port used to refuse, against the JAX package.

* ``use_voxel_net``: ``DepthAggregation`` alone (eval and train-mode
  BatchNorm), the view transformer with the branch (forward and gradients
  against ``jax.grad``), the splat of given rows (``voxel_scatter``) against
  JAX's ``voxel_scatter``, and the tiny model built from a model dict;
* ``pooling_attn_mask=False``: the tiny model with trilinear attention
  masks.

JAX's ``translate_cfg`` drops ``use_voxel_net`` from the view transformer's
dict (ROADMAP §C, known reference faults), so the model-level tests wrap it
with ``monkeypatch`` to pass the key; the JAX package is unchanged.  All in
float32 on the CPU.  Tolerances: modules within rtol/atol 1e-4 (the same
float32 math through other conv libraries and summation orders), gradients
within 1e-4 * max|ref| + 1e-6, the whole tiny model's outputs within
1e-3 * max|ref| + 1e-4 (as tests/test_torch_model.py).  The whole tiny train
step against JAX's ``build_train_step`` is ``slow`` (a JAX compile of about
a minute a flag).
"""
import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp
import optax

import tiny_cfg
from occformer_tpu.engine.convert_weights import match_to_tree
from occformer_tpu.models import detector as jax_detector
from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
from occformer_tpu.models.lss import DepthAggregation as JaxDepthAggregation
from occformer_tpu.models.lss import ViewTransformerLiftSplatShootVoxel as JaxLSS
from occformer_tpu.ops.scatter import voxel_scatter as jax_voxel_scatter
from occformer_tpu_torch.engine.convert_weights import (
    TreeBuilder,
    convert_depth_aggregation,
    convert_depthnet,
    flax_to_torch_state_dict,
)
from occformer_tpu_torch.engine.eval import build_eval_step
from occformer_tpu_torch.engine.optim import build_optimizer
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.models.lss import DepthAggregation, ViewTransformerLiftSplatShootVoxel
from occformer_tpu_torch.ops.scatter import voxel_rows, voxel_scatter, voxel_scatter_plain_rows

COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")
TRAIN_PTS = dict(num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, tol=1e-4):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def _grad_close(got, ref, name):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, tol = np.abs(got - ref).max(), 1e-4 * np.abs(ref).max() + 1e-6
    assert err <= tol, f"{name}: max |diff| {err} > {tol}"


def _randomize_bn(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return module


def _sd(module, prefix=""):
    return {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_vars(tb, dst, init):
    target = {"params": init["params"], "batch_stats": init.get("batch_stats", {})}
    variables, missing = match_to_tree(
        {"params": tb.params[dst], "batch_stats": tb.stats.get(dst, {})}, target)
    assert not missing, missing
    return variables


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


# ---------------------------------------------------------------------------
# DepthAggregation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("train", [False, True])
def test_depth_aggregation_matches_jax(train):
    """Eval mode (running statistics) and train mode (batch statistics and
    the running-statistics update flax makes)."""
    rng = np.random.RandomState(11)
    C = 8
    torch.manual_seed(11)
    tm = _randomize_bn(DepthAggregation(C, C, C), 11).train(train)
    tb = TreeBuilder()
    convert_depth_aggregation(tb, _sd(tm, "da."), "da", "da")
    x = rng.randn(5, 6, 7, C).astype(np.float32)  # planes [n, W, D, C]
    jm = JaxDepthAggregation(mid_channels=C, out_channels=C, train=train)
    variables = _jax_vars(tb, "da", jax.eval_shape(jm.init, jax.random.PRNGKey(0), x))
    if train:
        ref, upd = jm.apply(variables, x, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, x)
    got = tm(_nchw(x))
    _close(np.moveaxis(got.detach().numpy(), 1, -1), ref)
    if train:
        for name in ("reduce_bn", "bn1", "bn2"):
            stats = upd["batch_stats"][name]["BatchNorm_0"]
            bn = getattr(tm, name)
            _close(bn.running_mean.numpy(), stats["mean"])
            _close(bn.running_var.numpy(), stats["var"])


# ---------------------------------------------------------------------------
# the splat of given rows
# ---------------------------------------------------------------------------

def test_voxel_scatter_plain_rows_matches_jax():
    """Rows with coordinates outside the grid (clamped) and invalid rows
    (dropped), over two batch items; the sum and its gradient."""
    rng = np.random.RandomState(12)
    B, P, C, nx = 2, 300, 5, (4, 5, 3)
    feats = rng.randn(B, P, C).astype(np.float32)
    coords = rng.randint(-1, 6, size=(B, P, 3)).astype(np.int32)
    valid = rng.rand(B, P) > 0.3
    weight = rng.randn(B, *nx, C).astype(np.float32)

    def jloss(f):
        return jnp.sum(jax_voxel_scatter(f, jnp.asarray(coords), jnp.asarray(valid), nx)
                       * weight)

    ref = jax_voxel_scatter(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid), nx)
    ref_g = jax.grad(jloss)(jnp.asarray(feats))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = voxel_scatter(f, torch.from_numpy(coords), torch.from_numpy(valid), nx)
    (got * torch.from_numpy(weight)).sum().backward()
    _close(got.detach().numpy(), ref, 1e-5)
    _grad_close(f.grad.numpy(), ref_g, "d_feats")
    # the plain version is one index_add_ over voxel_rows, in point order
    rows = voxel_rows(torch.from_numpy(coords), torch.from_numpy(valid), nx)
    plain = voxel_scatter_plain_rows(torch.from_numpy(feats), rows, B * int(np.prod(nx)))
    assert torch.equal(plain.reshape(got.shape), got.detach())
    assert (f.grad.numpy()[~valid] == 0).all()


# ---------------------------------------------------------------------------
# the view transformer with use_voxel_net
# ---------------------------------------------------------------------------

def _vt_pair(seed):
    rng = np.random.RandomState(seed)
    C_IN, C_T = 16, 8
    cfg = dict(grid_config=tiny_cfg.GRID_CONFIG, data_config=tiny_cfg.DATA_CONFIG,
               numC_input=C_IN, numC_Trans=C_T, downsample=tiny_cfg.DOWNSAMPLE)
    torch.manual_seed(seed)
    tm = _randomize_bn(ViewTransformerLiftSplatShootVoxel(**cfg, use_voxel_net=True),
                       seed).eval()
    tb = TreeBuilder()
    sd = _sd(tm)
    convert_depthnet(tb, sd, "depth_net", "vt/depth_net")
    convert_depth_aggregation(tb, sd, "depth_aggregation_net", "vt/depth_aggregation_net")
    batch = tiny_cfg.make_batch(rng, B=1)
    # cameras that look along +x, so that much of the frustum lands in the grid
    rot = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    batch["rots"][:] = rot
    fH, fW = tiny_cfg.INPUT_SIZE[0] // 8, tiny_cfg.INPUT_SIZE[1] // 8
    x = rng.randn(1, tiny_cfg.NUM_CAMS, fH, fW, C_IN).astype(np.float32)
    geo = [batch[k] for k in ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")]
    jm = JaxLSS(**cfg, use_voxel_net=True)
    variables = _jax_vars(tb, "vt", jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, *geo))
    return tm, jm, variables, x, geo, rng


def test_voxel_net_view_transformer_matches_jax():
    """Forward, and the gradients of a weighted sum of the volume with
    respect to the image features and to DepthAggregation's kernels."""
    tm, jm, variables, x, geo, rng = _vt_pair(13)
    vol_j, dp_j = jax.jit(jm.apply)(variables, x, *geo)
    assert (np.asarray(vol_j) != 0).any(axis=-1).mean() > 0.05  # the splat hit the grid
    weight = rng.randn(*np.asarray(vol_j).shape).astype(np.float32)

    def jloss(params, xx):
        vol, _ = jm.apply({"params": params, "batch_stats": variables["batch_stats"]},
                          xx, *geo)
        return jnp.sum(vol * weight)

    g_params, g_x = jax.jit(jax.grad(jloss, argnums=(0, 1)))(variables["params"], x)
    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2))).requires_grad_(True)
    vol_t, dp_t = tm(xt, *(torch.from_numpy(g) for g in geo))
    _close(vol_t.detach().numpy(), vol_j)
    _close(dp_t.detach().numpy(), dp_j)
    (vol_t * torch.from_numpy(weight)).sum().backward()
    _grad_close(np.moveaxis(xt.grad.numpy(), 2, -1), g_x, "d_x")
    da = g_params["depth_aggregation_net"]
    for name in ("reduce_conv", "conv1", "conv2", "out_conv"):
        got = getattr(tm.depth_aggregation_net, name).weight.grad.numpy()
        _grad_close(np.transpose(got, (2, 3, 1, 0)), da[name]["Conv_0"]["kernel"], name)
    _grad_close(tm.depth_aggregation_net.out_conv.bias.grad.numpy(),
                da["out_conv"]["Conv_0"]["bias"], "out_conv.bias")


# ---------------------------------------------------------------------------
# the tiny model with each flag
# ---------------------------------------------------------------------------

def _patch_jax_translate(monkeypatch):
    """JAX's translate_cfg with ``use_voxel_net`` passed through."""
    orig = jax_detector.translate_cfg

    def translate(cfg, train, dtype):
        cls, kwargs = orig(cfg, train, dtype)
        if cfg.get("type") == "ViewTransformerLiftSplatShootVoxel" and cfg.get("use_voxel_net"):
            kwargs["use_voxel_net"] = True
        return cls, kwargs

    monkeypatch.setattr(jax_detector, "translate_cfg", translate)


def _flag_cfg(flag):
    cfg = tiny_cfg.model_cfg()
    if flag == "use_voxel_net":
        cfg["img_view_transformer"]["use_voxel_net"] = True
    else:
        cfg["pts_bbox_head"]["pooling_attn_mask"] = False
    return cfg


def _serve_batch():
    rng = np.random.RandomState(0)
    batch = tiny_cfg.make_batch(rng)
    P = 256
    batch["lidar_xyz"] = rng.uniform(0, 1, (1, P, 3)).astype(np.float32)
    batch["lidar_valid"] = rng.rand(1, P) > 0.1
    batch["lidar_label"] = rng.randint(1, tiny_cfg.NUM_CLASSES, (1, P)).astype(np.int32)
    return batch


def _randomize_flax_stats(variables, seed):
    r = np.random.RandomState(seed)
    return jax.tree_util.tree_map_with_path(
        lambda p, v: (r.rand(*v.shape).astype(np.float32) + 0.5
                      if "var" in jax.tree_util.keystr(p)
                      else r.randn(*v.shape).astype(np.float32) * 0.1
                      if "mean" in jax.tree_util.keystr(p) else np.asarray(v)),
        variables)


@pytest.mark.parametrize("flag", ["use_voxel_net", "pooling_attn_mask=False"])
def test_tiny_model_with_flag_matches_jax(flag, monkeypatch):
    """Built from a model dict with the flag, the JAX variables carried in
    strictly by ``flax_to_torch_state_dict`` (``depth_aggregation_net.*``
    and its BatchNorm statistics with it), the forward outputs and the eval
    step against JAX's."""
    from occformer_tpu.engine.eval import build_eval_step as jax_build_eval_step

    _patch_jax_translate(monkeypatch)
    cfg = _flag_cfg(flag)
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS})
    batch = _serve_batch()
    jbatch = {k: v for k, v in batch.items() if not k.startswith("lidar")}
    variables = jax.tree_util.tree_map(np.asarray,
                                       jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch))
    variables = {"params": variables["params"],
                 "batch_stats": _randomize_flax_stats(variables["batch_stats"], 3)}
    assert ("depth_aggregation_net" in variables["params"]["view_transformer"]) == (
        flag == "use_voxel_net")
    with torch.random.fork_rng():
        tmodel = build_model(cfg, device="cpu")
    assert hasattr(tmodel.img_view_transformer, "depth_aggregation_net") == (
        flag == "use_voxel_net")
    sd = flax_to_torch_state_dict(variables, tmodel)
    tmodel.load_state_dict(sd, strict=True)
    ref = jax.jit(jmodel.apply)(variables, jbatch)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in jbatch.items()})
    for k in ("cls_preds", "mask_embeds", "mask_feature", "depth_prob"):
        r, g = np.asarray(ref[k], np.float32), got[k].numpy()
        assert g.shape == r.shape, k
        err, tol = np.abs(g - r).max(), 1e-3 * np.abs(r).max() + 1e-4
        assert err <= tol, f"{k}: max |diff| {err} > {tol}"
    occ, n = tuple(tiny_cfg.OCC_SIZE), tiny_cfg.NUM_CLASSES
    ref = jax_build_eval_step(jmodel, occ, n)(variables, batch)
    got = build_eval_step(tmodel, occ, n)(batch)
    for k in ("voxel_pred", "point_pred"):
        assert (got[k].numpy() == np.asarray(ref[k])).mean() >= 0.995, k


def _train_batch(rng):
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


@pytest.mark.parametrize("flag", ["use_voxel_net", "pooling_attn_mask=False"])
def test_port_train_steps_with_flag_learn_and_repeat(flag):
    """The port's own train step with each flag: finite losses that fall
    over three steps, DepthAggregation's kernels get a gradient and its
    BatchNorms move, and a second run from the same seeds repeats the first
    bit for bit."""
    cfg = _flag_cfg(flag)
    batch = _train_batch(np.random.RandomState(0))
    runs = []
    for _ in range(2):
        model = build_model(cfg, device="cpu", seed=0).train()
        opt = build_optimizer(model, lr=3e-4, grad_clip=5.0)
        step = build_train_step(model, opt, build_loss_cfg(cfg["pts_bbox_head"], TRAIN_PTS),
                                device="cpu")
        g = torch.Generator().manual_seed(5)
        hist = [step(batch, g) for _ in range(3)]
        runs.append((hist, {k: v.clone() for k, v in model.state_dict().items()}))
        if flag == "use_voxel_net":
            da = model.img_view_transformer.depth_aggregation_net
            assert da.reduce_conv.weight.grad.abs().sum() > 0
            assert int(da.bn1.num_batches_tracked) == 3
    hist, state = runs[0]
    for m in hist:
        assert all(torch.isfinite(v) for v in m.values()), m
    assert float(hist[-1]["total_loss"]) < float(hist[0]["total_loss"])
    hist2, state2 = runs[1]
    for a, b in zip(hist, hist2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(state[k], state2[k]) for k in state)


@pytest.mark.slow
@pytest.mark.parametrize("flag", ["use_voxel_net", "pooling_attn_mask=False"])
def test_tiny_train_step_with_flag_matches_jax(flag, monkeypatch):
    """One tiny step of the port against JAX's ``build_train_step`` (eval-mode
    forward, ``train=False`` as tests/test_torch_train.py: JAX's train-mode
    drop-path draws cannot be reproduced) on the same weights and loss
    draws: every loss and ``total_loss`` within 1e-4 relative,
    ``grad_norm`` within 5e-4 (the tiny step is ill-conditioned: a 1e-6
    change of the images moves it by 2e-3, ROADMAP §C; with trilinear masks
    it lands 1.04e-4 apart), and the gradients (JAX's read off a step with
    ``optax.identity``) of every parameter within 1e-2 * max|ref| + 1e-6
    for all but at most 3 tensors (a ReLU kink, see
    tests/test_torch_train.py) and 6e-2 * max|ref| + 1e-6 for every one."""
    from occformer_tpu.engine.optim import step_lr_schedule as jax_step_lr
    from occformer_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from occformer_tpu.engine.train import TrainState
    from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
    from occformer_tpu.engine.train import build_train_step as jax_build_train_step
    from occformer_tpu_torch.engine.optim import step_lr_schedule
    from test_torch_loss import jax_loss_draws

    _patch_jax_translate(monkeypatch)
    cfg = _flag_cfg(flag)
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS}, train=False)
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

    _, metrics = jax_step(jax_build_optimizer(variables["params"],
                                              lr=jax_step_lr(1e-4, 10, [20, 23]),
                                              grad_clip=5.0))
    plus, _ = jax_step(optax.identity())
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   plus.params, variables["params"])

    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    model.eval()
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=5.0)
    step = build_train_step(model, opt, build_loss_cfg(cfg["pts_bbox_head"], TRAIN_PTS),
                            device="cpu")
    _, loss_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    draws = jax_loss_draws(loss_rng, jcfg, batch["lidar_valid"], cfg["pts_bbox_head"][
        "transformer_decoder"]["num_layers"] + 1)
    got = step(batch, torch.Generator().manual_seed(0), draws=draws)
    for k in metrics:
        if k != "point_mean_iou":
            np.testing.assert_allclose(float(got[k]), float(metrics[k]),
                                       rtol=5e-4 if k == "grad_norm" else 1e-4, atol=1e-6,
                                       err_msg=k)
    clip = min(1.0, 5.0 / float(got["grad_norm"]))
    want = flax_to_torch_state_dict({"params": grads, "batch_stats": variables["batch_stats"]},
                                    model)
    shares = {}
    for name, p in model.named_parameters():
        ref = want[name].numpy()
        err = np.abs(p.grad.numpy() / clip - ref).max()
        shares[name] = (err / (1e-2 * np.abs(ref).max() + 1e-6),
                        err / (6e-2 * np.abs(ref).max() + 1e-6))
    loose = sorted(k for k, v in shares.items() if v[0] > 1.0)
    assert len(loose) <= 3, loose
    worst = max(shares, key=lambda k: shares[k][1])
    assert shares[worst][1] <= 1.0, (worst, shares[worst])
