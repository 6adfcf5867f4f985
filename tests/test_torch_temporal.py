"""The temporal surface of the port against the JAX package, on the CPU in
float32: ``models/lss.py:shift_feature`` and ``OccupancyFormer4D``.

* ``build_model`` builds the class its ``type`` names, ``OccupancyFormer4D``
  from a 4D dict, and raises ``KeyError`` on any other type.
* ``shift_feature`` (the read through K4's plain version) at the identity,
  a translation and a rotation that moves cells out of range, within 1e-5 *
  max|ref| + 1e-6 of JAX's.
* The tiny 4D model (``tests/tiny_cfg.py``, the occupancy encoder's input
  doubled to 2 * NUMC_TRANS) with JAX's random variables carried in by
  ``flax_to_torch_state_dict`` (every key filled), on a batch whose key and
  previous frames differ in images and in geometry (the previous frame's
  cameras yawed, moved and with other intrinsics), so that the test tells
  the JAX docstring's claim (the key frame's sensor2ego in both frames'
  camera embeddings) from its code (each frame its own, which the port
  follows; ROADMAP §C):
  - eval mode: the outputs within ``1e-3 * max|ref| + 1e-4`` (as
    ``test_torch_model.py`` holds the one-frame model);
  - train mode: each frame's view-transformer outputs (volume and depth)
    within the same bound and every BatchNorm running statistic after the
    call within 1e-4 * max|ref| + 1e-6 (the key frame's batch first, then
    the previous frame's, each frame's camera embeddings normalised apart);
    the 3D encoder's drop-path draws differ, so its outputs are not held.
* One train step on each loss route against JAX's ``build_train_step(
  OccupancyFormer4D(...))`` with AdamW: losses, ``total_loss`` and
  ``grad_norm`` within 1e-4 relative, and the parameters after the update
  (see ``test_4d_train_step_matches_jax``); each route compiles the JAX
  step once, about a minute on the CPU.  And the port's own 4D steps on
  both routes: the previous frame without gradient, a seed repeating them.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.engine.optim import build_optimizer as jax_build_optimizer
from occformer_tpu.engine.optim import step_lr_schedule as jax_step_lr
from occformer_tpu.engine.train import TrainState
from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
from occformer_tpu.engine.train import build_train_step as jax_build_train_step
from occformer_tpu.models.detector import OccupancyFormer4D as JaxOccupancyFormer4D
from occformer_tpu.models.lss import shift_feature as jax_shift_feature
from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
from occformer_tpu_torch.engine.optim import build_optimizer, step_lr_schedule
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
from occformer_tpu_torch.models.detector import (DETECTORS, OccupancyFormer,
                                                 OccupancyFormer4D, build_model)
from occformer_tpu_torch.models.lss import shift_feature
from test_torch_loss import jax_loss_draws
from test_torch_r101_backbone import _random_variables

COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")
TRAIN_PTS = dict(num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75)
CAMS = ("rots", "trans", "intrins", "post_rots", "post_trans")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rel, name, atol=1e-4):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, tol = np.abs(got - ref).max(), rel * np.abs(ref).max() + atol
    assert err <= tol, f"{name}: max|diff| {err} > {tol}"


# ---------------------------------------------------------------------------
# build_model's dispatch
# ---------------------------------------------------------------------------

def model_cfg_4d():
    cfg = tiny_cfg.model_cfg()
    cfg["type"] = "OccupancyFormer4D"
    cfg["img_bev_encoder_backbone"]["in_channels"] = 2 * tiny_cfg.NUMC_TRANS
    return cfg


@pytest.mark.filterwarnings("ignore:.*meta parameter")
def test_build_model_builds_the_type_it_names():
    assert set(DETECTORS) == {"OccupancyFormer", "OccupancyFormer4D"}
    m4 = build_model(model_cfg_4d(), device="meta")
    assert type(m4) is OccupancyFormer4D
    conv = m4.img_bev_encoder_backbone.state_dict()
    first = next(v for k, v in conv.items() if k.endswith("weight") and v.dim() == 5)
    assert first.shape[1] == 2 * tiny_cfg.NUMC_TRANS
    assert type(build_model(tiny_cfg.model_cfg(), device="meta")) is OccupancyFormer
    with pytest.raises(KeyError, match="OccupancyFormer5D"):
        build_model(dict(model_cfg_4d(), type="OccupancyFormer5D"), device="meta")


# ---------------------------------------------------------------------------
# shift_feature
# ---------------------------------------------------------------------------

def _yaw(theta, tx=0.0, ty=0.0):
    m = np.eye(4, dtype=np.float32)
    m[:2, :2] = [[np.cos(theta), -np.sin(theta)], [np.sin(theta), np.cos(theta)]]
    m[0, 3], m[1, 3] = tx, ty
    return m


@pytest.mark.parametrize("case", ["identity", "translation", "rotation"])
def test_shift_feature_matches_jax(case):
    rng = np.random.RandomState(0)
    feat = rng.randn(2, 9, 7, 5).astype(np.float32)
    bx, dx = np.array([-4.0, -2.5]), np.array([1.0, 0.8])
    mats = {"identity": [np.eye(4, dtype=np.float32)] * 2,
            "translation": [_yaw(0.0, 1.0), _yaw(0.0, -0.4, 0.7)],
            "rotation": [_yaw(0.6, 0.3, -0.2), _yaw(-1.1, -1.5, 0.9)]}[case]
    curr2prev = np.stack(mats)
    got = shift_feature(torch.from_numpy(feat), torch.from_numpy(curr2prev), bx, dx).numpy()
    ref = np.asarray(jax_shift_feature(jnp.asarray(feat), jnp.asarray(curr2prev), bx, dx))
    _close(got, ref, 1e-5, case, atol=1e-6)
    if case == "identity":
        _close(got, feat, 1e-5, "identity", atol=1e-6)
    if case == "translation":  # one cell in +x: out[x] = feat[x + 1]
        _close(got[0, :-1], feat[0, 1:], 1e-5, "one cell", atol=1e-6)
        assert np.abs(got[0, -1]).max() == 0.0
    if case == "rotation":  # cells rotated out of the map read zeros
        assert (np.abs(got).max(-1) == 0).mean() > 0.1


# ---------------------------------------------------------------------------
# the tiny 4D model
# ---------------------------------------------------------------------------

def _interleave(key, prev):
    """[B, N, ...] x 2 -> [B, 2N, ...], the frame axis minor."""
    B, N = key.shape[:2]
    return np.stack([key, prev], axis=2).reshape(B, 2 * N, *key.shape[2:])


def frames_batch(rng):
    """A 4D batch (2 cameras x 2 frames) whose frames differ in images and in
    every camera tensor; ``bda`` shared."""
    key, prev = tiny_cfg.make_batch(rng), tiny_cfg.make_batch(rng)
    yaw = _yaw(0.15)[:3, :3]
    prev["rots"] = np.einsum("ij,bnjk->bnik", yaw, prev["rots"]).astype(np.float32)
    prev["intrins"][..., 0, 0] = prev["intrins"][..., 1, 1] = 33.0
    prev["post_rots"][..., 0, 0] = prev["post_rots"][..., 1, 1] = 1.05
    prev["post_trans"] = rng.uniform(-1, 1, prev["post_trans"].shape).astype(np.float32)
    batch = {k: _interleave(key[k], prev[k]) for k in ("imgs",) + CAMS}
    batch["bda"] = key["bda"]
    return batch


def train_batch(rng):
    """``frames_batch`` with the key frame's GT depth and LiDAR and a GT grid."""
    batch = frames_batch(rng)
    N, (H, W) = tiny_cfg.NUM_CAMS, tiny_cfg.INPUT_SIZE
    X, Y, Z = tiny_cfg.OCC_SIZE
    gt_occ = rng.randint(0, tiny_cfg.NUM_CLASSES, size=(1, X, Y, Z)).astype(np.int32)
    gt_occ[0, :2] = 255
    depth = rng.uniform(0, 10, size=(1, N, H, W)).astype(np.float32)
    depth[depth < 3] = 0.0
    P = 128
    batch.update(gt_occ=gt_occ, gt_depth=depth,
                 lidar_xyz=rng.uniform(0, 1, size=(1, P, 3)).astype(np.float32),
                 lidar_valid=np.arange(P)[None] < 100,
                 lidar_label=rng.randint(0, tiny_cfg.NUM_CLASSES, size=(1, P)).astype(np.int32))
    return batch


def _models(train, batch, seed=0):
    cfg = model_cfg_4d()
    jmodel = JaxOccupancyFormer4D(**{k: cfg[k] for k in COMPONENTS}, train=train)
    serve = {k: v for k, v in batch.items() if k in ("imgs", "bda") + CAMS}
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), serve)
    variables = _random_variables(shapes, np.random.RandomState(seed))
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    return cfg, jmodel, variables, model.train(train), serve


def test_4d_forward_matches_jax_in_eval_mode():
    batch = frames_batch(np.random.RandomState(1))
    _, jmodel, variables, model, serve = _models(False, batch)
    ref = jax.jit(jmodel.apply)(variables, serve)
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in serve.items()})
    X, Y, Z = tiny_cfg.VOXEL_GRID
    assert got["mask_feature"].shape[1:4] == (X, Y, Z)
    assert got["depth_prob"].shape[0] == tiny_cfg.NUM_CAMS  # the key frame's
    for k in ("cls_preds", "mask_embeds", "mask_feature", "depth_prob"):
        _close(got[k].numpy(), ref[k], 1e-3, k)
    # the previous frame's geometry reaches the output: its own cameras, not
    # the key frame's (JAX's code, against its docstring)
    same = dict(serve, **{k: _interleave(serve[k][:, 0::2], serve[k][:, 0::2])
                          for k in ("rots", "trans")})
    with torch.no_grad():
        other = model({k: torch.from_numpy(v) for k, v in same.items()})
    assert np.abs(other["cls_preds"].numpy() - got["cls_preds"].numpy()).max() > 1e-3


def test_4d_forward_matches_jax_in_train_mode():
    batch = frames_batch(np.random.RandomState(2))
    _, jmodel, variables, model, serve = _models(True, batch, seed=3)
    is_vt = lambda mdl, method: mdl.name == "view_transformer" and method == "__call__"
    ref, new = jax.jit(lambda v, b: jmodel.apply(
        v, b, mutable=["batch_stats", "intermediates"], capture_intermediates=is_vt,
        rngs={"dropout": jax.random.PRNGKey(4)}))(variables, serve)
    frames_ref = new["intermediates"]["view_transformer"]["__call__"]
    seen = []
    hook = model.img_view_transformer.register_forward_hook(lambda m, i, o: seen.append(o))
    with torch.no_grad():
        got = model({k: torch.from_numpy(v) for k, v in serve.items()})
    hook.remove()
    assert len(seen) == len(frames_ref) == 2
    for f, ((vol, depth), (vol_r, depth_r)) in enumerate(zip(seen, frames_ref)):
        _close(vol.numpy(), vol_r, 1e-3, f"frame {f} volume")
        _close(depth.numpy(), depth_r, 1e-3, f"frame {f} depth")
    _close(got["depth_prob"].numpy(), ref["depth_prob"], 1e-3, "depth_prob")
    want = flax_to_torch_state_dict(dict(variables, batch_stats=new["batch_stats"]), model)
    before = flax_to_torch_state_dict(variables, model)
    stats = [k for k in model.state_dict() if "running" in k]
    assert len(stats) > 40
    for k in stats:
        v = model.state_dict()[k].numpy()
        assert not np.array_equal(v, before[k].numpy()), k
        _close(v, want[k].numpy(), 1e-4, k, atol=1e-6)


def _port_step(route, seed=0):
    cfg = model_cfg_4d()
    model = build_model(cfg, device="cpu", seed=seed).train()
    head = dict(cfg["pts_bbox_head"], mxu_readout=route)
    opt = build_optimizer(model, lr=3e-4, grad_clip=5.0)
    return model, build_train_step(model, opt, build_loss_cfg(head, TRAIN_PTS), device="cpu")


@pytest.mark.parametrize("route", ["off", "on"])
def test_port_4d_train_steps_learn_and_repeat(route):
    """Three 4D steps on one batch, per route: every loss finite, the total
    falls, the previous frame's image features carry no gradient, the
    BatchNorm statistics move twice a step (key frame, then previous), and
    a second run from the same seeds repeats the first bit for bit."""
    batch = train_batch(np.random.RandomState(0))
    runs = []
    for _ in range(2):
        model, step = _port_step(route)
        grads_seen = []
        hook = model.img_neck.register_forward_hook(
            lambda m, i, o: grads_seen.append(o.requires_grad))
        g = torch.Generator().manual_seed(5)
        hist = [step(batch, g) for _ in range(3)]
        hook.remove()
        runs.append((hist, {k: v.clone() for k, v in model.state_dict().items()}))
        assert grads_seen == [True, False] * 3
    hist, state = runs[0]
    for m in hist:
        assert all(torch.isfinite(v) for k, v in m.items() if k != "point_mean_iou"), m
        assert {"loss_depth", "d0.loss_mask", "grad_norm"} <= set(m)
    assert float(hist[-1]["total_loss"]) < float(hist[0]["total_loss"])
    assert int(state["img_backbone.bn1.num_batches_tracked"]) == 6
    assert int(state["img_view_transformer.depth_net.bn.num_batches_tracked"]) == 6
    hist2, state2 = runs[1]
    for a, b in zip(hist, hist2):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(state[k], state2[k]) for k in state)


@pytest.mark.parametrize("route", ["off", "on"])
def test_4d_train_step_matches_jax(route):
    """One tiny 4D step of the port (eval-mode forward, as JAX's step runs
    ``train=False``: its drop-path draws cannot be reproduced) against
    JAX's ``build_train_step`` with AdamW and the same loss draws, on the
    per-layer route ("off") and the batched one (the port's "on" against
    JAX's Pallas "interpret"): every loss, ``total_loss`` and ``grad_norm``
    within 1e-4 relative; the parameters after the update within 3e-6 (3% of
    lr) of JAX's where the port's gradient is at least 1e-2 of its tensor's
    largest, and within 2 lr everywhere (Adam's first step is about -lr *
    sign(g), which flips where g is rounding noise; 3e-6 also covers the
    pixel decoder's LayerNorm scales that JAX's optimizer decays and the
    port's does not, lr * wd * |p| = 1e-6: test_torch_train.py)."""
    batch = train_batch(np.random.RandomState(0))
    cfg, jmodel, variables, model, _ = _models(False, batch, seed=6)
    head = cfg["pts_bbox_head"]
    jcfg = jax_build_loss_cfg(dict(head, mxu_readout="interpret" if route == "on" else "off"),
                              TRAIN_PTS)
    lr = 1e-4
    tx = jax_build_optimizer(variables["params"], lr=jax_step_lr(lr, 10, [20, 23]),
                             grad_clip=5.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    new_state, metrics = jax.jit(jax_build_train_step(jmodel, tx, jcfg))(
        state, batch, jax.random.PRNGKey(1))

    before = {k: v.clone() for k, v in model.state_dict().items()}
    opt = build_optimizer(model, lr=step_lr_schedule(lr, 10, [20, 23]), grad_clip=5.0)
    step = build_train_step(model, opt, build_loss_cfg(dict(head, mxu_readout=route),
                                                       TRAIN_PTS), device="cpu")
    _, loss_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    draws = jax_loss_draws(loss_rng, jcfg, batch["lidar_valid"],
                           head["transformer_decoder"]["num_layers"] + 1)
    seen = {}

    def read_then_step():  # the gradients as the backward left them
        seen.update({k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None})
        return type(opt).step(opt)

    opt.step = read_then_step
    got = step(batch, torch.Generator().manual_seed(0), draws=draws)
    for k in metrics:
        if k == "point_mean_iou":
            continue
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    want = flax_to_torch_state_dict({"params": new_state.params,
                                     "batch_stats": new_state.batch_stats}, model)
    assert len(seen) == len(list(model.parameters()))
    for name, p in model.named_parameters():
        g = seen[name].numpy()
        old = before[name].numpy()
        d_upd = np.abs((p.detach().numpy() - old) - (want[name].numpy() - old))
        big = np.abs(g) >= 1e-2 * np.abs(g).max()
        assert d_upd[big].max(initial=0.0) <= 3e-6, (name, d_upd[big].max())
        assert d_upd.max() <= 2.02 * lr, (name, d_upd.max())


def test_lss_geometry_stays_float32_under_autocast():
    """``ops/geometry.py:get_geometry`` under bf16 autocast equals its float32
    run bit for bit (ROADMAP C.12): the products of its 4x4 chain would
    otherwise run in bf16, which moved 16% of the flagship's valid frustum
    points into another voxel (up to 0.93 m) on the card."""
    from occformer_tpu_torch.ops.geometry import create_frustum, get_geometry

    batch = frames_batch(np.random.RandomState(3))
    cams = [torch.from_numpy(batch[k][:, 0::2]) for k in CAMS] + [torch.from_numpy(batch["bda"])]
    frustum = torch.from_numpy(create_frustum(tiny_cfg.GRID_CONFIG, tiny_cfg.INPUT_SIZE,
                                              tiny_cfg.DOWNSAMPLE))
    want = get_geometry(frustum, *cams)
    with torch.autocast("cpu", dtype=torch.bfloat16):
        got = get_geometry(frustum, *cams)
    assert got.dtype == torch.float32 and torch.equal(got, want)
