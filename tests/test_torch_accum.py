"""Gradient accumulation in the port's train step (``accum_steps``).

* ``build_train_step(accum_steps=2)`` on a batch of two equals its
  definition, written out here: two micro-steps of one sample each, in
  train mode (BatchNorm statistics updated in sequence, drop-path masks and
  then the loss draws of each micro-batch taken from the generator in turn,
  replayed by gradient checkpointing), gradients and metrics averaged, one
  optimizer update.
* The same step against JAX's ``build_train_step(accum_steps=2)`` is marked
  ``slow``: it compiles the JAX step with two micro-batches twice (one and a
  half to three minutes on the CPU).  Run it by hand after touching the train step:
  ``JAX_PLATFORMS=cpu python -m pytest tests/test_torch_accum.py -q -m slow``
"""
import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import tiny_cfg
from occformer_tpu_torch.engine.optim import build_optimizer, step_lr_schedule
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
from occformer_tpu_torch.losses.mask2former_loss import make_loss_draws, mask2former_loss
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.models.layers import drop_path_generator
from occformer_tpu_torch.models.lss import depth_bce_loss

TRAIN_PTS = dict(num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train_batch(rng, B):
    """tests/test_torch_train.py's tiny train batch with B samples."""
    batch = tiny_cfg.make_batch(rng, B=B)
    N, (H, W) = tiny_cfg.NUM_CAMS, tiny_cfg.INPUT_SIZE
    X, Y, Z = tiny_cfg.OCC_SIZE
    P = 128
    gt_occ = rng.randint(0, tiny_cfg.NUM_CLASSES, size=(B, X, Y, Z)).astype(np.int32)
    gt_occ[:, :2] = 255
    depth = rng.uniform(0, 10, size=(B, N, H, W)).astype(np.float32)
    depth[depth < 3] = 0.0
    batch.update(gt_occ=gt_occ, gt_depth=depth,
                 lidar_xyz=rng.uniform(0, 1, size=(B, P, 3)).astype(np.float32),
                 lidar_valid=np.arange(P)[None].repeat(B, 0) < 100 + 10 * np.arange(B)[:, None],
                 lidar_label=rng.randint(0, tiny_cfg.NUM_CLASSES, size=(B, P)).astype(np.int32))
    return batch


def test_accum_steps_two_equals_two_micro_steps():
    cfg = tiny_cfg.model_cfg()
    cfg["img_bev_encoder_backbone"] = dict(cfg["img_bev_encoder_backbone"], with_cp=True)
    head = dict(cfg["pts_bbox_head"], mxu_readout="on")
    loss_cfg = build_loss_cfg(head, TRAIN_PTS)
    batch = _train_batch(np.random.RandomState(0), B=2)
    model = build_model(cfg, device="cpu", seed=0).train()
    ref_model = copy.deepcopy(model)

    opt = build_optimizer(model, lr=1e-3, grad_clip=5.0)
    step = build_train_step(model, opt, loss_cfg, device="cpu", accum_steps=2)
    got = step(batch, torch.Generator().manual_seed(7))
    with pytest.raises(ValueError, match="per micro-batch"):
        step(batch, torch.Generator(), draws={})
    with pytest.raises(ValueError, match="divisible"):
        step({k: v[:1] for k, v in batch.items()}, torch.Generator())

    # the definition
    params = list(ref_model.parameters())
    ref_opt = build_optimizer(ref_model, lr=1e-3, grad_clip=5.0)
    vt = ref_model.img_view_transformer
    g = torch.Generator().manual_seed(7)
    sums, per = [None] * len(params), []
    for m in range(2):
        mb = {k: torch.from_numpy(v[m:m + 1]) for k, v in batch.items()}
        with drop_path_generator(g):
            out = ref_model(mb)
        draws = make_loss_draws(g, loss_cfg, mb["lidar_valid"], out["cls_preds"].shape[0])
        losses = mask2former_loss(out["cls_preds"], out["mask_embeds"], out["mask_feature"],
                                  mb["gt_occ"], loss_cfg, mb["lidar_xyz"], mb["lidar_valid"],
                                  draws)
        losses["loss_depth"] = depth_bce_loss(mb["gt_depth"], out["depth_prob"],
                                              vt.grid_config, vt.downsample,
                                              vt.loss_depth_weight)
        total = sum(v for k, v in losses.items() if "loss" in k)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        sums = [s if d is None else (d if s is None else s + d) for s, d in zip(sums, grads)]
        per.append(dict({k: v.detach() for k, v in losses.items()}, total_loss=total.detach()))
    for p, s in zip(params, sums):
        p.grad = None if s is None else s / 2
    grad_norm = ref_opt.step()

    assert int(model.img_backbone.bn1.num_batches_tracked) == 2
    for k, v in per[0].items():
        torch.testing.assert_close(got[k], (v + per[1][k]) / 2, rtol=1e-6, atol=1e-7,
                                   msg=k)
    torch.testing.assert_close(got["grad_norm"], grad_norm, rtol=1e-6, atol=0)
    assert float(per[0]["total_loss"]) != float(per[1]["total_loss"])
    for (name, p), r in zip(model.named_parameters(), params):
        if r.grad is not None:
            torch.testing.assert_close(p.grad, r.grad, rtol=1e-5, atol=1e-8, msg=name)
    ref_state = ref_model.state_dict()
    for k, v in model.state_dict().items():  # parameters and BatchNorm statistics
        torch.testing.assert_close(v, ref_state[k], rtol=1e-6, atol=1e-8, msg=k)


@pytest.mark.slow
def test_accum_step_matches_jax_build_train_step():
    """The port's ``accum_steps=2`` step against JAX's on the same weights,
    batch and loss draws (eval-mode forward, as in
    tests/test_torch_train.py::test_train_step_matches_jax_build_train_step,
    whose tolerances and reasons hold here): metrics within 1e-4 relative,
    gradients (JAX's read off a second step with ``optax.identity``) all but
    at most 3 tensors within 1e-2 * max|ref| + 1e-6 and all within 6e-2 *
    max|ref| + 1e-6."""
    from occformer_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from occformer_tpu.engine.optim import step_lr_schedule as jax_step_lr
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
    batch = _train_batch(np.random.RandomState(0), B=2)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                         {k: v[:1] for k, v in batch.items()}))

    def jax_step(tx):
        state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                           batch_stats=variables["batch_stats"],
                           opt_state=tx.init(variables["params"]))
        return jax.jit(jax_build_train_step(jmodel, tx, jcfg, accum_steps=2))(
            state, batch, jax.random.PRNGKey(1))

    lr = jax_step_lr(1e-4, 10, [20, 23])
    _, metrics = jax_step(jax_build_optimizer(variables["params"], lr=lr, grad_clip=5.0))
    plus, _ = jax_step(optax.identity())
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   plus.params, variables["params"])

    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    model.eval()
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=5.0)
    step = build_train_step(model, opt, build_loss_cfg(cfg["pts_bbox_head"], TRAIN_PTS),
                            device="cpu", accum_steps=2)
    # train.py:204,222-236: fold_in(step), one key per micro-batch, each split
    # into the drop and loss keys
    L = cfg["pts_bbox_head"]["transformer_decoder"]["num_layers"] + 1
    micro_keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0), 2)
    draws = [jax_loss_draws(jax.random.split(k)[1], jcfg, batch["lidar_valid"][m:m + 1], L)
             for m, k in enumerate(micro_keys)]
    got = step(batch, torch.Generator().manual_seed(0), draws=draws)

    for k in metrics:
        if k != "point_mean_iou":
            np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
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
    assert max(v[1] for v in shares.values()) <= 1.0
