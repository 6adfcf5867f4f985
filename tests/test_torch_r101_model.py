"""The R101-DCN 896x1600 configuration in the port against the JAX package, on the CPU.

* The configs: ``configs/occformer_nusc_r101_896x1600.py`` and its
  ``_trainval`` variant load through the port's ``config.py`` (the base's
  ``img_backbone`` replaced by ``_delete_=True``) to the JAX package's model,
  data and runtime dicts.
* The key space: the config's model on the meta device has the 1455 keys
  and shapes of the reference checkpoint
  (``tests/fixtures/key_manifests/occformer_nusc_r101_896x1600.json``), a
  caffe-style ResNet-101 with DCNv2 ``conv2`` in its 26 layer3 / layer4
  blocks, ``with_cp``, ``frozen_stages=1`` and ``norm_eval``.
* The FCOS3D init: a synthetic ``load_from`` file with the 694 keys and
  shapes of ``init_r101_dcn_fcos3d.json`` fills every one of the model's 676
  ``img_backbone`` tensors (the 26 ``conv_offset`` pairs among them); only
  its 18 ``img_neck.*`` keys (an FPN's) stay unused.
* The whole tiny model with an R-DCN caffe backbone (ResNet-50, DCNv2 in
  layer3 and layer4, ``frozen_stages=1``, frozen BatchNorm affines,
  ``norm_eval``, ``with_cp``; 2 cameras of 64 x 128, so that layer4's DCN
  sees a 2 x 4 map: at one row JAX's DCN gradients are NaN, see
  ``test_torch_r101_backbone.py``), JAX's random variables carried in by
  ``flax_to_torch_state_dict``:
  - serving: the forward's outputs (class scores, mask embeddings, the
    mask feature, the depth distribution) within ``1e-3 * max|ref| + 1e-4``
    (float32 through other conv and matmul libraries across ~80 layers, as
    ``test_torch_kitti_model.py`` holds the KITTI model);
  - one train step (the port's backbone in train mode: the frozen stem and
    layer1 without gradient, the other blocks recomputed through
    ``with_cp``; the rest of the model in eval mode, as JAX's
    ``build_train_step`` runs it with ``train=False``, whose drop-path draws
    cannot be reproduced) against JAX's ``build_train_step`` on the same
    weights and loss draws: every loss and ``total_loss`` within 1e-4
    relative; ``grad_norm`` within 1e-4 relative of JAX's without the
    frozen stem's and layer1's share (JAX's ``train=False`` backbone
    differentiates them); the image backbone's gradients as the backward
    leaves them (JAX's read off ``optax.identity``'s update) within ``1e-3 *
    max|ref| + 1e-6`` each (measured: 6.4e-5 at most, the offsets' convs
    and the frozen BatchNorm affines included), the frozen stages' absent.
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
from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.engine.train import TrainState
from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
from occformer_tpu.engine.train import build_train_step as jax_build_train_step
from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
from occformer_tpu_torch.engine.optim import (backbone_freeze_mask, build_optimizer,
                                              step_lr_schedule)
from occformer_tpu_torch.engine.pretrained import partial_load_torch
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
from occformer_tpu_torch.models.dcn import DeformConv2d
from occformer_tpu_torch.models.detector import build_model, translate_cfg
from occformer_tpu_torch.models.resnet import ResNet
from test_torch_loss import jax_loss_draws
from test_torch_pretrained import _manifest_sd
from test_torch_r101_backbone import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R101 = "configs/occformer_nusc_r101_896x1600.py"
TRAINVAL = "configs/occformer_nusc_r101_896x1600_trainval.py"
MANIFESTS = os.path.join(REPO, "tests", "fixtures", "key_manifests")
COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")
TRAIN_PTS = dict(num_points=48, oversample_ratio=2.0, importance_sample_ratio=0.75)
INPUT = (64, 128)
META = pytest.mark.filterwarnings("ignore:.*meta parameter")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(name):
    return load_config(os.path.join(REPO, "occformer_tpu_torch", name))


# ---------------------------------------------------------------------------
# the configs and the key space
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", [R101, TRAINVAL])
def test_r101_configs_yield_the_jax_dicts(name):
    mine = _config(name)
    theirs = jax_load_config(os.path.join(REPO, "occformer_tpu", name))
    for k in ("model", "data", "data_config", "img_norm_cfg", "occ_size", "load_from",
              "fp16", "compute_dtype", "evaluation", "optimizer", "lr_config", "runner"):
        assert mine[k] == theirs[k], (name, k)
    bb = mine["model"]["img_backbone"]
    assert "_delete_" not in bb and "pretrained" not in bb and bb["style"] == "caffe"
    assert mine["img_norm_cfg"] == dict(mean=[103.530, 116.280, 123.675], std=[1.0, 1.0, 1.0],
                                        to_rgb=False)
    test_steps = mine["data"]["test"]["pipeline"]
    assert test_steps[-1].get("is_test_submit", False) == (name == TRAINVAL)


@META
def test_r101_meta_model_matches_the_reference_key_space():
    cfg = _config(R101)["model"]
    cls, kw = translate_cfg(cfg["img_backbone"])
    assert cls is ResNet and kw == dict(depth=101, out_indices=(0, 1, 2, 3), frozen_stages=1,
                                        norm_eval=True, style="caffe", dcn_stages=(2, 3),
                                        with_cp=True)
    model = build_model(cfg, device="meta")
    with open(os.path.join(MANIFESTS, "occformer_nusc_r101_896x1600.json")) as f:
        manifest = json.load(f)["keys"]
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert len(got) == len(manifest) == 1455
    assert got == {k: list(v) for k, v in manifest.items()}
    dcns = [n for n, m in model.img_backbone.named_modules() if isinstance(m, DeformConv2d)]
    assert len(dcns) == 26 and all(model.img_backbone.get_submodule(n).modulated for n in dcns)
    assert {n.split(".")[0] for n in dcns} == {"layer3", "layer4"}
    assert model.img_backbone.layer3[0].conv1.stride == (2, 2)


@META
def test_fcos3d_load_from_fills_every_backbone_tensor():
    model = build_model(_config(R101)["model"], device="meta")
    sd = _manifest_sd("init_r101_dcn_fcos3d")
    assert len(sd) == 694
    rep = partial_load_torch(model, "r101_dcn_fcos3d_pretrain.pth", state_dict=sd)
    assert rep["loaded_subtrees"] == ["img_backbone"]
    assert rep["skipped_subtrees"] == ["img_neck"]
    assert rep["kept_init"] == []
    assert len(rep["unused_keys"]) == 18
    assert all(k.startswith("img_neck.") for k in rep["unused_keys"])
    backbone = {f"img_backbone.{k}" for k in model.img_backbone.state_dict()}
    assert len(backbone) == 676 and backbone <= set(sd)
    assert sum(".conv_offset." in k for k in backbone) == 52


# ---------------------------------------------------------------------------
# the whole tiny R-DCN model
# ---------------------------------------------------------------------------

def _model_cfg():
    cfg = tiny_cfg.model_cfg()
    cfg["img_backbone"] = dict(
        type="ResNet", depth=50, num_stages=4, out_indices=(0, 1, 2, 3), frozen_stages=1,
        norm_cfg=dict(type="BN2d", requires_grad=False), norm_eval=True, style="caffe",
        with_cp=True, dcn=dict(type="DCNv2", deform_groups=1, fallback_on_stride=False),
        stage_with_dcn=(False, False, True, True))
    cfg["img_neck"]["in_channels"] = [256, 512, 1024, 2048]
    cfg["img_view_transformer"]["data_config"] = dict(input_size=INPUT,
                                                      Ncams=tiny_cfg.NUM_CAMS)
    return cfg


def _batch(rng):
    """tests/test_torch_train.py's tiny train batch at 64 x 128."""
    N, (H, W) = tiny_cfg.NUM_CAMS, INPUT
    X, Y, Z = tiny_cfg.OCC_SIZE
    intrins = np.tile(np.eye(3, dtype=np.float32), (1, N, 1, 1))
    intrins[..., 0, 0] = intrins[..., 1, 1] = 60.0
    intrins[..., 0, 2], intrins[..., 1, 2] = W / 2, H / 2
    eye = np.tile(np.eye(3, dtype=np.float32), (1, N, 1, 1))
    gt_occ = rng.randint(0, tiny_cfg.NUM_CLASSES, size=(1, X, Y, Z)).astype(np.int32)
    gt_occ[0, :2] = 255
    depth = rng.uniform(0, 10, size=(1, N, H, W)).astype(np.float32)
    depth[depth < 3] = 0.0
    P = 128
    lidar_valid = np.ones((1, P), bool)
    lidar_valid[:, 100:] = False
    return {"imgs": rng.randn(1, N, H, W, 3).astype(np.float32), "rots": eye,
            "trans": rng.uniform(-1, 1, (1, N, 3)).astype(np.float32), "intrins": intrins,
            "post_rots": eye.copy(), "post_trans": np.zeros((1, N, 3), np.float32),
            "bda": np.eye(3, dtype=np.float32)[None], "gt_occ": gt_occ, "gt_depth": depth,
            "lidar_xyz": rng.uniform(0, 1, size=(1, P, 3)).astype(np.float32),
            "lidar_valid": lidar_valid,
            "lidar_label": rng.randint(0, tiny_cfg.NUM_CLASSES, size=(1, P)).astype(np.int32)}


def test_tiny_rdcn_model_serves_and_trains_as_jax():
    cfg = _model_cfg()
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS}, train=False)
    variables = _random_variables(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch),
                                  rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    assert model.img_backbone.with_cp and model.img_backbone.layer4[2].conv2.modulated

    # serving: the forward's outputs (the eval step's readout of them is
    # held to JAX's in test_torch_model.py)
    serve = {k: v for k, v in batch.items() if k not in ("gt_occ", "gt_depth")}
    ref = jax.jit(jmodel.apply)(variables, serve)
    with torch.no_grad():
        got = model.eval()({k: torch.from_numpy(v) for k, v in serve.items()})
    for k in ("cls_preds", "mask_embeds", "mask_feature", "depth_prob"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape, (k, g.shape, r.shape)
        err, tol = np.abs(g - r).max(), 1e-3 * np.abs(r).max() + 1e-4
        assert err <= tol, (k, err, tol)

    # one train step
    head = cfg["pts_bbox_head"]
    jcfg = jax_build_loss_cfg(dict(head, mxu_readout="off"), TRAIN_PTS)
    tx = optax.identity()  # its update is the gradient
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    new_state, metrics = jax.jit(jax_build_train_step(jmodel, tx, jcfg))(
        state, batch, jax.random.PRNGKey(1))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   new_state.params, variables["params"])
    frozen_sq = sum(float(np.sum(np.square(g))) for name, sub in grads["backbone"].items()
                    if name in ("conv1", "bn1") or name.startswith("layer1_")
                    for g in jax.tree_util.tree_leaves(sub))

    model.eval()
    model.img_backbone.train()
    assert not any(m.training for m in model.img_backbone.modules()
                   if isinstance(m, torch.nn.BatchNorm2d))
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=5.0,
                          freeze_mask=backbone_freeze_mask(model, cfg["img_backbone"]))
    step = build_train_step(model, opt, build_loss_cfg(head, TRAIN_PTS), device="cpu")
    # train.py:204,166: fold_in(step), then split into the drop and loss keys
    _, loss_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    draws = jax_loss_draws(loss_rng, jcfg, batch["lidar_valid"],
                           head["transformer_decoder"]["num_layers"] + 1)
    seen = {}

    def read_then_step():  # the gradients as the backward left them
        seen.update({k: None if p.grad is None else p.grad.clone()
                     for k, p in model.named_parameters()})
        return type(opt).step(opt)

    opt.step = read_then_step
    got = step(batch, torch.Generator().manual_seed(0), draws=draws)
    for k in metrics:
        if k in ("point_mean_iou", "grad_norm"):
            continue
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    want_norm = np.sqrt(float(metrics["grad_norm"]) ** 2 - frozen_sq)
    np.testing.assert_allclose(float(got["grad_norm"]), want_norm, rtol=1e-4)

    want = flax_to_torch_state_dict({"params": grads, "batch_stats": variables["batch_stats"]},
                                    model)
    for k, g in seen.items():
        if not k.startswith("img_backbone."):
            continue
        if k.split(".")[1] in ("conv1", "bn1", "layer1"):
            assert g is None, k
            continue
        ref = want[k].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max() + 1e-6, (k, err, np.abs(ref).max())
