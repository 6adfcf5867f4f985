"""The panoptic configuration's model and train step in the port against the
JAX package, on the CPU.

* The config: ``configs/occformer_nusc_panoptic_r50_256x704.py`` loads
  through the port's ``config.py`` (the flagship base merged, the pipelines
  replaced wholesale) to the JAX package's model, data and runtime dicts;
  the grad clip of 0.01 reaches the optimizer.
* The key space: the config's model on the meta device has the flagship
  checkpoint's 1097 keys (``tests/fixtures/key_manifests/
  occformer_nusc_r50_256x704.json``) with the same shapes but for
  ``query_embed`` / ``query_feat``, which are [150, 192]; the head is the
  panoptic one, with the config's stuff and thing classes, and the image
  ResNet runs ``with_cp``.
* ``build_loss_cfg`` reads the panoptic head (``panoptic``; its
  ``feature_readout`` and ``point_chunks`` ignored).
* One train step of the tiny model with the panoptic head (150 queries),
  JAX's random variables carried across by ``flax_to_torch_state_dict``,
  on a batch of panoptic ids (``class * 1000 + instance``, 65535 noise) and
  its padded id table (32 slots), against JAX's ``build_train_step`` (the
  model in eval mode, as JAX's ``train=False``) with the same loss draws:
  every loss and ``total_loss`` within 1e-4 relative, ``grad_norm`` within
  1e-4 relative, every gradient within ``1e-3 * max|ref| + 1e-6`` (JAX's
  read off ``optax.identity``'s update), and no ``point_mean_iou``: the
  panoptic LiDAR labels are not classes.
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
from occformer_tpu_torch.engine.optim import (build_optimizer, build_optimizer_from_config,
                                              step_lr_schedule)
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.models.mask2former_head import Mask2FormerNuscPanopticOccHead
from test_torch_loss import jax_loss_draws
from test_torch_panoptic_loss import panoptic_gt
from test_torch_r101_backbone import _random_variables

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/occformer_nusc_panoptic_r50_256x704.py"
COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")
TRAIN_PTS = dict(num_points=48, oversample_ratio=2.0, importance_sample_ratio=0.75)
SLOTS = 32  # the id table's width: 12 real slots, 2 invalid, 18 padding
META = pytest.mark.filterwarnings("ignore:.*meta parameter")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_panoptic_config_yields_the_jax_dicts():
    mine = load_config(os.path.join(REPO, "occformer_tpu_torch", CONFIG))
    theirs = jax_load_config(os.path.join(REPO, "occformer_tpu", CONFIG))
    for k in ("model", "data", "data_config", "img_norm_cfg", "occ_size", "class_names",
              "point_cloud_range", "bda_aug_conf", "optimizer", "optimizer_config",
              "lr_config", "runner", "evaluation", "compute_dtype", "max_lidar_points"):
        assert mine[k] == theirs[k], k
    head = mine["model"]["pts_bbox_head"]
    assert head["type"] == "Mask2FormerNuscPanopticOccHead" and head["num_queries"] == 150
    assert head["thing_indices"] == list(range(1, 11)) and head["stuff_indices"] == [
        0, 11, 12, 13, 14, 15, 16]
    assert mine["model"]["img_backbone"]["with_cp"]
    assert mine["model"]["train_cfg"]["pts"]["num_points"] == 50176
    assert [p["type"] for p in mine["data"]["test"]["pipeline"]][-1] == \
        "LoadNuscPanopticOccupancyAnnotations"
    assert mine["evaluation"] == dict(interval=999, save_best="nuScenes_panoptic_PQ",
                                      rule="greater")
    cfg = build_loss_cfg(head, mine["model"]["train_cfg"]["pts"])
    assert cfg.panoptic and cfg.use_lidar_points and cfg.num_points == 50176
    assert not cfg.batched_readout
    model = build_model(tiny_cfg.model_cfg(), device="cpu")
    assert build_optimizer_from_config(model, mine, 100).grad_clip == 0.01


@META
def test_panoptic_meta_model_has_the_flagship_keys_with_150_queries():
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", CONFIG))
    model = build_model(cfg["model"], device="meta")
    with open(os.path.join(REPO, "tests", "fixtures", "key_manifests",
                           "occformer_nusc_r50_256x704.json")) as f:
        manifest = {k: list(v) for k, v in json.load(f)["keys"].items()}
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert len(got) == len(manifest) == 1097
    queries = {"pts_bbox_head.query_embed.weight", "pts_bbox_head.query_feat.weight"}
    assert {k: v for k, v in got.items() if k not in queries} == \
        {k: v for k, v in manifest.items() if k not in queries}
    assert all(got[k] == [150, 192] and manifest[k] == [100, 192] for k in queries)
    head = model.pts_bbox_head
    assert isinstance(head, Mask2FormerNuscPanopticOccHead)
    assert head.thing_indices == tuple(range(1, 11)) and head.stuff_indices[0] == 0
    assert model.img_backbone.with_cp


def _batch(rng, slots=SLOTS):
    b = tiny_cfg.make_batch(rng)
    N, (H, W) = tiny_cfg.NUM_CAMS, tiny_cfg.INPUT_SIZE
    gt, table = panoptic_gt(rng, 1, slots=slots)
    depth = rng.uniform(0, 10, (1, N, H, W)).astype(np.float32)
    depth[depth < 3] = 0.0
    P = 128
    sem = rng.randint(1, tiny_cfg.NUM_CLASSES, (1, P))
    b.update(gt_occ=gt, panoptic_ids=table, gt_depth=depth,
             lidar_xyz=rng.uniform(0, 1, (1, P, 3)).astype(np.float32),
             lidar_valid=np.arange(P)[None] < 100,
             lidar_label=(sem * 1000 + rng.randint(0, 3, (1, P))).astype(np.int32))
    return b


def test_tiny_panoptic_train_step_matches_jax():
    cfg = tiny_cfg.model_cfg()
    head = dict(cfg["pts_bbox_head"], type="Mask2FormerNuscPanopticOccHead", num_queries=150,
                stuff_indices=[0, 3, 4], thing_indices=[1, 2], feature_readout=True,
                point_chunks=8)
    cfg["pts_bbox_head"] = head
    rng = np.random.RandomState(0)
    batch = _batch(rng)
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS}, train=False)
    variables = _random_variables(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch),
                                  rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    assert model.pts_bbox_head.query_feat.weight.shape == (150, tiny_cfg.VOXEL_OUT)

    jcfg = jax_build_loss_cfg(dict(head, mxu_readout="off"), TRAIN_PTS)
    assert jcfg.panoptic
    tx = optax.identity()  # its update is the gradient
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    new_state, metrics = jax.jit(jax_build_train_step(jmodel, tx, jcfg))(
        state, batch, jax.random.PRNGKey(1))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a) - np.asarray(b),
                                   new_state.params, variables["params"])
    assert "point_mean_iou" not in metrics

    model.eval()
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=0.01)
    loss_cfg = build_loss_cfg(head, TRAIN_PTS)
    assert loss_cfg.panoptic
    step = build_train_step(model, opt, loss_cfg, device="cpu")
    # train.py:204,166: fold_in(step), then split into the drop and loss keys
    _, loss_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    draws = jax_loss_draws(loss_rng, jcfg, batch["lidar_valid"],
                           head["transformer_decoder"]["num_layers"] + 1, num_slots=SLOTS)
    seen = {}

    def read_then_step():  # the gradients as the backward left them
        seen.update({k: p.grad.clone() for k, p in model.named_parameters()
                     if p.grad is not None})
        return type(opt).step(opt)

    opt.step = read_then_step
    got = step(batch, torch.Generator().manual_seed(0), draws=draws)
    assert "point_mean_iou" not in got and set(metrics) <= set(got)
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    assert float(got["unassigned_gt"]) == 0.0 and float(got["loss_mask"]) > 0
    want = flax_to_torch_state_dict({"params": grads, "batch_stats": variables["batch_stats"]},
                                    model)
    assert len(seen) > 100
    for k, g in seen.items():
        ref = want[k].numpy()
        err = np.abs(g.numpy() - ref).max()
        assert err <= 1e-3 * np.abs(ref).max() + 1e-6, (k, err, np.abs(ref).max())
