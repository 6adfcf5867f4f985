"""The port's SemanticKITTI model against the JAX package, on the CPU.

* The camera geometry and embedding with KITTI's 3x4 P2 intrinsics and a 4x4
  BDA (``tests/test_kitti_e2e.py:_kitti_batch``'s flip and shift, and
  random image augmentations): ``ops/geometry.py:get_geometry`` within
  ``1e-5 * max|ref|`` (the same float32 products in another order) and
  ``models/depthnet.py:get_mlp_input`` exactly.
* The config copy and the key space: ``configs/occformer_kitti.py``'s model
  dict equals JAX's, and its meta model has the 1983 keys and shapes of the
  reference checkpoint (``tests/fixtures/key_manifests/occformer_kitti.json``).
* The whole tiny KITTI model (``tests/test_kitti_e2e.py:_kitti_model_cfg``:
  EfficientNet-b0 at 64 x 64, one camera, the KITTI head): the JAX model's
  variables carried in by ``flax_to_torch_state_dict`` and loaded strictly;
  the forward's outputs within ``1e-3 * max|ref| + 1e-4`` (float32 through
  other conv and matmul libraries across ~60 layers), ``voxel_pred`` equal
  on >= 99.5% of voxels (near-tied class scores may flip), and
  ``evaluate(compute_ssc=True)`` against JAX's ``evaluate`` over two
  labelled frames: every SSC metric within 2e-3 (a flipped voxel moves an
  IoU by about 1e-4).
* One tiny train step against JAX's ``build_train_step`` on the same weights
  and the same loss draws (the grid branch's Gumbel noise from the JAX key
  tree): every loss, ``total_loss`` and ``grad_norm`` within 1e-4 relative.
  It is marked ``slow``: it compiles the JAX train step (about a minute).
* Train-mode BatchNorm over one value a channel (the camera embedding of
  one camera at batch 1) normalizes it to 0, as flax does, exactly; torch's
  own ``batch_norm`` refuses it (ROADMAP C.11).
* The mmcls EfficientNet-B7 init: a synthetic classifier ``.pth`` with the
  1200 keys and shapes of ``init_efficientnet_b7_mmcls.json``, loaded with
  ``prefix="backbone"`` through the config's ``init_cfg``: every backbone
  tensor from the file, the classifier's ``head.*`` outside the prefix.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.engine.eval import build_eval_step as jax_build_eval_step
from occformer_tpu.engine.eval import evaluate as jax_evaluate
from occformer_tpu.models.depthnet import get_mlp_input as jax_get_mlp_input
from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
from occformer_tpu.ops.geometry import create_frustum
from occformer_tpu.ops.geometry import get_geometry as jax_get_geometry
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
from occformer_tpu_torch.engine.eval import build_eval_step, evaluate
from occformer_tpu_torch.engine.pretrained import init_from_pretrained
from occformer_tpu_torch.models.depthnet import get_mlp_input
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.models.efficientnet import CustomEfficientNet
from occformer_tpu_torch.ops.geometry import get_geometry
from test_kitti_e2e import INPUT, _kitti_batch, _kitti_model_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = "configs/occformer_kitti.py"
MANIFESTS = os.path.join(REPO, "tests", "fixtures", "key_manifests")
COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")
TRAIN_PTS = dict(num_points=48, oversample_ratio=2.0, importance_sample_ratio=0.75)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _model_cfg():
    cfg = _kitti_model_cfg()
    cfg["img_view_transformer"]["cam_channels"] = 33  # 3x4 P2 and a 4x4 BDA
    return cfg


def _batch(seed=0, gt=True):
    rng = np.random.RandomState(seed)
    batch = _kitti_batch(rng)
    if gt:
        X, Y, Z = tiny_cfg.OCC_SIZE
        occ = rng.randint(0, tiny_cfg.NUM_CLASSES, (1, X, Y, Z)).astype(np.int32)
        occ[rng.rand(*occ.shape) < 0.6] = 0
        occ[:, :3] = 255
        depth = rng.uniform(0, 10, (1, 1, *INPUT)).astype(np.float32)
        depth[depth < 3] = 0.0
        batch.update(gt_occ=occ, gt_depth=depth)
    return batch


# ---------------------------------------------------------------------------
# geometry and the camera embedding
# ---------------------------------------------------------------------------

def _cameras(seed):
    """_kitti_batch's 3x4 P2 and 4x4 BDA (x flip about the range centre)
    with a random rotation, translation and image augmentation, B = 2."""
    rng = np.random.RandomState(seed)
    b = _kitti_batch(rng, B=2)
    a = rng.uniform(-0.3, 0.3, 2)
    b["rots"] = np.stack([[[[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]]]
                          for t in a]).astype(np.float32)
    b["post_rots"][..., :2, :2] *= rng.uniform(0.9, 1.1, (2, 1, 1, 1)).astype(np.float32)
    b["post_trans"][..., :2] = rng.uniform(-20, 20, (2, 1, 2)).astype(np.float32)
    b["bda"][1, :3, :3] = np.diag([1.0, -1.0, 1.0]).astype(np.float32)  # a y flip
    b["bda"][1, :3, 3] = [0.0, 0.0, 0.3]
    return b


@pytest.mark.parametrize("seed", [0, 1])
def test_geometry_and_camera_embedding_with_3x4_intrinsics_and_4x4_bda(seed):
    b = _cameras(seed)
    keys = ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")
    frustum = create_frustum(tiny_cfg.GRID_CONFIG, INPUT, 16)
    ref = np.asarray(jax_get_geometry(jnp.asarray(frustum), *(jnp.asarray(b[k]) for k in keys)))
    got = get_geometry(torch.from_numpy(frustum), *(torch.from_numpy(b[k]) for k in keys))
    assert got.shape == ref.shape == (2, 1, *frustum.shape)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    ref = np.asarray(jax_get_mlp_input(*(jnp.asarray(b[k]) for k in keys)))
    got = get_mlp_input(*(torch.from_numpy(b[k]) for k in keys))
    assert got.shape == ref.shape == (2, 1, 33)
    np.testing.assert_array_equal(got.numpy(), ref)
    # nuScenes' 3x3 intrinsics with a 4x4 BDA: 27 dims, as JAX
    b3 = dict(b, intrins=np.ascontiguousarray(b["intrins"][..., :3]))
    assert get_mlp_input(*(torch.from_numpy(b3[k]) for k in keys)).shape == (2, 1, 27)


# ---------------------------------------------------------------------------
# the config and the key space
# ---------------------------------------------------------------------------

def test_kitti_config_copies_yield_the_jax_model_dict():
    for name in (KITTI, "configs/occformer_kitti_submit.py",
                 "configs/occformer_kitti_video_demo.py"):
        mine = load_config(os.path.join(REPO, "occformer_tpu_torch", name))
        theirs = jax_load_config(os.path.join(REPO, "occformer_tpu", name))
        assert mine["model"] == theirs["model"], name
        for k in ("occ_size", "compute_dtype", "data_config", "data", "evaluation",
                  "class_names", "num_class"):
            assert mine[k] == theirs[k], (name, k)


def test_kitti_meta_model_matches_reference_key_space():
    with open(os.path.join(MANIFESTS, "occformer_kitti.json")) as f:
        manifest = json.load(f)["keys"]
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", KITTI))
    model = build_model(cfg["model"], device="meta")
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert len(got) == len(manifest) == 1983
    assert got == {k: list(v) for k, v in manifest.items()}
    assert isinstance(model.img_backbone, CustomEfficientNet)


# ---------------------------------------------------------------------------
# the whole tiny model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def both_models():
    cfg = _model_cfg()
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS})
    batch = _batch(gt=False)
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))
    tmodel = build_model(cfg, device="cpu")
    tmodel.load_state_dict(flax_to_torch_state_dict(variables, tmodel), strict=True)
    return cfg, jmodel, variables, tmodel


def _close(got, ref, name):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    tol = 1e-3 * np.abs(ref).max() + 1e-4
    err = np.abs(got - ref).max()
    assert err <= tol, f"{name}: max |diff| {err} > {tol}"


def test_forward_and_eval_step_match_jax(both_models):
    cfg, jmodel, variables, tmodel = both_models
    batch = _batch(1, gt=False)
    ref = jax.jit(jmodel.apply)(variables, batch)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in batch.items()})
    for k in ("cls_preds", "mask_embeds", "mask_feature", "depth_prob"):
        _close(got[k].numpy(), ref[k], k)
    occ, n = tuple(tiny_cfg.OCC_SIZE), tiny_cfg.NUM_CLASSES
    ref = jax_build_eval_step(jmodel, occ, n)(variables, batch)["voxel_pred"]
    got = build_eval_step(tmodel, occ, n)(batch)["voxel_pred"].numpy()
    assert got.shape == ref.shape == (1, *occ) and got.dtype == np.uint8
    assert (got == np.asarray(ref)).mean() >= 0.995


def test_evaluate_ssc_matches_jax(both_models):
    cfg, jmodel, variables, tmodel = both_models
    frames = [_batch(s) for s in (2, 3)]
    for f in frames:
        f.pop("gt_depth")
        f["_meta"] = [{}]
    occ, n = tuple(tiny_cfg.OCC_SIZE), tiny_cfg.NUM_CLASSES
    ref = jax_evaluate(jmodel, variables, frames, occ, n, compute_ssc=True,
                       all_reduce=lambda s: s)
    got = evaluate(tmodel, frames, occ, n, compute_ssc=True)
    assert got.keys() == ref.keys() >= {"semkitti_SC_IoU", "semkitti_SSC_mIoU",
                                        "SSC_precision", "SSC_recall"}
    for k in got:
        assert abs(got[k] - ref[k]) <= 2e-3, (k, got[k], ref[k])


@pytest.mark.slow
def test_train_step_matches_jax_build_train_step(both_models):
    from occformer_tpu.engine.optim import build_optimizer as jax_build_optimizer
    from occformer_tpu.engine.train import TrainState
    from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
    from occformer_tpu.engine.train import build_train_step as jax_build_train_step
    from occformer_tpu_torch.engine.optim import build_optimizer, step_lr_schedule
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from test_torch_kitti_loss import jax_grid_draws

    cfg, _, variables, _ = both_models
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS}, train=False)
    head = cfg["pts_bbox_head"]
    jcfg = jax_build_loss_cfg(head, TRAIN_PTS)
    batch = _batch(4)
    tx = jax_build_optimizer(variables["params"], lr=1e-4, grad_clip=5.0)
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       opt_state=tx.init(variables["params"]))
    _, metrics = jax.jit(jax_build_train_step(jmodel, tx, jcfg))(
        state, batch, jax.random.PRNGKey(1))

    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    model.eval()
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=5.0)
    step = build_train_step(model, opt, build_loss_cfg(head, TRAIN_PTS), device="cpu")
    # train.py:204,166: fold_in(step), then split into the drop and loss keys
    _, loss_rng = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(1), 0))
    L = head["transformer_decoder"]["num_layers"] + 1
    draws = jax_grid_draws(loss_rng, L, 1, tiny_cfg.NUM_CLASSES,
                           int(np.prod(tiny_cfg.OCC_SIZE)))
    got = step(batch, torch.Generator().manual_seed(0), draws=draws)
    assert set(metrics) <= set(got) and "d0.loss_mask" in got and "loss_depth" in got
    for k in metrics:
        np.testing.assert_allclose(float(got[k]), float(metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)


def test_train_mode_batchnorm_of_one_camera_matches_flax():
    from occformer_tpu.models.layers import BatchNorm as JaxBatchNorm
    from occformer_tpu_torch.models.layers import BatchNorm1d

    rng = np.random.RandomState(5)
    x = rng.randn(1, 33).astype(np.float32)
    scale, bias = rng.uniform(0.5, 2, 33).astype(np.float32), rng.randn(33).astype(np.float32)
    jm = JaxBatchNorm(use_running_average=False)
    v = {"params": {"BatchNorm_0": {"scale": scale, "bias": bias}},
         "batch_stats": {"BatchNorm_0": {"mean": np.zeros(33, np.float32),
                                         "var": np.ones(33, np.float32)}}}
    ref, stats = jm.apply(v, x, mutable=["batch_stats"])
    bn = BatchNorm1d(33).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
    xt = torch.from_numpy(x).requires_grad_(True)
    got = bn(xt)
    got.sum().backward()
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.detach().numpy(), bias[None])
    assert float(xt.grad.abs().max()) == 0.0
    for k, name in (("mean", "running_mean"), ("var", "running_var")):
        np.testing.assert_allclose(getattr(bn, name).numpy(),
                                   np.asarray(stats["batch_stats"]["BatchNorm_0"][k]),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the mmcls EfficientNet-B7 init
# ---------------------------------------------------------------------------

def test_mmcls_efficientnet_b7_init_loads_every_backbone_tensor(tmp_path):
    with open(os.path.join(MANIFESTS, "init_efficientnet_b7_mmcls.json")) as f:
        manifest = json.load(f)["keys"]
    assert len(manifest) == 1200
    rng = np.random.RandomState(0)
    sd = {k: (torch.zeros(v, dtype=torch.long) if k.endswith("num_batches_tracked")
              else torch.from_numpy(rng.randn(*v).astype(np.float32)))
          for k, v in manifest.items()}
    path = str(tmp_path / "efficientnet-b7_mmcls.pth")
    torch.save({"state_dict": sd, "meta": {"CLASSES": None}}, path)

    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", KITTI))
    bb_cfg = dict(cfg["model"]["img_backbone"])
    bb_cfg["init_cfg"] = dict(bb_cfg["init_cfg"], checkpoint=path)
    holder = torch.nn.Module()
    holder.img_backbone = CustomEfficientNet(arch="b7", out_indices=(2, 3, 4, 5, 6))
    (report,) = init_from_pretrained(holder, {"img_backbone": bb_cfg})
    assert report["kind"] == "backbone_init" and report["prefix"] == "backbone"
    assert report["kept_init"] == [] and report["unused_keys"] == []
    own = holder.img_backbone.state_dict()
    assert len(own) == 1198
    for k, v in own.items():
        assert torch.equal(v, sd["backbone." + k]), k
    # a missing file keeps the random init, with a report
    bb_cfg["init_cfg"]["checkpoint"] = str(tmp_path / "missing.pth")
    assert init_from_pretrained(holder, {"img_backbone": bb_cfg}) == [
        {"source": bb_cfg["init_cfg"]["checkpoint"], "kind": "backbone_init", "found": False}]
