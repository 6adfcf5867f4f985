"""The PyTorch port's serving slice against the JAX package, end to end.

The JAX tiny model (tests/tiny_cfg.py) is initialized, its variables are
carried into the port with ``flax_to_torch_state_dict`` and loaded strictly,
and both eval steps run on the same batch on the CPU in float32.

Tolerances: the raw outputs agree within ``1e-3 * max|ref| + 1e-4``: both
sides run the same float32 math, but through different conv/matmul
libraries and summation orders, across ~40 layers.  The argmax outputs agree
on >= 99.5% of entries: near-tied class scores may flip.
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

import tiny_cfg
from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.engine.eval import build_eval_step as jax_build_eval_step
from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
from occformer_tpu_torch.engine.eval import build_eval_step
from occformer_tpu_torch.models.detector import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = "configs/occformer_nusc_r50_256x704.py"
COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    rng = np.random.RandomState(0)
    batch = tiny_cfg.make_batch(rng)
    P = 256
    batch["lidar_xyz"] = rng.uniform(0, 1, (1, P, 3)).astype(np.float32)
    batch["lidar_valid"] = rng.rand(1, P) > 0.1
    batch["lidar_label"] = rng.randint(1, tiny_cfg.NUM_CLASSES, (1, P)).astype(np.int32)
    return batch


@pytest.fixture(scope="module")
def both_models():
    cfg = tiny_cfg.model_cfg()
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS})
    batch = _batch()
    jbatch = {k: v for k, v in batch.items() if not k.startswith("lidar")}
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    with torch.random.fork_rng():
        tmodel = build_model(cfg, device="cpu")
    sd = flax_to_torch_state_dict(variables, tmodel)
    tmodel.load_state_dict(sd, strict=True)
    return jmodel, variables, tmodel, batch


def _close(got, ref, name):
    ref = np.asarray(ref, np.float32)
    got = np.asarray(got, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    tol = 1e-3 * np.abs(ref).max() + 1e-4
    err = np.abs(got - ref).max()
    assert err <= tol, f"{name}: max |diff| {err} > {tol}"


def test_forward_outputs_match_jax(both_models):
    jmodel, variables, tmodel, batch = both_models
    jbatch = {k: v for k, v in batch.items() if not k.startswith("lidar")}
    ref = jax.jit(jmodel.apply)(variables, jbatch)
    with torch.no_grad():
        got = tmodel({k: torch.from_numpy(v) for k, v in jbatch.items()})
    for k in ("cls_preds", "mask_embeds", "mask_feature", "depth_prob"):
        _close(got[k].numpy(), ref[k], k)


def test_eval_step_matches_jax(both_models):
    jmodel, variables, tmodel, batch = both_models
    occ, n = tuple(tiny_cfg.OCC_SIZE), tiny_cfg.NUM_CLASSES
    ref = jax_build_eval_step(jmodel, occ, n)(variables, batch)
    got = build_eval_step(tmodel, occ, n)(batch)
    for k in ("voxel_pred", "point_pred"):
        g, r = got[k].numpy(), np.asarray(ref[k])
        assert g.shape == r.shape and g.dtype == r.dtype, (k, g.shape, r.shape)
        assert (g == r).mean() >= 0.995, (k, (g == r).mean())
    cm_g, cm_r = got["confusion"].numpy(), np.asarray(ref["confusion"])
    assert cm_g.shape == cm_r.shape == (n, n)
    assert cm_g.sum() == cm_r.sum() == batch["lidar_valid"].sum()


def test_flagship_meta_model_matches_reference_key_space():
    path = os.path.join(REPO, "tests", "fixtures", "key_manifests",
                        "occformer_nusc_r50_256x704.json")
    with open(path) as f:
        manifest = json.load(f)["keys"]
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", FLAGSHIP))
    model = build_model(cfg["model"], device="meta")
    got = {k: list(v.shape) for k, v in model.state_dict().items()}
    assert len(got) == len(manifest) == 1097
    assert got == {k: list(v) for k, v in manifest.items()}
    assert sum(k.endswith("num_batches_tracked") for k in got) == 71
    assert sum(k.endswith("relative_position_index") for k in got) == 8


def test_config_copy_yields_the_jax_model_dict():
    mine = load_config(os.path.join(REPO, "occformer_tpu_torch", FLAGSHIP))
    theirs = jax_load_config(os.path.join(REPO, "occformer_tpu", FLAGSHIP))
    assert mine["model"] == theirs["model"]
    for k in ("occ_size", "compute_dtype", "max_lidar_points", "data_config"):
        assert mine[k] == theirs[k], k
