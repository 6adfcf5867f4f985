"""Split evaluation of the port against the JAX package's ``evaluate``.

The tiny CLI model (``configs/synthetic_tiny.py``) is initialized in JAX, its
variables are carried into the port with ``flax_to_torch_state_dict``, and
both packages' ``evaluate`` run over the same 2 synthetic samples on the
CPU in float32.  The confusion matrices come out identical here, so the
metric tables are held equal; the port's ``evaluate`` is also held to the
sum of its eval step's per-sample matrices.  (The two packages' raw
outputs agree to about 1e-3 of their scale, tests/test_torch_model.py, so a
point whose top two logits lie that close could flip; none of these does.)
"""
import os

import jax
import numpy as np
import pytest
import torch

from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.data.loader import build_dataloader as jax_build_dataloader
from occformer_tpu.data.synthetic import SyntheticOccDataset as JaxSynthetic
from occformer_tpu.engine.eval import build_eval_step as jax_build_eval_step
from occformer_tpu.engine.eval import evaluate as jax_evaluate
from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.data.loader import build_dataloader, build_dataset
from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
from occformer_tpu_torch.engine.eval import build_eval_step, evaluate
from occformer_tpu_torch.models.detector import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "configs/synthetic_tiny.py"
COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loader(cfg, build, ds):
    return build(ds, samples_per_gpu=1, shuffle=False, max_points=cfg["max_lidar_points"])


def test_evaluate_matches_jax():
    over = {"data.test.num_samples": 2}
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", TINY), over)
    jcfg = jax_load_config(os.path.join(REPO, "occformer_tpu", TINY), over)
    occ, n, names = tuple(cfg["occ_size"]), cfg["num_class"], cfg["class_names"]

    jmodel = JaxOccupancyFormer(**{k: jcfg["model"][k] for k in COMPONENTS})
    jloader = _loader(jcfg, jax_build_dataloader,
                      JaxSynthetic(**{k: v for k, v in jcfg["data"]["test"].items()
                                      if k != "type"}))
    first = dict(next(iter(jloader)))
    first.pop("_meta")
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0), first))
    tmodel = build_model(cfg["model"], device="cpu")
    tmodel.load_state_dict(flax_to_torch_state_dict(variables, tmodel), strict=True)
    loader = _loader(cfg, build_dataloader, build_dataset(cfg["data"]["test"], test_mode=True))

    # per-sample confusion matrices of both eval steps
    jstep, tstep = jax_build_eval_step(jmodel, occ, n), build_eval_step(tmodel, occ, n)
    cms = []
    for jb, tb in zip(jloader, loader):
        for b in (jb, tb):
            b.pop("_meta")
            b.pop("gt_occ")
        cms.append((np.asarray(jstep(variables, jb)["confusion"]),
                    tstep(tb)["confusion"].numpy()))
    assert len(cms) == 2
    for j, t in cms:
        assert j.sum() == t.sum() == cfg["max_lidar_points"]
        assert np.array_equal(j, t)

    ref = jax_evaluate(jmodel, variables, jloader, occ, n, class_names=names)
    got = evaluate(tmodel, loader, occ, n, class_names=names)
    assert "nuScenes_lidarseg_mean" in got
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k])), k


def test_evaluate_raises_for_branches_of_later_slices():
    """Every branch is ported now: an empty split gives each branch's keys
    (the SSC branch is held to JAX's in tests/test_torch_kitti_pipeline.py,
    the panoptic one in tests/test_torch_panoptic_eval.py)."""
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", TINY))
    model = build_model(cfg["model"], device="cpu")
    got = evaluate(model, [], tuple(cfg["occ_size"]), cfg["num_class"], compute_ssc=True)
    assert got["semkitti_SC_IoU"] == 0.0 and "semkitti_SSC_mIoU" in got
    got = evaluate(model, [], tuple(cfg["occ_size"]), cfg["num_class"], panoptic=True,
                   thing_indices=[1, 2])
    assert {k for k in got if "panoptic" in k} == {
        "nuScenes_panoptic_PQ", "nuScenes_panoptic_SQ", "nuScenes_panoptic_RQ"}
    assert got["nuScenes_panoptic_PQ"] == 0.0
