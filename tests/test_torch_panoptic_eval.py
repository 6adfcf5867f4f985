"""Panoptic evaluation of the port against the JAX package, on the CPU.

* ``utils/panoptic.py:PanopticEval`` against JAX's on random segments (a
  perfect prediction, partial overlaps, class 0 ignored, stuff and thing
  segments, segments under ``min_points``): the counters of ``state()``
  and ``get_pq()`` equal, exactly.
* ``format_panoptic_results`` against JAX's on random logits, with and
  without ``skip_empty_argmax``: the semantic and panoptic ids equal.
* The tiny model with the panoptic head (8 queries), JAX's variables
  carried across by ``flax_to_torch_state_dict``, through both packages'
  ``build_eval_step(..., panoptic=True)`` on the same batches: ``point_cls``
  and ``point_mask`` within ``1e-3 * max|ref| + 1e-4`` (float32 through
  other conv and matmul libraries, as ``test_torch_r101_model.py`` holds
  the forward), the confusion matrix of the labels' class part equal; and
  ``evaluate(panoptic=True, thing_indices=...)``'s PQ / SQ / RQ and IoU
  table equal to JAX's.  The LiDAR labels are each sample's JAX-formatted
  prediction with a fifth of the points moved to other ids, so that
  segments match, miss and overlap.  (No point's two best queries lie
  within the packages' 1e-3 here, so the formatting agrees exactly, as in
  ``test_torch_evaluate.py``.)
"""
import numpy as np
import pytest
import torch

import jax

import tiny_cfg
from occformer_tpu.engine import eval as jax_eval
from occformer_tpu.engine.eval import build_eval_step as jax_build_eval_step
from occformer_tpu.engine.eval import evaluate as jax_evaluate
from occformer_tpu.models.detector import OccupancyFormer as JaxOccupancyFormer
from occformer_tpu.utils.panoptic import PanopticEval as JaxPanopticEval
from occformer_tpu.utils.panoptic import format_panoptic_results as jax_format
from occformer_tpu_torch.engine.convert_weights import flax_to_torch_state_dict
from occformer_tpu_torch.engine.eval import build_eval_step, evaluate
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.utils.panoptic import PanopticEval, format_panoptic_results
from test_torch_r101_backbone import _random_variables

NC = tiny_cfg.NUM_CLASSES
THINGS = [1, 2]
COMPONENTS = ("img_backbone", "img_neck", "img_view_transformer",
              "img_bev_encoder_backbone", "img_bev_encoder_neck", "pts_bbox_head")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _segments(rng, case, n=600):
    """(sem_pred, pan_pred, sem_gt, pan_gt) over n points."""
    sem_gt = rng.randint(0, NC, n)
    inst_gt = np.where(np.isin(sem_gt, THINGS), rng.randint(1, 4, n), 0)
    pan_gt = sem_gt * 1000 + inst_gt
    if case == "perfect":
        return sem_gt, pan_gt, sem_gt, pan_gt
    sem_pred, pan_pred = sem_gt.copy(), pan_gt.copy()
    moved = rng.rand(n) < (0.25 if case == "partial" else 0.6)
    sem_pred[moved] = rng.randint(0, NC, moved.sum())
    pan_pred[moved] = sem_pred[moved] * 1000 + rng.randint(0, 5, moved.sum())
    if case == "ignored":  # most GT points of class 0: dropped before matching
        sem_gt[rng.rand(n) < 0.5] = 0
        pan_gt = sem_gt * 1000 + inst_gt
    return sem_pred, pan_pred, sem_gt, pan_gt


@pytest.mark.parametrize("case", ["perfect", "partial", "ignored", "mixed"])
def test_panoptic_eval_matches_jax(case):
    rng = np.random.RandomState(["perfect", "partial", "ignored", "mixed"].index(case))
    mine, theirs = PanopticEval(NC, min_points=15), JaxPanopticEval(NC, min_points=15)
    for _ in range(3):
        seg = _segments(rng, case)
        mine.add_batch(*seg)
        theirs.add_batch(*seg)
    s, r = mine.state(), theirs.state()
    assert s.keys() == r.keys() == {"pan_tp", "pan_fp", "pan_fn", "pan_iou"}
    for k in s:
        assert s[k].dtype == r[k].dtype and np.array_equal(s[k], r[k]), k
    got, ref = mine.get_pq(), theirs.get_pq()
    assert got[:3] == ref[:3]
    if case == "perfect":
        assert got[:3] == (1.0, 1.0, 1.0)
    else:
        assert 0.0 <= got[0] < 1.0 and s["pan_fp"].sum() > 0
    if case == "partial":
        assert got[0] > 0.0 and s["pan_tp"].sum() > 0
    again = PanopticEval(NC, min_points=15)
    again.set_state(s)
    assert again.get_pq()[:3] == got[:3]


@pytest.mark.parametrize("skip_empty", [False, True])
def test_format_panoptic_results_matches_jax(skip_empty):
    rng = np.random.RandomState(4)
    Q, P = 12, 500
    cls = rng.randn(Q, NC + 1).astype(np.float32) * 2
    masks = rng.randn(Q, P).astype(np.float32)
    got = format_panoptic_results(cls, masks, THINGS, skip_empty_argmax=skip_empty)
    ref = jax_format(cls, masks, THINGS, skip_empty_argmax=skip_empty)
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and np.array_equal(g, r)
    sem, pan = got
    things = np.isin(sem, THINGS)
    assert (pan[~things] == sem[~things] * 1000).all() and (pan[things] % 1000 > 0).all()


def _tiny_panoptic():
    cfg = tiny_cfg.model_cfg()
    cfg["pts_bbox_head"] = dict(cfg["pts_bbox_head"], type="Mask2FormerNuscPanopticOccHead",
                                stuff_indices=[0, 3, 4], thing_indices=THINGS)
    rng = np.random.RandomState(0)
    base = tiny_cfg.make_batch(rng)
    jmodel = JaxOccupancyFormer(**{k: cfg[k] for k in COMPONENTS})
    variables = _random_variables(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), base),
                                  rng)
    model = build_model(cfg, device="cpu")
    model.load_state_dict(flax_to_torch_state_dict(variables, model), strict=True)
    assert model.pts_bbox_head.thing_indices == tuple(THINGS)
    return jmodel, variables, model.eval()


def _batches(n=2, P=96):
    out = []
    for i in range(n):
        r = np.random.RandomState(10 + i)
        b = tiny_cfg.make_batch(r)
        b["lidar_xyz"] = r.uniform(-0.05, 1.05, (1, P, 3)).astype(np.float32)
        b["lidar_valid"] = np.arange(P)[None] < P - 8
        out.append(b)
    return out


def test_panoptic_eval_step_and_evaluate_match_jax(monkeypatch):
    jmodel, variables, model = _tiny_panoptic()
    occ = tuple(tiny_cfg.OCC_SIZE)
    jstep = jax_build_eval_step(jmodel, occ, NC, panoptic=True)
    tstep = build_eval_step(model, occ, NC, panoptic=True)
    batches = _batches()
    # the labels: JAX's formatted prediction, a fifth of the points moved
    for i, b in enumerate(batches):
        out = jstep(variables, b)
        sem, pan = jax_format(np.asarray(out["point_cls"][0]), np.asarray(out["point_mask"][0]),
                              THINGS)
        r = np.random.RandomState(20 + i)
        moved = r.rand(pan.size) < 0.2
        cls = r.randint(1, NC, moved.sum())
        pan[moved] = cls * 1000 + np.where(np.isin(cls, THINGS), r.randint(1, 3, moved.sum()), 0)
        b["lidar_label"] = pan[None].astype(np.int32)
    for b in batches:
        ref = jstep(variables, b)
        got = tstep(b)
        for k in ("point_cls", "point_mask"):
            g, r = got[k].numpy(), np.asarray(ref[k])
            assert g.dtype == np.float32 and g.shape == r.shape, (k, g.shape, r.shape)
            err, tol = np.abs(g - r).max(), 1e-3 * np.abs(r).max() + 1e-4
            assert err <= tol, (k, err, tol)
        assert got["point_mask"].shape == (1, 8, 96)
        np.testing.assert_array_equal(got["confusion"].numpy(), np.asarray(ref["confusion"]))
        assert int(got["confusion"].sum()) == 88
    names = [f"c{i}" for i in range(NC)]
    # JAX's evaluate builds the same eval step again: hand it the one compiled above
    monkeypatch.setattr(jax_eval, "build_eval_step", lambda *args, **kwargs: jstep)
    ref = jax_evaluate(jmodel, variables, batches, occ, NC, class_names=names, panoptic=True,
                       thing_indices=THINGS)
    got = evaluate(model, batches, occ, NC, class_names=names, panoptic=True,
                   thing_indices=THINGS)
    assert got.keys() == ref.keys()
    for k in got:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k])), k
    assert 0.0 < got["nuScenes_panoptic_PQ"] < 1.0 and 0.0 < got["nuScenes_panoptic_RQ"] < 1.0
