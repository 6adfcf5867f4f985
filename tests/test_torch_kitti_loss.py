"""The port's SemanticKITTI loss (the grid branch) against the JAX package.

* ``mask2former_loss`` on the grid branch (``use_lidar_points=False``):
  frequency-drawn GT voxels, the per-layer matching and supervision, the
  mask volumes read at ``idx / (size - 1)`` with align_corners=True where
  the prediction grid is half the GT grid, gathered where the two are one.
  The port takes the Gumbel noise of its draws as an argument;
  ``jax_grid_draws`` builds it from the JAX key tree
  (``mask2former_loss.py:1008,1095`` the sample-weight and layer keys,
  ``:1033,1057`` per-sample keys, ``:229`` the matching key and
  ``point_sampling.py:57`` its draw over the GT voxels, ``:701-702,913,933``
  the per-slot candidate and fill keys).  Every ``d{i}.loss_*`` and the
  gradients with respect to ``cls_preds``, ``mask_embeds`` and
  ``mask_feature`` are compared.
* ``sample_with_frequencies`` and ``index_topk`` (``lax.top_k``'s index
  order where fewer voxels carry weight than are drawn), bit for bit.
* ``build_loss_cfg`` of the ``occformer_kitti`` config against JAX's
  (``tests/test_configs_metrics.py:60-80`` gives the expected values).

Float32 on the CPU (K2's plain version); tolerances are stated at each
comparison: both sides compute the same float32 sums in another order.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
from occformer_tpu.losses.mask2former_loss import mask2former_loss as jax_mask2former_loss
from occformer_tpu.losses.point_sampling import (
    sample_with_frequencies as jax_sample_with_frequencies,
)
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.engine.train import build_loss_cfg
from occformer_tpu_torch.losses.mask2former_loss import (
    GRID_ALIGN_CORNERS,
    mask2former_loss,
    match_assignments,
)
from occformer_tpu_torch.losses.point_sampling import index_topk, sample_with_frequencies

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = "configs/occformer_kitti.py"
NUM_CLASSES = 20
TRAIN_PTS = dict(num_points=48, oversample_ratio=2.0, importance_sample_ratio=0.75)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def kitti_head(num_queries=24):
    head = tiny_cfg.model_cfg()["pts_bbox_head"]
    return dict(head, type="Mask2FormerOccHead", num_occupancy_classes=NUM_CLASSES,
                num_queries=num_queries,
                loss_cls=dict(head["loss_cls"], class_weight=[1.0] * NUM_CLASSES + [0.1]))


def jax_grid_draws(loss_rng, L, B, G, N):
    """The JAX grid branch's Gumbel noise, from its key tree, in the port's
    layout: ``match`` [L, B, N], ``cand`` and ``fill`` [L, B, G, N]."""
    f32 = jnp.float32
    _, rng = jax.random.split(loss_rng)            # the sample-weight key first
    out = {"match": [], "cand": [], "fill": []}
    for layer_key in jax.random.split(rng, L):
        rows = {k: [] for k in out}
        for k in jax.random.split(layer_key, B):
            r_match, r_rest = jax.random.split(k)
            rows["match"].append(jax.random.gumbel(r_match, (N,), f32))
            r_sup, r_sup2 = jax.random.split(r_rest)
            rows["cand"].append(jnp.stack([jax.random.gumbel(kk, (N,), f32)
                                           for kk in jax.random.split(r_sup, G)]))
            rows["fill"].append(jnp.stack([jax.random.gumbel(kk, (N,), f32)
                                           for kk in jax.random.split(r_sup2, G)]))
        for key in out:
            out[key].append(np.stack([np.asarray(r) for r in rows[key]]))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def _loss_inputs(seed, L, B, Q, gt_grid, pred_grid=(8, 8, 4), C=16):
    rng = np.random.RandomState(seed)
    gt = rng.randint(0, NUM_CLASSES, (B, *gt_grid)).astype(np.int32)
    gt[rng.rand(*gt.shape) < 0.5] = 0              # mostly empty, as KITTI
    gt[:, :2] = 255                                # unlabelled voxels
    gt[gt == 7] = 8                                # class 7 absent: an invalid slot
    return dict(
        cls_preds=rng.randn(L, B, Q, NUM_CLASSES + 1).astype(np.float32),
        mask_embeds=(0.4 * rng.randn(L, B, Q, C)).astype(np.float32),
        mask_feature=(0.4 * rng.randn(B, *pred_grid, C)).astype(np.float32),
        gt_occ=gt)


@pytest.mark.parametrize("gt_grid,B", [((16, 16, 8), 1), ((8, 8, 4), 2)],
                         ids=["pred_grid_half_the_gt_grid", "same_grid_two_samples"])
def test_grid_loss_and_its_gradients_match_jax(gt_grid, B):
    head = kitti_head()
    jcfg = jax_build_loss_cfg(head, TRAIN_PTS)
    cfg = build_loss_cfg(head, TRAIN_PTS)
    assert not jcfg.use_lidar_points and not cfg.use_lidar_points
    assert jcfg.align_corners == GRID_ALIGN_CORNERS
    L, Q = 3, head["num_queries"]
    x = _loss_inputs(1, L, B, Q, gt_grid)
    loss_rng = jax.random.PRNGKey(5)
    N = int(np.prod(gt_grid))

    def jax_total(cls, emb, feat):
        losses = jax_mask2former_loss(loss_rng, cls, emb, feat, jnp.asarray(x["gt_occ"]), jcfg)
        return sum(v for k, v in losses.items() if "loss" in k), losses

    diff = ("cls_preds", "mask_embeds", "mask_feature")
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jax_total, (0, 1, 2), has_aux=True))(
        *(jnp.asarray(x[k]) for k in diff))

    leaves = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in diff}
    draws = jax_grid_draws(loss_rng, L, B, NUM_CLASSES, N)
    got = mask2former_loss(leaves["cls_preds"], leaves["mask_embeds"],
                           leaves["mask_feature"], torch.from_numpy(x["gt_occ"]), cfg,
                           draws=draws)
    assert set(got) == set(ref) and "d1.loss_mask" in got
    for k in ref:  # float32 sums over <= 96 points a slot in another order
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(got["unassigned_gt"]) == 0.0
    sum(v for k, v in got.items() if "loss" in k).backward()
    for k, g in zip(diff, ref_grads):
        g = np.asarray(g)
        tol = 1e-4 * np.abs(g).max() + 1e-7
        assert np.abs(leaves[k].grad.numpy() - g).max() <= tol, k


def test_grid_draws_from_a_generator_repeat_and_assign_every_valid_slot():
    """Without given draws the grid branch draws from the generator, layer
    by layer: one generator state gives one loss; the assignment leaves no
    valid slot unassigned and every invalid one at -1."""
    cfg = build_loss_cfg(kitti_head(), TRAIN_PTS)
    x = {k: torch.from_numpy(v) for k, v in _loss_inputs(2, 2, 1, 24, (16, 16, 8)).items()}
    args = (x["cls_preds"], x["mask_embeds"], x["mask_feature"], x["gt_occ"], cfg)
    a = mask2former_loss(*args, generator=torch.Generator().manual_seed(3))
    b = mask2former_loss(*args, generator=torch.Generator().manual_seed(3))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assign = match_assignments(*args, generator=torch.Generator().manual_seed(3))
    valid = torch.stack([(x["gt_occ"] == c).any() for c in range(NUM_CLASSES)])
    assert assign.shape == (2, 1, NUM_CLASSES)
    assert (assign[..., valid] >= 0).all() and (assign[..., ~valid] == -1).all()


@pytest.mark.parametrize("k", [40, 300])
def test_sample_with_frequencies_matches_jax(k):
    """k = 300 draws more voxels than the 256 labelled ones: the rest come in
    index order, as ``lax.top_k`` orders the tied -inf keys.  The port looks
    the weights up by label; JAX sums them over the one-hot masks."""
    rng = np.random.RandomState(3)
    gt = rng.randint(0, 6, (8, 8, 8))
    gt.reshape(-1)[256:] = 255
    gt[gt == 2] = 3  # class 2 absent: an invalid slot
    masks = np.stack([gt == c for c in range(6)])
    labels = np.arange(6)
    valid = masks.reshape(6, -1).any(-1)
    sw = rng.uniform(0.5, 4.0, 6).astype(np.float32)
    key = jax.random.PRNGKey(9)
    ref_idx, ref_pts = jax_sample_with_frequencies(
        key, jnp.asarray(masks), jnp.asarray(labels), jnp.asarray(valid), jnp.asarray(sw), k)
    noise = torch.from_numpy(np.array(jax.random.gumbel(key, (512,), jnp.float32)))
    idx, pts = sample_with_frequencies(torch.from_numpy(gt), torch.from_numpy(sw), k, noise)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(pts.numpy(), np.asarray(ref_pts))
    assert len(set(idx.tolist())) == k


def test_index_topk_takes_each_weighted_entry_before_the_unweighted_ones():
    w = torch.tensor([0.0, 2.0, 0.0, 1.0, 0.0])
    g = torch.tensor([[9.0, 0.0, 9.0, 0.5, 9.0], [9.0, 0.0, 9.0, 1.0, 9.0]])
    assert index_topk(w, 4, g).tolist() == [[1, 3, 0, 2], [3, 1, 0, 2]]


def test_build_loss_cfg_of_the_kitti_config_matches_jax():
    mine = load_config(os.path.join(REPO, "occformer_tpu_torch", KITTI))
    theirs = jax_load_config(os.path.join(REPO, "occformer_tpu", KITTI))
    head, pts = mine["model"]["pts_bbox_head"], mine["model"]["train_cfg"]["pts"]
    got = build_loss_cfg(head, pts)
    ref = jax_build_loss_cfg(dict(theirs["model"]["pts_bbox_head"]),
                             dict(theirs["model"]["train_cfg"]["pts"]))
    for f in ("num_classes", "num_points", "oversample_ratio", "importance_sample_ratio",
              "cls_loss_weight", "mask_loss_weight", "dice_loss_weight", "cls_cost_weight",
              "mask_cost_weight", "dice_cost_weight", "dice_eps", "class_weight",
              "sample_weights", "sample_weight_gamma", "use_lidar_points",
              "match_num_points"):
        assert getattr(got, f) == getattr(ref, f), f
    # the grid branch reads as JAX's KITTI config sets (tests/test_configs_metrics.py:70-78)
    assert ref.align_corners == GRID_ALIGN_CORNERS
    assert not got.use_lidar_points
    assert got.num_points == 12544 * 4 and got.num_candidates == 150528
    assert len(got.sample_weights) == 20 and len(got.class_weight) == 21
    assert abs(got.class_weight[0] - 1.0) < 1e-6 and got.class_weight[2] > got.class_weight[0]
    assert abs(got.class_weight[-1] - 0.1) < 1e-7  # float32's 0.1
