"""The port's training losses and matching against the JAX package.

* ``mask2former_loss``: the port against the JAX ``mask2former_loss`` on the
  feature-readout path (``mxu_readout="off"``, ``feature_readout=True``,
  shared candidates), on the same model outputs and the same random draws:
  the port takes its draws as an argument, and ``jax_loss_draws`` builds them
  from the JAX key tree (``mask2former_loss.py:1008,1095`` sample-weight and
  layer keys, ``:1033,1057`` per-sample keys, ``:229,701-702`` the match /
  supervision keys, ``:196-208`` matching points, ``:726-743`` candidates).
  Every ``d{i}.loss_*`` and the gradients with respect to ``cls_preds``,
  ``mask_embeds`` and ``mask_feature`` are compared.
* ``depth_bce_loss``, ``dice_loss``, the Gumbel top-k (index form),
  ``uncertainty_topk``, the matching cost, and scipy's assignment against
  the JAX auction and host Hungarian matchers on costs with a unique optimum.

Everything runs in float32 on the CPU (the port's plain K2).  Tolerances are
stated at each comparison: both sides compute the same float32 sums in
another order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
from occformer_tpu.losses.mask2former_loss import mask2former_loss as jax_mask2former_loss
from occformer_tpu.losses.matching import auction_match
from occformer_tpu.losses.matching import hungarian_match as jax_hungarian_match
from occformer_tpu.losses.matching import mask_matching_cost as jax_matching_cost
from occformer_tpu.losses.point_sampling import gumbel_topk_sample as jax_gumbel_topk
from occformer_tpu.losses.point_sampling import uncertainty_topk as jax_uncertainty_topk
from occformer_tpu.losses.seg_losses import dice_loss as jax_dice_loss
from occformer_tpu.models.lss import depth_bce_loss as jax_depth_bce_loss
from occformer_tpu_torch.engine.train import build_loss_cfg
from occformer_tpu_torch.losses.mask2former_loss import make_loss_draws, mask2former_loss
from occformer_tpu_torch.losses.matching import hungarian_match, mask_matching_cost
from occformer_tpu_torch.losses.point_sampling import gumbel_topk_sample, uncertainty_topk
from occformer_tpu_torch.losses.seg_losses import dice_loss
from occformer_tpu_torch.models.lss import depth_bce_loss

TRAIN_PTS = dict(num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_loss_draws(loss_rng, cfg, lidar_valid, L, num_slots=None):
    """The JAX loss's draws, from its key tree, in the port's layout, for
    ``num_slots`` GT slots (default: one per class)."""
    B, P = lidar_valid.shape
    G = num_slots or cfg.num_classes
    n_match = cfg.match_num_points or cfg.num_points
    k1 = n_match // 2
    num_sampled = int(cfg.num_points * cfg.oversample_ratio)
    n_cand = min(num_sampled, P)
    n_rand = cfg.num_points - int(cfg.importance_sample_ratio * cfg.num_points)
    f32 = jnp.float32
    _, rng = jax.random.split(loss_rng)            # sample-weight key first
    layer_keys = jax.random.split(rng, L)
    out = {k: [] for k in ("match_perm", "match_rand1", "match_rand2", "cand_perm",
                           "cand_rand", "cand_extra", "rand_fill")}
    for l in range(L):
        rows = {k: [] for k in out}
        for b, k in enumerate(jax.random.split(layer_keys[l], B)):
            valid = jnp.asarray(lidar_valid[b]).astype(f32)
            r_match, r_rest = jax.random.split(k)
            rows["match_perm"].append(jax_gumbel_topk(r_match, valid, k1))
            r1, r2 = jax.random.split(jax.random.fold_in(r_match, 1))
            rows["match_rand1"].append(jax.random.uniform(r1, (k1, 3), f32))
            rows["match_rand2"].append(jax.random.uniform(r2, (n_match - k1, 3), f32))
            r_sup, r_sup2 = jax.random.split(r_rest)
            rows["cand_perm"].append(jax_gumbel_topk(r_sup, valid, n_cand))
            rows["cand_rand"].append(jax.random.uniform(
                jax.random.fold_in(r_sup, 7), (n_cand, 3), f32))
            rows["cand_extra"].append(jax.random.uniform(
                jax.random.fold_in(r_sup, 8), (num_sampled - n_cand, 3), f32))
            rows["rand_fill"].append(jax.random.uniform(r_sup2, (G, n_rand, 3), f32))
        for key in out:
            out[key].append(np.stack([np.asarray(r) for r in rows[key]]))
    return {k: torch.from_numpy(np.stack(v)) for k, v in out.items()}


def _loss_inputs(seed=0, L=4, B=1, P=100):
    rng = np.random.RandomState(seed)
    Q, nc, C = 8, tiny_cfg.NUM_CLASSES, tiny_cfg.VOXEL_OUT
    X, Y, Z = tiny_cfg.VOXEL_GRID
    gt = rng.randint(0, nc, (B, *tiny_cfg.OCC_SIZE)).astype(np.int32)
    gt[:, :3] = 255
    gt[gt == 3] = 4  # class 3 absent: an invalid GT slot
    return dict(
        cls_preds=rng.randn(L, B, Q, nc + 1).astype(np.float32),
        mask_embeds=(0.4 * rng.randn(L, B, Q, C)).astype(np.float32),
        mask_feature=(0.4 * rng.randn(B, X, Y, Z, C)).astype(np.float32),
        gt_occ=gt,
        lidar_xyz=rng.uniform(0, 1, (B, P, 3)).astype(np.float32),
        lidar_valid=np.arange(P)[None].repeat(B, 0) < int(0.8 * P),
    )


@pytest.mark.parametrize("B,P", [(1, 100), (2, 160)])
def test_mask2former_loss_and_its_gradients_match_jax(B, P):
    """P = 100 < 128 candidates: uniform extras fill the candidate set; P =
    160: more LiDAR points than candidates, and two samples per batch."""
    head = tiny_cfg.model_cfg()["pts_bbox_head"]
    jcfg = jax_build_loss_cfg(dict(head, mxu_readout="off"), TRAIN_PTS)
    assert jcfg.feature_readout and jcfg.shared_candidate_readout
    cfg = build_loss_cfg(head, TRAIN_PTS)
    x = _loss_inputs(B=B, P=P)
    loss_rng = jax.random.PRNGKey(3)
    L = x["cls_preds"].shape[0]

    def jax_total(cls, emb, feat):
        losses = jax_mask2former_loss(loss_rng, cls, emb, feat, jnp.asarray(x["gt_occ"]),
                                      jcfg, lidar_xyz=jnp.asarray(x["lidar_xyz"]),
                                      lidar_valid=jnp.asarray(x["lidar_valid"]))
        return sum(v for k, v in losses.items() if "loss" in k), losses

    diff = ("cls_preds", "mask_embeds", "mask_feature")
    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jax_total, (0, 1, 2), has_aux=True))(
        *(jnp.asarray(x[k]) for k in diff))

    leaves = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in diff}
    draws = jax_loss_draws(loss_rng, jcfg, x["lidar_valid"], L)
    got = mask2former_loss(leaves["cls_preds"], leaves["mask_embeds"],
                           leaves["mask_feature"], torch.from_numpy(x["gt_occ"]), cfg,
                           torch.from_numpy(x["lidar_xyz"]),
                           torch.from_numpy(x["lidar_valid"]), draws)
    assert set(got) == set(ref) and "d0.loss_dice" in got and "loss_cls" in got
    for k in ref:  # float32 sums over <= 128 points in another order
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert float(got["unassigned_gt"]) == 0.0
    sum(v for k, v in got.items() if "loss" in k).backward()
    for k, g in zip(diff, ref_grads):
        g = np.asarray(g)
        tol = 1e-4 * np.abs(g).max() + 1e-7
        assert np.abs(leaves[k].grad.numpy() - g).max() <= tol, k


def test_loss_draws_have_the_jax_shapes_and_ranges():
    head = tiny_cfg.model_cfg()["pts_bbox_head"]
    cfg = build_loss_cfg(head, TRAIN_PTS)
    valid = torch.from_numpy(np.arange(100)[None] < 80)
    d = make_loss_draws(torch.Generator().manual_seed(0), cfg, valid, 4)
    ref = jax_loss_draws(jax.random.PRNGKey(0),
                         jax_build_loss_cfg(dict(head, mxu_readout="off"), TRAIN_PTS),
                         valid.numpy(), 4)
    assert {k: tuple(v.shape) for k, v in d.items()} == \
        {k: tuple(v.shape) for k, v in ref.items()}
    # Gumbel top-k over a 0/1 mask: valid points only, without replacement
    for k in ("match_perm", "cand_perm"):
        idx = d[k].reshape(-1, d[k].shape[-1])
        assert all(len(set(r.tolist())) == len(r) for r in idx)
    assert (d["match_perm"] < 80).all()
    again = make_loss_draws(torch.Generator().manual_seed(0), cfg, valid, 4)
    assert all(torch.equal(d[k], again[k]) for k in d)


def test_depth_bce_loss_matches_jax():
    rng = np.random.RandomState(4)
    grid = tiny_cfg.GRID_CONFIG
    ds, D = 8, 8
    depth = rng.uniform(0, 10.5, (1, 2, 32, 64)).astype(np.float32)
    depth[depth < 4] = 0.0
    logits = rng.randn(2 * 4 * 8, D).astype(np.float32)
    prob = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    prob = prob.reshape(2, 4, 8, D)
    ref = jax_depth_bce_loss(jnp.asarray(depth), jnp.asarray(prob), grid, ds, 1.0)
    got = depth_bce_loss(torch.from_numpy(depth), torch.from_numpy(prob), grid, ds, 1.0)
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_dice_loss_matches_jax():
    rng = np.random.RandomState(5)
    pred = rng.randn(6, 40).astype(np.float32)
    tgt = (rng.rand(6, 40) > 0.5).astype(np.float32)
    w = rng.rand(6).astype(np.float32)
    for kw in (dict(), dict(weight=w, avg_factor=3.0)):
        ref = jax_dice_loss(jnp.asarray(pred), jnp.asarray(tgt),
                            **{k: jnp.asarray(v) for k, v in kw.items()})
        got = dice_loss(torch.from_numpy(pred), torch.from_numpy(tgt),
                        **{k: torch.as_tensor(v) for k, v in kw.items()})
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-6)


def test_gumbel_topk_index_form_and_uncertainty_topk_match_jax():
    key = jax.random.PRNGKey(6)
    w = jnp.asarray((np.random.RandomState(6).rand(300) > 0.3).astype(np.float32))
    noise = jax.random.gumbel(key, w.shape, jnp.float32)
    ref = jax_gumbel_topk(key, w, 50)
    got = gumbel_topk_sample(torch.from_numpy(np.array(w)), 50,
                             gumbel=torch.from_numpy(np.array(noise)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    logits = np.random.RandomState(7).randn(4, 90).astype(np.float32)
    ref = np.sort(np.asarray(jax_uncertainty_topk(jnp.asarray(logits), 30)), -1)
    got = np.sort(uncertainty_topk(torch.from_numpy(logits), 30).numpy(), -1)
    np.testing.assert_array_equal(got, ref)


def test_matching_cost_and_assignment_match_jax():
    """scipy's assignment against the JAX auction and host Hungarian
    matchers: random costs have a unique optimum (almost surely); slot 2 is
    invalid and gets -1."""
    rng = np.random.RandomState(8)
    Q, G, P = 12, 6, 70
    cls = rng.randn(Q, 7).astype(np.float32)
    pred = rng.randn(Q, P).astype(np.float32)
    labels = rng.randint(0, 6, G)
    gt_pts = rng.rand(G, P).astype(np.float32)
    valid = np.ones(G, bool)
    valid[2] = False
    ref_cost = jax_matching_cost(jnp.asarray(cls), jnp.asarray(pred), jnp.asarray(labels),
                                 jnp.asarray(gt_pts), jnp.asarray(valid))
    cost = mask_matching_cost(torch.from_numpy(cls), torch.from_numpy(pred),
                              torch.from_numpy(labels), torch.from_numpy(gt_pts),
                              torch.from_numpy(valid))
    np.testing.assert_allclose(cost.numpy(), np.asarray(ref_cost), rtol=1e-5, atol=1e-6)
    for trial in range(5):
        c = rng.randn(2, Q, G).astype(np.float32)
        v = np.stack([valid, rng.rand(G) > 0.3])
        got = hungarian_match(torch.from_numpy(c), torch.from_numpy(v)).numpy()
        host = np.asarray(jax_hungarian_match(jnp.asarray(c), jnp.asarray(v)))
        auction = np.stack([np.asarray(auction_match(jnp.asarray(c[i]), jnp.asarray(v[i])))
                            for i in range(2)])
        np.testing.assert_array_equal(got, host)
        np.testing.assert_array_equal(got, auction)
        assert (got[~v] == -1).all() and (got[v] >= 0).all()
