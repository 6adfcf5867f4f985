"""The panoptic head's GT slots and training loss in the port against the JAX
package, on the CPU.

* ``preprocess_panoptic_gt`` against JAX's on a grid of panoptic ids
  (``class * 1000 + instance``) with 65535 noise and empty voxels (0), and
  a padded id table holding -1 slots, an id absent from the grid and an id
  past the classes: masks, labels and valid bits equal.
* The GT read of the batched route at panoptic ids: K3's plain version
  (``sample_id_masks`` at the ids) against JAX's ``_sample_id_masks`` and
  against the port's one-hot reads of the override's masks, at shared and
  per-slot points, within 1e-6.
* The loss at the panoptic slot structure (150 queries, 100 slots of which
  about 12 are real): the port's per-layer route (``mxu_readout="off"``)
  against JAX's ``"off"`` and the port's batched route (``"on"``, the GT
  through K3 at the panoptic ids) against JAX's ``"interpret"``, both JAX
  runs with ``gt_override`` (the port's loss takes the id table and builds
  the same slots) and the same draws (``jax_loss_draws`` at 100
  slots).  Losses within rtol 1e-5 / atol 1e-6 (per layer) and 1e-4 / 1e-6
  (batched, the tolerances of ``test_torch_loss_batched.py``); gradients of
  ``cls_preds``, ``mask_embeds`` and ``mask_feature`` within ``1e-4 *
  max|ref|`` (per layer) and rtol 1e-3 / atol 1e-5 (batched); the port's
  assignments equal JAX's per (layer, sample) matching
  (``_match_single_sample`` on the same keys) and each other.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
from occformer_tpu.losses.mask2former_loss import _match_single_sample as jax_match_single
from occformer_tpu.losses.mask2former_loss import _sample_id_masks as jax_sample_id_masks
from occformer_tpu.losses.mask2former_loss import mask2former_loss as jax_mask2former_loss
from occformer_tpu.losses.mask2former_loss import preprocess_panoptic_gt as jax_preprocess
from occformer_tpu_torch.engine.train import build_loss_cfg
from occformer_tpu_torch.losses.mask2former_loss import (_gt_reader, mask2former_loss,
                                                         match_assignments,
                                                         preprocess_panoptic_gt)
from occformer_tpu_torch.ops.loss_gather import sample_id_masks
from test_torch_loss import TRAIN_PTS, jax_loss_draws

DIFF = ("cls_preds", "mask_embeds", "mask_feature")
NC = tiny_cfg.NUM_CLASSES
SLOTS, QUERIES, LAYERS = 100, 150, 2
PAN_HEAD = dict(tiny_cfg.model_cfg()["pts_bbox_head"], type="Mask2FormerNuscPanopticOccHead",
                num_queries=QUERIES, stuff_indices=[0, 3, 4], thing_indices=[1, 2])


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def panoptic_gt(rng, B, grid=tiny_cfg.OCC_SIZE, slots=SLOTS):
    """A panoptic id grid [B, *grid] int32 and its padded id table [B,
    slots] int32 per sample: stuff ids ``c * 1000`` (c = 3, 4), 5 instances
    of each thing class (1, 2), empty voxels 0 and 65535 noise; the table
    holds the grid's ids but 0 (as the pipeline writes it), then an id
    absent from the grid and one past the classes (both invalid), then -1."""
    ids = np.array([3000, 4000] + [c * 1000 + k for c in (1, 2) for k in range(1, 6)])
    gts, tables = [], []
    for b in range(B):
        vals = np.concatenate([[0, 65535], ids[b:]])  # the samples hold different ids
        gt = vals[rng.randint(0, len(vals), grid)]
        table = np.full(slots, -1, np.int64)
        present = np.unique(gt)
        present = present[(present > 0) & (present < 65535)]
        table[:len(present) + 2] = np.concatenate([present, [2009, (NC + 2) * 1000]])
        gts.append(gt)
        tables.append(table)
    return np.stack(gts).astype(np.int32), np.stack(tables).astype(np.int32)


def _inputs(B, seed=0, P=100):
    rng = np.random.RandomState(seed)
    C = tiny_cfg.VOXEL_OUT
    X, Y, Z = tiny_cfg.VOXEL_GRID
    gt, table = panoptic_gt(rng, B)
    return dict(
        cls_preds=rng.randn(LAYERS, B, QUERIES, NC + 1).astype(np.float32),
        mask_embeds=(0.4 * rng.randn(LAYERS, B, QUERIES, C)).astype(np.float32),
        mask_feature=(0.4 * rng.randn(B, X, Y, Z, C)).astype(np.float32),
        gt_occ=gt, panoptic_ids=table,
        lidar_xyz=rng.uniform(-0.1, 1.1, (B, P, 3)).astype(np.float32),
        lidar_valid=np.arange(P)[None].repeat(B, 0) < int(0.8 * P),
    )


def test_preprocess_panoptic_gt_matches_jax():
    rng = np.random.RandomState(1)
    gt, table = panoptic_gt(rng, 2)
    ref = jax_preprocess(jnp.asarray(gt), jnp.asarray(table), NC)
    got = preprocess_panoptic_gt(torch.from_numpy(gt), torch.from_numpy(table), NC)
    for g, r, name in zip(got, ref, ("masks", "labels", "valid")):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    masks, labels, valid = got
    assert masks.dtype == torch.bool and masks.shape == (2, SLOTS, *tiny_cfg.OCC_SIZE)
    n_real = (table >= 0).sum(1) - 2
    assert valid.sum(1).tolist() == n_real.tolist()  # the absent id, the id past the classes
    assert not masks[torch.from_numpy(gt == 65535)[:, None].expand_as(masks)].any()  # noise
    assert (labels[torch.from_numpy(table < 0)] == 0).all()


@pytest.mark.parametrize("per_slot", [False, True])
def test_gt_read_at_panoptic_ids_matches_jax_and_the_one_hot_read(per_slot):
    rng = np.random.RandomState(2)
    gt, table = panoptic_gt(rng, 2)
    masks = preprocess_panoptic_gt(torch.from_numpy(gt), torch.from_numpy(table), NC)[0]
    shape = (LAYERS, 2, SLOTS, 7, 3) if per_slot else (LAYERS, 2, 40, 3)
    pts = torch.from_numpy(rng.uniform(-0.1, 1.1, shape).astype(np.float32))
    gt_t = torch.from_numpy(gt)
    got = _gt_reader(gt_t, masks, torch.from_numpy(table), LAYERS)(pts)
    one_hot = _gt_reader(gt_t, masks, None, LAYERS)(pts)
    np.testing.assert_allclose(got.numpy(), one_hot.numpy(), rtol=0, atol=1e-6)
    flat = sample_id_masks(gt_t, torch.from_numpy(table), pts.reshape(LAYERS * 2, *shape[2:]))
    for n in range(LAYERS * 2):
        b = n % 2
        if per_slot:  # each slot's points read against its own id
            ref = np.asarray(jax.vmap(lambda i, p: jax_sample_id_masks(
                jnp.asarray(gt[b]), i[None], p, False, "border")[:, 0])(
                jnp.asarray(table[b]), jnp.asarray(pts.reshape(-1, *shape[2:])[n].numpy())))
        else:
            ref = np.asarray(jax_sample_id_masks(
                jnp.asarray(gt[b]), jnp.asarray(table[b]),
                jnp.asarray(pts.reshape(-1, *shape[2:])[n].numpy()), False, "border")).T
        np.testing.assert_allclose(flat[n].numpy(), ref, rtol=0, atol=1e-6)


def _jax_run(x, jcfg, loss_rng):
    gt = jnp.asarray(x["gt_occ"])
    override = jax_preprocess(gt, jnp.asarray(x["panoptic_ids"]), NC)

    def total(cls, emb, feat):
        losses = jax_mask2former_loss(loss_rng, cls, emb, feat, gt, jcfg,
                                      lidar_xyz=jnp.asarray(x["lidar_xyz"]),
                                      lidar_valid=jnp.asarray(x["lidar_valid"]),
                                      gt_override=override)
        return sum(v for k, v in losses.items() if "loss" in k), losses

    (_, ref), grads = jax.jit(jax.value_and_grad(total, (0, 1, 2), has_aux=True))(
        *(jnp.asarray(x[k]) for k in DIFF))
    return ref, grads, override


def _jax_assignments(x, jcfg, loss_rng, override):
    """JAX's per-layer matching (``mask2former_loss.py:1043-1103``'s key tree)."""
    gm, gl, gv = override
    _, rng = jax.random.split(loss_rng)
    B = x["gt_occ"].shape[0]
    match = jax.jit(lambda k, cls, m, lab, v, xyz, valid, emb, feat: jax_match_single(
        k, cls, None, m, lab, v, xyz, valid, None, jcfg, mask_embed=emb, feature=feat))
    out = np.zeros((LAYERS, B, SLOTS), np.int64)
    for l, lk in enumerate(jax.random.split(rng, LAYERS)):
        for b, k in enumerate(jax.random.split(lk, B)):
            out[l, b] = np.asarray(match(
                k, jnp.asarray(x["cls_preds"][l, b]), gm[b], gl[b], gv[b],
                jnp.asarray(x["lidar_xyz"][b]), jnp.asarray(x["lidar_valid"][b]),
                jnp.asarray(x["mask_embeds"][l, b]), jnp.asarray(x["mask_feature"][b])))
    return out


def test_panoptic_loss_routes_match_jax():
    """Two samples with different ids and slot counts."""
    B = 2
    x = _inputs(B)
    loss_rng = jax.random.PRNGKey(5)
    jcfg_off = jax_build_loss_cfg(dict(PAN_HEAD, mxu_readout="off"), TRAIN_PTS)
    jcfg_int = jax_build_loss_cfg(dict(PAN_HEAD, mxu_readout="interpret"), TRAIN_PTS)
    assert jcfg_off.panoptic and jcfg_off.feature_readout
    draws = jax_loss_draws(loss_rng, jcfg_off, x["lidar_valid"], LAYERS, num_slots=SLOTS)
    assert draws["rand_fill"].shape[2] == SLOTS
    gt = torch.from_numpy(x["gt_occ"])
    ids = torch.from_numpy(x["panoptic_ids"])
    override = preprocess_panoptic_gt(gt, ids, NC)
    assigns = {}
    for route, jcfg, tol in (("off", jcfg_off, dict(rtol=1e-5, atol=1e-6)),
                             ("on", jcfg_int, dict(rtol=1e-4, atol=1e-6))):
        cfg = build_loss_cfg(dict(PAN_HEAD, mxu_readout=route), TRAIN_PTS)
        assert cfg.panoptic and cfg.batched_readout == (route == "on")
        ref, ref_grads, j_override = _jax_run(x, jcfg, loss_rng)
        leaves = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in DIFF}
        args = (leaves["cls_preds"], leaves["mask_embeds"], leaves["mask_feature"], gt, cfg,
                torch.from_numpy(x["lidar_xyz"]), torch.from_numpy(x["lidar_valid"]), draws)
        got = mask2former_loss(*args, panoptic_ids=ids)
        assert set(got) == set(ref)
        for k in ref:
            np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), err_msg=k, **tol)
        assert float(got["unassigned_gt"]) == 0.0
        sum(v for k, v in got.items() if "loss" in k).backward()
        for k, g in zip(DIFF, ref_grads):
            g = np.asarray(g)
            if route == "off":
                assert np.abs(leaves[k].grad.numpy() - g).max() <= 1e-4 * np.abs(g).max(), k
            else:
                np.testing.assert_allclose(leaves[k].grad.numpy(), g, rtol=1e-3, atol=1e-5,
                                           err_msg=k)
        assigns[route] = match_assignments(*args, panoptic_ids=ids).numpy()
    want = _jax_assignments(x, jcfg_off, loss_rng, j_override)
    np.testing.assert_array_equal(assigns["off"], want)
    np.testing.assert_array_equal(assigns["on"], assigns["off"])
    valid = override[2].numpy()
    assert ((assigns["off"] >= 0) == valid[None]).all()
    assert valid.sum(1).tolist() == [12, 11]
