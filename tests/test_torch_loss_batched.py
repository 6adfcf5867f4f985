"""The port's all-layer batched loss route (``mxu_readout="on"``) against the
JAX package's (``_mxu_batched_loss``, run on the CPU with
``mxu_readout="interpret"``), and the port's two routes against each other.

* The batched route against JAX ``mask2former_loss`` with
  ``feature_readout=True`` and ``mxu_readout="interpret"``, with the GT read
  by JAX's plain label gather (``gt_label_kernel=False``) and by its Pallas
  label kernel (``gt_label_kernel=True``), at B = 1 and 2, on the same model
  outputs and the draws of ``jax_loss_draws`` (JAX's key tree).  Every
  ``d{i}.loss_*`` and ``unassigned_gt`` to rtol 1e-4 / atol 1e-6, and the
  gradients with respect to ``cls_preds``, ``mask_embeds`` and
  ``mask_feature`` to rtol 1e-3 / atol 1e-5: the tolerances of JAX's own
  equivalence test of its two routes
  (``tests/test_loss_edge_cases.py::test_mxu_readout_equivalent_losses_and_grads``),
  since the volume side and the feature side round differently.
* The port's batched route against its per-layer route on the same inputs
  and draws, with the class-id GT read (K3's plain version) and with the
  one-hot GT read the batched route keeps for slots that are not class ids
  (``num_classes >= 256``).
* ``build_loss_cfg`` reads ``mxu_readout`` as JAX does; ``"auto"`` is the
  per-layer route.

Some LiDAR points lie outside [0, 1], so the border padding is exercised.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.engine.train import build_loss_cfg as jax_build_loss_cfg
from occformer_tpu.losses.mask2former_loss import mask2former_loss as jax_mask2former_loss
from occformer_tpu_torch.engine.train import build_loss_cfg
from occformer_tpu_torch.losses.mask2former_loss import (
    MaskLossConfig,
    make_loss_draws,
    mask2former_loss,
)
from test_torch_loss import TRAIN_PTS, jax_loss_draws

DIFF = ("cls_preds", "mask_embeds", "mask_feature")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(B, seed=0, L=4, P=100, num_classes=tiny_cfg.NUM_CLASSES):
    rng = np.random.RandomState(seed)
    Q, C = 8, tiny_cfg.VOXEL_OUT
    X, Y, Z = tiny_cfg.VOXEL_GRID
    gt = rng.randint(0, tiny_cfg.NUM_CLASSES, (B, *tiny_cfg.OCC_SIZE)).astype(np.int32)
    gt[:, :3] = 255
    gt[gt == 3] = 4  # class 3 absent: an invalid GT slot
    return dict(
        cls_preds=rng.randn(L, B, Q, num_classes + 1).astype(np.float32),
        mask_embeds=(0.4 * rng.randn(L, B, Q, C)).astype(np.float32),
        mask_feature=(0.4 * rng.randn(B, X, Y, Z, C)).astype(np.float32),
        gt_occ=gt,
        lidar_xyz=rng.uniform(-0.1, 1.1, (B, P, 3)).astype(np.float32),
        lidar_valid=np.arange(P)[None].repeat(B, 0) < int(0.8 * P),
    )


def _port_loss(x, cfg, draws):
    """Losses and the three input gradients of the port's loss."""
    leaves = {k: torch.from_numpy(x[k]).requires_grad_(True) for k in DIFF}
    losses = mask2former_loss(leaves["cls_preds"], leaves["mask_embeds"],
                              leaves["mask_feature"], torch.from_numpy(x["gt_occ"]), cfg,
                              torch.from_numpy(x["lidar_xyz"]),
                              torch.from_numpy(x["lidar_valid"]), draws)
    sum(v for k, v in losses.items() if "loss" in k).backward()
    return ({k: float(v.detach()) for k, v in losses.items()},
            {k: leaves[k].grad.numpy() for k in DIFF})


@pytest.mark.parametrize("gt_label_kernel", [False, True])
@pytest.mark.parametrize("B", [1, 2])
def test_batched_loss_and_its_gradients_match_jax(B, gt_label_kernel):
    head = tiny_cfg.model_cfg()["pts_bbox_head"]
    jcfg = dataclasses.replace(
        jax_build_loss_cfg(dict(head, mxu_readout="interpret"), TRAIN_PTS),
        gt_label_kernel=gt_label_kernel)
    assert jcfg.feature_readout and jcfg.use_lidar_points
    cfg = build_loss_cfg(dict(head, mxu_readout="on"), TRAIN_PTS)
    assert cfg.batched_readout
    x = _inputs(B)
    loss_rng = jax.random.PRNGKey(5)
    L = x["cls_preds"].shape[0]

    def jax_total(cls, emb, feat):
        losses = jax_mask2former_loss(loss_rng, cls, emb, feat, jnp.asarray(x["gt_occ"]),
                                      jcfg, lidar_xyz=jnp.asarray(x["lidar_xyz"]),
                                      lidar_valid=jnp.asarray(x["lidar_valid"]))
        return sum(v for k, v in losses.items() if "loss" in k), losses

    (_, ref), ref_grads = jax.jit(jax.value_and_grad(jax_total, (0, 1, 2), has_aux=True))(
        *(jnp.asarray(x[k]) for k in DIFF))
    got, grads = _port_loss(x, cfg, jax_loss_draws(loss_rng, jcfg, x["lidar_valid"], L))
    assert set(got) == set(ref) and "d0.loss_dice" in got
    for k in ref:
        np.testing.assert_allclose(got[k], float(ref[k]), rtol=1e-4, atol=1e-6, err_msg=k)
    assert got["unassigned_gt"] == 0.0
    for k, g in zip(DIFF, ref_grads):
        np.testing.assert_allclose(grads[k], np.asarray(g), rtol=1e-3, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("num_classes", [tiny_cfg.NUM_CLASSES, 256])
def test_the_two_routes_agree(num_classes):
    """Same inputs, same draws: the batched route (the label gather, or the
    one-hot GT read at 256 slots) equals the per-layer route to float32
    rounding.  rtol 1e-5 on the losses (sums over at most 128 points);
    gradients within 1e-4 of their max (the two routes contract in another
    order)."""
    B, L = 2, 3
    x = _inputs(B, seed=1, L=L, num_classes=num_classes)
    cfg = MaskLossConfig(num_classes=num_classes, num_points=64, oversample_ratio=2.0,
                         class_weight=(1.0,) * num_classes + (0.1,), mxu_readout="off")
    draws = make_loss_draws(torch.Generator().manual_seed(3), cfg,
                            torch.from_numpy(x["lidar_valid"]), L)
    ref, ref_grads = _port_loss(x, cfg, draws)
    got, grads = _port_loss(x, dataclasses.replace(cfg, mxu_readout="on"), draws)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-5, atol=1e-6, err_msg=k)
    for k in DIFF:
        g = ref_grads[k]
        assert np.abs(grads[k] - g).max() <= 1e-4 * np.abs(g).max() + 1e-7, k


@pytest.mark.parametrize("B", [1, 2])
def test_batched_route_calls_each_kernel_three_times_on_contiguous_tensors(B, monkeypatch):
    """The kernels take only contiguous tensors, and the route's launch
    counts (K2 3, K3 3 per call) are what the card's smoke run checks: the
    wrappers, seen from the CPU."""
    from occformer_tpu_torch.losses import mask2former_loss as m2f
    from occformer_tpu_torch.ops import sampling

    calls = []

    def spy(name, real):
        def wrapped(*args, **kwargs):
            calls.append((name, all(a.is_contiguous() for a in args
                                    if isinstance(a, torch.Tensor))))
            return real(*args, **kwargs)
        return wrapped

    monkeypatch.setattr(sampling, "trilerp_sample", spy("K2", sampling.trilerp_sample))
    monkeypatch.setattr(m2f, "sample_id_masks", spy("K3", m2f.sample_id_masks))
    x = _inputs(B, L=2)
    cfg = build_loss_cfg(dict(tiny_cfg.model_cfg()["pts_bbox_head"], mxu_readout="on"),
                         TRAIN_PTS)
    draws = make_loss_draws(torch.Generator().manual_seed(0), cfg,
                            torch.from_numpy(x["lidar_valid"]), 2)
    _port_loss(x, cfg, draws)
    assert [n for n, _ in calls] == ["K2", "K3"] * 3
    assert all(ok for _, ok in calls), calls


def test_build_loss_cfg_reads_mxu_readout():
    head = tiny_cfg.model_cfg()["pts_bbox_head"]
    assert build_loss_cfg(head, TRAIN_PTS).mxu_readout == "auto"
    assert not build_loss_cfg(head, TRAIN_PTS).batched_readout
    for value, batched in (("auto", False), ("off", False), ("on", True),
                           ("interpret", True)):
        cfg = build_loss_cfg(dict(head, mxu_readout=value), TRAIN_PTS)
        assert cfg.mxu_readout == value and cfg.batched_readout == batched
        assert jax_build_loss_cfg(dict(head, mxu_readout=value), TRAIN_PTS).mxu_readout == value
    with pytest.raises(ValueError, match="mxu_readout"):
        build_loss_cfg(dict(head, mxu_readout="fast"), TRAIN_PTS)
