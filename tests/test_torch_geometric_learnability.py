"""Held-out geometric learnability of the port, and its scene renderers.

The port of ``tests/test_geometric_learnability.py``: box scenes rendered
through one camera rig into both the images and the occupancy grid
(``occformer_tpu_torch/data/geo_scenes.py``).  Trained on 12 scenes for 300
steps (the tiny model, AdamW at 3e-4, clip 5), the port must beat chance on
4 held-out scenes by the JAX test's margins: held-out SC IoU > 0.15 (chance
is about the occupied share of the grid) and class mIoU > 0.08.  That holds
only if the whole camera -> LSS -> voxel -> head chain is spatially
consistent.  It is ``slow`` on the CPU, as the JAX test is; ``chip_smoke.py``
runs it on the card.  Not slow: both renderers, the tiny 2-camera rig and
the nuScenes-like 6-camera rig, give the JAX test's and tool's arrays bit
for bit from the same generator state.
"""
import numpy as np
import pytest
import torch

import test_geometric_learnability as jax_tiny
import tiny_cfg
from occformer_tpu_torch.data import geo_scenes
from occformer_tpu_torch.engine.train import build_loss_cfg
from occformer_tpu_torch.tools.synthetic_geo_benchmark import train_geo
from tools import synthetic_geo_benchmark as jax_nusc  # the JAX package's tool


def _assert_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            _assert_equal([a[k] for k in sorted(a)], [b[k] for k in sorted(b)])
        else:
            a, b = np.asarray(a), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 3])
def test_tiny_rig_scenes_equal_jax(seed):
    got_rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(3):
        _assert_equal(geo_scenes.make_tiny_scene(got_rng), jax_tiny.make_scene(ref_rng))
    _assert_equal([geo_scenes.tiny_scene_batch(got_rng)], [jax_tiny.scene_batch(ref_rng)])
    assert got_rng.random() == ref_rng.random()  # the same draws were taken


@pytest.mark.parametrize("seed", [0, 7])
def test_nusc_rig_scenes_equal_jax(seed):
    got_rng, ref_rng = np.random.default_rng(seed), np.random.default_rng(seed)
    _assert_equal(geo_scenes.make_nusc_scene(got_rng), jax_nusc.make_scene(ref_rng))
    got = geo_scenes.nusc_scene_batch(got_rng, max_lidar=20000)
    ref = jax_nusc.scene_batch(ref_rng, max_lidar=20000)
    _assert_equal([got], [ref])
    assert got["imgs"].shape == (1, 6, 256, 704, 3) and got["lidar_valid"].any()
    assert got_rng.random() == ref_rng.random()


def test_rig_constants_equal_jax():
    assert np.array_equal(geo_scenes.NuscRig.ROTS, jax_nusc.ROTS)
    assert np.array_equal(geo_scenes.NuscRig.PALETTE, jax_nusc._palette)
    assert np.array_equal(geo_scenes.TinyRig.ROTS, jax_tiny.ROTS)
    assert list(geo_scenes.TinyRig.OCC) == list(tiny_cfg.OCC_SIZE)
    assert (geo_scenes.TinyRig.H, geo_scenes.TinyRig.W) == tuple(tiny_cfg.INPUT_SIZE)


def test_heldout_iou_counts():
    gt = np.zeros((4, 4, 2), np.int64)
    gt[:2, :2] = 1
    gt[3, 3] = 2
    pred = np.zeros_like(gt)
    pred[:2, :2] = 1  # class 1 exactly, class 2 missed, class 3 absent
    r = geo_scenes.heldout_iou([pred], [gt], 4)
    assert r["sc_iou"] == 8 / 10 and r["chance_sc_iou"] == 10 / 32
    assert r["miou"] == 0.5  # over the present classes 1 and 2
    assert r["miou_all_classes"] == pytest.approx(1 / 3)  # over 1, 2 and 3


@pytest.mark.slow
def test_geometric_learnability_heldout():
    torch.set_num_threads(4)
    cfg = tiny_cfg.model_cfg()
    loss_cfg = build_loss_cfg(cfg["pts_bbox_head"], dict(
        num_points=128, oversample_ratio=2.0, importance_sample_ratio=0.75))
    rec = train_geo(cfg, loss_cfg, "tiny", steps=300, train_scenes=12, test_scenes=4,
                    device="cpu", lr=3e-4)
    sc, miou = rec["heldout_SC_IoU"], rec["heldout_mIoU_all_classes"]
    # chance SC IoU ~0.06 (the occupied share)
    assert sc > 0.15, f"held-out SC IoU {sc:.3f} (chance {rec['chance_SC_IoU']:.3f})"
    assert miou > 0.08, f"held-out class mIoU {miou:.3f}"
