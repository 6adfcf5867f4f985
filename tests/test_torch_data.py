"""The port's copies of the JAX package's jax-free host code, held to it.

``SyntheticOccDataset`` samples, ``collate_batch``, ``ShardedLoader``'s batch
order (two epochs, two host shards, shuffled and in order, grouped), the
dot-path config overrides, the tiny CLI config and ``metrics_from_state``
must equal the JAX package's exactly: the same numpy code on the same
seeds.  ``prefetch_to_device`` on the CPU hands out the loader's arrays as
tensors.
"""
import os

import numpy as np
import pytest
import torch

from occformer_tpu.config import apply_overrides as jax_apply_overrides
from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.config import parse_override_value as jax_parse_value
from occformer_tpu.data.loader import ShardedLoader as JaxShardedLoader
from occformer_tpu.data.loader import collate_batch as jax_collate
from occformer_tpu.data.synthetic import SyntheticOccDataset as JaxSynthetic
from occformer_tpu.engine.eval import metrics_from_state as jax_metrics_from_state
from occformer_tpu_torch.config import (
    apply_overrides,
    load_config,
    parse_cfg_options,
    parse_override_value,
)
from occformer_tpu_torch.data.loader import (
    ShardedLoader,
    build_dataset,
    collate_batch,
    prefetch_to_device,
)
from occformer_tpu_torch.data.synthetic import SyntheticOccDataset
from occformer_tpu_torch.engine.eval import format_iou_table, metrics_from_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = "configs/synthetic_tiny.py"
DS_KW = dict(num_samples=6, num_cams=2, input_size=(16, 32), occ_size=(8, 8, 4),
             num_classes=5, num_lidar_points=300, seed=3)


def _assert_same(a, b, where=""):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (where, type(a), type(b))
    if isinstance(a, dict):
        assert a.keys() == b.keys(), (where, a.keys(), b.keys())
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("index", [0, 5])
def test_synthetic_samples_equal_jax(index):
    _assert_same(SyntheticOccDataset(**DS_KW)[index], JaxSynthetic(**DS_KW)[index])
    assert len(SyntheticOccDataset(**DS_KW)) == 6


def test_collate_batch_equals_jax():
    samples = [SyntheticOccDataset(**DS_KW)[i] for i in (1, 4)]
    for max_points in (200, 400):  # subsampled and padded
        got = collate_batch(samples, max_points=max_points, rng=np.random.RandomState(7))
        ref = jax_collate(samples, max_points=max_points, rng=np.random.RandomState(7))
        _assert_same(got, ref)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("grouped", [False, True])
def test_sharded_loader_batches_equal_jax(shuffle, grouped):
    """Two epochs, two host shards: the same batches in the same order."""
    kw = dict(batch_size=2, shuffle=shuffle, seed=5, num_hosts=2, max_points=250,
              drop_last=shuffle)
    ds = SyntheticOccDataset(**dict(DS_KW, num_samples=7))
    flags = np.array([0, 1, 0, 1, 1, 0, 1]) if grouped else None
    for host in (0, 1):
        got = ShardedLoader(ds, host_id=host, group_flags=flags, **kw)
        ref = JaxShardedLoader(ds, host_id=host, group_flags=flags, **kw)
        assert len(got) == len(ref) > 0
        for epoch in (0, 1):
            got.set_epoch(epoch)
            ref.set_epoch(epoch)
            assert np.array_equal(got._indices(), ref._indices())
            _assert_same(list(got), list(ref), f"host {host} epoch {epoch}")


def test_prefetch_to_device_on_the_cpu_hands_out_tensors():
    ds = SyntheticOccDataset(**DS_KW)
    loader = ShardedLoader(ds, batch_size=2, shuffle=False, max_points=250)
    ref = list(loader)
    got = list(prefetch_to_device(loader, "cpu"))
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert "_meta" not in g and set(g) == set(r) - {"_meta"}
        for k, v in g.items():
            assert isinstance(v, torch.Tensor) and np.array_equal(v.numpy(), r[k]), k


def test_build_dataset_names_what_is_not_ported():
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", TINY))
    ds = build_dataset(cfg["data"]["test"], test_mode=True)
    assert isinstance(ds, SyntheticOccDataset) and len(ds) == 16
    with pytest.raises(NotImplementedError, match="CustomSemanticKITTILssDataset"):
        build_dataset({"type": "CustomWaymoOccDataset", "data_root": "x"})


def test_config_overrides_equal_jax():
    opts = ["data.train.num_samples=2", "runner.max_epochs=3", "model.pts_bbox_head.num_queries=4",
            "log_config.interval=1", "data.train.input_size=[16,32]", "load_from=none.pth",
            "optimizer.betas=(0.8, 0.9)", "new.key=True"]
    mine = load_config(os.path.join(REPO, "occformer_tpu_torch", TINY), parse_cfg_options(opts))
    theirs = jax_load_config(os.path.join(REPO, "occformer_tpu", TINY),
                             {k: jax_parse_value(v) for k, v in (o.split("=", 1) for o in opts)})
    mine.pop("dist_params")  # the port's base runtime names NCCL, the JAX one ICI
    theirs.pop("dist_params")
    assert mine == theirs
    assert mine["data"]["train"]["input_size"] == [16, 32] and mine["new"]["key"] is True
    base = {"a": {"b": [1, 2, {"c": 3}]}}
    over = {"a.b.2.c": 9, "a.b.0": "x", "d.e": 1.5}
    assert apply_overrides(base, over) == jax_apply_overrides(base, over)
    for s in ("1", "1e-3", "[1, 2]", "abc", "{'x': 1}", "None"):
        assert parse_override_value(s) == jax_parse_value(s)


def test_tiny_cli_config_copy_equals_jax():
    mine = load_config(os.path.join(REPO, "occformer_tpu_torch", TINY))
    theirs = jax_load_config(os.path.join(REPO, "occformer_tpu", TINY))
    assert {k: v for k, v in mine.items() if k != "dist_params"} == \
        {k: v for k, v in theirs.items() if k != "dist_params"}


@pytest.mark.parametrize("n", [5, 17])
def test_metrics_from_state_equals_jax(n):
    rng = np.random.RandomState(n)
    cm = rng.randint(0, 50, (n, n)).astype(np.int64)
    cm[2, :] = 0
    cm[:, 2] = 0  # a class absent from both: NaN, left out of the mean
    names = [f"c{i}" for i in range(n)]
    got = metrics_from_state({"confusion": cm}, n, class_names=names)
    ref = jax_metrics_from_state({"confusion": cm}, n, class_names=names)
    assert got.keys() == ref.keys() and "nuScenes_lidarseg_mean" in got
    for k in got:
        assert got[k] == ref[k] or (np.isnan(got[k]) and np.isnan(ref[k])), k
    assert metrics_from_state({"confusion": np.zeros((n, n), np.int64)}, n) == {}
    assert format_iou_table(got).splitlines()[2].startswith("| nuScenes_lidarseg_c1 |")
