"""Data-parallel training and evaluation of the port over processes, on the CPU.

Two ``gloo`` processes (this file run as a script, one thread each, the
process group met through a ``file://`` path under ``tmp_path``) stand in
for two cards; each takes its rank's rows of the global batch.  The port of
``tests/test_multihost_train.py`` and ``tests/test_multihost_eval.py``:

* two consecutive tiny train steps (``DistributedDataParallel``, BatchNorm
  over the global batch, the loss normalisers summed over ranks, each rank's
  rows of the global draws, a frozen stem without gradients) equal the
  one-process steps on the global batch of 2: the metrics, every parameter, AdamW's moments and every BatchNorm's
  running statistics, within float32 tolerances stated below;
* each host's shard of a grouped epoch is group-pure, and the shards are
  disjoint up to the group padding;
* ``evaluate`` over two ranks' shards of an odd split (its counters summed
  by ``host_allreduce_sum``) equals the one-process result exactly; with
  ``panoptic=True`` (the tiny model with the panoptic head, each sample's
  panoptic LiDAR labels its own formatted prediction with every third point
  moved) the summed ``pan_*`` counters are the two ranks' local counters
  added exactly (int64 and float64 carried in their dtype), the integer
  ones equal one process's, the float64 IoU sums and PQ / SQ / RQ within
  1e-12 relative of it (the same float64 terms added in another order);
* ``host_allreduce_sum`` keeps int64 counters past 2**31 and float64 sums
  exact.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

import tiny_cfg
from occformer_tpu_torch.data.loader import ShardedLoader, build_dataloader
from occformer_tpu_torch.data.synthetic import SyntheticOccDataset
from occformer_tpu_torch.engine.eval import build_eval_step, evaluate
from occformer_tpu_torch.engine.optim import build_optimizer, step_lr_schedule
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step, wrap_ddp
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.parallel.distributed import host_allreduce_sum
from occformer_tpu_torch.utils.panoptic import format_panoptic_results

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
TIMEOUT = 150  # seconds, each multi-process run


def _global_batches():
    """Two global batches of 2 tiny train samples (rank r takes row r)."""
    out = []
    for step in range(2):
        samples = []
        for r in range(WORLD):
            rng = np.random.RandomState(1000 + 10 * step + r)
            b = tiny_cfg.make_batch(rng)
            N, (H, W) = tiny_cfg.NUM_CAMS, tiny_cfg.INPUT_SIZE
            gt_occ = rng.randint(0, tiny_cfg.NUM_CLASSES, (1, *tiny_cfg.OCC_SIZE))
            depth = rng.uniform(0, 10, (1, N, H, W)).astype(np.float32)
            depth[depth < 3] = 0.0
            P = 96
            valid = np.ones((1, P), bool)
            valid[:, 70 + 10 * r:] = False  # the ranks hold different valid counts
            b.update(gt_occ=gt_occ.astype(np.int32), gt_depth=depth,
                     lidar_xyz=rng.uniform(0, 1, (1, P, 3)).astype(np.float32),
                     lidar_valid=valid,
                     lidar_label=rng.randint(1, tiny_cfg.NUM_CLASSES, (1, P)).astype(np.int32))
            samples.append(b)
        out.append({k: np.concatenate([s[k] for s in samples]) for k in samples[0]})
    return out


def _trainer(ddp):
    torch.manual_seed(0)
    cfg = tiny_cfg.model_cfg()
    # the flagship's frozen stem: parameters DDP must find unused
    cfg["img_backbone"]["frozen_stages"] = 0
    model = build_model(cfg, device="cpu", seed=0).train()
    opt = build_optimizer(model, lr=step_lr_schedule(1e-4, 10, [20, 23]), grad_clip=5.0)
    loss_cfg = build_loss_cfg(cfg["pts_bbox_head"], dict(
        num_points=64, oversample_ratio=2.0, importance_sample_ratio=0.75))
    step = build_train_step(wrap_ddp(model) if ddp else model, opt, loss_cfg, device="cpu")
    return model, opt, step


def _train(rows=None):
    """Two steps on the global batches (or on ``rows`` of them); the state
    and the metrics."""
    model, opt, step = _trainer(ddp=rows is not None)
    metrics, adamw = [], []
    for k, gb in enumerate(_global_batches()):
        batch = gb if rows is None else {key: v[rows] for key, v in gb.items()}
        out = step(batch, torch.Generator().manual_seed(k))
        metrics.append({key: float(v) for key, v in out.items()})
        adamw.append({f"{i}.{name}": v.clone() for i, st in opt.state_dict()["adamw"]["state"].items()
                      for name, v in st.items() if name != "step"})
    return {"metrics": metrics, "adamw": adamw,
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def _eval_loader(num_hosts=1, host_id=0):
    ds = SyntheticOccDataset(num_samples=5, num_cams=tiny_cfg.NUM_CAMS,
                             input_size=tiny_cfg.INPUT_SIZE, occ_size=tiny_cfg.OCC_SIZE,
                             num_classes=tiny_cfg.NUM_CLASSES, num_lidar_points=200)
    return build_dataloader(ds, shuffle=False, num_hosts=num_hosts, host_id=host_id,
                            max_points=256)


def _evaluate(loader):
    model = build_model(tiny_cfg.model_cfg(), device="cpu", seed=0)
    return evaluate(model, loader, tuple(tiny_cfg.OCC_SIZE), tiny_cfg.NUM_CLASSES)


THINGS = [1, 2]


def _panoptic_evaluate(loader):
    """``evaluate(panoptic=True)`` of the tiny panoptic model over ``loader``,
    each batch's LiDAR labels replaced by panoptic ids: the sample's own
    formatted prediction, every third point moved to another id.  Returns
    (metrics, local counters, reduced counters)."""
    cfg = tiny_cfg.model_cfg()
    cfg["pts_bbox_head"] = dict(cfg["pts_bbox_head"], type="Mask2FormerNuscPanopticOccHead",
                                stuff_indices=[0, 3, 4], thing_indices=THINGS)
    model = build_model(cfg, device="cpu", seed=0)
    occ, n = tuple(tiny_cfg.OCC_SIZE), tiny_cfg.NUM_CLASSES
    step = build_eval_step(model, occ, n, panoptic=True)
    batches = []
    for b in loader:
        b = dict(b)
        out = step({k: v for k, v in b.items() if k not in ("_meta", "gt_occ")})
        _, pan = format_panoptic_results(out["point_cls"][0].numpy(),
                                         out["point_mask"][0].numpy(), THINGS)
        idx = np.arange(pan.size)
        pan[idx % 3 == 0] = ((idx[idx % 3 == 0] % (n - 1)) + 1) * 1000
        b["lidar_label"] = pan[None].astype(np.int32)
        batches.append(b)
    seen = {}

    def reduce(state):
        seen["local"] = state
        seen["reduced"] = host_allreduce_sum(state)
        return seen["reduced"]

    metrics = evaluate(model, batches, occ, n, panoptic=True, thing_indices=THINGS,
                       all_reduce=reduce)
    return metrics, seen["local"], seen["reduced"]


def _worker(mode, rank, init, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=WORLD)
    try:
        if mode == "train":
            result = _train(rows=slice(rank, rank + 1))
        elif mode == "eval":
            result = _evaluate(_eval_loader(WORLD, rank))
        elif mode == "pan_eval":
            result = _panoptic_evaluate(_eval_loader(WORLD, rank))
        else:  # allreduce
            big = np.int64(2 ** 31 + 12345)
            result = host_allreduce_sum({
                "cm": np.array([[big, 3], [0, 7]], np.int64) * (rank + 1),
                "f64": np.float64(1.0) + np.float64(1e-17) * rank,
                "small": np.arange(4, dtype=np.int32)})
        torch.save(result, f"{out}.{rank}")
    finally:
        dist.destroy_process_group()


def _run_ranks(mode, tmp_path):
    """``mode`` on WORLD processes; each rank's result."""
    init = f"file://{tmp_path / 'rendezvous'}"
    out = str(tmp_path / mode)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), mode, str(r), init,
                               out], cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (_, err) in zip(procs, logs):
        assert p.returncode == 0, err[-3000:]
    return [torch.load(f"{out}.{r}", weights_only=False) for r in range(WORLD)]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_two_process_train_steps_equal_one_process(tmp_path):
    ranks = _run_ranks("train", tmp_path)
    ref = _train()
    for got in ranks:  # every rank holds the same state
        for k, v in ranks[0]["state"].items():
            assert torch.equal(got["state"][k], v), k
    got = ranks[0]
    # step 1 starts from equal parameters: float32 reassociation only; step 2
    # starts from parameters that already differ by up to 2 * lr (Adam's
    # first update is about sign(g) * lr, and a near-zero gradient can flip
    # sign under reassociation), as in tests/test_multihost_train.py
    for k, (g, r) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert g.keys() == r.keys()
        for name in g:
            if name == "point_mean_iou" and np.isnan(r[name]):
                assert np.isnan(g[name])
                continue
            np.testing.assert_allclose(g[name], r[name], rtol=1e-4 if k == 0 else 1e-3,
                                       atol=1e-5 if k == 0 else 1e-4, err_msg=f"{k} {name}")
    bn = [k for k in ref["state"] if "running_" in k]
    assert bn, "the tiny model has BatchNorms"
    for name, v in ref["state"].items():
        if name in bn:  # the global batch's statistics, not the shard's
            tol = dict(atol=1e-4, rtol=1e-3)
        elif v.dtype.is_floating_point:  # parameters: 2 steps of at most 2 * lr
            tol = dict(atol=4.1e-4, rtol=0)
        else:
            assert torch.equal(got["state"][name], v), name
            continue
        np.testing.assert_allclose(got["state"][name].numpy(), v.numpy(), err_msg=name, **tol)
    # AdamW's moments, each against the largest of its kind in the model:
    # after step 1 (equal parameters, reassociation only) within 1e-2 of the
    # tensor's own largest moment, never below 1e-4 of the model's (measured
    # at most 1e-3: a gradient that is rounding noise has no scale of its
    # own); after step 2 (gradients at parameters up to 2 * lr apart) within
    # 1e-2 of the model's largest (measured at most 1.6e-3)
    for k, (g_step, r_step) in enumerate(zip(got["adamw"], ref["adamw"])):
        assert g_step.keys() == r_step.keys()
        for kind in ("exp_avg", "exp_avg_sq"):
            names = [n for n in r_step if n.endswith("." + kind)]
            top = max(r_step[n].abs().max().item() for n in names)
            for name in names:
                v = r_step[name]
                atol = (1e-2 * max(v.abs().max().item(), 1e-4 * top) if k == 0
                        else 1e-2 * top)
                np.testing.assert_allclose(g_step[name].numpy(), v.numpy(), rtol=0,
                                           atol=atol, err_msg=f"step {k + 1} {name}")


def test_two_process_evaluate_equals_one_process(tmp_path):
    ranks = _run_ranks("eval", tmp_path)
    single = _evaluate(_eval_loader())
    assert [len(_eval_loader(WORLD, r)) for r in range(WORLD)] == [3, 2]  # an odd split
    for got in ranks:
        assert got.keys() == single.keys() and "nuScenes_lidarseg_mean" in got
        for k in single:
            assert got[k] == single[k] or (np.isnan(got[k]) and np.isnan(single[k])), k


def test_two_process_panoptic_evaluate_equals_one_process(tmp_path):
    ranks = _run_ranks("pan_eval", tmp_path)
    single, _, one = _panoptic_evaluate(_eval_loader())
    keys = ("pan_tp", "pan_fp", "pan_fn", "pan_iou")
    assert one["pan_tp"].sum() > 0 and one["pan_fp"].sum() + one["pan_fn"].sum() > 0
    for got, local, reduced in ranks:
        for k in keys:
            assert reduced[k].dtype == one[k].dtype == (np.float64 if k == "pan_iou"
                                                       else np.int64)
            np.testing.assert_array_equal(reduced[k], ranks[0][1][k] + ranks[1][1][k])
            if k == "pan_iou":
                np.testing.assert_allclose(reduced[k], one[k], rtol=1e-12, atol=0)
            else:
                np.testing.assert_array_equal(reduced[k], one[k])
        assert got.keys() == single.keys() and "nuScenes_panoptic_PQ" in got
        for k in got:
            if "panoptic" in k:
                np.testing.assert_allclose(got[k], single[k], rtol=1e-12, atol=0, err_msg=k)
            else:
                assert got[k] == single[k] or (np.isnan(got[k]) and np.isnan(single[k])), k
    assert 0.0 < single["nuScenes_panoptic_PQ"] < 1.0


def test_host_allreduce_sum_keeps_64bit_counters_exact(tmp_path):
    ranks = _run_ranks("allreduce", tmp_path)
    big = np.int64(2 ** 31 + 12345)
    for out in ranks:
        assert out["cm"].dtype == np.int64
        np.testing.assert_array_equal(out["cm"], 3 * np.array([[big, 3], [0, 7]], np.int64))
        assert out["f64"].dtype == np.float64 and out["f64"] == 2.0 + 1e-17  # not in float32
        assert out["small"].dtype == np.int32
        np.testing.assert_array_equal(out["small"], 2 * np.arange(4))
    assert host_allreduce_sum({"x": np.arange(3)})["x"].tolist() == [0, 1, 2]  # one process


class _IndexDataset:
    def __init__(self, n=12):
        self.flag = np.arange(n) % 2

    def __len__(self):
        return len(self.flag)

    def __getitem__(self, i):
        return {"idx": np.array([i])}


def _collate(samples, rng=None):
    return {"idx": np.concatenate([s["idx"] for s in samples])}


def test_host_shards_are_group_pure_and_disjoint():
    ds = _IndexDataset(12)
    seen = {}
    for host in range(WORLD):
        ld = ShardedLoader(ds, batch_size=2, shuffle=True, seed=0, num_hosts=WORLD,
                           host_id=host, collate_fn=_collate)
        ld.set_epoch(0)
        idxs = [b["idx"] for b in ld]
        for b in idxs:
            assert len(set(ds.flag[b])) == 1, b  # group-pure batches on every host
        seen[host] = np.concatenate(idxs)
    # two groups of 6 pad to a multiple of batch_size * num_hosts = 4: 8 each,
    # so exactly 2 in-group resampled duplicates a group, 4 in all
    assert len(seen[0]) == len(seen[1]) == 8
    assert len(set(seen[0]) & set(seen[1])) <= 4
    assert set(seen[0]) | set(seen[1]) == set(range(12))


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4])
