"""A resumed train CLI run repeats the uninterrupted one (ROADMAP C.9), on the CPU.

The tiny synthetic config with 4 samples an epoch (``samples_per_gpu=1``):
a run stopped mid-epoch at step 2 and resumed to step 4 takes the
uninterrupted run's steps 3 and 4, and a run stopped by SIGTERM wherever
the signal lands and resumed does the same: every logged loss, grad_norm
and metric is equal, exactly.  The LR milestone sits at step 2 (epoch 0.5),
so a resume whose schedule drifted would show.  ``ShardedLoader``'s start
batch builds no sample of the batches it skips.
"""
import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from occformer_tpu_torch.data.loader import ShardedLoader
from occformer_tpu_torch.tools import train as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py")
OPTS = ["data.train.num_samples=4", "runner.max_epochs=3", "log_config.interval=1",
        "lr_config.step=[0.5]"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logs(out):
    """step -> its logged metrics, without the wall time."""
    logs = {}
    for line in out.splitlines():
        if line.startswith('{"step"'):
            rec = json.loads(line)
            rec.pop("sec/iter")
            logs[rec.pop("step")] = rec
    return logs


def _train(capsys, work, max_steps, opts=OPTS):
    assert train_cli.main([TINY, "--cpu", "--work-dir", str(work), "--max-steps",
                           str(max_steps), "--cfg-options", *opts]) == 0
    out = capsys.readouterr().out
    return out, _logs(out)


def test_mid_epoch_resume_repeats_the_uninterrupted_run(tmp_path, capsys):
    _, whole = _train(capsys, tmp_path / "whole", 4)
    assert sorted(whole) == [1, 2, 3, 4] and {r["epoch"] for r in whole.values()} == {0}
    _, first = _train(capsys, tmp_path / "split", 2)
    out, second = _train(capsys, tmp_path / "split", 4)
    assert "at step 2 (epoch 0 from batch 2)" in out
    assert sorted(first) == [1, 2] and sorted(second) == [3, 4]
    for k, run in ((1, first), (2, first), (3, second), (4, second)):
        assert run[k] == whole[k], k


def test_sigterm_stop_and_resume_repeats_the_uninterrupted_run(tmp_path, capsys):
    """SIGTERM saves at whatever step it lands on; resumed from there, the
    run repeats the uninterrupted run's next steps."""
    opts = ["data.train.num_samples=8", "runner.max_epochs=50", "log_config.interval=1",
            "lr_config.step=[0.5]"]
    work = tmp_path / "stopped"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "occformer_tpu_torch.tools.train", TINY, "--cpu",
         "--work-dir", str(work), "--cfg-options", *opts],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    head = []
    try:
        deadline = time.time() + 240
        while time.time() < deadline:
            head.append(proc.stdout.readline())
            if not head[-1] or head[-1].startswith('{"step": 1,'):
                break
        assert head[-1].startswith('{"step": 1,'), proc.stderr.read()[-3000:]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0, err[-3000:]
    out = "".join(head) + out
    saved = int(out.split("preempted: checkpoint saved at step")[1].split()[0])
    assert 1 <= saved < 8  # mid-epoch
    stopped = _logs(out)
    out, resumed = _train(capsys, work, saved + 2, opts)
    assert f"at step {saved} (epoch 0 from batch {saved})" in out
    _, whole = _train(capsys, tmp_path / "whole", saved + 2, opts)
    assert sorted(resumed) == [saved + 1, saved + 2]
    for k in range(1, saved + 3):
        assert (resumed if k > saved else stopped)[k] == whole[k], k


class _CountingDataset:
    """Index samples that count how often each index was built."""

    def __init__(self, n, flag=None):
        self.n, self.built = n, []
        if flag is not None:
            self.flag = flag

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        self.built.append(i)
        return {"idx": np.array([i])}


def _collate(samples, rng=None):
    return {"idx": np.concatenate([s["idx"] for s in samples])}


@pytest.mark.parametrize("grouped", [False, True])
@pytest.mark.parametrize("host", [0, 1])
def test_start_batch_skips_without_building(grouped, host):
    flag = np.arange(12) % 2 if grouped else None
    kw = dict(batch_size=2, shuffle=True, seed=3, num_hosts=2, host_id=host,
              collate_fn=_collate)
    full_ds = _CountingDataset(12, flag)
    full = ShardedLoader(full_ds, **kw)
    full.set_epoch(1)
    whole = [b["idx"] for b in full]
    ds = _CountingDataset(12, flag)
    loader = ShardedLoader(ds, **kw)
    loader.set_epoch(1, start_batch=2)
    assert len(loader) == len(full) == len(whole) == (4 if grouped else 3)
    tail = [b["idx"] for b in loader]
    assert [t.tolist() for t in tail] == [w.tolist() for w in whole[2:]]
    assert ds.built == np.concatenate(whole[2:]).tolist()  # the skipped ones: never built
    with pytest.raises(ValueError):
        loader.set_epoch(1, start_batch=len(whole) + 1)


def test_resume_through_the_nuscenes_pipeline_repeats_the_run(tmp_path, capsys):
    """The same on the flagship's train pipeline (the tiny model on 2 of the
    6 cameras of a ``make_nuscenes_tree`` tree of 4 samples), whose camera
    choice, image and BDA augmentation are drawn per sample (C.10): the
    resumed run rebuilds the uninterrupted run's batches, and its steps
    repeat, exactly."""
    from occformer_tpu_torch.data.fixtures import make_nuscenes_tree
    from occformer_tpu_torch.data.nuscenes import NUSC_CLASS_NAMES
    from occformer_tpu_torch.tools.time_backwards import NUSCENES_RIG
    from test_torch_nuscenes_pipeline import TINY_NUSC

    root = str(tmp_path / "tree")
    ann = make_nuscenes_tree(root, n_samples=4, n_points=2000, seed=2, image_size=(90, 160))
    cfg = tmp_path / "tiny_nusc.py"
    cfg.write_text(TINY_NUSC.format(
        base=os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py"),
        names=list(NUSC_CLASS_NAMES), cams=[r[0] for r in NUSCENES_RIG], root=root, ann=ann))

    def train(work, max_steps):
        assert train_cli.main([str(cfg), "--cpu", "--work-dir", str(work), "--max-steps",
                               str(max_steps), "--cfg-options", "log_config.interval=1",
                               "runner.max_epochs=3"]) == 0
        out = capsys.readouterr().out
        return out, _logs(out)

    _, whole = train(tmp_path / "whole", 4)
    _, first = train(tmp_path / "split", 2)
    out, second = train(tmp_path / "split", 4)
    assert "at step 2 (epoch 0 from batch 2)" in out
    assert sorted(whole) == [1, 2, 3, 4] and sorted({**first, **second}) == [1, 2, 3, 4]
    for k, rec in {**first, **second}.items():
        assert rec == whole[k], k


def test_soak_reloads_resumes_and_replays_on_the_cpu(tmp_path):
    """``tools/soak.py`` on the tiny config: the mid-run checkpoint reloads
    bit-equal, the replay without it repeats the trajectory, and a soak
    resumed from its last flush carries on to the longer run's end."""
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.tools import soak

    cfg = load_config(TINY)
    rec = soak.soak(cfg, "auto", 4, 2, 0, str(tmp_path), flush_every=2, log=lambda s: None,
                    device="cpu")
    assert rec["steps_completed"] == 4 and rec["mid_run_reload_bit_equal"] is True
    assert rec["replay"] == {"trajectory_equal": True, "steps_differing": [],
                             "final_state_equal": True, "tensors_differing": []}
    more = soak.soak(cfg, "auto", 6, 2, 0, str(tmp_path), flush_every=2, resume=True,
                     log=lambda s: None, device="cpu")
    assert more["steps_completed"] == 6 and "resumed at step 4" in more["events"]
    assert more["loss_first"] == rec["loss_first"] and more["replay"]["trajectory_equal"]
