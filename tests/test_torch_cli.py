"""The port's train and test CLIs on the tiny synthetic config, on the CPU.

``tools.train`` run in one go for 4 steps and run for 2 steps then resumed
to 4 (``data.train.num_samples=2``, so step 2 closes an epoch and the
resumed run starts a fresh one, as the JAX CLI resumes) give the same
losses at steps 3 and 4, exactly: every draw of step k comes from (seed,
k), and the checkpoint carries the weights, BatchNorm statistics, AdamW's
state and the schedule's step.  A SIGTERM during training leaves a
checkpoint that loads.  ``tools.test`` prints ``nuScenes_lidarseg_mean``
and writes the lidarseg submission.  The CLIs run in process through
``main(argv)``, except for the SIGTERM test, which needs its own process.
"""
import json
import os
import signal
import subprocess
import sys
import time

import pytest
import torch

from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.engine.checkpoint import latest_checkpoint, load_checkpoint
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.tools import test as test_cli
from occformer_tpu_torch.tools import train as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py")
# a frozen stem, as the flagship has: the optimizer's groups follow the freeze
OPTS = ["--cfg-options", "data.train.num_samples=2", "runner.max_epochs=3",
        "log_config.interval=1", "model.img_backbone.frozen_stages=0"]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _train(capsys, work, max_steps, *extra):
    assert train_cli.main([TINY, "--cpu", "--work-dir", str(work), "--max-steps",
                           str(max_steps), *extra, *OPTS]) == 0
    out = capsys.readouterr().out
    logs = {}
    for line in out.splitlines():
        if line.startswith('{"step"'):
            rec = json.loads(line)
            logs[rec.pop("step")] = rec
    return out, logs


def test_resumed_train_cli_repeats_the_uninterrupted_run(tmp_path, capsys):
    out, whole = _train(capsys, tmp_path / "whole", 4)
    assert "training done at step 4" in out and sorted(whole) == [1, 2, 3, 4]
    assert '{"kernel_launches": {"K1": 0, ' in out  # the CPU runs the plain versions
    _, first = _train(capsys, tmp_path / "split", 2)
    out, second = _train(capsys, tmp_path / "split", 4)
    assert f"resumed from {tmp_path / 'split' / 'ckpts' / 'step_2'} at step 2" in out
    assert "training done at step 4" in out and sorted(second) == [3, 4]
    for k, run in ((1, first), (2, first), (3, second), (4, second)):
        assert run[k]["epoch"] == whole[k]["epoch"] == (k - 1) // 2
        got = {n: v for n, v in run[k].items() if n != "sec/iter"}
        ref = {n: v for n, v in whole[k].items() if n != "sec/iter"}
        assert got == ref, k
    # max_keep_ckpts=1 (the base runtime): only the newest survives
    assert os.listdir(tmp_path / "split" / "ckpts") == ["step_4"]


def test_train_cli_without_a_card_needs_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="--cpu"):
        train_cli.main([TINY, "--work-dir", str(tmp_path), "--max-steps", "1"])
    with pytest.raises(RuntimeError, match="--cpu"):
        test_cli.main([TINY, "--max-samples", "1"])


def test_load_from_gives_weights_at_step_zero(tmp_path, capsys):
    _train(capsys, tmp_path / "a", 1)
    ckpt = latest_checkpoint(str(tmp_path / "a" / "ckpts"))
    out, _ = _train(capsys, tmp_path / "b", 1, "--load-from", ckpt)
    assert f"loaded model weights from {ckpt}" in out and "training done at step 1" in out
    out, _ = _train(capsys, tmp_path / "c", 1, "--load-from", str(tmp_path / "nope"))
    assert "not found" in out and "training done at step 1" in out


def test_test_cli_prints_lidarseg_mean_and_writes_the_submission(tmp_path, capsys):
    _train(capsys, tmp_path / "w", 1)
    sub = tmp_path / "sub"
    assert test_cli.main([TINY, "--cpu", "--checkpoint", str(tmp_path / "w" / "ckpts" / "step_1"),
                          "--max-samples", "2", "--test-save", str(sub)]) == 0
    lines = capsys.readouterr().out.splitlines()
    timing = json.loads(lines[1])
    assert timing["samples"] == 2 and timing["sec/sample"] > 0
    results = json.loads(lines[-1])
    assert "nuScenes_lidarseg_mean" in results and "| nuScenes_lidarseg_mean |" in lines[-2]
    assert os.path.isfile(sub / "test" / "submission.json")
    preds = (sub / "lidarseg" / "test" / "s0_lidarseg.bin").read_bytes()
    assert len(preds) == 512 and max(preds) < 5 and min(preds) >= 1  # the valid points


def test_test_cli_and_per_epoch_evaluation_agree(tmp_path, capsys):
    """Both evaluation routes serve float32 parameters under the config's
    compute dtype (bf16 autocast here, through ``build_eval_step``): the
    train CLI's per-epoch evaluation and the test CLI on the checkpoint that
    epoch saved give the same IoU table."""
    opts = ["--cfg-options", "data.train.num_samples=2", "data.val.num_samples=2",
            "data.test.num_samples=2", "runner.max_epochs=1", "evaluation.interval=1",
            "compute_dtype='bfloat16'"]
    assert train_cli.main([TINY, "--cpu", "--work-dir", str(tmp_path), *opts]) == 0
    out = capsys.readouterr().out.splitlines()
    per_epoch = [ln for ln in out if ln.startswith("|")]
    assert any(ln.startswith("| nuScenes_lidarseg_mean |") for ln in per_epoch)
    assert test_cli.main([TINY, "--cpu", "--checkpoint", str(tmp_path / "ckpts" / "step_2"),
                          *opts]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert [ln for ln in lines if ln.startswith("|")] == per_epoch


def test_sigterm_during_training_leaves_a_loadable_checkpoint(tmp_path):
    work = tmp_path / "w"
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "occformer_tpu_torch.tools.train", TINY, "--cpu",
         "--work-dir", str(work), "--cfg-options", "log_config.interval=1",
         "runner.max_epochs=50"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=REPO,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        deadline = time.time() + 300
        saw_step = False
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith('{"step": 1,'):
                saw_step = True
                break
        assert saw_step, proc.stderr.read()[-3000:]
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        assert "preempted: checkpoint saved at step" in out
    finally:
        if proc.poll() is None:
            proc.kill()
    ckpt = latest_checkpoint(str(work / "ckpts"))
    saved_at = int(out.split("preempted: checkpoint saved at step")[1].split()[0])
    assert ckpt.endswith(f"step_{saved_at}") and saved_at >= 1
    model = build_model(load_config(TINY)["model"], device="cpu")
    assert load_checkpoint(ckpt, model) == saved_at
