"""The port's StageTimer, stage benchmark and memory tool against the JAX
package's, on the CPU at the tiny config (``configs/synthetic_tiny.py``).

* ``utils/profiling.py:StageTimer.report()`` given the same ``times`` gives
  JAX's string.
* ``tools/benchmark.py --cpu --iters 1`` prints JAX's keys (with
  ``--stage-breakdown``, and ``{"stage", "ms_per_call"}`` with ``--stage``).
* ``tools/memory_analysis.py --cpu``: its parameter bytes equal the JAX
  tiny model's ``jax.eval_shape`` parameter bytes, and its AdamW state
  bytes the two moments of JAX's ``build_optimizer(params).init(params)``.
  Both keep moments for frozen parameters (their gradients are zeroed
  before the clip, not masked out of AdamW).  By design the port's state
  also holds one step counter a parameter and JAX's one count in all;
  neither is in the compared bytes.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from occformer_tpu.utils.profiling import StageTimer as JaxStageTimer
from occformer_tpu_torch.tools import benchmark, memory_analysis
from occformer_tpu_torch.utils import profiling
from occformer_tpu_torch.utils.profiling import StageTimer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py")
JAX_TINY = "occformer_tpu/configs/synthetic_tiny.py"
JAX_BENCHMARK_KEYS = {"fps_per_chip", "sec_per_frame", "method", "img_encoder_ms",
                      "through_neck_ms", "full_ms"}


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("times", [
    {"img_encoder": [0.0123, 0.0131], "view_transformer": [0.25], "head": [0.0009, 0.0011]},
    {"only": [1.5]},
    {"empty": [], "zero": [0.0]},
])
def test_stage_timer_report_equals_jax(times):
    port, ref = StageTimer("cpu"), JaxStageTimer()
    for k, v in times.items():
        port.times[k].extend(v)
        ref.times[k].extend(v)
    assert port.report() == ref.report()
    port.reset()
    ref.reset()
    assert port.report() == ref.report() == ""


def test_stage_timer_times_each_stage_on_the_host():
    timer = StageTimer("cpu")
    for _ in range(3):
        with timer.stage("a"):
            sum(range(1000))
    with timer.stage("b"):
        pass
    assert len(timer.times["a"]) == 3 and len(timer.times["b"]) == 1
    assert all(t >= 0 for v in timer.times.values() for t in v)
    assert timer.report().startswith("a: ")


def test_stage_timer_and_trace_need_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StageTimer()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        with profiling.trace(str(tmp_path)):
            pass
    assert profiling.device_memory_stats() == {}
    with profiling.trace(str(tmp_path), device="cpu") as d:
        torch.ones(4).sum()
    with open(os.path.join(d, "trace.json")) as f:
        assert "traceEvents" in json.load(f)


@pytest.mark.parametrize("args,keys", [
    (["--stage-breakdown"], JAX_BENCHMARK_KEYS),
    (["--stage", "feat"], {"stage", "ms_per_call"}),
])
def test_benchmark_prints_the_jax_keys(capsys, args, keys):
    assert benchmark.main([TINY, "--cpu", "--iters", "1", *args]) == 0
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(report) == keys
    if "full_ms" in report:
        assert 0 < report["img_encoder_ms"] and 0 < report["through_neck_ms"]
        assert report["sec_per_frame"] * 1e3 == pytest.approx(report["full_ms"])
        assert report["fps_per_chip"] == pytest.approx(1.0 / report["sec_per_frame"])
    else:
        assert report["stage"] == "feat" and report["ms_per_call"] > 0


def test_benchmark_batch_is_jax_s():
    from __graft_entry__ import _flagship_model_and_batch
    from occformer_tpu_torch.config import load_config

    _, ref = _flagship_model_and_batch(jnp.float32, 2)
    got = benchmark.benchmark_batch(load_config(os.path.join(
        REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")), 2)
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_memory_tool_counts_jax_s_parameters_and_adamw_moments(capsys):
    from occformer_tpu.engine.optim import build_optimizer

    sys_path_tools = os.path.join(REPO, "tools")
    import sys

    sys.path.insert(0, sys_path_tools)
    try:
        from tpu_train_trial import build_trial
    finally:
        sys.path.remove(sys_path_tools)

    assert memory_analysis.main([TINY, "--cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])

    model, batch, _, _ = build_trial(JAX_TINY, 1, 512)
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": key, "dropout": key}, batch))
    params = shapes["params"]
    param_bytes = sum(np.prod(s.shape) * s.dtype.itemsize
                      for s in jax.tree_util.tree_leaves(params))
    opt_state = jax.eval_shape(build_optimizer(params, lr=1e-4, grad_clip=5.0).init, params)
    moments = [s for s in jax.tree_util.tree_leaves(opt_state) if s.ndim > 0]
    moment_bytes = sum(np.prod(s.shape) * s.dtype.itemsize for s in moments)
    gib = 2.0 ** 30

    assert got["param_gib"] * gib == param_bytes
    assert got["grad_gib"] * gib == param_bytes
    assert moment_bytes == 2 * param_bytes
    assert got["opt_state_gib"] * gib == moment_bytes
    assert got["argument_gib"] == pytest.approx(
        got["param_gib"] + got["buffer_gib"] + got["opt_state_gib"] + got["batch_gib"])
    assert got["stage_peak_gib"] is None and got["total_gib"] is None
