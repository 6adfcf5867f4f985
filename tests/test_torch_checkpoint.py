"""The port's checkpoints: the train state round trip and the directory contract.

After one train step of the tiny CLI model on the CPU (BatchNorm statistics
updated, AdamW moments non-zero), a save and a load into a fresh model and
optimizer give back every parameter, buffer, moment and step bit for bit,
and the next step of both is the same.  ``max_keep`` pruning, the sweep of
a killed save's temporary and ``latest_checkpoint`` as the JAX package's
directory contract has them; a reference ``.pth`` state dict through the
non-strict partial load.
"""
import os

import numpy as np
import pytest
import torch

from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.data.loader import build_dataloader, build_dataset
from occformer_tpu_torch.engine.checkpoint import (
    latest_checkpoint,
    load_checkpoint,
    read_checkpoint,
    save_checkpoint,
)
from occformer_tpu_torch.engine.optim import build_optimizer
from occformer_tpu_torch.engine.pretrained import partial_load_torch
from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
from occformer_tpu_torch.models.detector import build_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(seed):
    cfg = load_config(TINY)
    m = cfg["model"]
    model = build_model(m, device="cpu", seed=seed).train()
    opt = build_optimizer(model, lr=1e-3)
    step = build_train_step(model, opt, build_loss_cfg(m["pts_bbox_head"], m["train_cfg"]["pts"]),
                            device="cpu")
    batch = next(iter(build_dataloader(build_dataset(cfg["data"]["train"]), max_points=512)))
    batch.pop("_meta")
    return model, opt, step, batch


def _opt_tensors(opt):
    return {(i, k): v for i, s in opt.state_dict()["adamw"]["state"].items()
            for k, v in s.items()}


def test_round_trip_is_bit_equal_and_training_continues_alike(tmp_path):
    model, opt, step, batch = _setup(seed=0)
    step(batch, torch.Generator().manual_seed(0))
    path = save_checkpoint(str(tmp_path), model, opt, 1)
    assert path == os.path.join(str(tmp_path), "step_1")

    model2, opt2, step2, _ = _setup(seed=1)
    assert not torch.equal(model2.state_dict()["pts_bbox_head.query_feat.weight"],
                           model.state_dict()["pts_bbox_head.query_feat.weight"])
    assert load_checkpoint(path, model2, opt2) == 1
    sd, sd2 = model.state_dict(), model2.state_dict()
    assert sd.keys() == sd2.keys()
    assert any("running_mean" in k for k in sd)  # BatchNorm statistics ride along
    for k in sd:
        assert sd[k].dtype == sd2[k].dtype and torch.equal(sd[k], sd2[k]), k
    t, t2 = _opt_tensors(opt), _opt_tensors(opt2)
    assert t.keys() == t2.keys() and {k for _, k in t} == {"step", "exp_avg", "exp_avg_sq"}
    for k in t:
        assert torch.equal(t[k], t2[k]), k
    assert opt2.step_count == opt.step_count == 1

    m1 = step(batch, torch.Generator().manual_seed(1))
    m2 = step2(batch, torch.Generator().manual_seed(1))
    assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m2.items()}
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert torch.equal(a, b), k


def test_directory_contract(tmp_path):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    ckpts = str(tmp_path / "ckpts")
    assert latest_checkpoint(ckpts) is None
    os.makedirs(os.path.join(ckpts, "step_3.tmp-999"))  # a save killed half-way
    save_checkpoint(ckpts, model, None, 3, max_keep=2)
    save_checkpoint(ckpts, model, None, 7, max_keep=2)
    save_checkpoint(ckpts, model, None, 12, max_keep=2)
    assert sorted(os.listdir(ckpts)) == ["step_12", "step_7"]
    assert latest_checkpoint(ckpts) == os.path.join(ckpts, "step_12")
    state = read_checkpoint(latest_checkpoint(ckpts))
    assert state["step"] == 12 and state["optimizer"] is None
    save_checkpoint(ckpts, model, None, 12, max_keep=2)  # a re-save of the same step
    assert sorted(os.listdir(ckpts)) == ["step_12", "step_7"]


def test_reference_state_dict_loads_strictly_at_step_zero(tmp_path):
    """A reference ``.pth`` (an mmcv checkpoint or a bare state dict) loads
    through ``engine/pretrained.py:partial_load_torch``, as mmcv's
    non-strict ``load_from``: a complete file fills every tensor and leaves
    nothing unused; a file whose tensors match nothing is skipped and
    reported, the model untouched.  ``load_checkpoint`` stays strict for the
    train CLI's ``step_N`` directories (step 0 here) and refuses a file."""
    src = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    dst = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    torch.save({"state_dict": src.state_dict(), "meta": {"epoch": 24}}, tmp_path / "ref.pth")
    torch.save(src.state_dict(), tmp_path / "bare.pth")
    for name in ("ref.pth", "bare.pth"):
        rep = partial_load_torch(dst, str(tmp_path / name))
        assert rep["loaded_subtrees"] == ["0", "1"] and rep["skipped_subtrees"] == []
        assert rep["kept_init"] == [] and rep["unused_keys"] == []
        for k, v in src.state_dict().items():
            assert torch.equal(v, dst.state_dict()[k]), k
    torch.save({"state_dict": {"0.weight": np.zeros(1)}}, tmp_path / "bad.pth")
    before = {k: v.clone() for k, v in dst.state_dict().items()}
    rep = partial_load_torch(dst, str(tmp_path / "bad.pth"))
    assert rep["skipped_subtrees"] == ["0"] and rep["unused_keys"] == ["0.weight"]
    assert all(torch.equal(v, before[k]) for k, v in dst.state_dict().items())
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "bad.pth"), dst)
    path = save_checkpoint(str(tmp_path / "ckpts"), src, None, 0)
    assert load_checkpoint(path, dst) == 0
    with pytest.raises(RuntimeError):  # strict: missing and unexpected keys
        load_checkpoint(path, torch.nn.Sequential(torch.nn.Linear(3, 4)))
