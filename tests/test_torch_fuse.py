"""Conv + BatchNorm fusion (``engine/fuse.py``): the two rules of
tests/test_fuse.py on the port, and the fusion tool on a train-CLI
checkpoint.

Fused eval-mode outputs equal the unfused ones within float32 rounding
(rtol/atol 2e-5, as tests/test_fuse.py), every fused BatchNorm is an exact
add (weight 1, mean 0), unpaired modules are left untouched, and the fused
checkpoint loads strictly into the same model.
"""
import os

import numpy as np
import pytest
import torch
import torch.nn as nn

import tiny_cfg
from occformer_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
from occformer_tpu_torch.engine.fuse import fuse_conv_bn
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.models.resnet import ResNet
from occformer_tpu_torch.tools import fuse_conv_bn as fuse_tool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trained_statistics(model, seed):
    """Non-trivial BatchNorm statistics (a fresh model's mean 0 / var 1 fuse
    to almost nothing), as if an epoch had run."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.running_mean.normal_(0.0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
    return model


def test_resnet_fused_outputs_match():
    torch.manual_seed(0)
    model = _trained_statistics(ResNet(depth=18, out_indices=(0, 1, 2, 3)), 1).eval()
    x = torch.from_numpy(np.random.RandomState(0).rand(1, 3, 32, 32).astype(np.float32))
    with torch.no_grad():
        ref = model(x)
    fused, pairs, unpaired = fuse_conv_bn(model)
    # ResNet-18: stem + 8 blocks x 2 convs + 3 downsamples = 20 pairs
    assert len(pairs) == 20, pairs
    assert unpaired == []
    model.load_state_dict(fused, strict=True)
    with torch.no_grad():
        out = model(x)
    for a, b in zip(ref, out):
        np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=2e-5, atol=2e-5)
    for pair in pairs:
        bn = pair.split("<->")[1]
        assert torch.equal(fused[bn + ".weight"], torch.ones_like(fused[bn + ".weight"]))
        assert torch.equal(fused[bn + ".running_mean"],
                           torch.zeros_like(fused[bn + ".running_mean"]))


def test_unpaired_modules_untouched():
    model = nn.Module()
    model.convX = nn.Conv2d(4, 8, 3)
    model.lonely_bn = nn.BatchNorm2d(8)
    model.other = nn.Sequential(nn.Conv2d(4, 8, 1), nn.ReLU(), nn.BatchNorm2d(8))
    _trained_statistics(model, 2)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    fused, pairs, unpaired = fuse_conv_bn(model)
    assert pairs == []
    assert sorted(unpaired) == ["convX"]
    assert all(torch.equal(fused[k], sd[k]) for k in sd)
    assert all(torch.equal(model.state_dict()[k], sd[k]) for k in sd)  # input unchanged


def test_fuse_tool_on_a_train_checkpoint(tmp_path):
    """The tiny model (its DepthNet, view transformer and ResNet pairs) with
    trained statistics, saved as the train CLI saves it, fused by the tool:
    the fused checkpoint loads strictly and serves the same frame."""
    from occformer_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py"))
    model = _trained_statistics(build_model(cfg["model"], device="cpu", seed=0), 3).eval()
    save_checkpoint(str(tmp_path / "ckpts"), model, None, 4)
    batch = {k: torch.from_numpy(v) for k, v in tiny_cfg.make_batch(np.random.RandomState(0)).items()}
    with torch.no_grad():
        ref = model(batch)
    report = fuse_tool.fuse_checkpoint(cfg, str(tmp_path / "ckpts" / "step_4"),
                                       str(tmp_path / "fused" / "step_4"))
    assert report["fused_pairs"] >= 20
    fresh = build_model(cfg["model"], device="cpu", seed=1)
    assert load_checkpoint(str(tmp_path / "fused" / "step_4"), fresh) == 4
    with torch.no_grad():
        out = fresh(batch)
    for k in ("cls_preds", "mask_embeds", "depth_prob"):
        r = ref[k].numpy()
        np.testing.assert_allclose(out[k].numpy(), r, rtol=1e-4, atol=1e-4 * np.abs(r).max())
