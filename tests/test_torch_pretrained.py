"""The port's pretrained init (``engine/pretrained.py``) against the key
manifests and the JAX package.

No ``.pth`` file exists here, so, as tests/test_pretrained_init.py does for
JAX, synthetic state dicts are built from the reconstructed init-checkpoint
manifests (tests/fixtures/key_manifests/init_*.json):

1. the torchvision R50 file fills every tensor of the flagship's backbone
   and leaves only the classifier's ``fc.*`` unused;
2. the FCOS3D R101-DCN ``load_from`` file fills every tensor of the
   config's caffe-style R101 backbone with DCNv2 stages, the offset convs
   included; only its FPN ``img_neck.*`` is skipped and unused;
3. a partial ``.pth`` with ``img_backbone.*`` plus extra keys loads through
   the train CLI without raising and reports the extras; a name-matching
   key of another shape keeps its init and is reported;
4. the JAX ``load_backbone_pretrained`` and the port's, given the same
   synthetic R50 state dict, give backbones whose outputs on one numpy
   input agree (float32, rtol/atol 1e-4 of the output scale: the same math
   through other conv libraries and summation orders).
"""
import json
import os

import numpy as np
import pytest
import torch

import jax

from occformer_tpu.engine.pretrained import load_backbone_pretrained as jax_load_backbone
from occformer_tpu.models.resnet import ResNet as JaxResNet
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.engine.pretrained import (
    init_from_pretrained,
    load_backbone_pretrained,
    partial_load_torch,
)
from occformer_tpu_torch.models.detector import build_model
from occformer_tpu_torch.models.resnet import ResNet
from occformer_tpu_torch.tools import train as train_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFESTS = os.path.join(REPO, "tests", "fixtures", "key_manifests")
FLAGSHIP = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")
TINY = os.path.join(REPO, "occformer_tpu_torch", "configs", "synthetic_tiny.py")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _manifest_sd(name, seed=0):
    """A synthetic state dict of the manifest's keys and shapes: conv and
    linear weights scaled by 1/sqrt(fan_in), BatchNorm scales near 1 and
    variances in [0.5, 2], so that a deep backbone stays finite."""
    with open(os.path.join(MANIFESTS, f"{name}.json")) as f:
        keys = json.load(f)["keys"]
    rng = np.random.RandomState(seed)
    sd = {}
    for k, shape in keys.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = np.zeros(shape, np.int64)
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, shape).astype(np.float32)
        elif len(shape) > 1:
            fan_in = int(np.prod(shape[1:]))
            sd[k] = (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)
        elif k.endswith("weight"):
            sd[k] = rng.uniform(0.5, 1.5, shape).astype(np.float32)
        else:
            sd[k] = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    return sd


class _Holder(torch.nn.Module):
    """A model holding just the named children."""

    def __init__(self, **children):
        super().__init__()
        for name, child in children.items():
            setattr(self, name, child)


# shapes only: a load into the meta device copies nothing and says so
META = pytest.mark.filterwarnings("ignore:.*meta parameter")


@META
def test_r50_torchvision_init_fills_the_flagship_backbone():
    model = build_model(load_config(FLAGSHIP)["model"], device="meta")
    sd = _manifest_sd("init_resnet50_torchvision")
    rep = load_backbone_pretrained(model, "resnet50-0676ba61.pth", state_dict=sd)
    assert rep["kept_init"] == []
    assert rep["unused_keys"] and all(k.startswith("fc.") for k in rep["unused_keys"])


@META
def test_r101_fcos3d_partial_load_fills_the_backbone_and_skips_the_fpn():
    with torch.device("meta"):
        model = _Holder(img_backbone=ResNet(depth=101, style="caffe", dcn_stages=(2, 3)),
                        img_neck=torch.nn.Conv2d(8, 8, 1))
    sd = _manifest_sd("init_r101_dcn_fcos3d")
    rep = partial_load_torch(model, "r101_dcn_fcos3d_pretrain.pth", state_dict=sd)
    assert rep["loaded_subtrees"] == ["img_backbone"]
    assert rep["skipped_subtrees"] == ["img_neck"]
    assert rep["kept_init"] == []
    # the FPN alone; the DCN stages' offset convs are filled
    assert rep["unused_keys"] and all(k.startswith("img_neck.") for k in rep["unused_keys"]), \
        rep["unused_keys"][:10]
    assert sum(".conv2.conv_offset." in k for k in model.img_backbone.state_dict()) == 52


def test_partial_pth_with_extras_loads_through_the_train_cli(tmp_path, capsys):
    cfg = load_config(TINY)
    src = build_model(cfg["model"], device="cpu", seed=3)
    sd = {f"img_backbone.{k}": v for k, v in src.img_backbone.state_dict().items()}
    sd["img_neck.fpn_convs.0.conv.weight"] = torch.zeros(4, 4, 3, 3)  # an FPN's key space
    sd["extra_head.weight"] = torch.ones(3)
    sd["img_backbone.fc.weight"] = torch.ones(10, 512)
    path = str(tmp_path / "partial.pth")
    torch.save({"state_dict": sd, "meta": {"epoch": 12}}, path)

    model = build_model(cfg["model"], device="cpu", seed=4)
    reports = init_from_pretrained(model, cfg["model"], load_from=path)
    assert len(reports) == 1
    rep = reports[0]
    assert rep["loaded_subtrees"] == ["img_backbone"]
    assert rep["skipped_subtrees"] == ["extra_head", "img_neck"]
    assert rep["kept_init"] == []
    assert sorted(rep["unused_keys"]) == ["extra_head.weight", "img_backbone.fc.weight",
                                          "img_neck.fpn_convs.0.conv.weight"]
    for k, v in src.img_backbone.state_dict().items():
        assert torch.equal(model.img_backbone.state_dict()[k], v), k

    assert train_cli.main([TINY, "--cpu", "--work-dir", str(tmp_path / "w"), "--max-steps", "1",
                           "--load-from", path, "--cfg-options", "data.train.num_samples=1"]) == 0
    out = capsys.readouterr().out
    assert f"pretrained init from {path} (partial_load)" in out
    assert "skipped ['extra_head', 'img_neck']" in out and "unused_keys=3" in out
    assert "training done at step 1" in out


def test_a_name_matching_key_of_another_shape_keeps_its_init():
    model = _Holder(img_backbone=torch.nn.Sequential(torch.nn.Linear(3, 4)))
    before = model.img_backbone[0].weight.detach().clone()
    sd = {"img_backbone.0.weight": torch.ones(5, 3), "img_backbone.0.bias": torch.ones(4)}
    rep = partial_load_torch(model, "part.pth", state_dict=sd)
    assert rep["loaded_subtrees"] == ["img_backbone"]
    assert rep["kept_init"] == ["img_backbone.0.weight: shape (5, 3) in the file, (4, 3) "
                                "in the model"]
    assert rep["unused_keys"] == ["img_backbone.0.weight"]
    assert torch.equal(model.img_backbone[0].weight, before)
    assert torch.equal(model.img_backbone[0].bias, torch.ones(4))


def test_missing_files_keep_the_random_init():
    model = build_model(load_config(TINY)["model"], device="meta")
    reports = init_from_pretrained(model, {"img_backbone": {"pretrained": "ckpts/nope.pth"}},
                                   load_from="ckpts/also_nope.pth")
    assert [(r["kind"], r["found"]) for r in reports] == [("backbone_init", False),
                                                           ("partial_load", False)]


def test_r50_init_matches_jax_load_backbone_pretrained():
    sd = _manifest_sd("init_resnet50_torchvision", seed=1)
    x = np.random.RandomState(2).randn(1, 64, 64, 3).astype(np.float32)

    jm = JaxResNet(depth=50)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables = {"params": {"backbone": init["params"]},
                 "batch_stats": {"backbone": init["batch_stats"]}}
    out, rep = jax_load_backbone(variables, {"type": "ResNet"}, "r50.pth", state_dict=sd)
    assert not rep["kept_init"]
    refs = jax.jit(jm.apply)({"params": out["params"]["backbone"],
                              "batch_stats": out["batch_stats"]["backbone"]}, x)

    model = _Holder(img_backbone=ResNet(depth=50))
    port_rep = load_backbone_pretrained(model, "r50.pth", state_dict=sd)
    assert port_rep["kept_init"] == []
    model.eval()
    with torch.no_grad():
        gots = model.img_backbone(torch.from_numpy(x).permute(0, 3, 1, 2).contiguous())
    assert len(gots) == len(refs) == 4
    for g, r in zip(gots, refs):
        r = np.asarray(r)
        scale = np.abs(r).max()
        np.testing.assert_allclose(np.moveaxis(g.numpy(), 1, -1), r, rtol=1e-4,
                                   atol=1e-4 * scale)
