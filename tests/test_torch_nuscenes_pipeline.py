"""The port's nuScenes data pipeline held to the JAX package's, on the CPU.

On the same on-disk trees (the JAX tests' fixture tree, whose cameras look
straight up with identity extrinsics, and the port's
``data/fixtures.py:make_nuscenes_tree`` at a forward-looking rig, with
smaller images), the flagship config's train and test pipelines of both
packages, each step's ``rng`` set to one ``RandomState`` as
``tests/test_dataset_fixture.py`` sets it, must give the same samples key by
key and bit for bit, and ``collate_batch`` the same batches.  The
corrupt-sample retry replaces a broken sample in train mode as the JAX
dataset does and raises in test mode.  The native library equals its numpy
plain versions and the JAX package's library; a build whose compiler cannot
run raises.  Last, the train and test CLIs run a tiny model through the
pipeline on a tree.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.data import native as jax_native
from occformer_tpu.data.loader import collate_batch as jax_collate
from occformer_tpu.data.nuscenes import CustomNuScenesOccLSSDataset as JaxNusc
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.data import native
from occformer_tpu_torch.data.fixtures import make_nuscenes_tree, nuscenes_cfg_options
from occformer_tpu_torch.data.loader import build_dataset, collate_batch
from occformer_tpu_torch.data.nuscenes import CustomNuScenesOccLSSDataset, sample_rng
from occformer_tpu_torch.data.transforms import zbuffer_depth_plain
from occformer_tpu_torch.data.voxelize import majority_vote_plain, majority_vote_voxelize
from test_dataset_fixture import _make_nusc_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/occformer_nusc_r50_256x704.py"


def _assert_same(a, b, where=""):
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), (where, a.keys(), b.keys())
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), (where, type(b))
        assert a.dtype == b.dtype and a.shape == b.shape, (where, a.dtype, b.dtype)
        assert np.array_equal(a, b), where
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _tree(tmp_path, kind):
    root = str(tmp_path / kind)
    if kind == "fixture":
        return root, _make_nusc_tree(root)
    return root, make_nuscenes_tree(root, n_samples=2, n_points=3000, seed=1,
                                    image_size=(450, 800))


def _datasets(root, ann_file, train, rng_seed=0):
    """The flagship config's train (or val) dataset of both packages on the
    tree, each pipeline step's rng one RandomState(rng_seed)."""
    out = []
    for pkg, load, cls in (("occformer_tpu_torch", load_config, CustomNuScenesOccLSSDataset),
                           ("occformer_tpu", jax_load_config, JaxNusc)):
        cfg = load(os.path.join(REPO, pkg, CONFIG))
        dcfg = dict(cfg["data"]["train" if train else "val"])
        pipeline = [dict(p) for p in dcfg.pop("pipeline")]
        for p in pipeline:
            if p["type"] == "LoadNuscOccupancyAnnotations":
                p["data_root"] = root
        dcfg.update(data_root=root, ann_file=ann_file, pipeline=pipeline)
        dcfg.pop("type")
        ds = cls(**dcfg)
        for step in ds.pipeline:
            if hasattr(step, "rng"):
                step.rng = np.random.RandomState(rng_seed)
        out.append(ds)
    return out


@pytest.mark.parametrize("kind", ["fixture", "rig"])
@pytest.mark.parametrize("train", [True, False])
def test_pipeline_samples_equal_jax(tmp_path, kind, train):
    root, ann_file = _tree(tmp_path, kind)
    mine, theirs = _datasets(root, ann_file, train)
    assert len(mine) == len(theirs) >= 1
    for i in range(len(mine)):
        got, ref = mine[i], theirs[i]
        _assert_same(got, ref, f"sample {i}")
        assert ("gt_depth" in got) == train
    if train:
        assert (got["gt_depth"] > 0).any(axis=(1, 2)).sum() >= 1


def test_rig_tree_projects_into_every_camera(tmp_path):
    """The port's tree: depth in every camera and the LiDAR inside the grid."""
    root, ann_file = _tree(tmp_path, "rig")
    mine, _ = _datasets(root, ann_file, train=True)
    s = mine[0]
    assert s["imgs"].shape == (6, 256, 704, 3)
    assert ((s["gt_depth"] > 0).sum(axis=(1, 2)) > 20).all()
    pcr = np.asarray(s["pc_range"])
    xyz = s["points_occ"][:, :3]
    assert ((xyz >= pcr[:3]) & (xyz < pcr[3:])).all()
    assert set(np.unique(s["gt_occ"])) - {0, 255}  # classes beside empty and ignore


@pytest.mark.parametrize("max_points", [1000, 5000])
def test_collated_batch_equals_jax(tmp_path, max_points):
    root, ann_file = _tree(tmp_path, "fixture")
    mine, theirs = _datasets(root, ann_file, train=True)
    got = collate_batch([mine[0]], max_points=max_points, rng=np.random.RandomState(7))
    ref = jax_collate([theirs[0]], max_points=max_points, rng=np.random.RandomState(7))
    _assert_same(got, ref)
    assert got["lidar_xyz"].shape == (1, max_points, 3)


def test_corrupt_sample_retry_equals_jax(tmp_path, monkeypatch):
    """Train mode replaces a sample whose image is truncated by a random
    other one.  The port draws the replacements from the failed sample's
    stream (``sample_rng(seed, epoch, index, stream=1)``), the JAX dataset
    from the global ``np.random``; given the port's draws, the JAX dataset
    builds the same sample.  Test mode raises."""
    root, ann_file = _tree(tmp_path, "rig")
    with open(ann_file, "rb") as f:
        infos = pickle.load(f)["infos"]
    bad = infos[1]["cams"]["CAM_FRONT"]["data_path"].replace("./data/nuscenes", root)
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a jpeg")
    mine, theirs = _datasets(root, ann_file, train=True)
    got = mine[1]
    retry = sample_rng(mine.seed, mine.epoch, 1, stream=1)
    monkeypatch.setattr(np.random, "randint", lambda n: retry.randint(n))
    ref = theirs[1]
    assert got["sample_idx"] == "sample0000"
    _assert_same(got, ref)
    test_ds, _ = _datasets(root, ann_file, train=False)
    test_ds.test_mode = True
    with pytest.raises(OSError):
        test_ds[1]


def test_native_majority_vote_equals_numpy_and_jax():
    rng = np.random.RandomState(0)
    grid, pcr = (8, 8, 4), [-4, -4, -2, 4, 4, 2]
    pts = rng.uniform(-4.5, 4.5, (3000, 3)).astype(np.float32)  # some outside, clipped
    labels = rng.randint(0, 20, 3000)
    got = majority_vote_voxelize(pts, labels, grid, pcr, empty_id=17)
    ref = majority_vote_plain(pts, labels, grid, pcr, empty_id=17)
    assert got.dtype == ref.dtype == np.uint8 and np.array_equal(got, ref)
    flat = rng.randint(0, 256, 3000)
    lab = rng.randint(0, 6, 3000)
    mine = native.majority_vote_native(flat, lab, 256, 9)
    np.testing.assert_array_equal(mine, jax_native.majority_vote_native(flat, lab, 256, 9))
    # voxel 0: [0, 0, 5] -> 5 under suppression; voxel 1: [0] alone stays 0
    out = native.majority_vote_native(np.array([0, 0, 0, 1]), np.array([0, 0, 5, 0]), 4, 9,
                                      suppress_zero=True)
    np.testing.assert_array_equal(out, [5, 0, 9, 9])


def test_native_zbuffer_and_bits_equal_numpy_and_jax():
    rng = np.random.RandomState(1)
    h, w, n = 20, 30, 2000
    u = rng.randint(0, w, n).astype(np.int32)
    v = rng.randint(0, h, n).astype(np.int32)
    d = rng.uniform(0.5, 60, n).astype(np.float32)
    got = native.zbuffer_depth_native(u, v, d, np.ones(n, np.uint8), h, w)
    np.testing.assert_array_equal(got, zbuffer_depth_plain(u, v, d, h, w))
    np.testing.assert_array_equal(got, jax_native.zbuffer_depth_native(
        u, v, d, np.ones(n, np.uint8), h, w))
    data = rng.randint(0, 256, 64).astype(np.uint8)
    np.testing.assert_array_equal(native.unpack_bits_native(data), np.unpackbits(data))
    np.testing.assert_array_equal(native.unpack_bits_native(data),
                                  jax_native.unpack_bits_native(data))


def test_native_build_without_a_compiler_raises(tmp_path):
    with pytest.raises(RuntimeError, match="cannot be built"):
        native.build_native(cxx=str(tmp_path / "no-such-g++"), force=True)
    bad = tmp_path / "false-cxx"
    bad.write_text("#!/bin/sh\necho broken >&2\nexit 3\n")
    bad.chmod(0o755)
    with pytest.raises(RuntimeError, match="failed to build"):
        native.build_native(cxx=str(bad), force=True)
    assert os.path.exists(native.build_native())  # the good library is untouched


def test_flagship_config_builds_the_nuscenes_dataset(tmp_path):
    from occformer_tpu_torch.config import parse_cfg_options

    root, ann_file = _tree(tmp_path, "fixture")
    path = os.path.join(REPO, "occformer_tpu_torch", CONFIG)
    cfg = load_config(path, parse_cfg_options(
        nuscenes_cfg_options(load_config(path), root, ann_file)))
    train = build_dataset(cfg["data"]["train"])
    val = build_dataset(cfg["data"]["val"], test_mode=True)
    assert isinstance(train, CustomNuScenesOccLSSDataset) and not train.test_mode
    assert isinstance(val, CustomNuScenesOccLSSDataset) and val.test_mode
    assert [type(s).__name__ for s in train.pipeline] == [
        "LoadMultiViewImageFromFiles_OccFormer", "CreateDepthFromLiDAR",
        "LoadNuscOccupancyAnnotations"]
    assert train.pipeline[-1].data_root == root == val.pipeline[-1].data_root
    assert val[0]["gt_occ"].shape == (256, 256, 32)


TINY_NUSC = """
_base_ = [{base!r}]
class_names = {names!r}
num_class = 17
data_config = dict(cams={cams!r}, Ncams=2, input_size=(32, 64), src_size=(90, 160),
                   resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True, crop_h=(0.0, 0.0),
                   resize_test=0.0)
model = dict(img_view_transformer=dict(data_config=data_config),
             pts_bbox_head=dict(num_occupancy_classes=17,
                                loss_cls=dict(class_weight=[1.0] * 17 + [0.1])))
_ann = dict(type="LoadNuscOccupancyAnnotations", data_root={root!r}, grid_size=[32, 32, 16],
            point_cloud_range=[-8.0, -8.0, -2.0, 8.0, 8.0, 2.0],
            bda_aug_conf=dict(rot_lim=(0, 0), scale_lim=(0.95, 1.05), flip_dx_ratio=0.5,
                              flip_dy_ratio=0.5, flip_dz_ratio=0.5))
_train = [dict(type="LoadMultiViewImageFromFiles_OccFormer", is_train=True,
               data_config=data_config),
          dict(type="CreateDepthFromLiDAR", dataset="nusc"), dict(_ann, is_train=True)]
_test = [dict(type="LoadMultiViewImageFromFiles_OccFormer", is_train=False,
              data_config=data_config), dict(_ann, is_train=False)]
_nusc = dict(_delete_=True, type="CustomNuScenesOccLSSDataset", data_root={root!r},
             ann_file={ann!r}, classes=class_names, occ_size=[32, 32, 16],
             pc_range=[-8.0, -8.0, -2.0, 8.0, 8.0, 2.0])
data = dict(train=dict(_nusc, pipeline=_train), val=dict(_nusc, pipeline=_test),
            test=dict(_nusc, pipeline=_test))
"""


def test_train_and_test_cli_run_through_the_pipeline(tmp_path, capsys):
    """The tiny model (17 classes, 2 of the 6 cameras) trains 2 steps and
    is evaluated over the tree with the CLIs, on the CPU."""
    from occformer_tpu.data.nuscenes import NUSC_CLASS_NAMES
    from occformer_tpu_torch.tools import test as test_cli
    from occformer_tpu_torch.tools import train as train_cli
    from occformer_tpu_torch.tools.time_backwards import NUSCENES_RIG

    root = str(tmp_path / "tree")
    ann = make_nuscenes_tree(root, n_samples=2, n_points=2000, seed=2, image_size=(90, 160))
    cams = [r[0] for r in NUSCENES_RIG]
    src = TINY_NUSC.format(base=os.path.join(REPO, "occformer_tpu_torch", "configs",
                                             "synthetic_tiny.py"),
                           names=list(NUSC_CLASS_NAMES), cams=cams, root=root, ann=ann)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = tmp_path / "tiny_nusc.py"
        cfg.write_text(src)
        assert train_cli.main([str(cfg), "--cpu", "--work-dir", str(tmp_path / "work"),
                               "--max-steps", "2"]) == 0
        out = capsys.readouterr().out
        steps = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"step"')]
        assert [s["step"] for s in steps] == [1, 2]
        assert all(np.isfinite(s["total_loss"]) for s in steps)
        assert test_cli.main([str(cfg), "--cpu", "--checkpoint",
                              str(tmp_path / "work" / "ckpts" / "step_2")]) == 0
        out = capsys.readouterr().out
    finally:
        torch.set_num_threads(n)
    results = json.loads(out.strip().splitlines()[-1])
    assert "nuScenes_lidarseg_car" in results and 0 <= results["nuScenes_lidarseg_mean"] <= 1
    assert "| nuScenes_lidarseg_vegetation |" in out
