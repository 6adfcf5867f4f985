"""The panoptic configuration's data pipeline in the port against the JAX
package's, on the CPU.

* On the JAX tests' fixture tree with a panoptic sidecar (random classes
  and instances over the 32 nuScenes classes, as
  ``tests/test_dataset_fixture.py::test_nuscenes_panoptic_pipeline_from_disk``
  writes it) and on ``data/fixtures.py:make_nuscenes_tree(...,
  panoptic=True)`` (the ray-cast boxes as instances), the panoptic config's
  train and test pipelines of both packages, each step's ``rng`` one
  ``RandomState`` (the port's step draws from it through ``step_rng``, as
  the semantic loader's does), give the same samples bit for bit, ``gt_occ``
  and ``panoptic_ids`` among them; ``collate_batch`` the same batch.
* The slot cap: with more than ``max_instances`` (100) segments in a
  frame, both packages keep the first 100 ids in ascending order, so the
  stuff classes (ids 11000-16000) are the ones the loss loses.
* ``make_nuscenes_tree``'s sidecars agree with its lidarseg labels.
"""
import os
import pickle

import numpy as np
import pytest

from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.data.loader import collate_batch as jax_collate
from occformer_tpu.data.nuscenes import CustomNuScenesOccLSSDataset as JaxNusc
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.data.fixtures import make_nuscenes_tree
from occformer_tpu_torch.data.loader import collate_batch
from occformer_tpu_torch.data.nuscenes import CustomNuScenesOccLSSDataset
from test_dataset_fixture import _make_nusc_tree
from test_torch_nuscenes_pipeline import _assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = "configs/occformer_nusc_panoptic_r50_256x704.py"
STEP = "LoadNuscPanopticOccupancyAnnotations"


def _sidecar(root, token, data):
    d = os.path.join(root, "panoptic", "v1.0-trainval")
    os.makedirs(d, exist_ok=True)
    np.savez_compressed(os.path.join(d, f"{token}_panoptic.npz"), data=data.astype(np.uint16))


def _tree(tmp_path, kind):
    root = str(tmp_path / kind)
    if kind == "rig":
        return root, make_nuscenes_tree(root, n_samples=2, n_points=3000, seed=1,
                                        image_size=(450, 800), panoptic=True)
    ann_file = _make_nusc_tree(root)
    n = np.fromfile(os.path.join(root, "lidarseg/v1.0-trainval/tok0_lidarseg.bin"),
                    np.uint8).size
    rng = np.random.RandomState(7)
    if kind == "fixture":  # as tests/test_dataset_fixture.py writes it
        data = rng.randint(0, 32, n) * 1000 + rng.randint(0, 5, n)
    else:  # "crowded": 150 car instances (class 17 -> 4) beside two stuff classes
        data = np.where(rng.rand(n) < 0.8, 17000 + rng.randint(1, 151, n),
                        rng.choice([24000, 30000], n))
    _sidecar(root, "tok0", data)
    return root, ann_file


def _datasets(root, ann_file, train):
    """The panoptic config's train (or val) dataset of both packages on the
    tree, each pipeline step's rng one RandomState(0)."""
    out = []
    for pkg, load, cls in (("occformer_tpu_torch", load_config, CustomNuScenesOccLSSDataset),
                           ("occformer_tpu", jax_load_config, JaxNusc)):
        cfg = load(os.path.join(REPO, pkg, CONFIG))
        dcfg = dict(cfg["data"]["train" if train else "val"])
        pipeline = [dict(p) for p in dcfg.pop("pipeline")]
        for p in pipeline:
            if p["type"] == STEP:
                p["data_root"] = root
        dcfg.update(data_root=root, ann_file=ann_file, pipeline=pipeline)
        dcfg.pop("type")
        ds = cls(**dcfg)
        for step in ds.pipeline:
            if hasattr(step, "rng"):
                step.rng = np.random.RandomState(0)
        out.append(ds)
    return out


@pytest.mark.parametrize("kind", ["fixture", "rig"])
@pytest.mark.parametrize("train", [True, False])
def test_panoptic_pipeline_samples_equal_jax(tmp_path, kind, train):
    root, ann_file = _tree(tmp_path, kind)
    mine, theirs = _datasets(root, ann_file, train)
    assert len(mine) == len(theirs) >= 1
    for i in range(len(mine)):
        got, ref = mine[i], theirs[i]
        _assert_same(got, ref, f"sample {i}")
        ids = got["panoptic_ids"]
        assert ids.shape == (100,) and (ids[ids >= 0] // 1000 <= 16).all()
        occ = got["gt_occ"]
        assert set(np.unique(occ)) - {0, 65535} == set(ids[ids >= 0].tolist())
    if train:
        batch = collate_batch([got], max_points=2000, rng=np.random.RandomState(3))
        _assert_same(batch, jax_collate([ref], max_points=2000, rng=np.random.RandomState(3)))
        assert batch["panoptic_ids"].dtype == np.int32 and batch["lidar_label"].max() > 1000


def test_rig_tree_sidecars_agree_with_the_lidarseg_labels(tmp_path):
    root, ann_file = _tree(tmp_path, "rig")
    with open(ann_file, "rb") as f:
        infos = pickle.load(f)["infos"]
    for info in infos:
        seg = np.fromfile(os.path.join(root, info["lidarseg"]), np.uint8)
        pan = np.load(os.path.join(root, info["lidarseg"].replace("lidarseg", "panoptic")
                                   .replace(".bin", ".npz")))["data"]
        assert pan.dtype == np.uint16 and pan.shape == seg.shape
        np.testing.assert_array_equal(pan // 1000, seg)
        things = np.isin(seg, (17, 23))  # car, truck: the boxes
        assert (pan[things] % 1000 > 0).all() and (pan[~things] % 1000 == 0).all()
        assert len(np.unique(pan[things])) >= 3
    mine, _ = _datasets(root, ann_file, train=False)
    ids = mine[0]["panoptic_ids"]
    real = ids[ids >= 0]
    assert any(i % 1000 for i in real) and any(i % 1000 == 0 for i in real)  # things, stuff


def test_slot_cap_drops_the_largest_ids_as_jax_does(tmp_path):
    """More than 100 segments: the first 100 ids in ascending order are kept,
    so the stuff classes (11000 driveable surface, 16000 vegetation) get no
    GT slot, in both packages."""
    root, ann_file = _tree(tmp_path, "crowded")
    mine, theirs = _datasets(root, ann_file, train=False)
    got, ref = mine[0], theirs[0]
    _assert_same(got, ref)
    present = np.unique(got["gt_occ"])
    present = present[(present > 0) & (present < 17000)]
    assert len(present) > 100 and {11000, 16000} <= set(present.tolist())
    np.testing.assert_array_equal(got["panoptic_ids"], present[:100])
    assert not {11000, 16000} & set(got["panoptic_ids"].tolist())
    assert (got["panoptic_ids"] // 1000 == 4).all()  # only car instances keep a slot


TINY_PAN = """
_base_ = [{base!r}]
class_names = {names!r}
num_class = 17
data_config = dict(cams={cams!r}, Ncams=2, input_size=(32, 64), src_size=(90, 160),
                   resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True, crop_h=(0.0, 0.0),
                   resize_test=0.0)
model = dict(img_view_transformer=dict(data_config=data_config),
             pts_bbox_head=dict(type="Mask2FormerNuscPanopticOccHead", num_occupancy_classes=17,
                                stuff_indices=[0, 11, 12, 13, 14, 15, 16],
                                thing_indices=list(range(1, 11)),
                                loss_cls=dict(class_weight=[1.0] * 17 + [0.1])))
_ann = dict(type="LoadNuscPanopticOccupancyAnnotations", data_root={root!r},
            grid_size=[32, 32, 16], point_cloud_range=[-8.0, -8.0, -2.0, 8.0, 8.0, 2.0],
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
optimizer_config = dict(grad_clip=dict(max_norm=0.01, norm_type=2))
"""


def test_panoptic_train_and_test_cli_run_through_the_pipeline(tmp_path, capsys):
    """A tiny model with the panoptic head (17 classes, 2 of the 6 cameras)
    trains 2 steps on a panoptic tree and is evaluated with the CLIs, on
    the CPU: finite losses and no ``point_mean_iou``, then PQ / SQ / RQ."""
    import json

    import torch

    from occformer_tpu.data.nuscenes import NUSC_CLASS_NAMES
    from occformer_tpu_torch.tools import test as test_cli
    from occformer_tpu_torch.tools import train as train_cli
    from occformer_tpu_torch.tools.time_backwards import NUSCENES_RIG

    root = str(tmp_path / "tree")
    ann = make_nuscenes_tree(root, n_samples=2, n_points=2000, seed=2, image_size=(90, 160),
                             panoptic=True)
    src = TINY_PAN.format(base=os.path.join(REPO, "occformer_tpu_torch", "configs",
                                            "synthetic_tiny.py"),
                          names=list(NUSC_CLASS_NAMES), cams=[r[0] for r in NUSCENES_RIG],
                          root=root, ann=ann)
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = tmp_path / "tiny_pan.py"
        cfg.write_text(src)
        assert train_cli.main([str(cfg), "--cpu", "--work-dir", str(tmp_path / "work"),
                               "--max-steps", "2"]) == 0
        out = capsys.readouterr().out
        steps = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"step"')]
        assert [s["step"] for s in steps] == [1, 2]
        assert all(np.isfinite(s["total_loss"]) and "point_mean_iou" not in s for s in steps)
        assert test_cli.main([str(cfg), "--cpu", "--checkpoint",
                              str(tmp_path / "work" / "ckpts" / "step_2")]) == 0
        out = capsys.readouterr().out
    finally:
        torch.set_num_threads(n)
    results = json.loads(out.strip().splitlines()[-1])
    for k in ("nuScenes_panoptic_PQ", "nuScenes_panoptic_SQ", "nuScenes_panoptic_RQ"):
        assert 0.0 <= results[k] <= 1.0, (k, results)
    assert "nuScenes_lidarseg_mean" in results
