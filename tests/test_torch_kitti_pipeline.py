"""The port's SemanticKITTI data path, metrics, writers and CLIs against the
JAX package, on the CPU.

* The ``occformer_kitti`` config's train and test pipelines of both
  packages on the same on-disk trees (the JAX tests' fixture tree,
  ``tests/test_dataset_fixture.py:_make_kitti_tree``, and the port's
  ``data/fixtures.py:make_kitti_tree`` at full size), each step's ``rng``
  set to one ``RandomState`` as the JAX tests set it (the port's steps then
  draw from it instead of the sample's stream): the same samples key by key
  and bit for bit, and ``collate_batch`` the same batches.
* The corrupt-sample retry replaces a broken frame in train mode (from the
  failed sample's own stream, ``sample_rng``) and raises in test mode; the
  test-submit split has no labels (``gt_occ`` None, the identity BDA, no
  ``gt_occ`` in the batch).
* ``SSCMetrics`` against JAX's golden (``tests/test_configs_metrics.py:105``)
  and on random labels, exactly; the learning maps, the packed-bit readers
  and ``write_submission_label`` against JAX's, and a round trip; the label
  preprocessor against ``tools/kitti_preprocess.py``, bit for bit.
* The train and test CLIs in process on a tiny KITTI model over a tree:
  one step, then the SSC metrics and a ``.label`` per val frame.
"""
import importlib.util
import json
import os
import shutil

import numpy as np
import pytest
import torch

from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.data.loader import collate_batch as jax_collate
from occformer_tpu.data.semantic_kitti import CustomSemanticKITTILssDataset as JaxKitti
from occformer_tpu.utils import semkitti_io as jax_io
from occformer_tpu.utils.metrics import SSCMetrics as JaxSSC
from occformer_tpu_torch.config import load_config, parse_cfg_options
from occformer_tpu_torch.data.fixtures import kitti_cfg_options, make_kitti_tree
from occformer_tpu_torch.data.loader import build_dataloader, build_dataset, collate_batch
from occformer_tpu_torch.data.semantic_kitti import CustomSemanticKITTILssDataset
from occformer_tpu_torch.tools.kitti_preprocess import process_frame
from occformer_tpu_torch.utils import semkitti_io
from occformer_tpu_torch.utils.metrics import SSCMetrics
from test_dataset_fixture import _make_kitti_tree
from test_torch_nuscenes_pipeline import _assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KITTI = "configs/occformer_kitti.py"


@pytest.fixture(scope="module")
def port_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kitti"))
    make_kitti_tree(root, frames={"08": 2}, seed=1)
    return root


def _tree(tmp_path, port_tree, kind):
    if kind == "port":
        return port_tree, os.path.join(port_tree, "labels")
    root = str(tmp_path / "fixture")
    return root, _make_kitti_tree(root)


def _datasets(root, label_root, train, rng_seed=3):
    """The KITTI config's train (or test) dataset of both packages on the
    val split of the tree, each step's rng one RandomState(rng_seed)."""
    out = []
    for pkg, load, cls in (("occformer_tpu_torch", load_config, CustomSemanticKITTILssDataset),
                           ("occformer_tpu", jax_load_config, JaxKitti)):
        cfg = load(os.path.join(REPO, pkg, KITTI))
        dcfg = dict(cfg["data"]["train" if train else "val"])
        dcfg.update(data_root=root, ann_file=label_root, split="val")
        dcfg.pop("type")
        ds = cls(**dcfg)
        for step in ds.pipeline:
            if hasattr(step, "rng"):
                step.rng = np.random.RandomState(rng_seed)
        out.append(ds)
    return out


@pytest.mark.parametrize("kind", ["fixture", "port"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "test"])
def test_pipeline_samples_and_batches_equal_jax(tmp_path, port_tree, kind, train):
    root, label_root = _tree(tmp_path, port_tree, kind)
    mine, theirs = _datasets(root, label_root, train)
    assert len(mine) == len(theirs) >= 1
    for i in range(len(mine)):
        got, ref = mine[i], theirs[i]
        _assert_same(got, ref, f"sample {i}")
        assert got["intrins"].shape == (1, 3, 4) and got["bda"].shape == (4, 4)
        assert got["gt_occ"].shape == (256, 256, 32)
        assert ("gt_depth" in got) == train
    if train:
        assert int((got["gt_depth"] > 0).sum()) > 100
    _assert_same(collate_batch([got], rng=np.random.RandomState(7)),
                 jax_collate([ref], rng=np.random.RandomState(7)), "batch")


def test_port_tree_frames_hold_a_street(port_tree):
    """make_kitti_tree: the LiDAR projects into the image, the labels hold
    the street's classes, and the raw voxel files preprocess to the labels."""
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", KITTI),
                      parse_cfg_options(kitti_cfg_options(port_tree)))
    s = build_dataset(dict(cfg["data"]["train"], split="val"))[0]
    assert s["imgs"].shape == (1, 384, 1280, 3)
    assert int((s["gt_depth"] > 0).sum()) > 5000
    classes = set(np.unique(s["gt_occ"]).tolist())
    assert {0, 1, 9, 11, 13, 15, 17, 18, 255} <= classes
    seq = os.path.join(port_tree, "dataset", "sequences", "08")
    occ = semkitti_io.read_occupancy(os.path.join(seq, "voxels", "000000.bin"))
    labels = np.load(os.path.join(port_tree, "labels", "08", "000000_1_1.npy"))
    assert np.array_equal(occ, ((labels > 0) & (labels < 255)).astype(np.uint8))
    assert np.array_equal(semkitti_io.read_invalid_voxels(
        os.path.join(seq, "voxels", "000000.invalid")), (labels == 255).astype(np.uint8))
    assert np.array_equal(semkitti_io.read_label_voxels(
        os.path.join(seq, "voxels", "000000.label")), np.where(labels == 255, 0, labels))


def test_corrupt_sample_retry_and_test_mode(tmp_path, port_tree):
    root = str(tmp_path / "kitti")
    make_kitti_tree(root, frames={"08": 2}, seed=4)
    img = os.path.join(root, "dataset", "sequences", "08", "image_2", "000001.png")
    with open(img, "wb") as f:
        f.write(b"not a png")
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch", KITTI),
                      parse_cfg_options(kitti_cfg_options(root)))
    ds = build_dataset(dict(cfg["data"]["train"], split="val"))
    s = ds[1]  # replaced by the one readable frame
    assert s["frame_id"] == "000000"
    again = build_dataset(dict(cfg["data"]["train"], split="val"))[1]
    _assert_same(s, again, "retried sample")  # the retry's draw is the sample's own
    with pytest.raises(Exception):
        build_dataset(cfg["data"]["test"], test_mode=True)[1]


def test_a_missing_split_sequence_raises_as_jax_does(tmp_path):
    """make_kitti_tree writes every split's sequences, and a sequence of the
    split that the tree lacks fails both datasets rather than drop its
    frames from the split."""
    root = str(tmp_path / "kitti")
    label_root = make_kitti_tree(root, frames={})

    def train_split(load, cls, pkg):
        dcfg = dict(load(os.path.join(REPO, pkg, KITTI))["data"]["train"])
        dcfg.update(data_root=root, ann_file=label_root, split="train")
        dcfg.pop("type")
        return cls(**dcfg)

    packages = ((load_config, CustomSemanticKITTILssDataset, "occformer_tpu_torch"),
                (jax_load_config, JaxKitti, "occformer_tpu"))
    assert [len(train_split(*p)) for p in packages] == [0, 0]
    shutil.rmtree(os.path.join(root, "dataset", "sequences", "03"))
    for p in packages:
        with pytest.raises(FileNotFoundError):
            train_split(*p)


def test_test_submit_split_has_no_labels(tmp_path):
    root = str(tmp_path / "kitti")
    make_kitti_tree(root, frames={"11": 1}, seed=5)
    cfg = load_config(os.path.join(REPO, "occformer_tpu_torch",
                                   "configs/occformer_kitti_submit.py"),
                      parse_cfg_options(kitti_cfg_options(root)))
    ds = build_dataset(cfg["data"]["test"], test_mode=True)
    assert len(ds) == 1 and ds.data_infos[0]["voxel_path"] is None
    s = ds[0]
    assert s["gt_occ"] is None and np.array_equal(s["bda"], np.eye(4, dtype=np.float32))
    batch = next(iter(build_dataloader(ds, shuffle=False)))
    assert "gt_occ" not in batch and batch["_meta"] == [
        {"sample_idx": "11_000000", "sequence": "11", "frame_id": "000000"}]


# ---------------------------------------------------------------------------
# metrics, IO, the preprocessor
# ---------------------------------------------------------------------------

def test_ssc_metrics_golden_and_random_equal_jax():
    m = SSCMetrics(3)
    m.update(np.array([[0, 1, 2, 1], [0, 0, 2, 2]]), np.array([[0, 1, 1, 255], [0, 2, 2, 2]]))
    r = m.compute()
    assert abs(r["sc_iou"] - 4 / 5) < 1e-6 and abs(r["iou_per_class"][1] - 0.5) < 1e-6
    rng = np.random.RandomState(0)
    mine, theirs = SSCMetrics(20), JaxSSC(20)
    for _ in range(3):
        pred = rng.randint(0, 20, (16, 16, 8)).astype(np.uint8)
        tgt = rng.randint(0, 20, (16, 16, 8))
        tgt[rng.rand(*tgt.shape) < 0.2] = 255
        mine.update(pred, tgt)
        theirs.update(pred, tgt)
    _assert_same(mine.state(), theirs.state(), "state")
    a, b = mine.compute(), theirs.compute()
    for k in ("sc_iou", "ssc_miou", "precision", "recall"):
        assert a[k] == b[k], k
    merged = SSCMetrics(20)
    merged.set_state(mine.state())
    merged.merge(mine)
    assert (merged.tps == 2 * mine.tps).all() and merged.sc_fn == 2 * mine.sc_fn


def test_semkitti_io_equals_jax_and_round_trips(tmp_path, port_tree):
    assert np.array_equal(semkitti_io.learning_map_lut(), jax_io.learning_map_lut())
    assert np.array_equal(semkitti_io.learning_map_inv_lut(), jax_io.learning_map_inv_lut())
    raw = np.random.RandomState(1).randint(0, 256, 4096).astype(np.uint8)
    assert np.array_equal(semkitti_io.unpack_binary_voxels(raw),
                          jax_io.unpack_binary_voxels(raw))
    path = os.path.join(port_tree, "dataset", "sequences", "08", "voxels", "000001.bin")
    assert np.array_equal(semkitti_io.read_occupancy(path), jax_io.read_occupancy(path))
    pred = np.random.RandomState(2).randint(0, 20, (256, 256, 32)).astype(np.uint8)
    mine, theirs = str(tmp_path / "a" / "x.label"), str(tmp_path / "b" / "x.label")
    semkitti_io.write_submission_label(pred, mine)
    jax_io.write_submission_label(pred, theirs)
    with open(mine, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    assert np.array_equal(semkitti_io.read_label_voxels(mine), pred)


def test_label_preprocessor_equals_the_jax_tool(tmp_path):
    spec = importlib.util.spec_from_file_location(
        "jax_kitti_preprocess", os.path.join(REPO, "tools", "kitti_preprocess.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    rng = np.random.RandomState(3)
    dims = (16, 16, 8)
    vox = tmp_path / "voxels"
    vox.mkdir()
    inv = semkitti_io.learning_map_inv_lut()
    inv[rng.randint(0, 20, dims)].astype(np.uint16).tofile(vox / "000000.label")
    np.packbits(rng.rand(*dims) < 0.3).tofile(vox / "000000.invalid")
    for name, fn in (("mine", process_frame), ("theirs", tool.process_frame)):
        os.makedirs(tmp_path / name)
        fn(str(vox), "000000", str(tmp_path / name), semkitti_io.learning_map_lut(), dims=dims)
    for s in (1, 2, 4, 8):
        a = np.load(tmp_path / "mine" / f"000000_1_{s}.npy")
        b = np.load(tmp_path / "theirs" / f"000000_1_{s}.npy")
        assert a.dtype == b.dtype and np.array_equal(a, b), s


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

TINY_KITTI = """
_base_ = [{base!r}]
data_config = dict(input_size=(64, 192), resize=(-0.06, 0.11), rot=(-5.4, 5.4), flip=True,
                   crop_h=(0.0, 0.0), resize_test=0.0)
grid_config = dict(xbound=[0.0, 51.2, 3.2], ybound=[-25.6, 25.6, 3.2], zbound=[-2.0, 4.4, 0.8],
                   dbound=[2.0, 58.0, 7.0])
_gn = dict(type="GN", num_groups=8, requires_grad=True)
model = dict(
    img_backbone=dict(arch="b0"),
    img_neck=dict(in_channels=[24, 40, 112, 320, 1280], out_channels=[16] * 5),
    img_view_transformer=dict(numC_input=80, numC_Trans=32, grid_config=grid_config,
                              data_config=data_config),
    img_bev_encoder_backbone=dict(in_channels=32, block_numbers=[1, 1, 1, 1],
                                  block_inplanes=[32, 32, 64, 64], norm_cfg=_gn),
    img_bev_encoder_neck=dict(
        in_channels=[32, 32, 64, 64], feat_channels=48, out_channels=48, norm_cfg=_gn,
        encoder=dict(num_layers=1, transformerlayers=dict(
            attn_cfgs=dict(num_heads=4, num_points=2), feedforward_channels=96)),
        positional_encoding=dict(num_feats=16)),
    pts_bbox_head=dict(
        feat_channels=48, out_channels=48, num_queries=24, positional_encoding=dict(num_feats=16),
        transformer_decoder=dict(num_layers=2, transformerlayers=dict(
            attn_cfgs=dict(num_heads=4), feedforward_channels=96))),
    train_cfg=dict(pts=dict(num_points=128)),
)
_pcr = [0.0, -25.6, -2.0, 51.2, 25.6, 4.4]
_bda = dict(rot_lim=(0, 0), scale_lim=(0.95, 1.05), flip_dx_ratio=0.5, flip_dy_ratio=0.5,
            flip_dz_ratio=0.5)
_train = [dict(type="LoadMultiViewImageFromFiles_SemanticKitti", is_train=True,
               data_config=data_config),
          dict(type="CreateDepthFromLiDAR", dataset="kitti"),
          dict(type="LoadSemKittiAnnotation", is_train=True, point_cloud_range=_pcr,
               bda_aug_conf=_bda)]
_test = [dict(type="LoadMultiViewImageFromFiles_SemanticKitti", is_train=False,
              data_config=data_config),
         dict(type="LoadSemKittiAnnotation", is_train=False, point_cloud_range=_pcr,
              bda_aug_conf=_bda)]
data = dict(train=dict(pipeline=_train), val=dict(pipeline=_test), test=dict(pipeline=_test))
runner = dict(max_epochs=1)
log_config = dict(interval=1)
compute_dtype = "float32"
"""


def test_train_and_test_cli_run_on_a_kitti_tree(tmp_path, capsys):
    """A tiny KITTI model (EfficientNet-b0 at 64 x 192, a 16 x 16 x 8 grid)
    trains one step over a tree's train frame with the CLI on the CPU; the
    test CLI gives the SSC metrics over the val frame and writes its
    ``.label`` submission."""
    from occformer_tpu_torch.tools import test as test_cli
    from occformer_tpu_torch.tools import train as train_cli

    root = str(tmp_path / "tree")
    make_kitti_tree(root, frames={"00": 1, "08": 1}, seed=6)
    cfg = tmp_path / "tiny_kitti.py"
    cfg.write_text(TINY_KITTI.format(base=os.path.join(REPO, "occformer_tpu_torch", KITTI)))
    opts = ["--cfg-options", *kitti_cfg_options(root)]
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        assert train_cli.main([str(cfg), "--cpu", "--work-dir", str(tmp_path / "work"),
                               "--max-steps", "1", *opts]) == 0
        out = capsys.readouterr().out
        steps = [json.loads(ln) for ln in out.splitlines() if ln.startswith('{"step"')]
        assert [s["step"] for s in steps] == [1]
        assert np.isfinite(steps[0]["total_loss"]) and "d0.loss_mask" in steps[0]
        assert "not found; keeping the random init" in out  # the B7 file is not here
        save = tmp_path / "save"
        assert test_cli.main([str(cfg), "--cpu", "--checkpoint",
                              str(tmp_path / "work" / "ckpts" / "step_1"), "--test-save",
                              str(save), *opts]) == 0
        out = capsys.readouterr().out
    finally:
        torch.set_num_threads(n)
    results = json.loads(out.strip().splitlines()[-1])
    assert 0.0 <= results["semkitti_SC_IoU"] <= 1.0 and "semkitti_SSC_mIoU" in results
    labels = save / "sequences" / "08" / "predictions" / "000000.label"
    vox = semkitti_io.read_label_voxels(str(labels))
    assert vox.shape == (256, 256, 32) and int(vox.max()) < 20
