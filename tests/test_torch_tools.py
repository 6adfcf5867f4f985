"""The port's jax-free tools (``occformer_tpu_torch/tools/``), each run in
process on a tree from ``data/fixtures.py``, a written log or written
predictions, and held to the JAX package's tool of the same name where that
tool imports no JAX (``tools/analyze_logs.py``, ``tools/visualize.py``,
``tools/prepare_video_infos.py``, ``tools/validate_submission.py``'s
checks): the same records, pictures, infos and verdicts.
"""
import json
import os
import pickle
import sys

import numpy as np
import pytest

from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.data.fixtures import make_nuscenes_tree, nuscenes_cfg_options
from occformer_tpu_torch.tools import (
    analyze_logs,
    debug_dataset,
    prepare_video_infos,
    print_config,
    validate_submission,
    visualize,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")


@pytest.fixture(scope="module")
def nusc_tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return root, make_nuscenes_tree(root, 2, n_points=2000)


def _run_jax_tool(name, argv, monkeypatch):
    import importlib

    mod = importlib.import_module(f"tools.{name}")
    monkeypatch.setattr(sys, "argv", [name] + list(argv))
    try:
        mod.main()
    except SystemExit as e:
        return e.code
    return 0


def test_print_config_resolves_overrides(capsys):
    print_config.main([FLAGSHIP, "--json", "--cfg-options", "model.pts_bbox_head.num_queries=7",
                       "optimizer.lr=0.5"])
    got = json.loads(capsys.readouterr().out)
    want = load_config(FLAGSHIP, {"model.pts_bbox_head.num_queries": 7, "optimizer.lr": 0.5})
    assert got["model"]["pts_bbox_head"]["num_queries"] == 7
    assert got["optimizer"]["lr"] == 0.5
    assert got == json.loads(json.dumps(want, default=repr))
    print_config.main([FLAGSHIP])
    assert "pts_bbox_head" in capsys.readouterr().out


def test_analyze_logs_reads_the_train_log(tmp_path, capsys, monkeypatch):
    log = tmp_path / "train.log"
    lines = ["loaded model weights from x", "{not json"]
    for step in range(1, 6):
        lines.append(json.dumps({"step": step, "epoch": 0, "sec/iter": 0.5,
                                 "total_loss": 10.0 / step, "loss_depth": 1.0 / step}))
    lines.append(json.dumps({"kernel_launches": {"K1": 3}}))
    log.write_text("\n".join(lines) + "\n")
    recs = analyze_logs.load_records(str(log))
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5]
    from tools.analyze_logs import load_records as jax_load_records

    assert recs == jax_load_records(str(log))
    out = tmp_path / "curves.png"
    analyze_logs.main([str(log), "--keys", "total_loss", "loss_depth", "--out", str(out)])
    text = capsys.readouterr().out
    assert out.exists() and "total_loss: first=10.0000 last=2.0000 min=2.0000" in text
    empty = tmp_path / "empty.log"
    empty.write_text("nothing\n")
    with pytest.raises(SystemExit):
        analyze_logs.main([str(empty)])


def test_visualize_renders_pictures_and_a_video(tmp_path):
    rng = np.random.RandomState(0)
    files = []
    for i in range(2):
        pred = rng.randint(0, 17, (32, 32, 16)).astype(np.uint8)
        gt = pred.copy()
        gt[:4] = 255
        path = tmp_path / f"s{i}.npz"
        np.savez(path, pred=pred, gt=gt)
        files.append(str(path))
    from tools.visualize import bev_class_map as jax_bev

    pred = np.load(files[0])["pred"]
    np.testing.assert_array_equal(visualize.bev_class_map(pred), jax_bev(pred))
    visualize.main([files[0], "--out", str(tmp_path / "one.png")])
    visualize.main(files + ["--video", "--out", str(tmp_path / "scene.gif")])
    assert (tmp_path / "one.png").stat().st_size > 0
    from PIL import Image

    with Image.open(tmp_path / "scene.gif") as im:
        assert im.n_frames == 2


def test_prepare_video_infos_on_a_nuscenes_tree(nusc_tree, tmp_path, monkeypatch):
    root, ann = nusc_tree
    with open(ann, "rb") as f:
        data = pickle.load(f)
    # two scenes, the infos out of order
    infos = data["infos"]
    for i, info in enumerate(infos):
        info["scene_token"] = f"scene{i % 2}"
    data["infos"] = infos[::-1]
    src = tmp_path / "infos.pkl"
    with open(src, "wb") as f:
        pickle.dump(data, f)
    prepare_video_infos.main([str(src), "--out", str(tmp_path / "port.pkl")])
    assert _run_jax_tool("prepare_video_infos",
                         [str(src), "--out", str(tmp_path / "jax.pkl")], monkeypatch) == 0
    with open(tmp_path / "port.pkl", "rb") as f:
        got = pickle.load(f)
    with open(tmp_path / "jax.pkl", "rb") as f:
        want = pickle.load(f)
    assert [(i["token"], i["scene_name"]) for i in got["infos"]] == \
        [(i["token"], i["scene_name"]) for i in want["infos"]]
    assert set(got) == set(want)
    ts = [i["timestamp"] for i in got["infos"] if i["scene_token"] == "scene0"]
    assert ts == sorted(ts)


def test_debug_dataset_on_a_nuscenes_tree(nusc_tree, tmp_path, capsys):
    root, ann = nusc_tree
    opts = nuscenes_cfg_options(load_config(FLAGSHIP), root, ann)
    debug_dataset.main([FLAGSHIP, "--split", "train", "--dump-dir", str(tmp_path / "viz"),
                        "--cfg-options", *opts])
    text = capsys.readouterr().out
    assert "CustomNuScenesOccLSSDataset, 2 samples" in text
    assert "imgs: (6, 256, 704, 3) float32" in text
    assert (tmp_path / "viz" / "cameras.png").exists()
    assert (tmp_path / "viz" / "gt_occ.png").exists()


def _kitti_submission(root, bad=False):
    rng = np.random.RandomState(0)
    raw = np.array(sorted(validate_submission.KITTI_VALID_RAW), np.uint16)
    for seq in validate_submission.KITTI_TEST_SEQS:
        d = os.path.join(root, "sequences", seq, "predictions")
        os.makedirs(d, exist_ok=True)
        labels = raw[rng.randint(0, len(raw), validate_submission.NUM_KITTI_VOXELS)]
        if bad and seq == "13":
            labels[5] = 7  # not a raw SemanticKITTI label
        labels.tofile(os.path.join(d, "000000.label"))


def _nusc_submission(root, bad=False):
    os.makedirs(os.path.join(root, "test"), exist_ok=True)
    with open(os.path.join(root, "test", "submission.json"), "w") as f:
        json.dump({"meta": {"use_camera": True}}, f)
    d = os.path.join(root, "lidarseg", "test")
    os.makedirs(d, exist_ok=True)
    labels = np.random.RandomState(0).randint(1, 17, 1000).astype(np.uint8)
    if bad:
        labels[3] = 0
    labels.tofile(os.path.join(d, "tok_lidarseg.bin"))


@pytest.mark.parametrize("dataset", ["kitti", "nusc"])
def test_validate_submission(dataset, tmp_path, monkeypatch, capsys):
    write = _kitti_submission if dataset == "kitti" else _nusc_submission
    good, bad = str(tmp_path / "good"), str(tmp_path / "bad")
    write(good)
    write(bad, bad=True)
    validate_submission.main([dataset, good, "--zip", str(tmp_path / "sub.zip")])
    assert "submission valid" in capsys.readouterr().out
    assert (tmp_path / "sub.zip").stat().st_size > 0
    with pytest.raises(SystemExit) as e:
        validate_submission.main([dataset, bad])
    assert e.value.code == 1
    for root, code in ((good, 0), (bad, 1)):
        assert _run_jax_tool("validate_submission", [dataset, root], monkeypatch) == code
