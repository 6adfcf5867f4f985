"""The nuScenes pipeline's draws are addressed by sample (ROADMAP C.10), on the CPU.

Every random draw of a train sample (camera choice, image resize / crop /
flip / rotate, the BDA, the corrupt-sample retry's replacement) comes from
``data/nuscenes.py:sample_rng(seed, epoch, index)``.  So two builds of the
flagship's train dataset on one ``make_nuscenes_tree`` tree give the same
sample in every key the augmentation touches, whatever order the samples
are built in; another epoch or another seed draws anew; the retry picks the
same replacement every time; and a loader epoch resumed part-way repeats
the full epoch's batches bit for bit.
"""
import os
import pickle

import numpy as np
import pytest

from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.data.fixtures import make_nuscenes_tree
from occformer_tpu_torch.data.loader import ShardedLoader, build_dataset
from occformer_tpu_torch.data.nuscenes import sample_rng

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "occformer_tpu_torch", "configs", "occformer_nusc_r50_256x704.py")
# every key a train draw reaches (ROADMAP C.10)
DRAWN = ("imgs", "post_rots", "post_trans", "gt_depth", "gt_occ", "points_occ",
         "points_lidar", "bda")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nusc"))
    return root, make_nuscenes_tree(root, n_samples=3, n_points=3000, seed=1,
                                    image_size=(450, 800))


def _dataset(tree, **kw):
    """The flagship config's train dataset on the tree."""
    root, ann_file = tree
    cfg = load_config(CONFIG)
    dcfg = dict(cfg["data"]["train"], data_root=root, ann_file=ann_file, **kw)
    dcfg["pipeline"] = [dict(p, data_root=root) if p["type"] == "LoadNuscOccupancyAnnotations"
                        else dict(p) for p in dcfg["pipeline"]]
    return build_dataset(dcfg)


def _same(a, b, keys=DRAWN):
    return all(np.array_equal(a[k], b[k]) for k in keys)


def test_two_builds_give_the_same_sample_in_any_order(tree):
    first, second = _dataset(tree), _dataset(tree)
    a = first[0]
    second[2], second[1]  # other samples first: no shared stream to advance
    b = second[0]
    assert set(DRAWN) <= set(a) and "aug_rng" not in a
    for k in DRAWN:
        assert np.array_equal(a[k], b[k]), k
    assert a["cam_names"] == b["cam_names"]


def test_another_epoch_or_seed_draws_anew(tree):
    ds = _dataset(tree)
    a = ds[0]
    ds.set_epoch(1)
    b = ds[0]
    c = _dataset(tree, seed=5)[0]
    for other in (b, c):  # the image homography is drawn from a continuum
        assert not np.array_equal(a["post_rots"], other["post_rots"])
        assert not np.array_equal(a["post_trans"], other["post_trans"])
    bdas = set()
    for epoch in range(6):  # the BDA is three coin flips: it takes several values
        ds.set_epoch(epoch)
        bdas.add(ds[0]["bda"].tobytes())
    assert len(bdas) > 1
    ds.set_epoch(0)
    assert _same(ds[0], a)


def test_the_retry_choice_is_repeatable(tree, tmp_path):
    """A corrupt sample's replacement comes from its own stream: the same
    index, and the same sample, on every build."""
    root, ann_file = tree
    with open(ann_file, "rb") as f:
        infos = pickle.load(f)
    bad = infos["infos"][1]["cams"]["CAM_FRONT"]["data_path"].replace(
        "./data/nuscenes", str(tmp_path))
    # a copy of the tree's index whose sample 1 points at a truncated image
    os.makedirs(os.path.dirname(bad), exist_ok=True)
    with open(bad, "wb") as f:
        f.write(b"\xff\xd8\xff\xe0 not a jpeg")
    infos["infos"][1]["cams"]["CAM_FRONT"]["data_path"] = bad
    broken = str(tmp_path / "broken.pkl")
    with open(broken, "wb") as f:
        pickle.dump(infos, f)
    got = [_dataset((root, broken))[1] for _ in range(2)]
    retry = sample_rng(0, 0, 1, stream=1)
    pick = retry.randint(3)
    while pick == 1:
        pick = retry.randint(3)
    assert got[0]["sample_idx"] == got[1]["sample_idx"] == f"sample{pick:04d}"
    assert _same(got[0], got[1])
    assert _same(got[0], _dataset(tree)[pick])  # built as the sample itself


def test_a_resumed_loader_epoch_repeats_its_batches(tree):
    def batches(start):
        loader = ShardedLoader(_dataset(tree), batch_size=1, seed=0, max_points=4000)
        loader.set_epoch(1, start_batch=start)
        return list(loader)

    whole, resumed = batches(0), batches(2)
    assert len(whole) == 3 and len(resumed) == 1
    for k, v in whole[2].items():
        if k != "_meta":
            assert np.array_equal(v, resumed[0][k]), k
    assert whole[2]["_meta"] == resumed[0]["_meta"]
