"""The R101-DCN configs' nuScenes pipelines in the port against the JAX package, on the CPU.

At 896 x 1600 (the 900-row camera images resized by 1 and cropped to 896
rows), with the caffe backbone's BGR mean-only normalization
(``to_rgb=False``, std 1), the train and test pipelines of
``configs/occformer_nusc_r101_896x1600.py`` and the test pipeline of its
``_trainval`` variant (``is_test_submit=True``: placeholder labels, no
``gt_occ``) must give the JAX package's samples key by key and bit for bit,
each step's ``rng`` one ``RandomState``, on the JAX tests' fixture tree
(``tests/test_dataset_fixture.py:_make_nusc_tree``) and on the port's
``data/fixtures.py:make_nuscenes_tree`` (900 x 1600 JPEGs, a forward-looking
rig).
"""
import os

import numpy as np
import pytest

from occformer_tpu.config import load_config as jax_load_config
from occformer_tpu.data.nuscenes import CustomNuScenesOccLSSDataset as JaxNusc
from occformer_tpu_torch.config import load_config
from occformer_tpu_torch.data.fixtures import make_nuscenes_tree
from occformer_tpu_torch.data.nuscenes import CustomNuScenesOccLSSDataset
from test_dataset_fixture import _make_nusc_tree
from test_torch_nuscenes_pipeline import _assert_same

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R101 = "configs/occformer_nusc_r101_896x1600.py"
TRAINVAL = "configs/occformer_nusc_r101_896x1600_trainval.py"


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    root = tmp_path_factory.mktemp("r101_trees")
    fixture = str(root / "fixture")
    rig = str(root / "rig")
    return {"fixture": (fixture, _make_nusc_tree(fixture)),
            "rig": (rig, make_nuscenes_tree(rig, n_samples=1, n_points=3000, seed=2))}


def _datasets(config, split, root, ann_file):
    """The config's dataset of both packages on the tree, each pipeline
    step's rng one RandomState(0)."""
    out = []
    for pkg, load, cls in (("occformer_tpu_torch", load_config, CustomNuScenesOccLSSDataset),
                           ("occformer_tpu", jax_load_config, JaxNusc)):
        dcfg = dict(load(os.path.join(REPO, pkg, config))["data"][split])
        pipeline = [dict(p) for p in dcfg.pop("pipeline")]
        for p in pipeline:
            if p["type"] == "LoadNuscOccupancyAnnotations":
                p["data_root"] = root
        dcfg.update(data_root=root, ann_file=ann_file, pipeline=pipeline)
        dcfg.pop("type")
        ds = cls(**dcfg)
        for step in ds.pipeline:
            if hasattr(step, "rng"):
                step.rng = np.random.RandomState(0)
        out.append(ds)
    return out


@pytest.mark.parametrize("config,split", [(R101, "train"), (R101, "test"),
                                          (TRAINVAL, "test")])
@pytest.mark.parametrize("kind", ["fixture", "rig"])
def test_r101_samples_equal_jax(trees, kind, config, split):
    root, ann_file = trees[kind]
    mine, theirs = _datasets(config, split, root, ann_file)
    got, ref = mine[0], theirs[0]
    _assert_same(got, ref, "sample 0")
    assert got["imgs"].shape == (6, 896, 1600, 3) and got["imgs"].dtype == np.float32
    assert ("gt_depth" in got) == (split == "train")
    assert ("gt_occ" in got) == (config == R101)
    if config == TRAINVAL:  # the test server's placeholder labels
        assert not got["points_occ"][:, 3].any()
        np.testing.assert_array_equal(got["bda"], np.eye(3, dtype=np.float32))
