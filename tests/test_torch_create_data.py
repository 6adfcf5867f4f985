"""The port's ``tools/create_data.py`` against the JAX repo's.

The geometry helpers on the case of ``tests/test_data.py:123`` (random
rotations and translations), then ``build_nuscenes_infos`` and ``main`` of
both on one stub devkit: ``nuscenes.nuscenes``, ``nuscenes.utils.splits``
and ``pyquaternion`` put into ``sys.modules``, two scenes (one train, one
val) of two samples each, six cameras, one sample without lidarseg.  The
two must give equal info dicts and equal pickles.
"""
import importlib.util
import os
import pickle
import sys
import types

import numpy as np
import pytest

from occformer_tpu_torch.tools import create_data

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("jax_create_data",
                                               os.path.join(REPO, "tools", "create_data.py"))
jax_create_data = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_create_data)


def _rand_rot(rng):
    a, b, c = rng.uniform(-np.pi, np.pi, 3)
    Rz = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    Ry = np.array([[np.cos(b), 0, np.sin(b)], [0, 1, 0], [-np.sin(b), 0, np.cos(b)]])
    Rx = np.array([[1, 0, 0], [0, np.cos(c), -np.sin(c)], [0, np.sin(c), np.cos(c)]])
    return Rz @ Ry @ Rx


def test_geometry_helpers_equal_jax():
    rng = np.random.default_rng(0)
    args = []
    for scale in (2, 100, 2, 100):
        args += [_rand_rot(rng), rng.uniform(-scale, scale, 3)]
    np.testing.assert_array_equal(create_data.rt_to_mat(args[0], args[1]),
                                  jax_create_data.rt_to_mat(args[0], args[1]))
    r, t = create_data.sensor2lidar(*args)
    jr, jt = jax_create_data.sensor2lidar(*args)
    np.testing.assert_array_equal(r, jr)
    np.testing.assert_array_equal(t, jt)
    # a rigid transform: the rotation is orthonormal
    np.testing.assert_allclose(r @ r.T, np.eye(3), atol=1e-12)


class _Quaternion:
    """pyquaternion's ``Quaternion(w, x, y, z).rotation_matrix``."""

    def __init__(self, q):
        self.q = np.asarray(q, float) / np.linalg.norm(q)

    @property
    def rotation_matrix(self):
        w, x, y, z = self.q
        return np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def _stub_db(rng):
    """Two scenes of two samples: tables of the devkit's records."""
    tables = {"sample_data": {}, "calibrated_sensor": {}, "ego_pose": {}, "lidarseg": {}}
    scenes = [{"token": "scene_a", "name": "scene-0001"},
              {"token": "scene_b", "name": "scene-0002"}]
    samples = []

    def pose(token):
        return {"token": token, "rotation": list(rng.normal(size=4)),
                "translation": list(rng.uniform(-50, 50, 3))}

    for s, scene in enumerate(scenes):
        for i in range(2):
            token = f"sample_{s}{i}"
            data = {}
            for sensor in ["LIDAR_TOP"] + jax_create_data.CAMS:
                sd = f"{token}_{sensor}"
                cs, ep = f"cs_{sd}", f"ep_{sd}"
                tables["calibrated_sensor"][cs] = dict(
                    pose(cs), camera_intrinsic=np.diag(rng.uniform(400, 1300, 3)).tolist())
                tables["ego_pose"][ep] = pose(ep)
                tables["sample_data"][sd] = {
                    "token": sd, "filename": f"samples/{sensor}/{sd}.bin",
                    "calibrated_sensor_token": cs, "ego_pose_token": ep,
                    "timestamp": 1_000_000 * s + 500_000 * i + len(data)}
                data[sensor] = sd
            if (s, i) != (1, 1):  # one sample without lidarseg
                tables["lidarseg"][data["LIDAR_TOP"]] = {
                    "filename": f"lidarseg/{data['LIDAR_TOP']}_lidarseg.bin"}
            samples.append({"token": token, "timestamp": 1_000_000 * s + 500_000 * i,
                            "scene_token": scene["token"], "data": data})
    return scenes, samples, tables


@pytest.fixture
def stub_devkit(monkeypatch):
    scenes, samples, tables = _stub_db(np.random.RandomState(0))

    class NuScenes:
        def __init__(self, version, dataroot, verbose=True):
            self.version, self.dataroot = version, dataroot
            self.scene, self.sample = scenes, samples

        def get(self, table, token):
            return tables[table][token]  # KeyError where the record is absent

    nusc_pkg = types.ModuleType("nuscenes")
    nusc_mod = types.ModuleType("nuscenes.nuscenes")
    nusc_mod.NuScenes = NuScenes
    utils = types.ModuleType("nuscenes.utils")
    splits = types.ModuleType("nuscenes.utils.splits")
    splits.train, splits.val = ["scene-0001"], ["scene-0002"]
    splits.test, splits.mini_train, splits.mini_val = [], ["scene-0001"], ["scene-0002"]
    utils.splits = splits
    nusc_pkg.nuscenes, nusc_pkg.utils = nusc_mod, utils
    pyq = types.ModuleType("pyquaternion")
    pyq.Quaternion = _Quaternion
    for name, mod in (("nuscenes", nusc_pkg), ("nuscenes.nuscenes", nusc_mod),
                      ("nuscenes.utils", utils), ("nuscenes.utils.splits", splits),
                      ("pyquaternion", pyq)):
        monkeypatch.setitem(sys.modules, name, mod)


def _assert_equal_infos(got, ref):
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if k == "cams":
                assert g[k].keys() == r[k].keys()
                for cam in g[k]:
                    assert g[k][cam].keys() == r[k][cam].keys()
                    for f, v in g[k][cam].items():
                        np.testing.assert_array_equal(v, r[k][cam][f], err_msg=f"{cam}.{f}")
            else:
                assert g[k] == r[k], k


@pytest.mark.parametrize("version", ["v1.0-trainval", "v1.0-mini"])
def test_build_nuscenes_infos_equals_jax(stub_devkit, version):
    train, val = create_data.build_nuscenes_infos("data/nuscenes", version)
    jtrain, jval = jax_create_data.build_nuscenes_infos("data/nuscenes", version)
    assert [i["token"] for i in train] == ["sample_00", "sample_01"]
    assert [i["token"] for i in val] == ["sample_10", "sample_11"]
    assert "lidarseg" not in val[1] and "lidarseg" in val[0]
    assert set(train[0]["cams"]) == set(create_data.CAMS)
    _assert_equal_infos(train, jtrain)
    _assert_equal_infos(val, jval)


def test_main_writes_the_jax_pickles(stub_devkit, tmp_path, monkeypatch):
    create_data.main(["nuscenes", "--root-path", "data/nuscenes", "--out-dir",
                      str(tmp_path / "port")])
    monkeypatch.setattr(sys, "argv", ["create_data.py", "nuscenes", "--root-path",
                                      "data/nuscenes", "--out-dir", str(tmp_path / "jax")])
    jax_create_data.main()
    for split in ("train", "val"):
        name = f"nuscenes_infos_temporal_{split}.pkl"
        with open(tmp_path / "port" / name, "rb") as f:
            got = pickle.load(f)
        with open(tmp_path / "jax" / name, "rb") as f:
            ref = pickle.load(f)
        assert got["metadata"] == ref["metadata"] == {"version": "v1.0-trainval"}
        _assert_equal_infos(got["infos"], ref["infos"])


def test_without_the_devkit_it_exits_as_jax_does(monkeypatch):
    monkeypatch.setitem(sys.modules, "nuscenes", None)
    with pytest.raises(SystemExit, match="nuscenes-devkit required") as got:
        create_data.build_nuscenes_infos("data/nuscenes", "v1.0-mini")
    with pytest.raises(SystemExit) as ref:
        jax_create_data.build_nuscenes_infos("data/nuscenes", "v1.0-mini")
    assert str(got.value) == str(ref.value)
