"""Generate the nuScenes info pkls (the port of ``tools/create_data.py``).

    python3 -m occformer_tpu_torch.tools.create_data nuscenes
        --root-path data/nuscenes --out-dir data --version v1.0-trainval

Replaces the reference's ``tools/create_data.py nuscenes`` (mmdet3d
nuscenes_converter): walks the nuScenes database with the official devkit
and writes ``nuscenes_infos_temporal_{train,val,test}.pkl``
(``{"infos": [...], "metadata": {"version": ...}}``) with exactly the
fields ``data/nuscenes.py`` and ``data/transforms.py`` read: per sample
``token, timestamp, scene_token, lidar_path, lidarseg`` and per camera
``data_path, cam_intrinsic, sensor2lidar_rotation,
sensor2lidar_translation``.

The nuscenes-devkit (``nuscenes``, ``pyquaternion``) is imported when
``build_nuscenes_infos`` runs; without it the tool exits with the JAX
tool's message.  The geometry helpers need no devkit.  Nothing is
downloaded.
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

CAMS = ["CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
        "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT"]


def rt_to_mat(rotation: np.ndarray, translation: np.ndarray) -> np.ndarray:
    """3x3 rotation + 3 translation -> homogeneous 4x4."""
    m = np.eye(4)
    m[:3, :3] = rotation
    m[:3, 3] = translation
    return m


def sensor2lidar(cam_rot, cam_tran, cam_ego_rot, cam_ego_tran,
                 lidar_rot, lidar_tran, lidar_ego_rot, lidar_ego_tran):
    """cam->lidar rigid transform as (rotation 3x3, translation 3).

    cam2lidar = inv(lidar2global) @ cam2global with X2global =
    ego2global_at_X @ sensor2ego_X; each pose is (3x3 R, 3 t).  Equivalent to
    mmdet3d's ``obtain_sensor2top`` chain, written as plain 4x4 composition.
    """
    cam2global = rt_to_mat(cam_ego_rot, cam_ego_tran) @ rt_to_mat(cam_rot, cam_tran)
    lidar2global = rt_to_mat(lidar_ego_rot, lidar_ego_tran) @ rt_to_mat(lidar_rot, lidar_tran)
    m = np.linalg.inv(lidar2global) @ cam2global
    return m[:3, :3], m[:3, 3]


def build_nuscenes_infos(root_path: str, version: str):
    """(train infos, val infos) of the nuScenes ``version`` under
    ``root_path``, split by the devkit's scene lists."""
    try:
        from nuscenes.nuscenes import NuScenes
        from nuscenes.utils import splits
        from pyquaternion import Quaternion
    except ImportError as e:
        raise SystemExit(
            "nuscenes-devkit required: pip install nuscenes-devkit "
            f"(import failed: {e})")

    nusc = NuScenes(version=version, dataroot=root_path, verbose=True)
    if version == "v1.0-trainval":
        train_scenes, val_scenes = splits.train, splits.val
    elif version == "v1.0-test":
        train_scenes, val_scenes = splits.test, []
    elif version == "v1.0-mini":
        train_scenes, val_scenes = splits.mini_train, splits.mini_val
    else:
        raise SystemExit(f"unknown version {version}")

    scene_name = {s["token"]: s["name"] for s in nusc.scene}
    train_infos, val_infos = [], []
    for sample in nusc.sample:
        lidar_sd = nusc.get("sample_data", sample["data"]["LIDAR_TOP"])
        lidar_cs = nusc.get("calibrated_sensor", lidar_sd["calibrated_sensor_token"])
        lidar_ep = nusc.get("ego_pose", lidar_sd["ego_pose_token"])
        l_rot = Quaternion(lidar_cs["rotation"]).rotation_matrix
        l_tran = np.asarray(lidar_cs["translation"])
        le_rot = Quaternion(lidar_ep["rotation"]).rotation_matrix
        le_tran = np.asarray(lidar_ep["translation"])

        info = dict(
            token=sample["token"],
            timestamp=sample["timestamp"],
            scene_token=sample["scene_token"],
            lidar_path=os.path.join(root_path, lidar_sd["filename"]),
            cams={},
        )
        try:  # absent on v1.0-test / without the lidarseg expansion
            info["lidarseg"] = nusc.get("lidarseg",
                                        sample["data"]["LIDAR_TOP"])["filename"]
        except KeyError:
            pass

        for cam in CAMS:
            cam_sd = nusc.get("sample_data", sample["data"][cam])
            cam_cs = nusc.get("calibrated_sensor", cam_sd["calibrated_sensor_token"])
            cam_ep = nusc.get("ego_pose", cam_sd["ego_pose_token"])
            r, t = sensor2lidar(
                Quaternion(cam_cs["rotation"]).rotation_matrix,
                np.asarray(cam_cs["translation"]),
                Quaternion(cam_ep["rotation"]).rotation_matrix,
                np.asarray(cam_ep["translation"]),
                l_rot, l_tran, le_rot, le_tran,
            )
            info["cams"][cam] = dict(
                data_path=os.path.join(root_path, cam_sd["filename"]),
                type=cam,
                sample_data_token=sample["data"][cam],
                cam_intrinsic=np.asarray(cam_cs["camera_intrinsic"]),
                sensor2lidar_rotation=r,
                sensor2lidar_translation=t,
                timestamp=cam_sd["timestamp"],
            )
        name = scene_name[sample["scene_token"]]
        (train_infos if name in train_scenes else val_infos).append(info)
    return train_infos, val_infos


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("dataset", choices=["nuscenes"])
    p.add_argument("--root-path", default="data/nuscenes")
    p.add_argument("--out-dir", default="data")
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args(argv)

    train_infos, val_infos = build_nuscenes_infos(args.root_path, args.version)
    os.makedirs(args.out_dir, exist_ok=True)
    meta = dict(version=args.version)
    if args.version == "v1.0-test":
        out = os.path.join(args.out_dir, "nuscenes_infos_temporal_test.pkl")
        with open(out, "wb") as f:
            pickle.dump(dict(infos=train_infos, metadata=meta), f)
        print(f"{len(train_infos)} test infos -> {out}")
        return
    for split, infos in (("train", train_infos), ("val", val_infos)):
        out = os.path.join(args.out_dir, f"nuscenes_infos_temporal_{split}.pkl")
        with open(out, "wb") as f:
            pickle.dump(dict(infos=infos, metadata=meta), f)
        print(f"{len(infos)} {split} infos -> {out}")


if __name__ == "__main__":
    main()
