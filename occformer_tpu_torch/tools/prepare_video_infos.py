"""Reorganize nuScenes info pkls for scene-ordered video demos (reference
projects/mmdet3d_plugin/tools/prepare_video_infos.py; port of
``tools/prepare_video_infos.py``).

Groups the infos by scene, sorts each scene by timestamp and annotates
``scene_name`` so that ``tools/visualize.py --video`` can emit one
animation a scene.  The nuscenes-devkit is optional: when it imports, the
scene names are the devkit's; else ``scene-0000``, ... in scene-token
order.

Usage:
  python3 -m occformer_tpu_torch.tools.prepare_video_infos infos_val.pkl
      --out infos_video_val.pkl [--data-root data/nuscenes]
"""
from __future__ import annotations

import argparse
import pickle
from collections import defaultdict


def scene_sorted_infos(infos: list, nusc=None) -> list:
    """The infos grouped by scene (scene-token order), each scene sorted by
    timestamp, each info given its ``scene_name``."""
    by_scene = defaultdict(list)
    for info in infos:
        by_scene[info.get("scene_token", "unknown")].append(info)
    out = []
    for si, (token, scene_infos) in enumerate(sorted(by_scene.items())):
        name = nusc.get("scene", token)["name"] if nusc is not None else f"scene-{si:04d}"
        for info in sorted(scene_infos, key=lambda e: e["timestamp"]):
            out.append(dict(info, scene_name=name))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("infos_pkl")
    p.add_argument("--out", required=True)
    p.add_argument("--data-root", default="data/nuscenes")
    p.add_argument("--version", default="v1.0-trainval")
    args = p.parse_args(argv)
    with open(args.infos_pkl, "rb") as f:
        data = pickle.load(f)
    infos = data["infos"] if isinstance(data, dict) else data
    try:
        from nuscenes.nuscenes import NuScenes  # optional

        nusc = NuScenes(version=args.version, dataroot=args.data_root, verbose=False)
    except Exception:
        nusc = None
        print("nuscenes-devkit unavailable: writing scene-sorted infos without its "
              "scene names")
    out_infos = scene_sorted_infos(infos, nusc)
    payload = {"infos": out_infos}
    if isinstance(data, dict):
        payload.update({k: v for k, v in data.items() if k != "infos"})
    with open(args.out, "wb") as f:
        pickle.dump(payload, f)
    n_scenes = len({i["scene_name"] for i in out_infos})
    print(f"wrote {len(out_infos)} infos over {n_scenes} scenes to {args.out}")


if __name__ == "__main__":
    main()
