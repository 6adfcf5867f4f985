"""nuScenes occupancy / LiDAR-segmentation dataset.

The port's copy of ``occformer_tpu/data/nuscenes.py`` (reference
projects/mmdet3d_plugin/datasets/nuscenes_lss_dataset.py:8-200).  Reads the
standard ``nuscenes_infos_temporal_{train,val}.pkl`` info files (pickles
this program or the nuScenes tools wrote: unpickling runs code) and runs the
numpy pipeline of ``data/transforms.py`` and ``data/voxelize.py``, whose
steps come from the ``PIPELINES`` registry; evaluation consumes accumulated
confusion matrices (``utils/metrics.py``).

Every random draw of a sample (camera choice, image and BDA augmentation,
the corrupt-sample retry's replacement) comes from ``sample_rng(seed, epoch,
index)``: a rerun, a resumed epoch, another loader thread or another host
count builds the same sample.  (The JAX package's steps each hold one
unseeded ``RandomState`` for their lifetime, and its retry draws from the
global ``np.random``; a step given its own ``rng`` still draws from it.)
"""
from __future__ import annotations

import logging
import pickle
from typing import Dict, Optional, Sequence

import numpy as np

from ..registry import DATASETS
from ..utils.metrics import cm_to_ious

NUSC_CLASS_NAMES = [
    "empty", "barrier", "bicycle", "bus", "car", "construction_vehicle",
    "motorcycle", "pedestrian", "traffic_cone", "trailer", "truck",
    "driveable_surface", "other_flat", "sidewalk", "terrain", "manmade",
    "vegetation",
]


def sample_rng(seed: int, epoch: int, index: int, stream: int = 0) -> np.random.RandomState:
    """The ``RandomState`` of sample ``index``'s draws in ``epoch`` of a run
    seeded ``seed``: stream 0 the pipeline's augmentation, stream 1 the
    retry's choice of a replacement."""
    s = np.random.SeedSequence([seed, epoch, index, stream]).generate_state(1)[0]
    return np.random.RandomState(s)


@DATASETS.register_module()
class CustomNuScenesOccLSSDataset:
    def __init__(
        self,
        data_root: str,
        ann_file: str,
        pipeline: Sequence,
        occ_size: Sequence[int],
        pc_range: Sequence[float],
        classes: Optional[Sequence[str]] = None,
        test_mode: bool = False,
        seed: int = 0,
        **kwargs,
    ):
        self.data_root = data_root
        self.seed = int(seed)
        self.epoch = 0
        self.occ_size = np.asarray(occ_size)
        self.pc_range = np.asarray(pc_range)
        self.classes = list(classes or NUSC_CLASS_NAMES)
        self.test_mode = test_mode
        self.pipeline = self._build_pipeline(pipeline)
        with open(ann_file, "rb") as f:
            data = pickle.load(f)
        infos = data["infos"] if isinstance(data, dict) else data
        self.data_infos = sorted(infos, key=lambda e: e["timestamp"])

    def _build_pipeline(self, pipeline_cfg):
        from . import transforms, voxelize  # noqa: F401  (register the steps)
        from ..registry import PIPELINES, build_from_cfg

        steps = []
        for step in pipeline_cfg:
            if callable(step):
                steps.append(step)
            else:
                steps.append(build_from_cfg(dict(step), PIPELINES))
        return steps

    def __len__(self):
        return len(self.data_infos)

    def set_epoch(self, epoch: int):
        """The epoch whose draws the samples take (``ShardedLoader.set_epoch``
        calls it)."""
        self.epoch = int(epoch)

    def get_data_info(self, index: int) -> Dict:
        """Mirrors reference get_data_info (:49-119): path fixups and the
        lidar->camera extrinsics assembled from sensor2lidar r/t."""
        info = self.data_infos[index]
        input_dict = dict(
            sample_idx=info["token"],
            pts_filename=info["lidar_path"].replace("./data/nuscenes", self.data_root),
            timestamp=info["timestamp"],
            scene_token=info.get("scene_token"),
            occ_size=self.occ_size,
            pc_range=self.pc_range,
        )
        if "lidarseg" in info:
            input_dict["lidarseg"] = info["lidarseg"]
        lidar2cam_dic = {}
        for cam_type, cam_info in info["cams"].items():
            cam_info["data_path"] = cam_info["data_path"].replace(
                "./data/nuscenes", self.data_root
            )
            r = np.linalg.inv(cam_info["sensor2lidar_rotation"])
            t = cam_info["sensor2lidar_translation"] @ r.T
            rt = np.eye(4)
            rt[:3, :3] = r.T
            rt[3, :3] = -t
            lidar2cam_dic[cam_type] = rt.T
        input_dict["curr"] = info
        input_dict["lidar2cam_dic"] = lidar2cam_dic
        return input_dict

    def _run_pipeline(self, index: int) -> Dict:
        results = self.get_data_info(index)
        results["aug_rng"] = sample_rng(self.seed, self.epoch, index)
        for step in self.pipeline:
            results = step(results)
        del results["aug_rng"]
        return results

    def __getitem__(self, index: int) -> Dict:
        if self.test_mode:
            return self._run_pipeline(index)
        # train mode: a corrupt/unreadable sample is replaced by a random
        # other one (reference _rand_another retry loop,
        # nuscenes_lss_dataset.py:23-29) instead of killing the epoch; the
        # replacements are drawn from the failed sample's own stream
        retry = sample_rng(self.seed, self.epoch, index, stream=1)
        for _ in range(50):
            try:
                results = self._run_pipeline(index)
            except Exception as e:  # noqa: BLE001 — any IO/decode failure
                logging.getLogger(__name__).warning(
                    "sample %d failed (%s); retrying a random other", index, e)
                results = None
            if results is not None:
                return results
            index = int(retry.randint(len(self)))
        raise RuntimeError("50 consecutive corrupt samples — dataset broken?")

    def evaluate_lidarseg(self, confusion_matrix: np.ndarray) -> Dict:
        """Confusion matrix (16 fg classes) -> per-class IoU + mean
        (reference :121-200 evaluate dispatch)."""
        ious = cm_to_ious(confusion_matrix)
        out = {
            f"nuScenes_lidarseg_{self.classes[i + 1]}": float(ious[i])
            for i in range(len(ious))
        }
        out["nuScenes_lidarseg_mean"] = float(np.nanmean(ious))
        return out
