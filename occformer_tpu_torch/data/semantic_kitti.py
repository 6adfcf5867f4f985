"""SemanticKITTI semantic scene completion dataset.

The port's copy of ``occformer_tpu/data/semantic_kitti.py`` (reference
datasets/semantic_kitti_lss_dataset.py:9-257): each sequence's calib.txt
(P2/P3/Tr), its frames found by ``voxels/*.bin`` (or ``image_2/*.png`` with
``load_continuous``), the preprocessed ``<label_root>/<seq>/<frame>_1_1.npy``
voxel labels (``tools/kitti_preprocess.py``), the train / val (08) /
test-submit (11-21) splits (a sequence of the split whose calib.txt the tree
lacks is left out: the JAX dataset raises), and the numpy pipeline of
``data/transforms.py`` and ``data/voxelize.py``, whose steps come from the
``PIPELINES`` registry.

Every random draw of a sample (the image and BDA augmentation, the
corrupt-sample retry's replacement) comes from
``data/nuscenes.py:sample_rng(seed, epoch, index)``, as for nuScenes (ROADMAP
C.10): a rerun, a resumed epoch, another loader thread or another host count
builds the same sample.  (The JAX package's KITTI steps each hold one
unseeded ``RandomState`` for their lifetime, and its retry draws from the
global ``np.random``; a step given its own ``rng`` still draws from it.)
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ..registry import DATASETS
from .nuscenes import sample_rng

SPLITS = {
    "train": ["00", "01", "02", "03", "04", "05", "06", "07", "09", "10"],
    "val": ["08"],
    "trainval": ["00", "01", "02", "03", "04", "05", "06", "07", "08", "09", "10"],
    "test": ["08"],
    "test-submit": ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"],
}


def read_calib(calib_path: str) -> Dict[str, np.ndarray]:
    """KITTI calib.txt -> P2, P3 and Tr (velodyne -> camera), each 4x4
    (reference :38-74)."""
    calib_all = {}
    with open(calib_path) as f:
        for line in f.readlines():
            if line == "\n":
                break
            key, value = line.split(":", 1)
            calib_all[key] = np.array([float(x) for x in value.split()])
    out = {}
    for k in ("P2", "P3", "Tr"):
        m = np.identity(4)
        m[:3, :4] = calib_all[k].reshape(3, 4)
        out[k] = m
    return out


@DATASETS.register_module()
class CustomSemanticKITTILssDataset:
    def __init__(
        self,
        data_root: str,
        pipeline: Sequence,
        split: str = "train",
        ann_file: Optional[str] = None,  # the preprocessed voxel-label root
        camera_used: Sequence[str] = ("left",),
        occ_size: Sequence[int] = (256, 256, 32),
        pc_range: Sequence[float] = (0, -25.6, -2, 51.2, 25.6, 4.4),
        load_continuous: bool = False,
        classes: Optional[Sequence[str]] = None,
        test_mode: bool = False,
        seed: int = 0,
        **kwargs,
    ):
        self.data_root = data_root
        self.label_root = ann_file or os.path.join(data_root, "labels")
        self.occ_size = np.asarray(occ_size)
        self.pc_range = np.asarray(pc_range)
        self.test_mode = test_mode
        self.seed = int(seed)
        self.epoch = 0
        camera_map = {"left": "2", "right": "3"}
        self.camera_used = [camera_map[c] for c in camera_used]
        self.sequences = SPLITS[split]
        self.load_continuous = load_continuous
        self.data_infos = self._load_annotations()
        self.pipeline = self._build_pipeline(pipeline)

    def _build_pipeline(self, pipeline_cfg):
        from . import transforms, voxelize  # noqa: F401  (register the steps)
        from ..registry import PIPELINES, build_from_cfg

        return [step if callable(step) else build_from_cfg(dict(step), PIPELINES)
                for step in pipeline_cfg]

    def _load_annotations(self):
        scans = []
        for seq in self.sequences:
            seq_dir = os.path.join(self.data_root, "dataset", "sequences", seq)
            calib = read_calib(os.path.join(seq_dir, "calib.txt"))
            id_glob = os.path.join(seq_dir, "image_2" if self.load_continuous else "voxels",
                                   "*.png" if self.load_continuous else "*.bin")
            for id_path in sorted(glob.glob(id_glob)):
                frame_id = os.path.basename(id_path).split(".")[0]
                voxel_path = os.path.join(self.label_root, seq, frame_id + "_1_1.npy")
                scans.append(dict(
                    sequence=seq,
                    frame_id=frame_id,
                    img_2_path=os.path.join(seq_dir, "image_2", frame_id + ".png"),
                    img_3_path=os.path.join(seq_dir, "image_3", frame_id + ".png"),
                    pts_path=os.path.join(seq_dir, "velodyne", frame_id + ".bin"),
                    P2=calib["P2"],
                    P3=calib["P3"],
                    T_velo_2_cam=calib["Tr"],
                    voxel_path=voxel_path if os.path.exists(voxel_path) else None,
                ))
        return scans

    def __len__(self):
        return len(self.data_infos)

    def set_epoch(self, epoch: int):
        """The epoch whose draws the samples take (``ShardedLoader.set_epoch``
        calls it)."""
        self.epoch = int(epoch)

    def get_data_info(self, index: int) -> Dict:
        info = self.data_infos[index]
        cam = self.camera_used[0]
        return dict(
            sample_idx=f"{info['sequence']}_{info['frame_id']}",
            sequence=info["sequence"],
            frame_id=info["frame_id"],
            img_filename=info[f"img_{cam}_path"],
            pts_filename=info["pts_path"],
            lidar2cam=info["T_velo_2_cam"],
            cam_intrinsic=info[f"P{cam}"][:3, :4],
            voxel_label_path=info["voxel_path"],
            occ_size=self.occ_size,
            pc_range=self.pc_range,
        )

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
        # train mode: a corrupt sample is replaced by a random other one
        # (reference _rand_another loop), drawn from the failed sample's own
        # stream
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
