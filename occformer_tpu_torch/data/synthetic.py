"""Synthetic nuScenes-style batches at a config's exact shapes.

The port's copy of the batch logic of ``tools/tpu_train_trial.py:74-104``
(nuScenes branch): 6 camera images with native-scale intrinsics (fx = 1266
on the 1600-wide sensor) and the aug homography that resizes them to the
network input (post scale W / 1600), identity rotations and BDA, random
translations, and ``max_lidar_points`` LiDAR returns in [0, 1] of the
point-cloud range with random labels (``make_serving_batch``); for training
also the occupancy labels at ``occ_size`` and a sparse depth map
(``make_train_batch``, drawn in the tool's order).  Everything comes from
``numpy.random.RandomState(seed)``.

``SyntheticOccDataset`` is the port's copy of
``occformer_tpu/data/synthetic.py:SyntheticOccDataset``: random samples with
a dataset's full structure, so that the train and test CLIs run without
nuScenes or SemanticKITTI on disk; sample ``i`` comes from
``RandomState(seed + i)`` and equals the JAX package's array for array.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

from ..registry import DATASETS


def _cameras(cfg: Dict, rng: np.random.RandomState, depth=None) -> Dict[str, np.ndarray]:
    """Images and camera geometry of one frame (batch 1)."""
    data_config = cfg["data_config"]
    B = 1
    N = data_config.get("Ncams", 1)
    H, W = data_config["input_size"]
    fx, post_scale = 1266.0, W / 1600.0
    cx, cy = W / 2 / post_scale, H / 2 / post_scale
    intrins = np.zeros((B, N, 3, 3), np.float32)
    intrins[..., 0, 0] = fx
    intrins[..., 1, 1] = fx
    intrins[..., 0, 2] = cx
    intrins[..., 1, 2] = cy
    intrins[..., 2, 2] = 1.0
    post_rots = np.tile(np.eye(3, dtype=np.float32) * post_scale, (B, N, 1, 1))
    post_rots[..., 2, 2] = 1.0
    out = {}
    if depth is not None:  # the train batch draws its depth map first
        d_lo, d_hi = depth
        g = rng.uniform(0, d_hi, (B, N, H, W)).astype(np.float32)
        g[g < (d_lo + 0.7 * (d_hi - d_lo))] = 0.0  # sparse, LiDAR-like
        out["gt_depth"] = g
    out.update({
        "imgs": rng.randn(B, N, H, W, 3).astype(np.float32),
        "rots": np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1)),
        "trans": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        "intrins": intrins,
        "post_rots": post_rots,
        "post_trans": np.zeros((B, N, 3), np.float32),
        "bda": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
    })
    return out


def make_serving_batch(cfg: Dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """One frame (batch 1), as a frame-by-frame server receives it."""
    num_classes = cfg["model"]["pts_bbox_head"].get("num_occupancy_classes", 20)
    P = int(cfg["max_lidar_points"])
    rng = np.random.RandomState(seed)
    batch = _cameras(cfg, rng)
    batch.update(
        lidar_xyz=rng.uniform(0, 1, (1, P, 3)).astype(np.float32),
        lidar_valid=np.ones((1, P), bool),
        lidar_label=rng.randint(1, num_classes, (1, P)).astype(np.int32),
    )
    return batch


def make_train_batch(cfg: Dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """One training sample (batch 1): the frame plus ``gt_depth`` [1, N, H, W]
    (uniform in [0, d_max), zero below 70% of the depth range), ``gt_occ``
    [1, *occ_size] int32 uniform over the classes, ``max_lidar_points``
    valid LiDAR points and their labels."""
    m = cfg["model"]
    num_classes = m["pts_bbox_head"].get("num_occupancy_classes", 20)
    d_lo, d_hi = m["img_view_transformer"]["grid_config"]["dbound"][:2]
    X, Y, Z = cfg["occ_size"]
    P = int(cfg["max_lidar_points"])
    rng = np.random.RandomState(seed)
    batch = _cameras(cfg, rng, depth=(d_lo, d_hi))
    batch.update(
        gt_occ=rng.randint(0, num_classes, (1, X, Y, Z)).astype(np.int32),
        lidar_xyz=rng.uniform(0, 1, (1, P, 3)).astype(np.float32),
        lidar_valid=np.ones((1, P), bool),
        lidar_label=rng.randint(1, num_classes, (1, P)).astype(np.int32),
    )
    return batch


@DATASETS.register_module()
class SyntheticOccDataset:
    def __init__(
        self,
        num_samples: int = 8,
        num_cams: int = 2,
        input_size: Sequence[int] = (64, 128),
        occ_size: Sequence[int] = (32, 32, 16),
        num_classes: int = 5,
        num_lidar_points: int = 512,
        pc_range: Sequence[float] = (-8.0, -8.0, -2.0, 8.0, 8.0, 2.0),
        seed: int = 0,
        pipeline: Optional[Sequence] = None,  # accepted, unused
        **kwargs,
    ):
        self.num_samples = num_samples
        self.num_cams = num_cams
        self.input_size = tuple(input_size)
        self.occ_size = tuple(occ_size)
        self.num_classes = num_classes
        self.num_lidar_points = num_lidar_points
        self.pc_range = np.asarray(pc_range, np.float32)
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, index: int) -> Dict:
        rng = np.random.RandomState(self.seed + index)
        N = self.num_cams
        H, W = self.input_size
        intrins = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
        intrins[:, 0, 0] = intrins[:, 1, 1] = W / 2.0
        intrins[:, 0, 2] = W / 2.0
        intrins[:, 1, 2] = H / 2.0
        depth = rng.uniform(0, 10, (N, H, W)).astype(np.float32)
        depth[depth < 5] = 0.0
        pts = rng.uniform(self.pc_range[:3], self.pc_range[3:],
                          (self.num_lidar_points, 3)).astype(np.float32)
        labels = rng.randint(1, self.num_classes,
                             (self.num_lidar_points, 1)).astype(np.float32)
        return {
            "imgs": rng.randn(N, H, W, 3).astype(np.float32),
            "rots": np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)),
            "trans": rng.uniform(-1, 1, (N, 3)).astype(np.float32),
            "intrins": intrins,
            "post_rots": np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)),
            "post_trans": np.zeros((N, 3), np.float32),
            "bda": np.eye(3, dtype=np.float32),
            "gt_depth": depth,
            "gt_occ": rng.randint(0, self.num_classes,
                                  self.occ_size).astype(np.int64),
            "points_occ": np.concatenate([pts, labels], -1),
            "pc_range": self.pc_range,
        }
