"""Synthetic nuScenes-style serving batch at a config's exact shapes.

The port's copy of the batch logic of ``tools/tpu_train_trial.py``
(nuScenes branch), serving keys only: 6 camera images with native-scale
intrinsics (fx = 1266 on the 1600-wide sensor) and the aug homography that
resizes them to the network input (post scale W / 1600), identity rotations
and BDA, random translations, and ``max_lidar_points`` LiDAR returns in
[0, 1] of the point-cloud range with random labels.  Everything comes from
``numpy.random.RandomState(seed)``.
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def make_serving_batch(cfg: Dict, seed: int = 0) -> Dict[str, np.ndarray]:
    """One frame (batch 1), as a frame-by-frame server receives it."""
    data_config = cfg["data_config"]
    B = 1
    N = data_config.get("Ncams", 1)
    H, W = data_config["input_size"]
    num_classes = cfg["model"]["pts_bbox_head"].get("num_occupancy_classes", 20)
    P = int(cfg["max_lidar_points"])
    fx, post_scale = 1266.0, W / 1600.0
    cx, cy = W / 2 / post_scale, H / 2 / post_scale

    rng = np.random.RandomState(seed)
    intrins = np.zeros((B, N, 3, 3), np.float32)
    intrins[..., 0, 0] = fx
    intrins[..., 1, 1] = fx
    intrins[..., 0, 2] = cx
    intrins[..., 1, 2] = cy
    intrins[..., 2, 2] = 1.0
    post_rots = np.tile(np.eye(3, dtype=np.float32) * post_scale, (B, N, 1, 1))
    post_rots[..., 2, 2] = 1.0
    return {
        "imgs": rng.randn(B, N, H, W, 3).astype(np.float32),
        "rots": np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1)),
        "trans": rng.uniform(-1, 1, (B, N, 3)).astype(np.float32),
        "intrins": intrins,
        "post_rots": post_rots,
        "post_trans": np.zeros((B, N, 3), np.float32),
        "bda": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
        "lidar_xyz": rng.uniform(0, 1, (B, P, 3)).astype(np.float32),
        "lidar_valid": np.ones((B, P), bool),
        "lidar_label": rng.randint(1, num_classes, (B, P)).astype(np.int32),
    }
