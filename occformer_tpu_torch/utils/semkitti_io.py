"""SemanticKITTI IO and submission files.

The port's copy of ``occformer_tpu/utils/semkitti_io.py`` (reference
utils/semkitti_io.py, tools/kitti_process/io_data.py:10-216 and
apis/utils.py:18-51, :112-134): the learning maps of semantic-kitti.yaml,
the 1-bit-per-voxel readers (MSB first, unpacked by the native data library,
``data/native.py:unpack_bits_native``), the voxel label reader, and the
``.label`` and lidarseg ``.bin`` writers.
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from ..data.native import unpack_bits_native

# semantic-kitti.yaml learning_map (raw id -> train id 0..19)
KITTI_LEARNING_MAP: Dict[int, int] = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}
# train id -> raw id (for submissions)
KITTI_LEARNING_MAP_INV: Dict[int, int] = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}


def learning_map_lut() -> np.ndarray:
    lut = np.zeros(max(KITTI_LEARNING_MAP) + 1, np.int32)
    for k, v in KITTI_LEARNING_MAP.items():
        lut[k] = v
    return lut


def learning_map_inv_lut() -> np.ndarray:
    lut = np.zeros(max(KITTI_LEARNING_MAP_INV) + 1, np.uint16)
    for k, v in KITTI_LEARNING_MAP_INV.items():
        lut[k] = v
    return lut


def unpack_binary_voxels(compressed: np.ndarray) -> np.ndarray:
    """1-bit-per-voxel bytes -> 0/1 uint8, each byte 8 voxels, MSB first."""
    return unpack_bits_native(compressed)


def pack_binary_voxels(bits: np.ndarray) -> np.ndarray:
    return np.packbits(bits.astype(np.uint8))


def read_occupancy(path: str, dims=(256, 256, 32)) -> np.ndarray:
    return unpack_binary_voxels(np.fromfile(path, dtype=np.uint8)).reshape(dims)


def read_label_voxels(path: str, dims=(256, 256, 32)) -> np.ndarray:
    """A ``.label`` voxel file: uint16 raw semantic ids -> train ids."""
    raw = np.fromfile(path, dtype=np.uint16).reshape(dims)
    lut = learning_map_lut()
    return lut[np.clip(raw, 0, len(lut) - 1)].astype(np.uint8)


def read_invalid_voxels(path: str, dims=(256, 256, 32)) -> np.ndarray:
    return unpack_binary_voxels(np.fromfile(path, dtype=np.uint8)).reshape(dims)


def write_submission_label(pred_train_ids: np.ndarray, out_path: str):
    """Train-id voxel grid -> raw-id uint16 ``.label`` submission file."""
    inv = learning_map_inv_lut()
    raw = inv[pred_train_ids.reshape(-1).astype(np.int64)]
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    raw.astype(np.uint16).tofile(out_path)


def write_nusc_lidarseg_bin(point_labels: np.ndarray, out_path: str):
    """Per-point uint8 predictions for the nuScenes lidarseg benchmark."""
    os.makedirs(os.path.dirname(out_path), exist_ok=True)
    point_labels.astype(np.uint8).tofile(out_path)
