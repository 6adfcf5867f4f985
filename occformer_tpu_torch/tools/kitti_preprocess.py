"""Offline SemanticKITTI label preprocessing.

    python3 -m occformer_tpu_torch.tools.kitti_preprocess --kitti-root R
        --out-dir R/labels [--sequences 00 01 ...]

The port's copy of ``tools/kitti_preprocess.py`` (reference
tools/kitti_process/semantic_kitti_preprocess.py:25-100): each frame's raw
``voxels/<frame>.label`` (uint16 raw ids) and ``.invalid`` (packed bits) are
fused into the 256 x 256 x 32 ``<frame>_1_1.npy`` train labels (255 where
invalid), and majority-pooled into the 1_2 / 1_4 / 1_8 ones, with
vectorized numpy group-bys instead of the reference's per-voxel loops.
"""
import argparse
import glob
import os
import sys

import numpy as np

from ..utils.semkitti_io import learning_map_lut, read_invalid_voxels


def majority_pool(grid: np.ndarray, k: int = 2) -> np.ndarray:
    """Majority pooling that prefers real classes to 0 and 255
    (semantic_kitti_preprocess.py:69-93): a class in (0, 255) wins by
    count; else 0 beats 255."""
    X, Y, Z = grid.shape
    sub = grid.reshape(X // k, k, Y // k, k, Z // k, k)
    sub = sub.transpose(0, 2, 4, 1, 3, 5).reshape(-1, k * k * k).astype(np.int64)
    n_vox = sub.shape[0]
    flat = np.arange(n_vox)[:, None] * 256 + sub
    counts = np.bincount(flat.reshape(-1), minlength=n_vox * 256).reshape(n_vox, 256)
    real = counts[:, 1:255]
    has_real = real.sum(1) > 0
    best_real = real.argmax(1) + 1
    fallback = np.where(counts[:, 0] > 0, 0, 255)
    out = np.where(has_real, best_real, fallback).astype(np.uint8)
    return out.reshape(X // k, Y // k, Z // k)


def process_frame(voxel_dir: str, frame_id: str, out_dir: str, lut: np.ndarray,
                  dims=(256, 256, 32), scales=(1, 2, 4, 8)):
    label = np.fromfile(os.path.join(voxel_dir, frame_id + ".label"),
                        dtype=np.uint16).reshape(dims)
    invalid = read_invalid_voxels(os.path.join(voxel_dir, frame_id + ".invalid"), dims)
    label = lut[np.clip(label, 0, len(lut) - 1)].astype(np.uint8)
    label[invalid == 1] = 255
    for s in scales:
        grid = label if s == 1 else majority_pool(label, s)
        np.save(os.path.join(out_dir, f"{frame_id}_1_{s}.npy"), grid)


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--kitti-root", required=True)
    p.add_argument("--out-dir", required=True)
    p.add_argument("--sequences", nargs="*", default=[
        "00", "01", "02", "03", "04", "05", "06", "07", "08", "09", "10"])
    args = p.parse_args(argv)

    lut = learning_map_lut()
    for seq in args.sequences:
        voxel_dir = os.path.join(args.kitti_root, "dataset", "sequences", seq, "voxels")
        out_dir = os.path.join(args.out_dir, seq)
        os.makedirs(out_dir, exist_ok=True)
        frames = sorted(os.path.basename(f).split(".")[0]
                        for f in glob.glob(os.path.join(voxel_dir, "*.label")))
        for fid in frames:
            process_frame(voxel_dir, fid, out_dir, lut)
        print(f"sequence {seq}: {len(frames)} frames")
    return 0


if __name__ == "__main__":
    sys.exit(main())
