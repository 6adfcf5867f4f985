"""Leaderboard submission validators and zipper (reference
projects/mmdet3d_plugin/tools/{validate_semkitti_submission.py,
validate_lidarseg_submission.py}; port of ``tools/validate_submission.py``).

Checks the file inventory, dtypes, label ranges and sizes without the
official devkits, then zips.

Usage:
  python3 -m occformer_tpu_torch.tools.validate_submission kitti <dir> [--zip out.zip]
  python3 -m occformer_tpu_torch.tools.validate_submission nusc <dir> [--zip out.zip]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import zipfile

import numpy as np

from ..utils.semkitti_io import KITTI_LEARNING_MAP_INV

KITTI_TEST_SEQS = ["11", "12", "13", "14", "15", "16", "17", "18", "19", "20", "21"]
KITTI_VALID_RAW = set(KITTI_LEARNING_MAP_INV.values())
NUM_KITTI_VOXELS = 256 * 256 * 32


def validate_kitti(root: str) -> int:
    """Check sequences/<seq>/predictions/*.label; returns the error count."""
    errors = 0
    for seq in KITTI_TEST_SEQS:
        pred_dir = os.path.join(root, "sequences", seq, "predictions")
        if not os.path.isdir(pred_dir):
            print(f"MISSING sequence dir: {pred_dir}")
            errors += 1
            continue
        for fn in sorted(os.listdir(pred_dir)):
            if not fn.endswith(".label"):
                continue
            arr = np.fromfile(os.path.join(pred_dir, fn), dtype=np.uint16)
            if arr.size != NUM_KITTI_VOXELS:
                print(f"{seq}/{fn}: wrong voxel count {arr.size}")
                errors += 1
            bad = set(np.unique(arr).tolist()) - KITTI_VALID_RAW
            if bad:
                print(f"{seq}/{fn}: invalid raw labels {sorted(bad)[:8]}")
                errors += 1
    return errors


def validate_nusc(root: str) -> int:
    """Check lidarseg/test/*_lidarseg.bin and test/submission.json; returns
    the error count."""
    errors = 0
    meta = os.path.join(root, "test", "submission.json")
    if not os.path.exists(meta):
        print(f"MISSING {meta}")
        errors += 1
    else:
        with open(meta) as f:
            if "meta" not in json.load(f):
                print("submission.json missing 'meta' key")
                errors += 1
    bin_dir = os.path.join(root, "lidarseg", "test")
    if not os.path.isdir(bin_dir):
        print(f"MISSING {bin_dir}")
        return errors + 1
    n = 0
    for fn in sorted(os.listdir(bin_dir)):
        if not fn.endswith("_lidarseg.bin"):
            continue
        arr = np.fromfile(os.path.join(bin_dir, fn), dtype=np.uint8)
        if arr.size == 0:
            print(f"{fn}: empty")
            errors += 1
        if arr.max(initial=0) > 16 or arr.min(initial=1) < 1:
            print(f"{fn}: labels outside [1, 16]")
            errors += 1
        n += 1
    print(f"checked {n} lidarseg files")
    return errors


def zip_dir(root: str, out_zip: str):
    with zipfile.ZipFile(out_zip, "w", zipfile.ZIP_DEFLATED) as z:
        for dirpath, _, files in os.walk(root):
            for fn in files:
                full = os.path.join(dirpath, fn)
                z.write(full, os.path.relpath(full, root))
    print("wrote", out_zip)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("dataset", choices=["kitti", "nusc"])
    p.add_argument("submission_dir")
    p.add_argument("--zip", default=None)
    args = p.parse_args(argv)
    errors = (validate_kitti if args.dataset == "kitti" else validate_nusc)(
        args.submission_dir)
    if errors:
        print(f"FAILED with {errors} errors")
        sys.exit(1)
    print("submission valid")
    if args.zip:
        zip_dir(args.submission_dir, args.zip)


if __name__ == "__main__":
    main()
