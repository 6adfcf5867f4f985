"""Voxel-prediction pictures, headless (port of ``tools/visualize.py``,
which replaces the reference's mayavi visualizers
projects/mmdet3d_plugin/visualize/{visualize_kitti.py, visualize_nusc.py,
visualize_nusc_video.py}).

Renders the BEV class map and height slices of predicted (and GT)
occupancy from saved ``.npz`` files (``pred``, optional ``gt`` [X, Y, Z]
labels) to PNG, or stitches scene-sorted predictions into one GIF.

Usage:
  python3 -m occformer_tpu_torch.tools.visualize preds/sample_0001.npz --out viz/s1.png
  python3 -m occformer_tpu_torch.tools.visualize preds/*.npz --video --out scene.gif
"""
from __future__ import annotations

import argparse
import os

import numpy as np

# a qualitative palette for up to 20 classes (class 0 = empty -> white)
PALETTE = np.array([
    [255, 255, 255], [112, 128, 144], [220, 20, 60], [255, 127, 80],
    [255, 158, 0], [233, 150, 70], [255, 61, 99], [0, 0, 230],
    [47, 79, 79], [255, 140, 0], [255, 99, 71], [0, 207, 191],
    [175, 0, 75], [75, 0, 75], [112, 180, 60], [222, 184, 135],
    [0, 175, 0], [120, 120, 200], [255, 240, 150], [135, 60, 0],
], np.uint8)


def bev_class_map(vox: np.ndarray) -> np.ndarray:
    """[X, Y, Z] labels -> [X, Y, 3] RGB: per column, the class of the
    highest non-empty voxel (0 and 255 are empty)."""
    Z = vox.shape[2]
    nonempty = (vox > 0) & (vox < 255)
    top = np.where(nonempty.any(-1), Z - 1 - np.argmax(nonempty[..., ::-1], -1), 0)
    cls = np.take_along_axis(vox, top[..., None], axis=-1)[..., 0]
    cls = np.where(nonempty.any(-1), cls, 0)
    return PALETTE[np.clip(cls, 0, len(PALETTE) - 1)]


def render(pred: np.ndarray, gt: np.ndarray = None, out_path: str = "viz.png",
           slices=(4, 8, 12)):
    """One row (BEV and the ``slices`` heights) for ``pred`` and one for
    ``gt`` (255 shown empty), written to ``out_path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows, cols = 1 + (gt is not None), 1 + len(slices)
    fig, axes = plt.subplots(rows, cols, figsize=(4 * cols, 4 * rows))
    axes = np.atleast_2d(axes)

    def row(ax_row, vox, tag):
        ax_row[0].imshow(bev_class_map(vox).transpose(1, 0, 2), origin="lower")
        ax_row[0].set_title(f"{tag} BEV")
        for i, z in enumerate(slices):
            z = min(z, vox.shape[2] - 1)
            sl = np.clip(vox[:, :, z], 0, len(PALETTE) - 1)
            ax_row[i + 1].imshow(PALETTE[sl].transpose(1, 0, 2), origin="lower")
            ax_row[i + 1].set_title(f"{tag} z={z}")
        for ax in ax_row:
            ax.axis("off")

    row(axes[0], pred, "pred")
    if gt is not None:
        row(axes[1], np.where(gt == 255, 0, gt), "gt")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=110)
    plt.close(fig)


def render_video(npz_files, out_path: str, fps: int = 4):
    """The BEV maps of scene-sorted predictions as one animated GIF (PIL,
    no ffmpeg)."""
    from PIL import Image

    frames = []
    for f in npz_files:
        rgb = bev_class_map(np.load(f)["pred"]).transpose(1, 0, 2)[::-1]
        frames.append(Image.fromarray(np.ascontiguousarray(rgb)).resize(
            (rgb.shape[1] * 3, rgb.shape[0] * 3), Image.NEAREST))
    if not frames:
        raise SystemExit("no input frames")
    os.makedirs(os.path.dirname(os.path.abspath(out_path)) or ".", exist_ok=True)
    frames[0].save(out_path, save_all=True, append_images=frames[1:],
                   duration=int(1000 / fps), loop=0)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("npz", nargs="+", help=".npz file(s) with 'pred' (and optional 'gt')")
    p.add_argument("--out", default=None)
    p.add_argument("--video", action="store_true",
                   help="stitch all inputs (scene-sorted) into one GIF")
    p.add_argument("--fps", type=int, default=4)
    args = p.parse_args(argv)
    if args.video:
        out = args.out or "scene.gif"
        render_video(sorted(args.npz), out, fps=args.fps)
    else:
        for f in args.npz:
            data = np.load(f)
            out = (args.out if len(args.npz) == 1 and args.out
                   else os.path.splitext(f)[0] + ".png")
            render(data["pred"], data["gt"] if "gt" in data else None, out)
    print("wrote", out)


if __name__ == "__main__":
    main()
