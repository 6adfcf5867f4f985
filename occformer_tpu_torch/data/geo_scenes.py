"""Box scenes rendered through one camera rig into the images and the grid.

The port's copy of the scene renderers of ``tests/test_geometric_learnability.py``
(the tiny 2-camera rig) and ``tools/synthetic_geo_benchmark.py`` (a
nuScenes-like 6-camera rig at 256x704 over a 256x256x32 grid): random boxes
fill the occupancy grid, and their voxel centres are projected through the
same intrinsics and camera-to-ego rotations into the images (a colour per
class) and the depth maps.  A model can beat chance on held-out scenes only
if its whole camera -> LSS -> voxel -> head chain is spatially consistent.
Plain numpy: given the same ``np.random.Generator`` state, each function
gives the JAX package's arrays bit for bit.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

# camera-to-ego rotation: cam (x right, y down, z fwd) -> ego (x fwd, y left, z up)
R_C2E = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)


class TinyRig:
    """The tiny test model's rig (``tests/tiny_cfg.py``): 2 cameras at 32x64
    looking along +x and -x, a 32x32x16 grid over [-8, 8] x [-8, 8] x [-2, 2]
    m, 5 classes."""
    PC = np.asarray([-8.0, -8.0, -2.0, 8.0, 8.0, 2.0], np.float32)
    OCC = [32, 32, 16]
    H, W = 32, 64
    NCLS = 5
    R_YAW = np.array([[-1, 0, 0], [0, -1, 0], [0, 0, 1]], np.float32)  # 180deg
    ROTS = np.stack([R_C2E, R_YAW @ R_C2E])  # cam0 looks +x, cam1 looks -x
    TRANS = np.zeros((2, 3), np.float32)
    K = np.array([[30.0, 0, W / 2], [0, 30.0, H / 2], [0, 0, 1]], np.float32)
    COLORS = np.array([[0, 0, 0], [1.5, -1, -1], [-1, 1.5, -1], [-1, -1, 1.5],
                       [1.5, 1.5, -1]], np.float32)


def _rz(a):
    return np.array([[np.cos(a), -np.sin(a), 0],
                     [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)


class NuscRig:
    """A nuScenes-like rig: 6 cameras at 256x704, 60 degrees apart, at the
    ego origin; the flagship's 256x256x32 grid over [-51.2, 51.2]^2 x [-5, 3]
    m, 17 classes (0 empty)."""
    PC = np.array([-51.2, -51.2, -5.0, 51.2, 51.2, 3.0], np.float32)
    OCC = (256, 256, 32)
    H, W = 256, 704
    NCAM = 6
    NCLS = 17
    ROTS = np.stack([_rz(np.deg2rad(y)) @ R_C2E for y in (0, 60, 120, 180, 240, 300)])
    TRANS = np.zeros((NCAM, 3), np.float32)
    K = np.array([[560.0, 0, W / 2], [0, 560.0, H / 2], [0, 0, 1]], np.float32)
    PALETTE = np.random.RandomState(42).uniform(-1.5, 1.5, (NCLS, 3)).astype(np.float32)
    PALETTE[0] = 0.0


def make_tiny_scene(rng: np.random.Generator):
    """Random boxes on the tiny rig -> (gt_occ [X, Y, Z], imgs [2, H, W, 3],
    depth [2, H, W], LiDAR points [128, 3] in [0, 1], their validity)."""
    r = TinyRig
    PC, OCC, H, W, NCLS = r.PC, r.OCC, r.H, r.W, r.NCLS
    gt = np.zeros(OCC, np.int64)
    vx = (PC[3:] - PC[:3]) / np.asarray(OCC)
    boxes = []
    for side in (+1, -1):  # one box per camera's view
        for _ in range(2):
            c = rng.integers(1, NCLS)
            cx = side * rng.uniform(3.0, 6.5)
            cy = rng.uniform(-3.0, 3.0)
            cz = rng.uniform(-0.8, 0.8)
            sx, sy, sz = rng.uniform(1.5, 3.0, 3) * [1, 1, 0.8]
            boxes.append((c, cx, cy, cz, sx, sy, sz))
    xs = (np.arange(OCC[0]) + 0.5) * vx[0] + PC[0]
    ys = (np.arange(OCC[1]) + 0.5) * vx[1] + PC[1]
    zs = (np.arange(OCC[2]) + 0.5) * vx[2] + PC[2]
    GX, GY, GZ = np.meshgrid(xs, ys, zs, indexing="ij")
    for (c, cx, cy, cz, sx, sy, sz) in boxes:
        m = (np.abs(GX - cx) < sx / 2) & (np.abs(GY - cy) < sy / 2) & \
            (np.abs(GZ - cz) < sz / 2)
        gt[m] = c

    occ_idx = np.argwhere(gt > 0)
    centers = (occ_idx + 0.5) * vx + PC[:3]
    classes = gt[occ_idx[:, 0], occ_idx[:, 1], occ_idx[:, 2]]

    imgs = np.zeros((2, H, W, 3), np.float32)
    depth = np.zeros((2, H, W), np.float32)
    zbuf = np.full((2, H, W), 1e9, np.float32)
    for n in range(2):
        cam = (np.linalg.inv(r.ROTS[n]) @ (centers - r.TRANS[n]).T).T
        z = cam[:, 2]
        ok = z > 0.5
        uv = (r.K @ cam.T).T
        u = uv[:, 0] / z
        v = uv[:, 1] / z
        ok &= (u >= 1) & (u < W - 1) & (v >= 1) & (v < H - 1)
        order = np.argsort(-z)  # far first, near overwrites
        for i in order:
            if not ok[i]:
                continue
            ui, vi = int(u[i]), int(v[i])
            if z[i] < zbuf[n, vi, ui]:
                imgs[n, vi - 1:vi + 2, ui - 1:ui + 2] = r.COLORS[classes[i]]
                depth[n, vi - 1:vi + 2, ui - 1:ui + 2] = z[i]
                zbuf[n, vi - 1:vi + 2, ui - 1:ui + 2] = z[i]

    # lidar: subsample occupied voxel centers, normalized to [0,1]
    P = 128
    sel = rng.choice(len(centers), min(P, len(centers)), replace=False)
    pts01 = (centers[sel] - PC[:3]) / (PC[3:] - PC[:3])
    valid = np.zeros(P, bool)
    valid[: len(sel)] = True
    pts = np.zeros((P, 3), np.float32)
    pts[: len(sel)] = pts01
    return gt, imgs, depth, pts, valid


def tiny_scene_batch(rng: np.random.Generator) -> Dict[str, np.ndarray]:
    """A batch of one tiny-rig scene, the train step's inputs (the images
    with a fixed 0.05-sigma noise)."""
    r = TinyRig
    gt, imgs, depth, pts, valid = make_tiny_scene(rng)
    B, N = 1, 2
    intrins = np.tile(r.K, (B, N, 1, 1))
    return {
        "imgs": imgs[None] + 0.05 * np.random.RandomState(0).randn(
            1, 2, r.H, r.W, 3).astype(np.float32),
        "rots": r.ROTS[None].astype(np.float32),
        "trans": r.TRANS[None],
        "intrins": intrins.astype(np.float32),
        "post_rots": np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1)),
        "post_trans": np.zeros((B, N, 3), np.float32),
        "bda": np.tile(np.eye(3, dtype=np.float32), (B, 1, 1)),
        "gt_occ": gt[None].astype(np.int32),
        "gt_depth": depth[None],
        "lidar_xyz": pts[None],
        "lidar_valid": valid[None],
    }


def make_nusc_scene(rng: np.random.Generator, num_boxes: int = 10) -> Tuple[np.ndarray, ...]:
    """``num_boxes`` random boxes on the nuScenes-like rig -> (gt_occ
    [256, 256, 32], imgs [6, 256, 704, 3], depth [6, 256, 704], the occupied
    voxels' centres [M, 3] in metres, their classes [M])."""
    r = NuscRig
    PC, OCC, H, W, NCLS = r.PC, r.OCC, r.H, r.W, r.NCLS
    gt = np.zeros(OCC, np.int64)
    vx = (PC[3:] - PC[:3]) / np.asarray(OCC)
    xs = (np.arange(OCC[0]) + 0.5) * vx[0] + PC[0]
    ys = (np.arange(OCC[1]) + 0.5) * vx[1] + PC[1]
    zs = (np.arange(OCC[2]) + 0.5) * vx[2] + PC[2]
    for _ in range(num_boxes):
        c = int(rng.integers(1, NCLS))
        ang = rng.uniform(0, 2 * np.pi)
        rad = rng.uniform(6.0, 35.0)
        cx, cy = rad * np.cos(ang), rad * np.sin(ang)
        cz = rng.uniform(-1.5, 0.5)
        sx, sy, sz = rng.uniform(2.0, 6.0, 3) * [1, 1, 0.6]
        ix = np.where(np.abs(xs - cx) < sx / 2)[0]
        iy = np.where(np.abs(ys - cy) < sy / 2)[0]
        iz = np.where(np.abs(zs - cz) < sz / 2)[0]
        gt[np.ix_(ix, iy, iz)] = c

    occ_idx = np.argwhere(gt > 0)
    centers = (occ_idx + 0.5) * vx + PC[:3]
    classes = gt[occ_idx[:, 0], occ_idx[:, 1], occ_idx[:, 2]]

    imgs = np.zeros((r.NCAM, H, W, 3), np.float32)
    depth = np.zeros((r.NCAM, H, W), np.float32)
    for n in range(r.NCAM):
        cam = (np.linalg.inv(r.ROTS[n]) @ (centers - r.TRANS[n]).T).T
        z = cam[:, 2]
        ok = z > 1.0
        uv = (r.K @ cam.T).T
        u = np.where(ok, uv[:, 0] / np.maximum(z, 1e-3), -1)
        v = np.where(ok, uv[:, 1] / np.maximum(z, 1e-3), -1)
        ok &= (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1)
        ui = u[ok].astype(np.int64)
        vi = v[ok].astype(np.int64)
        zi = z[ok]
        ci = classes[ok]
        # nearest-wins z-buffer: sort far -> near, later writes win
        order = np.argsort(-zi)
        lin = vi[order] * W + ui[order]
        img_flat = imgs[n].reshape(-1, 3)
        dep_flat = depth[n].reshape(-1)
        img_flat[lin] = r.PALETTE[ci[order]]
        dep_flat[lin] = zi[order]
    return gt, imgs, depth, centers, classes


def nusc_scene_batch(rng: np.random.Generator, max_lidar: int = 35000) -> Dict[str, np.ndarray]:
    """A batch of one nuScenes-rig scene, the train step's inputs: the
    occupied voxels' centres as up to ``max_lidar`` LiDAR points."""
    r = NuscRig
    gt, imgs, depth, centers, classes = make_nusc_scene(rng)
    sel = rng.permutation(len(centers))[:max_lidar]
    pts = np.zeros((max_lidar, 3), np.float32)
    valid = np.zeros(max_lidar, bool)
    pts01 = (centers[sel] - r.PC[:3]) / (r.PC[3:] - r.PC[:3])
    pts[: len(sel)] = pts01
    valid[: len(sel)] = True
    intrins = np.tile(r.K, (1, r.NCAM, 1, 1))
    return {
        "imgs": imgs[None],
        "rots": r.ROTS[None],
        "trans": r.TRANS[None],
        "intrins": intrins.astype(np.float32),
        "post_rots": np.tile(np.eye(3, dtype=np.float32), (1, r.NCAM, 1, 1)),
        "post_trans": np.zeros((1, r.NCAM, 3), np.float32),
        "bda": np.tile(np.eye(3, dtype=np.float32), (1, 1, 1)),
        "gt_occ": gt[None].astype(np.int32),
        "gt_depth": depth[None],
        "lidar_xyz": pts[None],
        "lidar_valid": valid[None],
    }


def heldout_iou(preds, gts, num_classes: int) -> Dict[str, float]:
    """Held-out accuracy of predicted grids against GT grids (each pair the
    same shape; class 0 empty), summed over the scenes: ``sc_iou``, the
    scene-completion IoU (occupied vs empty); ``miou``, the class mIoU over
    the classes present (``tools/synthetic_geo_benchmark.py``);
    ``miou_all_classes``, over every foreground class, an absent one
    counting 0 (``tests/test_geometric_learnability.py``); and
    ``chance_sc_iou``, the occupied share of the GT grids, the SC IoU of
    calling every voxel occupied."""
    inter = np.zeros(num_classes)
    union = np.zeros(num_classes)
    sc_i = sc_u = occupied = voxels = 0
    for pred, gt in zip(preds, gts):
        sc_i += np.sum((pred > 0) & (gt > 0))
        sc_u += np.sum((pred > 0) | (gt > 0))
        occupied += np.sum(gt > 0)
        voxels += gt.size
        for c in range(1, num_classes):
            inter[c] += np.sum((pred == c) & (gt == c))
            union[c] += np.sum((pred == c) | (gt == c))
    ious = inter[1:] / np.maximum(union[1:], 1)
    present = union[1:] > 0
    return {"sc_iou": float(sc_i / max(sc_u, 1)),
            "miou": float(np.mean(ious[present])) if present.any() else 0.0,
            "miou_all_classes": float(np.nanmean(ious)),
            "chance_sc_iou": float(occupied / max(voxels, 1))}
