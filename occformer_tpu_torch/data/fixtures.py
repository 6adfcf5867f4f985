"""A nuScenes-layout tree at full size, made from a seed.

``make_nuscenes_tree`` writes what ``CustomNuScenesOccLSSDataset`` reads
from a real nuScenes checkout, for ``n_samples`` samples: six 900 x 1600
JPEGs, a LIDAR_TOP sweep of ``n_points`` x 5 float32 (x, y, z, intensity,
ring), its lidarseg labels (uint8, the 32 nuScenes classes) and one info
pickle with every sample.  The program's time on it is what it would spend
on a real frame of the same sizes; its scores mean nothing.

* **Cameras** stand where ``rig`` puts them (by default
  ``tools/time_backwards.py:NUSCENES_RIG``: six cameras 1.5 m above the
  ground, looking out level at the nuScenes yaws, with their focal
  lengths), so the LiDAR projects into every image and lands in the
  voxel grid as it does on the car.  The LiDAR frame is the rig's: x
  forward, y left, z up, the origin on the ground under the sensor.
* **The sweep** is ray-cast: 32 beams from 1.84 m high between -30.67 and
  +10.67 degrees of elevation (a LIDAR_TOP's), each swept over the full
  circle, hitting the ground (z = 0), a few box-shaped vehicles and a ring
  of walls 2.9 m high at 18 to 48 m whose radius changes with the azimuth;
  rays that hit nothing give no return.  ``n_points`` of the returns are
  kept, in scan order, with 2 cm of range noise.  Labels follow what was
  hit (driveable surface near the car, sidewalk and terrain further out,
  car and truck boxes, man-made and vegetation walls) and 2% are noise (0).
* **Panoptic labels** (``panoptic=True``): beside each lidarseg file, the
  nuScenes panoptic sidecar ``panoptic/v1.0-trainval/<token>_panoptic.npz``
  (uint16 ``data``, ``class * 1000 + instance`` over the same 32 classes):
  the returns of the k-th box are instance k of its class, every other
  return (ground, walls, noise) instance 0.  Its class part is the lidarseg
  file's label of each point.  The sidecars draw nothing from the seed, so
  the rest of the tree is the same with or without them.
* **Images** are smooth, as photos are: a vertical gradient (sky above
  the horizon, road below), random colour fields at three scales
  (9 x 16, 57 x 100 and 225 x 400 cells, bicubically upsampled) and a
  little per-pixel grain, saved at JPEG quality 90 (about 0.27 MB a
  frame).  Per-pixel noise alone compresses about 5x worse, and its
  entropy decoding makes it decode slower than a photo of that size.

Everything comes from ``numpy.random.RandomState(seed)``.
"""
from __future__ import annotations

import os
import pickle
from typing import Optional, Sequence

import numpy as np

SENSOR_HEIGHT = 1.84  # m above the ground (a LIDAR_TOP's mount)
BEAMS = np.linspace(-30.67, 10.67, 32)  # elevation of the 32 beams, degrees
WALL_HEIGHT = 2.9  # m: every return lies inside the flagship's z range [-5, 3]
# nuScenes lidarseg indices (the 32 classes) of what a ray hits
GROUND_NEAR, SIDEWALK, TERRAIN = 24, 26, 27
CAR, TRUCK = 17, 23
MANMADE, VEGETATION = 28, 30


def _camera_poses(rig):
    """Per camera (name, rotation [3, 3] with the camera's x right, y down,
    z forward as columns, position [3], focal length) of ``rig``'s rows
    (name, yaw in degrees, position, focal length)."""
    poses = []
    for name, yaw, pos, f in rig:
        c, s = np.cos(np.radians(yaw)), np.sin(np.radians(yaw))
        rot = np.array([[s, 0.0, c], [-c, 0.0, s], [0.0, -1.0, 0.0]])
        poses.append((name, rot, np.asarray(pos, np.float64), float(f)))
    return poses


def _boxes(rng, n=10):
    """Axis-aligned vehicle boxes [n, 6] (x0, y0, z0, x1, y1, z1) 5-30 m
    from the sensor, and their labels."""
    az = rng.uniform(0, 2 * np.pi, n)
    r = rng.uniform(5.0, 30.0, n)
    truck = rng.rand(n) < 0.3
    length = np.where(truck, 8.0, 4.5)
    width = np.where(truck, 2.5, 1.9)
    height = np.where(truck, 3.0, 1.6)
    cx, cy = r * np.cos(az), r * np.sin(az)
    boxes = np.stack([cx - length / 2, cy - width / 2, np.zeros(n),
                      cx + length / 2, cy + width / 2, height], 1)
    return boxes, np.where(truck, TRUCK, CAR)


def _sweep(rng, n_points):
    """One ray-cast sweep: (points [n_points, 5] float32, labels uint8,
    instances int64: k for a return of the k-th box, else 0)."""
    boxes, box_labels = _boxes(rng)
    wall_phase = rng.uniform(0, 2 * np.pi, 3)
    n_az = int(np.ceil(n_points / len(BEAMS) * 1.5))
    while True:
        az = (np.arange(n_az) + rng.uniform(0, 1, n_az)) * (2 * np.pi / n_az)
        el = np.radians(BEAMS)
        az_g, el_g = np.meshgrid(az, el, indexing="ij")  # scan order: azimuth, then beam
        d = np.stack([np.cos(el_g) * np.cos(az_g), np.cos(el_g) * np.sin(az_g),
                      np.sin(el_g)], -1).reshape(-1, 3)
        o = np.array([0.0, 0.0, SENSOR_HEIGHT])
        horiz = np.hypot(d[:, 0], d[:, 1])
        a = az_g.reshape(-1)
        label = np.zeros(len(d), np.uint8)
        inst = np.zeros(len(d), np.int64)
        # the ground
        down = d[:, 2] < 0
        t = np.where(down, -SENSOR_HEIGHT / np.where(down, d[:, 2], -1.0), np.inf)
        # the walls: a radius that changes with the azimuth
        radius = 33.0 + 9.0 * np.sin(3 * a + wall_phase[0]) + 6.0 * np.sin(7 * a + wall_phase[1])
        t_wall = radius / horiz
        z_wall = SENSOR_HEIGHT + t_wall * d[:, 2]
        t_wall = np.where((z_wall >= 0) & (z_wall <= WALL_HEIGHT), t_wall, np.inf)
        wall_label = np.where(np.sin(2 * a + wall_phase[2]) > 0, MANMADE, VEGETATION)
        hit_wall = t_wall < t
        t = np.where(hit_wall, t_wall, t)
        label = np.where(hit_wall, wall_label, label)
        # the vehicles: slab test per box
        inv = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
        for k, (box, box_label) in enumerate(zip(boxes, box_labels), 1):
            t0 = (box[:3] - o) * inv
            t1 = (box[3:] - o) * inv
            near = np.minimum(t0, t1).max(1)
            far = np.maximum(t0, t1).min(1)
            hit = (near <= far) & (near > 0) & (near < t)
            t = np.where(hit, near, t)
            label = np.where(hit, box_label, label)
            inst = np.where(hit, k, inst)
        ground = np.isfinite(t) & (label == 0)
        r_ground = t * horiz
        label = np.where(ground, np.where(r_ground < 15, GROUND_NEAR,
                                          np.where(np.sin(a * 5) > 0, SIDEWALK, TERRAIN)), label)
        keep = np.flatnonzero(np.isfinite(t))
        if len(keep) >= n_points:
            break
        n_az *= 2
    keep = np.sort(rng.choice(keep, n_points, replace=False))
    rng_t = t[keep] + rng.normal(0, 0.02, n_points)
    xyz = o + d[keep] * rng_t[:, None]
    xyz[:, 2] = np.maximum(xyz[:, 2], 0.0)
    labels = label[keep].astype(np.uint8)
    labels[rng.rand(n_points) < 0.02] = 0
    instances = np.where(labels > 0, inst[keep], 0)
    ring = np.broadcast_to(np.arange(len(BEAMS)), az_g.shape).reshape(-1)[keep]
    pts = np.stack([xyz[:, 0], xyz[:, 1], xyz[:, 2], rng.uniform(0, 100, n_points),
                    ring.astype(np.float64)], 1).astype(np.float32)
    return pts, labels, instances


def _image(rng, size=(900, 1600)):
    """A smooth 900 x 1600 RGB image (uint8): a vertical gradient plus random
    colour fields at three scales, bicubically upsampled, and some grain."""
    from PIL import Image

    H, W = size
    rows = np.linspace(0.0, 1.0, H)[:, None, None]
    base = np.where(rows < 0.45, 170.0 - 60.0 * rows, 90.0 + 30.0 * rows)
    img = np.broadcast_to(base, (H, W, 3)).astype(np.float64)
    for (h, w), amp in (((9, 16), 45.0), ((57, 100), 25.0), ((225, 400), 10.0)):
        field = rng.uniform(-1, 1, (h, w, 3)).astype(np.float32)
        for c in range(3):
            up = Image.fromarray(field[..., c], mode="F").resize((W, H), Image.Resampling.BICUBIC)
            img[..., c] += amp * np.asarray(up)
    img += rng.normal(0, 3.0, (H, W, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def make_nuscenes_tree(root: str, n_samples: int = 8, n_points: int = 34000, seed: int = 0,
                       rig: Optional[Sequence] = None, image_size=(900, 1600),
                       panoptic: bool = False) -> str:
    """Write ``n_samples`` samples under ``root`` in the nuScenes layout
    (``samples/CAM_*/<token>.jpg``, ``samples/LIDAR_TOP/<token>.bin``,
    ``lidarseg/v1.0-trainval/<token>_lidarseg.bin`` and, with ``panoptic``,
    ``panoptic/v1.0-trainval/<token>_panoptic.npz``) and one info pickle of
    them all, paths under ``./data/nuscenes`` as the nuScenes tools write
    them (the dataset maps them onto its ``data_root``).  Returns the info
    pickle's path: the configs' ``ann_file``, with ``data_root`` = ``root``
    and the annotation step's ``data_root`` = ``root``."""
    from PIL import Image

    if rig is None:
        from ..tools.time_backwards import NUSCENES_RIG as rig
    rng = np.random.RandomState(seed)
    poses = _camera_poses(rig)
    H, W = image_size
    for d in [os.path.join("samples", name) for name, *_ in poses] + [
            os.path.join("samples", "LIDAR_TOP"), os.path.join("lidarseg", "v1.0-trainval")] + (
            [os.path.join("panoptic", "v1.0-trainval")] if panoptic else []):
        os.makedirs(os.path.join(root, d), exist_ok=True)
    infos = []
    for i in range(n_samples):
        token = f"sample{i:04d}"
        lidar_rel = f"samples/LIDAR_TOP/{token}.bin"
        seg_rel = f"lidarseg/v1.0-trainval/{token}_lidarseg.bin"
        pts, labels, instances = _sweep(rng, n_points)
        pts.tofile(os.path.join(root, lidar_rel))
        labels.tofile(os.path.join(root, seg_rel))
        if panoptic:
            np.savez_compressed(
                os.path.join(root, "panoptic", "v1.0-trainval", f"{token}_panoptic.npz"),
                data=(labels.astype(np.int64) * 1000 + instances).astype(np.uint16))
        cams = {}
        for name, rot, pos, f in poses:
            img_rel = f"samples/{name}/{token}.jpg"
            Image.fromarray(_image(rng, (H, W))).save(os.path.join(root, img_rel), quality=90)
            cams[name] = dict(data_path="./data/nuscenes/" + img_rel,
                              cam_intrinsic=np.array([[f, 0.0, W / 2], [0.0, f, H / 2],
                                                      [0.0, 0.0, 1.0]]),
                              sensor2lidar_rotation=rot, sensor2lidar_translation=pos)
        infos.append(dict(token=token, lidar_path="./data/nuscenes/" + lidar_rel,
                          timestamp=i, scene_token="scene0000", lidarseg=seg_rel, cams=cams))
    ann_file = os.path.join(root, "nuscenes_infos.pkl")
    with open(ann_file, "wb") as fh:
        pickle.dump(dict(infos=infos, metadata=dict(version="v1.0-trainval")), fh)
    return ann_file


def nuscenes_cfg_options(cfg, root: str, ann_file: str):
    """The ``--cfg-options`` that point a nuScenes config's train, val and
    test splits at a tree: each split's ``data_root`` and ``ann_file``, and
    its annotation step's ``data_root`` (``data.<split>.pipeline.<i>.
    data_root``)."""
    opts = []
    for split in ("train", "val", "test"):
        opts += [f"data.{split}.data_root={root}", f"data.{split}.ann_file={ann_file}"]
        for i, step in enumerate(cfg["data"][split]["pipeline"]):
            if step["type"] in ("LoadNuscOccupancyAnnotations",
                                "LoadNuscPanopticOccupancyAnnotations"):
                opts.append(f"data.{split}.pipeline.{i}.data_root={root}")
    return opts


# ---------------------------------------------------------------------------
# SemanticKITTI
# ---------------------------------------------------------------------------

# an HDL-64E 1.73 m above the road; the velodyne frame: x forward, y left, z up
KITTI_SENSOR_HEIGHT = 1.73
KITTI_BEAMS = np.linspace(2.0, -24.8, 64)  # elevation of the 64 beams, degrees
# P2 and Tr of a KITTI odometry sequence (the left colour camera 0.27 m ahead
# of the scanner and 0.08 m below it; P2's fourth column its offset from cam0)
KITTI_P2 = np.array([[718.856, 0.0, 607.1928, 45.38225],
                     [0.0, 718.856, 185.2157, -0.1130887],
                     [0.0, 0.0, 1.0, 0.003779761]])
KITTI_TR = np.array([[0.0, -1.0, 0.0, 0.0], [0.0, 0.0, -1.0, -0.08],
                     [1.0, 0.0, 0.0, -0.27]])
KITTI_IMAGE = (370, 1226)
# SemanticKITTI train ids of what the scene holds
K_CAR, K_ROAD, K_SIDEWALK, K_BUILDING, K_VEGETATION, K_TERRAIN, K_POLE = 1, 9, 11, 13, 15, 17, 18
KITTI_PC_RANGE = (0.0, -25.6, -2.0, 51.2, 25.6, 4.4)
KITTI_GRID = (256, 256, 32)


def _street(rng):
    """One street scene: the wall offsets left and right (y), the cars as
    boxes [n, 6] (x0, y0, z0, x1, y1, z1) and the poles as boxes, in the
    velodyne frame."""
    left, right = rng.uniform(8.0, 14.0), -rng.uniform(8.0, 14.0)
    n = rng.randint(4, 9)
    x = rng.uniform(6.0, 48.0, n)
    y = rng.choice([-2.0, 2.0], n) + rng.uniform(-0.5, 0.5, n)
    length, width = rng.uniform(3.8, 4.8, n), rng.uniform(1.6, 1.9, n)
    ground = -KITTI_SENSOR_HEIGHT
    cars = np.stack([x - length / 2, y - width / 2, np.full(n, ground),
                     x + length / 2, y + width / 2, ground + rng.uniform(1.4, 1.7, n)], 1)
    px = rng.uniform(5.0, 50.0, 3)
    py = np.where(rng.rand(3) < 0.5, left - 1.5, right + 1.5)
    poles = np.stack([px - 0.15, py - 0.15, np.full(3, ground),
                      px + 0.15, py + 0.15, np.full(3, ground + 5.0)], 1)
    return left, right, cars, poles


def _street_scan(rng, street, n_azimuth=2048):
    """The HDL-64E's sweep of a street: points [n, 4] float32 (x, y, z,
    reflectance), 64 x 2048 rays cast against the road, the two walls (4.5 m
    high), the cars and the poles; rays that hit nothing within 80 m give no
    return, and 2 cm of range noise."""
    left, right, cars, poles = street
    az = (np.arange(n_azimuth) + rng.uniform(0, 1, n_azimuth)) * (2 * np.pi / n_azimuth)
    el = np.radians(KITTI_BEAMS)
    az_g, el_g = np.meshgrid(az, el, indexing="ij")
    d = np.stack([np.cos(el_g) * np.cos(az_g), np.cos(el_g) * np.sin(az_g),
                  np.sin(el_g)], -1).reshape(-1, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(d[:, 2] < 0, -KITTI_SENSOR_HEIGHT / d[:, 2], np.inf)
        for wall_y in (left, right):
            tw = wall_y / d[:, 1]
            zw = tw * d[:, 2]
            ok = (tw > 0) & (zw >= -KITTI_SENSOR_HEIGHT) & (zw <= 4.5 - KITTI_SENSOR_HEIGHT)
            t = np.where(ok & (tw < t), tw, t)
        inv = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
        for box in np.concatenate([cars, poles]):
            t0, t1 = box[:3] * inv, box[3:] * inv
            near = np.minimum(t0, t1).max(1)
            far = np.maximum(t0, t1).min(1)
            t = np.where((near <= far) & (near > 0) & (near < t), near, t)
    keep = np.isfinite(t) & (t < 80.0)
    r = t[keep] + rng.normal(0, 0.02, int(keep.sum()))
    xyz = d[keep] * r[:, None]
    return np.concatenate([xyz, rng.uniform(0, 1, (len(xyz), 1))], 1).astype(np.float32)


def _street_labels(street) -> np.ndarray:
    """The street's SemanticKITTI voxel labels [256, 256, 32] (uint8 train
    ids) over the KITTI range at 0.2 m: the ground layer (road within 4 m of
    the centre line, sidewalk to 7 m, terrain beyond), the walls (building
    on the left, vegetation on the right), the cars and the poles; empty (0)
    in the open street, and 255 (unobserved) behind the walls."""
    left, right, cars, poles = street
    X, Y, Z = KITTI_GRID
    pcr = np.asarray(KITTI_PC_RANGE)
    size = (pcr[3:] - pcr[:3]) / np.asarray(KITTI_GRID)
    cx = pcr[0] + (np.arange(X) + 0.5) * size[0]
    cy = pcr[1] + (np.arange(Y) + 0.5) * size[1]
    cz = pcr[2] + (np.arange(Z) + 0.5) * size[2]
    gx, gy, gz = np.meshgrid(cx, cy, cz, indexing="ij")
    labels = np.zeros(KITTI_GRID, np.uint8)
    ground = (gz >= -KITTI_SENSOR_HEIGHT - size[2]) & (gz < -KITTI_SENSOR_HEIGHT)
    ay = np.abs(gy)
    labels[ground] = np.where(ay[ground] < 4.0, K_ROAD,
                              np.where(ay[ground] < 7.0, K_SIDEWALK, K_TERRAIN))
    walls = (gz >= -KITTI_SENSOR_HEIGHT) & (gz < 4.5 - KITTI_SENSOR_HEIGHT)
    labels[walls & (gy >= left) & (gy < left + 0.6)] = K_BUILDING
    labels[walls & (gy <= right) & (gy > right - 0.6)] = K_VEGETATION
    labels[(gy >= left + 0.6) | (gy <= right - 0.6)] = 255
    for boxes, label in ((cars, K_CAR), (poles, K_POLE)):
        for b in boxes:
            inside = ((gx >= b[0]) & (gx < b[3]) & (gy >= b[1]) & (gy < b[4])
                      & (gz >= b[2]) & (gz < b[5]))
            labels[inside] = label
    return labels


def make_kitti_tree(root: str, frames: Optional[dict] = None, seed: int = 0) -> str:
    """Write a SemanticKITTI tree under ``root`` (``frames``: sequence ->
    frame count; by default two frames of the train sequence 00 and two of
    the val sequence 08): per sequence ``calib.txt`` (P0-P3 and Tr of a
    KITTI odometry sequence), and per frame a 370 x 1226 PNG in
    ``image_2``, the velodyne scan (about 130,000 returns of an HDL-64E:
    x, y, z, reflectance), the raw voxel files of ``voxels`` (the packed
    occupancy ``.bin``, the raw-id ``.label``, the packed ``.invalid``) and
    the preprocessed train labels ``labels/<seq>/<frame>_1_1.npy``
    (``tools/kitti_preprocess.py``); a test-submit sequence (11-21) gets
    its occupancy ``.bin`` and no labels, as SemanticKITTI's.  Every other
    sequence of the splits gets its ``calib.txt`` and no frames, so that
    each split loads (the dataset raises on a sequence it lacks).  Every frame
    is a street (road, sidewalks, a building and a hedge, cars, poles) made
    from ``numpy.random.RandomState(seed)``.  Returns the label root, the
    configs' ``ann_file`` (their default, ``root/labels``)."""
    from PIL import Image

    from ..tools.kitti_preprocess import process_frame
    from ..utils.semkitti_io import learning_map_inv_lut, learning_map_lut
    from .semantic_kitti import SPLITS

    rng = np.random.RandomState(seed)
    frames = {"00": 2, "08": 2} if frames is None else frames
    inv = learning_map_inv_lut()
    label_root = os.path.join(root, "labels")
    empty = {seq: 0 for split in SPLITS.values() for seq in split if seq not in frames}
    for seq, n in dict(frames, **empty).items():
        seq_dir = os.path.join(root, "dataset", "sequences", seq)
        for d in ("image_2", "velodyne", "voxels"):
            os.makedirs(os.path.join(seq_dir, d), exist_ok=True)
        if int(seq) <= 10:
            os.makedirs(os.path.join(label_root, seq), exist_ok=True)
        with open(os.path.join(seq_dir, "calib.txt"), "w") as f:
            for key, m in (("P0", KITTI_P2 * [1, 1, 1, 0]), ("P1", KITTI_P2 * [1, 1, 1, 0]),
                           ("P2", KITTI_P2), ("P3", KITTI_P2), ("Tr", KITTI_TR)):
                f.write(f"{key}: " + " ".join(f"{v:.12e}" for v in m.reshape(-1)) + "\n")
        for i in range(n):
            fid = f"{i:06d}"
            street = _street(rng)
            Image.fromarray(_image(rng, KITTI_IMAGE)).save(
                os.path.join(seq_dir, "image_2", fid + ".png"))
            _street_scan(rng, street).tofile(os.path.join(seq_dir, "velodyne", fid + ".bin"))
            labels = _street_labels(street)
            vox = os.path.join(seq_dir, "voxels", fid)
            np.packbits((labels > 0) & (labels < 255)).tofile(vox + ".bin")
            if int(seq) > 10:  # the test-submit sequences come without labels
                continue
            inv[np.where(labels == 255, 0, labels)].astype(np.uint16).tofile(vox + ".label")
            np.packbits(labels == 255).tofile(vox + ".invalid")
            process_frame(os.path.join(seq_dir, "voxels"), fid,
                          os.path.join(label_root, seq), learning_map_lut(), scales=(1,))
    return label_root


def kitti_cfg_options(root: str):
    """The ``--cfg-options`` that point a SemanticKITTI config's train, val
    and test splits at a tree (each split's ``data_root``; the labels under
    ``root/labels``)."""
    return [f"data.{split}.data_root={root}" for split in ("train", "val", "test")]
