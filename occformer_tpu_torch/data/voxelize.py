"""Occupancy-label voxelization + BEV-data augmentation (CPU, numpy).

The port's copy of ``occformer_tpu/data/voxelize.py`` (reference
projects/mmdet3d_plugin/datasets/pipelines/loading_nusc_occ.py), nuScenes
steps.  Majority voting runs in the native library (``data/native.py``,
the reference's numba kernel, loading_nusc_occ.py:122-138);
``majority_vote_plain`` is the JAX package's vectorized numpy groupby
(lexsort by (voxel, -count, label), first per voxel), the plain version with
the same tie-breaking (smallest label id wins).  ``LoadSemKittiAnnotation``
loads SemanticKITTI's preprocessed voxel labels and flips them about the
range's centre (a 4x4 BDA).  ``LoadNuscPanopticOccupancyAnnotations`` loads
the panoptic labels (``class * 1000 + instance``) and votes them into the
grid with noise suppressed.
"""
from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
from PIL import Image

from ..registry import PIPELINES
from .native import majority_vote_native
from .transforms import step_rng

# nuScenes lidarseg 32 -> 16 learning map (projects/configs/_base_/nuscenes.yaml)
NUSC_LEARNING_MAP = {
    0: 0, 1: 0, 2: 7, 3: 7, 4: 7, 5: 0, 6: 7, 7: 0, 8: 0, 9: 1, 10: 0,
    11: 0, 12: 8, 13: 0, 14: 2, 15: 3, 16: 3, 17: 4, 18: 5, 19: 0, 20: 0,
    21: 6, 22: 9, 23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 29: 0,
    30: 16, 31: 0,
}


def majority_vote_voxelize(
    points: np.ndarray,
    labels: np.ndarray,
    grid_size: Sequence[int],
    point_cloud_range: Sequence[float],
    empty_id: int,
    label_space: int = 256,
    suppress_zero: bool = False,
) -> np.ndarray:
    """Majority-vote point labels into a dense voxel grid.

    Equivalent to the reference's sort + nb_process_label
    (loading_nusc_occ.py:97-138): clip points into range, floor-quantize,
    per-voxel argmax of label counts (ties -> smallest label id), empty
    voxels get ``empty_id``.  ``suppress_zero`` reproduces the panoptic
    kernel's behaviour (loading_nusc_panoptic_occ.py:148-170): label 0
    (noise) never outvotes a real label but survives when alone.
    """
    flat = _flat_voxel_index(points, grid_size, point_cloud_range)
    dtype = np.uint8 if label_space <= 256 else np.int64
    out = majority_vote_native(flat, labels.astype(np.int64).reshape(-1),
                               int(np.prod(grid_size)), empty_id, suppress_zero=suppress_zero)
    return out.astype(dtype).reshape(tuple(int(g) for g in grid_size))


def _flat_voxel_index(points, grid_size, point_cloud_range) -> np.ndarray:
    """Each point's linear voxel index: clipped into the range, floored."""
    grid_size = np.asarray(grid_size, np.int64)
    pcr = np.asarray(point_cloud_range, np.float64)
    voxel_size = (pcr[3:] - pcr[:3]) / grid_size
    eps = 1e-5
    pts = np.clip(points[:, :3], pcr[:3], pcr[3:] - eps)
    idx = np.floor((pts - pcr[:3]) / voxel_size).astype(np.int64)
    return (idx[:, 0] * grid_size[1] + idx[:, 1]) * grid_size[2] + idx[:, 2]


def majority_vote_plain(points, labels, grid_size, point_cloud_range, empty_id: int,
                        label_space: int = 256, suppress_zero: bool = False) -> np.ndarray:
    """``majority_vote_voxelize`` in numpy (the JAX package's fallback): the
    plain version of the native kernel."""
    grid_size = np.asarray(grid_size, np.int64)
    flat = _flat_voxel_index(points, grid_size, point_cloud_range)
    labels = labels.astype(np.int64).reshape(-1)
    # count (voxel, label) pairs
    key = flat * label_space + labels
    uniq, counts = np.unique(key, return_counts=True)
    vox = uniq // label_space
    lab = uniq % label_space
    if suppress_zero:
        # zero label wins only when nothing else is present
        counts = np.where(lab == 0, 0, counts)
    # order: voxel asc, count desc, label asc -> first row per voxel wins
    order = np.lexsort((lab, -counts, vox))
    vox, lab = vox[order], lab[order]
    first = np.ones(len(vox), bool)
    first[1:] = vox[1:] != vox[:-1]

    dtype = np.uint8 if label_space <= 256 else np.int64
    out = np.full(int(np.prod(grid_size)), empty_id, dtype)
    out[vox[first]] = lab[first].astype(dtype)
    return out.reshape(tuple(grid_size))


def sample_3d_augmentation(bda_aug_conf: Dict, rng: np.random.RandomState):
    """BDA sampling (loading_nusc_occ.py:47-57)."""
    rotate = rng.uniform(*bda_aug_conf["rot_lim"])
    scale = rng.uniform(*bda_aug_conf["scale_lim"])
    flip_dx = rng.uniform() < bda_aug_conf["flip_dx_ratio"]
    flip_dy = rng.uniform() < bda_aug_conf["flip_dy_ratio"]
    flip_dz = rng.uniform() < bda_aug_conf.get("flip_dz_ratio", 0.0)
    return rotate, scale, flip_dx, flip_dy, flip_dz


def bda_matrix(rotate_deg: float, flip_dx: bool, flip_dy: bool, flip_dz: bool) -> np.ndarray:
    """flip @ rot 3x3 (loading_nusc_occ.py:141-180; scale is sampled but
    unused by the reference)."""
    a = np.deg2rad(rotate_deg)
    rot = np.array(
        [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
        np.float32,
    )
    flip = np.eye(3, dtype=np.float32)
    if flip_dx:
        flip = flip @ np.diag([-1.0, 1.0, 1.0]).astype(np.float32)
    if flip_dy:
        flip = flip @ np.diag([1.0, -1.0, 1.0]).astype(np.float32)
    if flip_dz:
        flip = flip @ np.diag([1.0, 1.0, -1.0]).astype(np.float32)
    return (flip @ rot).astype(np.float32)


def custom_rotate_3d(voxel_labels: np.ndarray, rotate_deg: float) -> np.ndarray:
    """Per-z-slice nearest BEV rotation with 255 fill
    (loading_nusc_occ.py:206-225)."""
    out = []
    for z in range(voxel_labels.shape[-1]):
        img = Image.fromarray(voxel_labels[..., z].astype(np.uint8))
        img = img.rotate(rotate_deg, resample=Image.Resampling.NEAREST, fillcolor=255)
        out.append(np.array(img))
    return np.stack(out, axis=-1)


def voxel_transform(
    voxel_labels: Optional[np.ndarray],
    rotate_deg: float,
    scale_ratio: float,
    flip_dx: bool,
    flip_dy: bool,
    flip_dz: bool,
    transform_center: Optional[np.ndarray] = None,
) -> Tuple[Optional[np.ndarray], np.ndarray]:
    """Apply BDA to a voxel label grid; return (labels, bda).

    nuScenes: origin-centered 3x3 (loading_nusc_occ.py:141-203).
    SemanticKITTI: center-normalized 4x4 ``denorm @ flip @ rot @ norm``
    because the x-range starts at 0 (loading_kitti_occ.py:57-105).
    """
    bda3 = bda_matrix(rotate_deg, flip_dx, flip_dy, flip_dz)
    if transform_center is not None:
        c = np.asarray(transform_center, np.float32)
        norm = np.eye(4, dtype=np.float32)
        norm[:3, 3] = -c
        denorm = np.eye(4, dtype=np.float32)
        denorm[:3, 3] = c
        m = np.eye(4, dtype=np.float32)
        m[:3, :3] = bda3
        bda = denorm @ m @ norm
    else:
        bda = bda3
    if voxel_labels is not None:
        v = voxel_labels.astype(np.uint8)
        if not np.isclose(rotate_deg, 0):
            v = custom_rotate_3d(v, rotate_deg)
        if flip_dz:
            v = v[:, :, ::-1]
        if flip_dy:
            v = v[:, ::-1]
        if flip_dx:
            v = v[::-1]
        voxel_labels = v.copy().astype(np.int64)
    return voxel_labels, bda


@PIPELINES.register_module()
class LoadNuscOccupancyAnnotations:
    """LiDAR-seg loading, BDA aug, majority-vote voxelization
    (loading_nusc_occ.py:14-120).  The BDA draws come from ``step_rng``: the
    sample's RandomState, or the step's own where ``seed`` gives one."""

    def __init__(self, data_root="data/nuscenes", is_train=False,
                 is_test_submit=False, grid_size=None, point_cloud_range=None,
                 bda_aug_conf=None, unoccupied_id=17, cls_metas=None,
                 seed: Optional[int] = None):
        self.data_root = data_root
        self.is_train = is_train
        self.is_test_submit = is_test_submit
        self.grid_size = np.asarray(grid_size)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float64)
        self.bda_aug_conf = bda_aug_conf
        self.unoccupied_id = unoccupied_id
        self.rng = None if seed is None else np.random.RandomState(seed)
        if cls_metas is not None and os.path.exists(str(cls_metas)):
            import yaml

            with open(cls_metas) as f:
                self.learning_map = yaml.safe_load(f)["learning_map"]
        else:
            self.learning_map = NUSC_LEARNING_MAP
        lut = np.zeros(max(self.learning_map) + 1, np.uint8)
        for k, v in self.learning_map.items():
            lut[k] = v
        self.lut = lut

    def __call__(self, results: Dict) -> Dict:
        points = np.fromfile(results["pts_filename"], dtype=np.float32).reshape(-1, 5)[:, :3]

        if self.is_test_submit:
            results["bda"] = np.eye(3, dtype=np.float32)
            results["points_occ"] = np.concatenate(
                [points, np.zeros((points.shape[0], 1), np.float32)], axis=-1
            )
            results["points_lidar"] = points
            return results

        raw = np.fromfile(
            os.path.join(self.data_root, results["lidarseg"]), dtype=np.uint8
        )
        labels = self.lut[raw].astype(np.float32).reshape(-1, 1)

        if self.is_train:
            rot, scale, fdx, fdy, fdz = sample_3d_augmentation(self.bda_aug_conf,
                                                               step_rng(self, results))
            bda = bda_matrix(rot, fdx, fdy, fdz)
        else:
            bda = np.eye(3, dtype=np.float32)
        points = points @ bda.T
        lidarseg = np.concatenate([points, labels], axis=-1)

        vox = majority_vote_voxelize(
            points, labels, self.grid_size, self.point_cloud_range,
            empty_id=self.unoccupied_id,
        ).astype(np.int64)
        # 0 (noise) -> 255 ignored; empty id -> class 0
        vox[vox == 0] = 255
        vox[vox == self.unoccupied_id] = 0

        results["gt_occ"] = vox
        results["points_occ"] = lidarseg.astype(np.float32)
        results["points_lidar"] = points.astype(np.float32)
        results["bda"] = bda
        return results


@PIPELINES.register_module()
class LoadSemKittiAnnotation:
    """The preprocessed 1_1 voxel labels and the BDA flips about the range's
    centre (loading_kitti_occ.py:8-54): KITTI's x range starts at 0, so the
    4x4 BDA is ``denorm @ flip @ rot @ norm`` about ``transform_center``.
    The test-submit split has no labels: ``gt_occ`` None and the identity.
    The draws come from ``step_rng``: the sample's RandomState, or the
    step's own where ``seed`` gives one."""

    def __init__(self, is_train=False, point_cloud_range=None, bda_aug_conf=None,
                 seed: Optional[int] = None):
        self.is_train = is_train
        self.bda_aug_conf = bda_aug_conf
        pcr = np.asarray(point_cloud_range if point_cloud_range is not None
                         else [0, -25.6, -2, 51.2, 25.6, 4.4], np.float32)
        self.transform_center = (pcr[:3] + pcr[3:]) / 2
        self.rng = None if seed is None else np.random.RandomState(seed)

    def __call__(self, results: Dict) -> Dict:
        gt_occ = results.get("gt_occ_1_1", results.get("gt_occ"))
        if gt_occ is None and results.get("voxel_label_path"):
            gt_occ = np.load(results["voxel_label_path"])
        if gt_occ is None:  # the test-submit split has no labels
            results["gt_occ"] = None
            results["bda"] = np.eye(4, dtype=np.float32)
            return results
        if self.is_train:
            rot, scale, fdx, fdy, fdz = sample_3d_augmentation(self.bda_aug_conf,
                                                               step_rng(self, results))
            gt_occ, bda = voxel_transform(np.asarray(gt_occ), rot, scale, fdx, fdy, fdz,
                                          transform_center=self.transform_center)
        else:
            bda = np.eye(4, dtype=np.float32)
            gt_occ = np.asarray(gt_occ).astype(np.int64)
        results["gt_occ"] = gt_occ
        results["bda"] = bda
        return results


@PIPELINES.register_module()
class LoadNuscPanopticOccupancyAnnotations:
    """Panoptic labels ``class * 1000 + instance`` from the sample's ``.npz``
    sidecar (``panoptic/<version>/<token>_panoptic.npz``, beside the
    lidarseg file), the learning map applied to the class part, BDA,
    majority voting with noise suppressed (reference
    loading_nusc_panoptic_occ.py:33-170): noise (0) becomes 65535, empty
    voxels 0.  Also the padded table of the sample's panoptic ids the loss
    reads (``losses/mask2former_loss.py:preprocess_panoptic_gt``):
    ``panoptic_ids [max_instances]``, the first ``max_instances`` ids of the
    grid in ascending order (stuff ``class * 1000`` included), -1 after
    them; with more segments than that the largest ids (the stuff classes
    11-16) are dropped, as in the JAX package.  The BDA draws come from
    ``step_rng``: the sample's RandomState, or the step's own where ``seed``
    gives one."""

    def __init__(self, data_root="data/nuscenes", is_train=False,
                 is_test_submit=False, grid_size=None, point_cloud_range=None,
                 bda_aug_conf=None, unoccupied_id=17, max_instances=100,
                 cls_metas=None, seed: Optional[int] = None):
        self.data_root = data_root
        self.is_train = is_train
        self.is_test_submit = is_test_submit
        self.grid_size = np.asarray(grid_size)
        self.point_cloud_range = np.asarray(point_cloud_range, np.float64)
        self.bda_aug_conf = bda_aug_conf
        self.unoccupied_id = unoccupied_id
        self.max_instances = max_instances
        self.rng = None if seed is None else np.random.RandomState(seed)
        self.learning_map = NUSC_LEARNING_MAP

    def __call__(self, results: Dict) -> Dict:
        points = np.fromfile(results["pts_filename"], dtype=np.float32).reshape(-1, 5)[:, :3]
        if self.is_test_submit:
            results["bda"] = np.eye(3, dtype=np.float32)
            results["points_occ"] = np.concatenate(
                [points, np.zeros((points.shape[0], 1), np.float32)], axis=-1)
            results["points_lidar"] = points
            return results

        pan_file = results["lidarseg"].replace("lidarseg", "panoptic").replace(".bin", ".npz")
        panoptic = np.load(os.path.join(self.data_root, pan_file))["data"].astype(np.int64)
        semantic = panoptic // 1000
        # the class part through the learning map, the instance part kept
        for sem_id in np.unique(semantic):
            m = semantic == sem_id
            mapped = self.learning_map[int(sem_id)]
            panoptic[m] = mapped * 1000 + (panoptic[m] - sem_id * 1000)
            semantic[m] = mapped

        if self.is_train:
            rot, scale, fdx, fdy, fdz = sample_3d_augmentation(self.bda_aug_conf,
                                                               step_rng(self, results))
            bda = bda_matrix(rot, fdx, fdy, fdz)
        else:
            bda = np.eye(3, dtype=np.float32)
        points = points @ bda.T
        lidarseg = np.concatenate(
            [points, panoptic.reshape(-1, 1).astype(np.float32)], axis=-1)

        empty_id = self.unoccupied_id * 1000
        vox = majority_vote_voxelize(
            points, panoptic, self.grid_size, self.point_cloud_range,
            empty_id=empty_id, label_space=65536, suppress_zero=True,
        ).astype(np.int64)
        vox[vox == 0] = 65535        # noise: ignored
        vox[vox == empty_id] = 0     # empty: 0

        # the padded id table: static shapes for the loss's GT slots
        ids = np.unique(vox)
        ids = ids[(ids > 0) & (ids < self.unoccupied_id * 1000)]
        ids = ids[: self.max_instances]
        pad = np.full(self.max_instances, -1, np.int64)
        pad[: len(ids)] = ids

        results["gt_occ"] = vox
        results["panoptic_ids"] = pad
        results["points_occ"] = lidarseg.astype(np.float32)
        results["points_lidar"] = points.astype(np.float32)
        results["bda"] = bda
        return results
