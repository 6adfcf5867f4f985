"""CPU-side image loading, augmentation and LiDAR->depth projection.

The port's copy of ``occformer_tpu/data/transforms.py`` (reference
projects/mmdet3d_plugin/datasets/pipelines/{loading_nusc_imgs.py,
lidar2depth.py}), nuScenes steps: numpy + PIL, the same draws from each
step's ``RandomState`` in the same order and PIL's same resample modes, so a
seeded step gives the JAX package's sample bit for bit.  The resize / crop /
flip / rotate augmentation is tracked as a 2D homography (post_rot,
post_tran) so the LSS geometry can undo it on the card.  The depth maps are
z-buffered by the native library (``data/native.py``); ``zbuffer_depth_plain``
is the JAX package's numpy formulation, the plain version.  SemanticKITTI's
monocular loader (``LoadMultiViewImageFromFiles_SemanticKitti``) keeps its
3x4 P2 as the intrinsics.

Outputs use the batch conventions of the model: images are channels-last
float32 [N, H, W, 3]; geometry arrays match ``ops/geometry.py:get_geometry``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from PIL import Image

from ..registry import PIPELINES
from .native import zbuffer_depth_native

def step_rng(step, results: Dict) -> np.random.RandomState:
    """The ``RandomState`` a pipeline step draws from: its own ``rng`` where
    one was set (a ``seed`` argument, or a test seeding it as the JAX
    package's tests do), else the sample's, ``results["aug_rng"]``, which
    the dataset addresses by (seed, epoch, index)."""
    if step.rng is not None:
        return step.rng
    if "aug_rng" not in results:
        raise KeyError(f"{type(step).__name__} draws from results['aug_rng'] (set by the "
                       "dataset) or from its own rng (its seed argument); neither is set")
    return results["aug_rng"]


def get_rot(h: float) -> np.ndarray:
    """2D rotation used by the aug homography (loading_nusc_imgs.py:28-32)."""
    return np.array(
        [[np.cos(h), np.sin(h)], [-np.sin(h), np.cos(h)]], np.float32
    )


def img_transform_matrices(
    resize: float,
    crop: Tuple[int, int, int, int],
    flip: bool,
    rotate_deg: float,
    post_rot: Optional[np.ndarray] = None,
    post_tran: Optional[np.ndarray] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Accumulate the augmentation homography (loading_nusc_imgs.py:34-52)."""
    post_rot = np.eye(2, dtype=np.float32) if post_rot is None else post_rot.copy()
    post_tran = np.zeros(2, dtype=np.float32) if post_tran is None else post_tran.copy()

    post_rot = post_rot * resize
    post_tran = post_tran - np.array(crop[:2], np.float32)
    if flip:
        A = np.array([[-1, 0], [0, 1]], np.float32)
        b = np.array([crop[2] - crop[0], 0], np.float32)
        post_rot = A @ post_rot
        post_tran = A @ post_tran + b
    A = get_rot(rotate_deg / 180.0 * np.pi)
    b = np.array([crop[2] - crop[0], crop[3] - crop[1]], np.float32) / 2.0
    b = A @ (-b) + b
    post_rot = A @ post_rot
    post_tran = A @ post_tran + b
    return post_rot, post_tran


def img_transform_core(img: Image.Image, resize_dims, crop, flip, rotate_deg):
    img = img.resize(resize_dims)
    img = img.crop(crop)
    if flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate_deg)
    return img


def mmlab_normalize(img: Image.Image, img_norm_cfg=None) -> np.ndarray:
    """uint8 PIL -> normalized float32 [H, W, 3] (loading_nusc_imgs.py:181-195).

    mmcv semantics: images are read BGR; ``to_rgb=True`` converts to RGB
    before normalizing (torchvision-style configs, RGB means), while
    ``to_rgb=False`` keeps BGR — the caffe-pretrained R101-DCN consumes BGR
    with BGR-ordered means (r101 config img_norm_cfg).  PIL gives RGB, so
    to_rgb=True needs no swap and to_rgb=False swaps RGB -> BGR here.
    """
    if img_norm_cfg is None:
        mean = np.array([123.675, 116.28, 103.53], np.float32)
        std = np.array([58.395, 57.12, 57.375], np.float32)
        to_rgb = True
    else:
        mean = np.asarray(img_norm_cfg["mean"], np.float32)
        std = np.asarray(img_norm_cfg["std"], np.float32)
        to_rgb = bool(img_norm_cfg.get("to_rgb", True))
    arr = np.asarray(img, np.float32)
    if not to_rgb:
        arr = arr[:, :, ::-1]  # network consumes BGR (caffe-style weights)
    return (arr - mean) / std


def sample_augmentation(
    data_config: Dict,
    H: int,
    W: int,
    is_train: bool,
    rng: np.random.RandomState,
    flip=None,
    scale=None,
):
    """Resize/crop/flip/rotate sampling (loading_nusc_imgs.py:73-97)."""
    fH, fW = data_config["input_size"]
    if is_train:
        resize = float(fW) / float(W)
        resize += rng.uniform(*data_config["resize"])
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*data_config["crop_h"])) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(data_config.get("flip", False)) and bool(rng.choice([0, 1]))
        rotate = rng.uniform(*data_config["rot"])
    else:
        resize = float(fW) / float(W)
        resize += data_config.get("resize_test", 0.0)
        if scale is not None:
            resize = scale
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(data_config["crop_h"])) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False if flip is None else flip
        rotate = 0.0
    return resize, resize_dims, crop, flip, rotate


@PIPELINES.register_module()
class LoadMultiViewImageFromFiles_OccFormer:
    """nuScenes multi-view image loading + per-camera aug
    (loading_nusc_imgs.py:10-179).  The draws come from ``step_rng``: the
    sample's RandomState, or the step's own where ``seed`` gives one."""

    def __init__(self, data_config, is_train=False, img_norm_cfg=None,
                 seed: Optional[int] = None):
        self.data_config = dict(data_config)
        self.is_train = is_train
        self.img_norm_cfg = img_norm_cfg
        self.rng = None if seed is None else np.random.RandomState(seed)

    def choose_cams(self, rng: np.random.RandomState):
        cams = self.data_config["cams"]
        n = self.data_config["Ncams"]
        if self.is_train and n < len(cams):
            return list(rng.choice(cams, n, replace=False))
        return list(cams)

    def __call__(self, results: Dict) -> Dict:
        imgs, rots, trans, intrins = [], [], [], []
        post_rots, post_trans, sensor2sensors = [], [], []
        rng = step_rng(self, results)
        cam_names = self.choose_cams(rng)
        results["cam_names"] = cam_names
        for cam in cam_names:
            cam_data = results["curr"]["cams"][cam]
            img = Image.open(cam_data["data_path"]).convert("RGB")
            intrin = np.asarray(cam_data["cam_intrinsic"], np.float32)
            sensor2lidar = np.linalg.inv(
                np.asarray(results["lidar2cam_dic"][cam], np.float64)
            ).astype(np.float32)
            resize, resize_dims, crop, flip, rotate = sample_augmentation(
                self.data_config, img.height, img.width, self.is_train, rng
            )
            img = img_transform_core(img, resize_dims, crop, flip, rotate)
            pr2, pt2 = img_transform_matrices(resize, crop, flip, rotate)
            post_rot = np.eye(3, dtype=np.float32)
            post_tran = np.zeros(3, dtype=np.float32)
            post_rot[:2, :2] = pr2
            post_tran[:2] = pt2

            imgs.append(mmlab_normalize(img, self.img_norm_cfg))
            rots.append(sensor2lidar[:3, :3])
            trans.append(sensor2lidar[:3, 3])
            intrins.append(intrin)
            post_rots.append(post_rot)
            post_trans.append(post_tran)
            sensor2sensors.append(sensor2lidar)

        results["imgs"] = np.stack(imgs)
        results["rots"] = np.stack(rots)
        results["trans"] = np.stack(trans)
        results["intrins"] = np.stack(intrins)
        results["post_rots"] = np.stack(post_rots)
        results["post_trans"] = np.stack(post_trans)
        results["sensor2sensors"] = np.stack(sensor2sensors)
        return results


@PIPELINES.register_module()
class LoadMultiViewImageFromFiles_SemanticKitti:
    """Monocular KITTI image loading (loading_kitti_imgs.py:12-145): the
    extrinsics from lidar2cam, the intrinsics the 3x4 P2 matrix.  The draws
    come from ``step_rng``: the sample's RandomState, or the step's own where
    ``seed`` gives one."""

    def __init__(self, data_config, is_train=False, img_norm_cfg=None,
                 seed: Optional[int] = None):
        self.data_config = dict(data_config)
        self.is_train = is_train
        self.img_norm_cfg = img_norm_cfg
        self.rng = None if seed is None else np.random.RandomState(seed)

    def __call__(self, results: Dict) -> Dict:
        img = Image.open(results["img_filename"]).convert("RGB")
        lidar2cam = np.asarray(results["lidar2cam"], np.float64)
        cam2lidar = np.linalg.inv(lidar2cam).astype(np.float32)
        intrin = np.asarray(results["cam_intrinsic"], np.float32)  # 3x4 P2

        resize, resize_dims, crop, flip, rotate = sample_augmentation(
            self.data_config, img.height, img.width, self.is_train,
            step_rng(self, results) if self.is_train else None)
        img = img_transform_core(img, resize_dims, crop, flip, rotate)
        pr2, pt2 = img_transform_matrices(resize, crop, flip, rotate)
        post_rot = np.eye(3, dtype=np.float32)
        post_tran = np.zeros(3, dtype=np.float32)
        post_rot[:2, :2] = pr2
        post_tran[:2] = pt2

        results["imgs"] = mmlab_normalize(img, self.img_norm_cfg)[None]
        results["rots"] = cam2lidar[None, :3, :3]
        results["trans"] = cam2lidar[None, :3, 3]
        results["intrins"] = intrin[None, :3, :4]
        results["post_rots"] = post_rot[None]
        results["post_trans"] = post_tran[None]
        results["sensor2sensors"] = cam2lidar[None]
        return results


@PIPELINES.register_module()
class CreateDepthFromLiDAR:
    """Project LiDAR into each view, z-buffer sparse GT depth maps
    (lidar2depth.py:9-87): per pixel the nearest return, by the native
    z-buffer (the JAX package sorts by descending depth and writes the
    nearest last: the same map, ``zbuffer_depth_plain``).

    Loads the RAW point cloud from ``pts_filename`` itself (reference
    lidar2depth.py:41-50) — the depth targets must be in the un-augmented
    lidar frame, since the cameras are not BDA-transformed (BDA is applied
    to the lifted volume inside the model, not to the images)."""

    def __init__(self, dataset="nusc", data_root=None):
        if dataset not in ("nusc", "kitti"):
            raise ValueError(f"dataset must be 'nusc' or 'kitti'; got {dataset!r}")
        self.dataset = dataset
        self.data_root = data_root  # reference API parity (unused: the
        # datasets here always provide an absolute pts_filename)

    def __call__(self, results: Dict) -> Dict:
        H, W = results["imgs"].shape[1:3]
        N = results["imgs"].shape[0]
        width = 5 if self.dataset == "nusc" else 4  # kitti: x,y,z,intensity
        points = np.fromfile(results["pts_filename"], dtype=np.float32)
        points = points.reshape(-1, width)[:, :3]

        depth_maps = np.zeros((N, H, W), np.float32)
        for i in range(N):
            lidar2cam_r = np.linalg.inv(results["rots"][i])
            lidar2cam_t = -lidar2cam_r @ results["trans"][i]
            cam_pts = points @ lidar2cam_r.T + lidar2cam_t
            intrin = results["intrins"][i]
            if intrin.shape[-1] == 4:  # KITTI P2
                hom = np.concatenate([cam_pts, np.ones_like(cam_pts[:, :1])], 1)
                proj = hom @ intrin.T
            else:
                proj = cam_pts @ intrin.T
            z = proj[:, 2]
            uv = proj[:, :2] / np.maximum(z[:, None], 1e-5)
            # apply the image aug homography
            uv = uv @ results["post_rots"][i][:2, :2].T + results["post_trans"][i][:2]
            # reference valid mask + nearest-pixel rounding (lidar2depth.py:60-77)
            valid = (z > 0) & (uv[:, 0] >= 0) & (uv[:, 0] <= W - 1) \
                & (uv[:, 1] >= 0) & (uv[:, 1] <= H - 1)
            u = np.rint(uv[valid, 0]).astype(np.int32)
            v = np.rint(uv[valid, 1]).astype(np.int32)
            depth_maps[i] = zbuffer_depth_native(u, v, z[valid], np.ones(len(u), np.uint8),
                                                 H, W)
        results["gt_depth"] = depth_maps
        return results


def zbuffer_depth_plain(u: np.ndarray, v: np.ndarray, d: np.ndarray, h: int,
                        w: int) -> np.ndarray:
    """The JAX package's numpy z-buffer (nearest written last wins): [h, w]
    float32, per pixel the smallest of the depths ``d`` > 0 that fall on it,
    0 elsewhere.  The plain version of ``zbuffer_depth_native``."""
    depth = np.zeros((h, w), np.float32)
    order = np.argsort(-d)
    depth[v[order], u[order]] = d[order]
    return depth
