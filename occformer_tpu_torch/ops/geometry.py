"""LSS camera geometry: frustum creation and camera -> ego unprojection.

Port of ``occformer_tpu/ops/geometry.py`` (reference
ViewTransformerLSSBEVDepth.py:104-150).  ``gen_dx_bx`` and
``create_frustum`` are numpy constants built once per model; the
unprojection and the voxel quantization are batched tensor ops.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch


def gen_dx_bx(xbound, ybound, zbound) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Voxel sizes, first-voxel centers and counts per axis (reference :21-25)."""
    dx = np.array([row[2] for row in (xbound, ybound, zbound)], np.float32)
    bx = np.array([row[0] + row[2] / 2.0 for row in (xbound, ybound, zbound)], np.float32)
    nx = np.array(
        [round((row[1] - row[0]) / row[2]) for row in (xbound, ybound, zbound)], np.int32
    )
    return dx, bx, nx


def create_frustum(
    grid_config: Dict, input_size: Tuple[int, int], downsample: int
) -> np.ndarray:
    """Frustum of (u, v, d) image-plane points, shape ``[D, fH, fW, 3]``."""
    ogfH, ogfW = input_size
    fH, fW = ogfH // downsample, ogfW // downsample
    d0, d1, dstep = grid_config["dbound"]
    ds = np.arange(d0, d1, dstep, dtype=np.float32).reshape(-1, 1, 1)
    D = ds.shape[0]
    ds = np.broadcast_to(ds, (D, fH, fW))
    xs = np.broadcast_to(
        np.linspace(0, ogfW - 1, fW, dtype=np.float32).reshape(1, 1, fW), (D, fH, fW)
    )
    ys = np.broadcast_to(
        np.linspace(0, ogfH - 1, fH, dtype=np.float32).reshape(1, fH, 1), (D, fH, fW)
    )
    return np.stack([xs, ys, ds], axis=-1)


def get_geometry(
    frustum: torch.Tensor,
    rots: torch.Tensor,
    trans: torch.Tensor,
    intrins: torch.Tensor,
    post_rots: torch.Tensor,
    post_trans: torch.Tensor,
    bda: torch.Tensor,
) -> torch.Tensor:
    """Ego-frame xyz of every frustum point: ``[B, N, D, fH, fW, 3]``.

    frustum [D, fH, fW, 3]; rots/post_rots [B, N, 3, 3]; intrins
    [B, N, 3, 3] or KITTI's P2 [B, N, 3, 4], whose shift column is taken off
    the lifted points before the inverse; trans/post_trans [B, N, 3]; bda
    [B, 3, 3] or an affine [B, 4, 4].  All in float32, autocast or not
    (under bf16 autocast the products would run in bf16 and move points by
    up to 2^-9 of their range across voxel borders; ROADMAP §C).
    """
    with torch.autocast(frustum.device.type, enabled=False):
        return _geometry(frustum.float(), rots.float(), trans.float(), intrins.float(),
                         post_rots.float(), post_trans.float(), bda.float())


def _geometry(frustum, rots, trans, intrins, post_rots, post_trans, bda):
    pts = frustum[None, None] - post_trans[:, :, None, None, None, :]
    inv_post = torch.linalg.inv(post_rots)
    pts = torch.einsum("bnij,bndhwj->bndhwi", inv_post, pts)

    # (u, v, d) -> (u*d, v*d, d)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:3]], dim=-1)
    if intrins.shape[-1] == 4:
        pts = pts - intrins[:, :, None, None, None, :3, 3]
        intrins = intrins[..., :3, :3]
    combine = torch.einsum("bnij,bnjk->bnik", rots, torch.linalg.inv(intrins))
    pts = torch.einsum("bnij,bndhwj->bndhwi", combine, pts)
    pts = pts + trans[:, :, None, None, None, :]
    if bda.shape[-1] == 4:
        return torch.einsum("bij,bndhwj->bndhwi", bda[:, :3, :3], pts) \
            + bda[:, None, None, None, None, :3, 3]
    return torch.einsum("bij,bndhwj->bndhwi", bda, pts)


def compute_voxel_coords(
    geom: torch.Tensor, dx: Sequence[float], bx: Sequence[float], nx: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Quantize ego xyz to integer voxel indices plus a validity mask.

    Every point keeps a static slot; invalid ones are masked.  The int cast
    truncates toward zero like torch ``.long()`` in the reference, so ratios
    in (-1, 0) land in voxel 0 and are kept.  Returns (coords int32, valid).
    """
    dx = torch.as_tensor(np.asarray(dx, np.float32), device=geom.device)
    bx = torch.as_tensor(np.asarray(bx, np.float32), device=geom.device)
    nx = torch.as_tensor(np.asarray(nx, np.int32), device=geom.device)
    coords = (geom - (bx - dx / 2.0)) / dx
    coords_i = coords.to(torch.int32)
    valid = ((coords_i >= 0) & (coords_i < nx)).all(dim=-1)
    return coords_i, valid
