"""Lift-Splat-Shoot voxel view transformer and its depth loss.

Port of ``occformer_tpu/models/lss.py:ViewTransformerLiftSplatShootVoxel``
(reference ViewTransformerLSSVoxel.py:12-121): DepthNet -> float32 depth
softmax -> frustum geometry -> fused depth x context scatter into a
``[B, X, Y, Z, C]`` volume (with ``use_voxel_net``, the lifted product is
materialized, refined by ``DepthAggregation`` and splatted by rows); the
temporal BEV alignment ``shift_feature``;
and the depth supervision
(``downsampled_gt_depth``, ``depth_bce_loss``, JAX ``:91-123``).  The reference's ``dx/bx/nx`` grid constants are
registered as buffers so its checkpoints load unchanged; the forward reads
float32 copies of them, whatever dtype the module was cast to.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.geometry import compute_voxel_coords, create_frustum, gen_dx_bx, get_geometry
from ..ops.scatter import voxel_scatter, voxel_scatter_lifted
from ..ops.trilerp_fused import fused_multilevel_gather
from ..parallel.distributed import all_reduce_sum, world_size
from .depthnet import DepthNet, get_mlp_input
from .layers import BatchNorm2d


class DepthAggregation(nn.Module):
    """Refinement of the lifted volume (JAX ``models/lss.py:27-61``,
    reference ViewTransformerLSSBEVDepth.py:506-561): a 3x3 reduce conv,
    BatchNorm and ReLU, a residual pair of 3x3 conv, BatchNorm and ReLU, and
    a 3x3 out conv with bias, over planes [n, C, W, D] (one per camera and
    feature row).  Only built with ``use_voxel_net``; no released config
    sets it."""

    def __init__(self, in_channels: int, mid_channels: int, out_channels: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.reduce_conv = nn.Conv2d(in_channels, mid_channels, 3, padding=1, bias=False,
                                     dtype=dtype)
        self.reduce_bn = BatchNorm2d(mid_channels, dtype=dtype)
        self.conv1 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1, bias=False,
                               dtype=dtype)
        self.bn1 = BatchNorm2d(mid_channels, dtype=dtype)
        self.conv2 = nn.Conv2d(mid_channels, mid_channels, 3, padding=1, bias=False,
                               dtype=dtype)
        self.bn2 = BatchNorm2d(mid_channels, dtype=dtype)
        self.out_conv = nn.Conv2d(mid_channels, out_channels, 3, padding=1, bias=True,
                                  dtype=dtype)

    def forward(self, x):
        y = F.relu(self.reduce_bn(self.reduce_conv(x)))
        z = F.relu(self.bn1(self.conv1(y)))
        z = F.relu(self.bn2(self.conv2(z)))
        return self.out_conv(y + z)


def shift_feature(feat: torch.Tensor, curr2prev: torch.Tensor, bx, dx) -> torch.Tensor:
    """Align a previous frame's BEV feature map to the current ego frame
    (JAX ``models/lss.py:64-88``, reference BEVDet4D.shift_feature
    detectors/bevdepth.py:180-298): each current cell centre goes through
    the 4x4 ``curr2prev`` into the previous frame, where ``feat`` is read
    bilinearly (``align_corners=True`` over the cell centres, zeros outside).
    feat [B, X, Y, C] channels-last; bx / dx the first centre and the cell
    size in (x, y).  Returns [B, X, Y, C] in feat's dtype.

    The read is ``fused_multilevel_gather`` over one level of Z = 1 (the
    DCN's route, ``models/dcn.py``): K4 on the card, whose backward K4-bwd
    sums each cell's gradient in a fixed order; its plain version
    (``F.grid_sample``) on the CPU."""
    B, X, Y, C = feat.shape
    dev = feat.device
    with torch.autocast(dev.type, enabled=False):  # the coordinates in float32
        xs = torch.arange(X, dtype=torch.float32, device=dev) * float(dx[0]) + float(bx[0])
        ys = torch.arange(Y, dtype=torch.float32, device=dev) * float(dx[1]) + float(bx[1])
        gx, gy = torch.meshgrid(xs, ys, indexing="ij")
        pts = torch.stack([gx, gy, torch.zeros_like(gx), torch.ones_like(gx)], -1)  # [X, Y, 4]
        prev = torch.einsum("bij,xyj->bxyi", curr2prev.float(), pts)
        u = (prev[..., 0] - float(bx[0])) / float(dx[0])
        v = (prev[..., 1] - float(bx[1])) / float(dx[1])
        nu = u / (X - 1) * 2 - 1 if X > 1 else torch.zeros_like(u)
        nv = v / (Y - 1) * 2 - 1 if Y > 1 else torch.zeros_like(v)
        coords = torch.stack([nu, nv, torch.zeros_like(nu)], -1).reshape(B, X * Y, 3)
    out = fused_multilevel_gather([feat.reshape(B, X * Y, C).contiguous()], [(X, Y, 1)], C,
                                  [coords.contiguous()], align_corners=True)[0]
    return out.transpose(1, 2).reshape(B, X, Y, C)


def downsampled_gt_depth(gt_depths: torch.Tensor, grid_config: Dict, downsample: int,
                         D: int) -> torch.Tensor:
    """[B, N, H, W] sparse depth -> one-hot [B*N*fH*fW, D] float32: the
    nearest non-zero return of each downsample cell (zeros are no return),
    binned by ``dbound``; cells with no return or outside the bins get an
    all-zero row (reference ViewTransformerLSSVoxel.py:27-52)."""
    B, N, H, W = gt_depths.shape
    ds = downsample
    g = gt_depths.float().reshape(B * N, H // ds, ds, W // ds, ds)
    g = g.permute(0, 1, 3, 2, 4).reshape(-1, ds * ds)
    g = torch.where(g == 0.0, torch.full_like(g, 1e5), g).min(dim=-1).values
    d0, _, dstep = grid_config["dbound"]
    g = (g - (d0 - dstep / 2.0)) / dstep
    g = torch.where((g < D + 1) & (g >= 0.0), g, torch.zeros_like(g))
    return F.one_hot(g.long(), D + 1)[:, 1:].float()


def depth_bce_loss(gt_depths: torch.Tensor, depth_prob: torch.Tensor, grid_config: Dict,
                   downsample: int, weight: float = 1.0) -> torch.Tensor:
    """BCE depth loss over the cells with a target, float32 (reference
    ViewTransformerLSSVoxel.py:54-75); ``depth_prob`` [..., D].  Under data
    parallelism the count of cells with a target is summed over ranks and
    the loss scaled as ``losses/mask2former_loss.py:_layer_losses`` scales
    its own."""
    D = depth_prob.shape[-1]
    labels = downsampled_gt_depth(gt_depths, grid_config, downsample, D)
    preds = depth_prob.reshape(-1, D).float()
    fg = (labels.max(dim=1).values > 0.0).float()
    eps = 1e-12
    bce = -(labels * torch.log(preds.clamp(min=eps))
            + (1.0 - labels) * torch.log((1.0 - preds).clamp(min=eps)))
    per_cell = bce.clamp(0.0, 100.0).sum(dim=1) * fg
    return world_size() * weight * per_cell.sum() / all_reduce_sum(fg.sum()).clamp(min=1.0)


class ViewTransformerLiftSplatShootVoxel(nn.Module):
    """forward(x [B, N, Cin, fH, fW], rots, trans, intrins, post_rots,
    post_trans, bda) -> (volume [B, X, Y, Z, C], depth_prob [B*N, fH, fW, D]).

    With ``use_voxel_net`` the lift depth x context is materialized as
    planes [B*N*fH, C, fW, D] (channels-last in memory: each (camera, row,
    column, depth bin) point's C features contiguous), refined by
    ``depth_aggregation_net`` and summed into the volume by
    ``ops/scatter.py:voxel_scatter`` (S1-rows on the card), its points in
    (camera, row, column, depth bin) order (JAX ``models/lss.py:193-210``,
    whose points run (camera, depth bin, row, column))."""

    def __init__(self, grid_config: Dict, data_config: Dict, numC_input: int = 512,
                 numC_Trans: int = 128, downsample: int = 16, cam_channels: int = 27,
                 loss_depth_weight: float = 1.0, use_voxel_net: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid_config = dict(grid_config)
        self.downsample = downsample
        self.loss_depth_weight = loss_depth_weight
        self.numC_Trans = numC_Trans
        self._dx, self._bx, self._nx = gen_dx_bx(
            grid_config["xbound"], grid_config["ybound"], grid_config["zbound"])
        self.register_buffer("dx", torch.from_numpy(self._dx.copy()))
        self.register_buffer("bx", torch.from_numpy(self._bx.copy()))
        self.register_buffer("nx", torch.from_numpy(self._nx.astype(np.float32)))
        self._frustum = create_frustum(grid_config, tuple(data_config["input_size"]),
                                       downsample)
        self.D = self._frustum.shape[0]
        self.depth_net = DepthNet(numC_input, numC_Trans, self.D,
                                  cam_channels=cam_channels, dtype=dtype)
        self.use_voxel_net = use_voxel_net
        if use_voxel_net:
            self.depth_aggregation_net = DepthAggregation(numC_Trans, numC_Trans, numC_Trans,
                                                          dtype=dtype)

    def forward(self, x, rots, trans, intrins, post_rots, post_trans, bda):
        B, N, Cin, fH, fW = x.shape
        mlp_input = get_mlp_input(rots, trans, intrins, post_rots, post_trans, bda)
        depth_digit, ctx = self.depth_net(x.reshape(B * N, Cin, fH, fW),
                                          mlp_input.reshape(B * N, -1))
        # float32 island for the depth softmax (reference @force_fp32)
        depth_prob = torch.softmax(depth_digit.float(), dim=1)  # [B*N, D, fH, fW]

        frustum = torch.from_numpy(self._frustum).to(x.device)
        geom = get_geometry(frustum, rots, trans, intrins, post_rots, post_trans, bda)
        coords, valid = compute_voxel_coords(geom, self._dx, self._bx, self._nx)

        depth_bn = depth_prob.reshape(B, N, self.D, fH, fW).to(x.dtype)
        ctx = ctx.reshape(B, N, self.numC_Trans, fH, fW).permute(0, 1, 3, 4, 2)
        if self.use_voxel_net:
            volume = self._voxel_net_splat(depth_bn, ctx, coords, valid)
        else:
            volume = voxel_scatter_lifted(depth_bn, ctx, coords, valid, self._nx)
        return volume, depth_prob.permute(0, 2, 3, 1)

    def _voxel_net_splat(self, depth, ctx, coords, valid):
        """depth [B, N, D, fH, fW], ctx [B, N, fH, fW, C] -> the refined lift
        summed into [B, X, Y, Z, C]."""
        B, N, D, fH, fW = depth.shape
        C = ctx.shape[-1]
        lifted = depth.permute(0, 1, 3, 4, 2)[..., None] * ctx[:, :, :, :, None, :]
        planes = lifted.reshape(B * N * fH, fW, D, C).permute(0, 3, 1, 2)  # channels-last
        with record_function("stage:depth_aggregation"):
            planes = self.depth_aggregation_net(planes)        # [B*N*fH, C, fW, D]
        rows = planes.permute(0, 2, 3, 1).reshape(B, N * fH * fW * D, C)
        order = (0, 1, 3, 4, 2)                               # points as (n, h, w, d)
        return voxel_scatter(rows, coords.permute(*order, 5).reshape(B, -1, 3),
                             valid.permute(*order).reshape(B, -1), self._nx)
