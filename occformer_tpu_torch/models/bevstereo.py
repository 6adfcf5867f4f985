"""BEVStereo view transformer: temporal-stereo EM depth with homography cost
volumes.

Port of ``occformer_tpu/models/bevstereo.py`` (reference
ViewTransformerLSSBEVDepth.py:792-1397: ``DepthNetStereo`` :792-891,
``ViewTransformerLSSBEVStereo`` :893-1397).  No released config
instantiates it, so there is no reference checkpoint to match: the modules
carry the JAX package's names, and ``engine/convert_weights.py:
convert_bevstereo`` maps the JAX module's variables onto them.  Feature maps
are channels-first, as in the port's other convolutional modules:

* ``DepthNetStereo``: x [BN, Cin, fH, fW] + the camera embedding [BN, cam]
  -> (reduced feature, context, mu, sigma, range score, mono depth logits);
  mu / sigma / range score come out of two stride-2 transposed
  convolutions at 4x the feature resolution, in float32.  The transposed
  convolutions keep flax's ``"SAME"`` rule (``_SameConvTranspose2d``).
* ``ViewTransformerLSSBEVStereo.forward_stereo``: per sweep the stereo
  features [BN, C, Hs, Ws] and mono depth logits [BN, D, fH, fW], the
  ``[BN, n_sweeps, 4, 4]`` matrices and the DepthNet's mu / sigma / range
  score [BN, R, Hs, Ws] -> the stereo depth score [BN, D, Hs, Ws] and the
  mask [BN, D, fH, fW] (a per-range Gaussian refined by ``em_iteration``
  EM steps over group-correlation cost volumes of the other sweeps, warped
  onto each depth hypothesis); ``fuse_depth`` -> depth probabilities [BN,
  D, fH, fW]; ``forward`` the lift-splat of image features with them into
  a ``[B, X, Y, Z, C]`` volume (S1 on the card).

The warps (``homo_warping``) read a sweep's features bilinearly at the key
frame's depth hypotheses through ``ops/trilerp_fused.py:
fused_multilevel_gather`` over one level of Z = 1, the table channels-last
[BN, Hs*Ws, C] (K4 on the card, its plain version, ``F.grid_sample``, on the
CPU), as the DCN reads its taps.  The cost volume sends gradient into the
sweep features through that read, and K4-bwd sums it in a fixed order where
``F.grid_sample``'s backward adds with atomics, so a repeated backward gives
the same bits.  The sampling grid carries no gradient (the reference builds
it under ``torch.no_grad()``, JAX under ``stop_gradient``), so K4-bwd runs
without d_coords; the mask's warps read detached depths and run K4 alone.
Each sweep's table is laid out once per ``forward_stereo``.  The grid's
4x4 chain runs in float32 with autocast off.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.geometry import compute_voxel_coords, create_frustum, gen_dx_bx, get_geometry
from ..ops.scatter import voxel_scatter_lifted
from ..ops.trilerp_fused import fused_multilevel_gather
from ..registry import NECKS
from .dcn import DeformConv2d
from .depthnet import ASPP2D, camera_embedding
from .layers import BasicBlock2D, BatchNorm1d, BatchNorm2d, BatchNorm3d, Mlp, SELayer


def depth_sampling_k_list(sampling_range: float, num_samples: int) -> np.ndarray:
    """Gaussian-quantile sampling offsets (reference ``depth_sampling``
    :966-977): the +-``sampling_range`` sigma interval split into
    ``num_samples`` bins of equal probability; their centres' z-scores."""
    from scipy.special import erf
    from scipy.stats import norm

    p_total = erf(sampling_range / np.sqrt(2))
    idx = np.arange(0, num_samples + 1)
    p = (1 - p_total) / 2 + (idx / num_samples) * p_total
    k = norm.ppf(p)
    return (k[1:] + k[:-1]) / 2


def _linspace(stop: float, num: int, device) -> torch.Tensor:
    """``jnp.linspace(0, stop, num)`` in float32 bit for bit, as XLA computes
    it: ``i * (stop * (1 / (num - 1)))``, each product rounded to float32,
    the last entry ``stop`` itself."""
    if num == 1:
        return torch.zeros(1, device=device)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    step = f32(stop) * f32(1.0 / (num - 1))
    return torch.cat([torch.arange(num - 1, dtype=torch.float32, device=device) * step,
                      f32([stop])])


def create_depth_sample_frustum(depth_sample: torch.Tensor, input_size: Tuple[int, int],
                                downsample_factor: int) -> torch.Tensor:
    """Homogeneous (x_pix, y_pix, depth, 1) points of per-pixel depth
    hypotheses in the full-resolution augmented image (reference
    ``create_depth_sample_frustum`` :979-1006): depth_sample [BN, S, fH, fW]
    -> [BN, S, fH, fW, 4]."""
    ogfH, ogfW = input_size
    BN, S, fH, fW = depth_sample.shape
    dev = depth_sample.device
    x = _linspace(ogfW - 1, fW, dev).view(1, 1, 1, fW).expand(BN, S, fH, fW)
    y = _linspace(ogfH - 1, fH, dev).view(1, 1, fH, 1).expand(BN, S, fH, fW)
    return torch.stack([x, y, depth_sample.float(), torch.ones_like(x)], dim=-1)


def warp_grid(key_intrin, sweep_intrin, sensor2sensor, key_ida, sweep_ida, depth_sample,
              frustum, feat_hw: Tuple[int, int], downsample_factor: int) -> torch.Tensor:
    """The sweep-image coordinates of the key frame's depth hypotheses
    (reference ``homo_warping`` :1008-1098), without gradient: undo the key
    IDA, scale by depth, key camera -> sweep camera -> sweep pixel -> sweep
    IDA; points behind the sweep camera are pushed off the image (:1063-1067);
    then the reference's mixed normalisation, a divide by (size - 1) / 2 of
    the full-resolution image, later read with ``align_corners=False``.
    Returns [BN, S * fH * fW, 3] float32 (y, x, 0), the coordinates of
    ``fused_multilevel_gather`` over the [Hs, Ws, 1] feature map."""
    BN = frustum.shape[0]
    with torch.no_grad(), torch.autocast(frustum.device.type, enabled=False):
        def apply(m, p):
            return torch.einsum("bij,bpj->bpi", m.float(), p)

        pts = frustum.reshape(BN, -1, 4).float()
        # z := 1 so that the IDA (a pixel-plane homography) acts on (x, y) only
        pts = torch.cat([pts[..., :2], torch.ones_like(pts[..., 2:3]), pts[..., 3:]], -1)
        pts = apply(torch.linalg.inv(key_ida.float()), pts)
        depth = depth_sample.reshape(BN, -1, 1).float()
        pts = torch.cat([pts[..., :3] * depth, pts[..., 3:]], -1)
        pts = apply(torch.linalg.inv(key_intrin.float()), pts)
        pts = apply(sensor2sensor, pts)
        pts = apply(sweep_intrin, pts)
        pts = torch.cat([pts[..., :2] / pts[..., 2:3], pts[..., 2:]], -1)
        pts = apply(sweep_ida, pts)
        full_h, full_w = feat_hw[0] * downsample_factor, feat_hw[1] * downsample_factor
        behind = pts[..., 2] < 1e-3
        px = torch.where(behind, torch.full_like(pts[..., 0], float(full_w)), pts[..., 0])
        py = torch.where(behind, torch.full_like(pts[..., 1], float(full_h)), pts[..., 1])
        nx = px / ((full_w - 1) / 2.0) - 1.0
        ny = py / ((full_h - 1) / 2.0) - 1.0
        return torch.stack([ny, nx, torch.zeros_like(nx)], dim=-1).contiguous()


def feature_table(feat: torch.Tensor) -> torch.Tensor:
    """[BN, C, H, W] -> the channels-last table [BN, H*W, C] that
    ``fused_multilevel_gather`` reads as one level of Z = 1."""
    BN, C, H, W = feat.shape
    return feat.permute(0, 2, 3, 1).reshape(BN, H * W, C).contiguous()


def read_table(table: torch.Tensor, feat_hw: Tuple[int, int], grid: torch.Tensor) -> torch.Tensor:
    """Bilinear read (zeros outside, ``align_corners=False``) of a
    ``feature_table`` at ``warp_grid``'s coordinates: [BN, C, S*fH*fW]."""
    C = table.shape[-1]
    return fused_multilevel_gather([table], [(feat_hw[0], feat_hw[1], 1)], C, [grid],
                                   align_corners=False)[0]


def homo_warping(stereo_feat, key_intrin, sweep_intrin, sensor2sensor, key_ida, sweep_ida,
                 depth_sample, frustum, downsample_factor: int) -> torch.Tensor:
    """A sweep's feature map warped onto the key frame's depth hypotheses
    (reference ``homo_warping`` :1008-1098): stereo_feat [BN, C, Hs, Ws] at
    1 / ``downsample_factor`` of the augmented image, the 4x4 matrices
    [BN, 4, 4], depth_sample [BN, S, fH, fW] and its
    ``create_depth_sample_frustum`` -> [BN, C, S, fH, fW]."""
    BN, C, Hs, Ws = stereo_feat.shape
    S, fH, fW = frustum.shape[1:4]
    grid = warp_grid(key_intrin, sweep_intrin, sensor2sensor, key_ida, sweep_ida,
                     depth_sample, frustum, (Hs, Ws), downsample_factor)
    out = read_table(feature_table(stereo_feat), (Hs, Ws), grid)
    return out.reshape(BN, C, S, fH, fW)


class _SameConvTranspose2d(nn.ConvTranspose2d):
    """flax ``nn.ConvTranspose(kernel 3, strides 2, padding="SAME")``: the
    stride-dilated input padded by 2 before and 1 after, output 2x the
    input.  torch's usual ``ConvTranspose2d(3, 2, padding=1,
    output_padding=1)`` pads (1, 2) and shifts the output by one pixel
    (ROADMAP §C); this one runs ``padding=0``, (2, 2), and drops the last
    output row and column.  Weight (I, O, 3, 3), the kernel flipped against
    flax's (``engine/convert_weights.py:t2f_deconv``), and a bias."""

    def __init__(self, channels: int, dtype: torch.dtype = torch.float32):
        super().__init__(channels, channels, 3, stride=2, padding=0, bias=True, dtype=dtype)

    def forward(self, x):
        return super().forward(x)[..., :-1, :-1]


class DepthNetStereo(nn.Module):
    """Stereo DepthNet head (reference :792-891, JAX ``bevstereo.py:133-201``).

    forward(x [BN, Cin, fH, fW], mlp_input [BN, cam]) -> (y [BN, mid, fH, fW]
    the reduced feature, ctx [BN, context, fH, fW], mu, sigma, range_score
    [BN, num_ranges, 4 fH, 4 fW] float32, mono [BN, depth, fH, fW] logits)."""

    def __init__(self, mid_channels: int, context_channels: int, depth_channels: int,
                 cam_channels: int = 27, num_ranges: int = 4,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        mid = mid_channels
        self.num_ranges = num_ranges
        self.bn_cam = BatchNorm1d(cam_channels, dtype=dtype)
        self.reduce_conv = nn.Conv2d(mid, mid, 3, padding=1, bias=True, dtype=dtype)
        self.reduce_bn = BatchNorm2d(mid, dtype=dtype)
        self.context_mlp = Mlp(cam_channels, mid, mid, dtype=dtype)
        self.context_se = SELayer(mid, dtype=dtype)
        self.context_conv = nn.Conv2d(mid, context_channels, 1, dtype=dtype)
        self.depth_mlp = Mlp(cam_channels, mid, mid, dtype=dtype)
        self.depth_se = SELayer(mid, dtype=dtype)
        self.depth_block0 = BasicBlock2D(mid, dtype=dtype)
        self.depth_block1 = BasicBlock2D(mid, dtype=dtype)
        self.aspp = ASPP2D(mid, lambda c: BatchNorm2d(c, dtype=dtype), dtype=dtype,
                           fixed_order=True)
        self.dcn = DeformConv2d(mid, mid, 3, padding=1, groups=4, dtype=dtype)
        self.mono_block = BasicBlock2D(mid, dtype=dtype)
        self.mono_pred = nn.Conv2d(mid, depth_channels, 1, dtype=dtype)
        self.msr_block = BasicBlock2D(mid, dtype=dtype)
        self.msr_up0 = _SameConvTranspose2d(mid, dtype=dtype)
        self.msr_up_bn0 = BatchNorm2d(mid, dtype=dtype)
        self.msr_up1 = _SameConvTranspose2d(mid, dtype=dtype)
        self.msr_up_bn1 = BatchNorm2d(mid, dtype=dtype)
        self.msr_pred = nn.Conv2d(mid, num_ranges * 3, 1, dtype=dtype)

    def forward(self, x, mlp_input):
        mlp_input = camera_embedding(self.bn_cam, mlp_input).to(x.dtype)
        y = F.relu(self.reduce_bn(self.reduce_conv(x)))
        ctx = self.context_conv(self.context_se(y, self.context_mlp(mlp_input)))
        dep = self.depth_se(y, self.depth_mlp(mlp_input))
        dep = self.dcn(self.aspp(self.depth_block1(self.depth_block0(dep))))
        mono = self.mono_pred(self.mono_block(dep))
        mss = self.msr_block(dep)
        for up, up_bn in ((self.msr_up0, self.msr_up_bn0), (self.msr_up1, self.msr_up_bn1)):
            mss = F.relu(up_bn(up(mss)))
        mss = self.msr_pred(mss)
        R = self.num_ranges
        mu, sigma, range_score = mss[:, :R].float(), mss[:, R:2 * R].float(), mss[:, 2 * R:]
        sigma = F.elu(sigma) + 1.0 + 1e-10
        return y, ctx, mu, sigma, range_score.float(), mono


def _stack_mats(mats: Dict[str, torch.Tensor], key_idx: int, src_idx: int):
    """(key intrinsics, sweep intrinsics, key -> sweep, key IDA, sweep IDA)."""
    return (mats["intrin_mats"][:, key_idx], mats["intrin_mats"][:, src_idx],
            mats["sensor2sensor_mats"][:, src_idx], mats["ida_mats"][:, key_idx],
            mats["ida_mats"][:, src_idx])


@NECKS.register_module()
class ViewTransformerLSSBEVStereo(nn.Module):
    """Temporal-stereo LSS view transformer (reference :893-1397, JAX
    ``bevstereo.py:203-450``).

    ``forward(img_feat [B, N, C, fH, fW], depth_prob [B*N, D, fH, fW], rots,
    trans, intrins, post_rots, post_trans, bda)`` is the lift-splat with a
    depth distribution the caller supplies (reference ``forward``
    :1359-1397), into a [B, X, Y, Z, C] volume; ``forward_stereo`` gives the
    stereo depth score and mask from per-sweep features, ``fuse_depth`` the
    BEVStereo combination of both with the mono logits."""

    def __init__(self, grid_config: Dict, data_config: Dict, numC_input: int = 512,
                 numC_Trans: int = 128, downsample: int = 16, cam_channels: int = 27,
                 num_ranges: int = 4,
                 range_list: Optional[Sequence[Sequence[float]]] = (
                     (2.0, 8.0), (8.0, 16.0), (16.0, 28.0), (28.0, 58.0)),
                 em_iteration: int = 3, sampling_range: float = 3.0, num_samples: int = 3,
                 k_list: Optional[Sequence[float]] = None, min_sigma: float = 1.0,
                 num_groups: int = 8, stereo_downsample_factor: int = 4,
                 use_mask: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid_config = dict(grid_config)
        self.input_size = tuple(data_config["input_size"])
        self.downsample = downsample
        self.em_iteration, self.num_samples = em_iteration, num_samples
        self.min_sigma, self.num_groups = min_sigma, num_groups
        self.stereo_downsample_factor, self.use_mask = stereo_downsample_factor, use_mask
        self._dx, self._bx, self._nx = gen_dx_bx(
            grid_config["xbound"], grid_config["ybound"], grid_config["zbound"])
        self._frustum = create_frustum(grid_config, self.input_size, downsample)
        self.D = D = self._frustum.shape[0]
        d0, d1, _ = grid_config["dbound"]
        if range_list is None:
            span = (d1 - d0) / num_ranges
            self.ranges = [(d0 + span * i, d0 + span * (i + 1)) for i in range(num_ranges)]
        else:
            if len(range_list) != num_ranges:
                raise ValueError(f"{len(range_list)} ranges for num_ranges={num_ranges}")
            self.ranges = [tuple(r) for r in range_list]
        ks = depth_sampling_k_list(sampling_range, num_samples) if k_list is None else k_list
        self.ks = tuple(float(k) for k in ks)

        self.depth_net = DepthNetStereo(numC_input, numC_Trans, D, cam_channels=cam_channels,
                                        num_ranges=num_ranges, dtype=dtype)
        # similarity_net (reference :915-930): 1x1x1 ConvBnReLU3D G -> 16 -> 8, conv 8 -> 1
        self.sim_conv1 = nn.Conv3d(num_groups, 16, 1, bias=False, dtype=dtype)
        self.sim_bn1 = BatchNorm3d(16, dtype=dtype)
        self.sim_conv2 = nn.Conv3d(16, 8, 1, bias=False, dtype=dtype)
        self.sim_bn2 = BatchNorm3d(8, dtype=dtype)
        self.sim_out = nn.Conv3d(8, 1, 1, bias=True, dtype=dtype)
        # depth_downsample_net (reference :932-940): stereo (1/4) -> feature (1/16)
        self.dds_conv1 = nn.Conv2d(D, 256, 3, stride=2, padding=1, dtype=dtype)
        self.dds_bn1 = BatchNorm2d(256, dtype=dtype)
        self.dds_conv2 = nn.Conv2d(256, 256, 3, stride=2, padding=1, dtype=dtype)
        self.dds_bn2 = BatchNorm2d(256, dtype=dtype)
        self.dds_out = nn.Conv2d(256, D, 1, dtype=dtype)
        if use_mask:
            self.mask_conv = nn.Conv2d(2 * D, 64, 3, padding=1, bias=True, dtype=dtype)
            self.mask_bn = BatchNorm2d(64, dtype=dtype)
            self.mask_block0 = BasicBlock2D(64, dtype=dtype)
            self.mask_block1 = BasicBlock2D(64, dtype=dtype)
            self.mask_out = nn.Conv2d(64, 1, 1, bias=True, dtype=dtype)

    # -- the submodules' passes ----------------------------------------------
    def _similarity(self, cost):
        """[BN, G, S, Hs, Ws] group correlation -> [BN, S, Hs, Ws]."""
        y = F.relu(self.sim_bn1(self.sim_conv1(cost)))
        y = F.relu(self.sim_bn2(self.sim_conv2(y)))
        return self.sim_out(y)[:, 0]

    def _mask_net(self, x):
        y = F.relu(self.mask_bn(self.mask_conv(x)))
        return torch.sigmoid(self.mask_out(self.mask_block1(self.mask_block0(y))))

    def depth_downsample(self, stereo_depth):
        """[BN, D, Hs, Ws] stereo-resolution score -> [BN, D, fH, fW]."""
        y = F.relu(self.dds_bn1(self.dds_conv1(stereo_depth)))
        y = F.relu(self.dds_bn2(self.dds_conv2(y)))
        return self.dds_out(y)

    def _generate_cost_volume(self, sweep_index, stereo_feats, tables, mats, depth_sample,
                              frustum):
        """Group-correlation cost volume averaged over the other sweeps
        (reference :1150-1218): [BN, S, Hs, Ws]."""
        BN, C, Hs, Ws = stereo_feats[0].shape
        G, S = self.num_groups, depth_sample.shape[1]
        ref = stereo_feats[sweep_index].reshape(BN, G, C // G, 1, Hs, Ws)
        scores = []
        for idx, table in enumerate(tables):
            if idx == sweep_index:
                continue
            grid = warp_grid(*_stack_mats(mats, sweep_index, idx), depth_sample, frustum,
                             (Hs, Ws), self.stereo_downsample_factor)
            warped = read_table(table, (Hs, Ws), grid).reshape(BN, G, C // G, S, Hs, Ws)
            scores.append(self._similarity((ref * warped).mean(dim=2)))
        return torch.stack(scores).mean(dim=0)

    def _forward_mask(self, sweep_index, mono_depths, mono_tables, mats, depth_sample,
                      frustum):
        """Cross-sweep mono-depth consistency mask (reference :1100-1148),
        both inputs without gradient (JAX :356-357): [BN, 1, fH, fW]."""
        BN, D, fH, fW = mono_depths[0].shape
        masks = []
        for idx, table in enumerate(mono_tables):
            if idx == sweep_index:
                continue
            grid = warp_grid(*_stack_mats(mats, sweep_index, idx), depth_sample, frustum,
                             (fH, fW), self.downsample)
            warped = read_table(table, (fH, fW), grid).reshape(BN, D, -1, fH, fW)
            pair = torch.cat([mono_depths[sweep_index].detach(), warped.mean(dim=2)], dim=1)
            masks.append(self._mask_net(pair))
        return torch.stack(masks).mean(dim=0)

    def forward_stereo(self, sweep_index: int, stereo_feats: List[torch.Tensor],
                       mono_depths: List[torch.Tensor], mats: Dict[str, torch.Tensor],
                       mus: List[torch.Tensor], sigmas: List[torch.Tensor],
                       range_scores: List[torch.Tensor]):
        """EM-refined per-range Gaussian stereo depth (reference :1220-1357).

        Lists are indexed by sweep: stereo_feats [BN, C, Hs, Ws], mono_depths
        [BN, D, fH, fW] logits, the DepthNet's mus / sigmas / range_scores
        [BN, R, Hs, Ws]; ``mats`` holds [BN, n_sweeps, 4, 4] ``intrin_mats``,
        ``ida_mats`` and ``sensor2sensor_mats`` (key frame -> sweep).
        Returns (stereo_depth [BN, D, Hs, Ws] float32, mask_score [BN, D, fH,
        fW] float32), or stereo_depth alone without ``use_mask``."""
        BN, _, Hs, Ws = stereo_feats[0].shape
        fH = Hs * self.stereo_downsample_factor // self.downsample
        fW = Ws * self.stereo_downsample_factor // self.downsample
        dev = stereo_feats[0].device
        d0, d1, dstep = self.grid_config["dbound"]
        d_coords = torch.arange(d0, d1, dstep, dtype=torch.float32, device=dev)
        bins = torch.arange(self.D, device=dev).view(1, -1, 1, 1)
        tables = [feature_table(f) for f in stereo_feats]
        mono_tables = ([feature_table(m.detach()) for m in mono_depths] if self.use_mask
                       else None)

        stereo_depth = torch.zeros((BN, self.D, Hs, Ws), dtype=torch.float32, device=dev)
        mask_score = torch.zeros((BN, self.D, fH, fW), dtype=torch.float32, device=dev)
        range_prob = torch.softmax(range_scores[sweep_index].float(), dim=1)
        S, mid = self.num_samples, self.num_samples // 2
        for r, (lo, hi) in enumerate(self.ranges):
            off = int((lo - d0) // dstep)
            length = int((hi - lo) // dstep)
            mu = torch.sigmoid(mus[sweep_index][:, r:r + 1]) * (hi - lo) + lo
            sigma = sigmas[sweep_index][:, r:r + 1]
            for _ in range(self.em_iteration):
                # [BN, S, Hs, Ws] hypotheses around the current mean
                ds = torch.cat([mu + sigma * k for k in self.ks], dim=1)
                frustum = create_depth_sample_frustum(ds, self.input_size,
                                                      self.stereo_downsample_factor)
                score = self._generate_cost_volume(sweep_index, stereo_feats, tables, mats,
                                                   ds, frustum)
                score = torch.softmax(score.float(), dim=1)
                scale = (0.5 / (1e-4 + score[:, mid:mid + 1])).clamp(0.1, 10.0)
                sigma = (sigma * scale).clamp(0.1, 10.0)
                mu = (ds * score).sum(dim=1, keepdim=True)
            mu = mu.clamp(lo, hi)
            in_range = (bins >= off) & (bins < off + length)
            if self.use_mask:
                pool = self.downsample // self.stereo_downsample_factor
                ds_m = F.avg_pool2d(mu, pool, pool)  # [BN, 1, fH, fW]
                frustum_m = create_depth_sample_frustum(ds_m, self.input_size, self.downsample)
                mask = self._forward_mask(sweep_index, mono_depths, mono_tables, mats, ds_m,
                                          frustum_m)
                mask_score = mask_score + torch.where(in_range, mask.float(),
                                                      torch.zeros_like(mask_score))
            sigma = sigma.clamp(min=self.min_sigma)
            d_slice = d_coords[off:off + length].view(1, -1, 1, 1)
            z = (d_slice - mu) / torch.sqrt(sigma)
            score_r = torch.exp(-0.5 * z * z) / (sigma * math.sqrt(2 * math.pi) + 1e-6)
            piece = F.pad(score_r * range_prob[:, r:r + 1],
                          (0, 0, 0, 0, off, self.D - off - length))
            stereo_depth = torch.where(in_range, piece, stereo_depth)
        if self.use_mask:
            return stereo_depth, mask_score
        return stereo_depth

    def fuse_depth(self, mono_depth, stereo_depth, mask_score=None):
        """The BEVStereo combination (JAX :428-436): softmax over depth of
        the mono logits plus the downsampled stereo score, times the mask:
        [BN, D, fH, fW] float32."""
        stereo_ds = self.depth_downsample(stereo_depth).float()
        if mask_score is not None:
            stereo_ds = stereo_ds * mask_score
        return torch.softmax(mono_depth.float() + stereo_ds, dim=1)

    def forward(self, img_feat, depth_prob, rots, trans, intrins, post_rots, post_trans, bda):
        """The lift-splat (reference forward :1359-1397): img_feat [B, N, C,
        fH, fW] and depth_prob [B*N, D, fH, fW] -> [B, X, Y, Z, C] (S1 on
        the card)."""
        B, N, C, fH, fW = img_feat.shape
        frustum = torch.from_numpy(self._frustum).to(img_feat.device)
        geom = get_geometry(frustum, rots, trans, intrins, post_rots, post_trans, bda)
        coords, valid = compute_voxel_coords(geom, self._dx, self._bx, self._nx)
        depth = depth_prob.reshape(B, N, self.D, fH, fW).to(img_feat.dtype)
        return voxel_scatter_lifted(depth, img_feat.permute(0, 1, 3, 4, 2), coords, valid,
                                    self._nx)
