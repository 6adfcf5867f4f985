"""MSDeformAttn pixel decoder in 3D: the Mask2Former "neck" over voxel scales.

Port of ``occformer_tpu/models/pixel_decoder.py`` (reference
necks/multiscale_deformattn_3d.py:21-249) with the checkpoint's names.  The 3
coarsest scales are projected (``input_convs``), tagged with 3D sine +
level embeddings and run through the deformable-attention encoder layers
(``encoder.layers``, a Python loop) over their flattened x-major tokens; the
finest scale is fused FPN-style (``lateral_convs`` / ``output_convs``) with a
trilinear upsample; ``mask_feature`` is a 1x1 Conv3d.  Volumes are
channels-first ``[B, C, X, Y, Z]``.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sampling import resize_trilinear
from .deform_attn import MultiScaleDeformableAttention3D
from .layers import FFN, Conv3dFixedOrderBackward
from .pos_embed import sine_positional_encoding_3d


def reference_points(spatial_shapes) -> np.ndarray:
    """Per-level [0, 1] grid centers, (x, y, z), flattened x-major
    (reference MlvlPointGenerator with offset 0.5, normalized)."""
    pts = []
    for (X, Y, Z) in spatial_shapes:
        xs = (np.arange(X, dtype=np.float32) + 0.5) / X
        ys = (np.arange(Y, dtype=np.float32) + 0.5) / Y
        zs = (np.arange(Z, dtype=np.float32) + 0.5) / Z
        g = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1)
        pts.append(g.reshape(-1, 3))
    return np.concatenate(pts, axis=0)


class _ConvGN(nn.Module):
    """mmcv ConvModule naming: ``conv`` then ``gn``.  ``fixed_order``: the
    convolution's backward on the card takes cuDNN's deterministic
    algorithms (``layers.Conv3dFixedOrderBackward``)."""

    def __init__(self, cin, cout, k, bias, groups, dtype, fixed_order=False):
        super().__init__()
        conv = Conv3dFixedOrderBackward if fixed_order else nn.Conv3d
        self.conv = conv(cin, cout, k, padding=k // 2, bias=bias, dtype=dtype)
        self.gn = nn.GroupNorm(groups, cout, dtype=dtype)

    def forward(self, x):
        return self.gn(self.conv(x))


class DeformableEncoderLayer(nn.Module):
    """self (deformable) attention -> LN -> FFN (relu) -> LN."""

    def __init__(self, embed_dims, num_heads, num_levels, num_points,
                 feedforward_channels, dtype=torch.float32):
        super().__init__()
        self.attentions = nn.ModuleList([MultiScaleDeformableAttention3D(
            embed_dims, num_heads, num_levels, num_points, dtype=dtype)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels, act="relu",
                                       dtype=dtype)])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, dtype=dtype)
                                    for _ in range(2)])

    def forward(self, x, pos, ref, spatial_shapes):
        y = self.attentions[0](x, x, ref, spatial_shapes, query_pos=pos)
        y = self.norms[0](y)
        return self.norms[1](self.ffns[0](y))


class MSDeformAttnPixelDecoder3D(nn.Module):
    """Volumes fine -> coarse ([B, C_i, X_i, Y_i, Z_i]) ->
    [mask_feature, fine, ..., coarse] (the reference's ordering)."""

    def __init__(self, in_channels: Sequence[int] = (256, 512, 1024, 2048),
                 feat_channels: int = 256, out_channels: int = 256,
                 num_encoder_levels: int = 3, num_encoder_layers: int = 6,
                 num_heads: int = 8, num_points: int = 4,
                 feedforward_channels: Optional[int] = None, num_groups: int = 32,
                 pos_num_feats: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = feat_channels
        n_in = len(in_channels)
        self.n_enc = num_encoder_levels
        self.feat_channels = C
        self.pos_num_feats = pos_num_feats or C // 3
        self.input_convs = nn.ModuleList([
            _ConvGN(in_channels[n_in - i - 1], C, 1, True, num_groups, dtype)
            for i in range(num_encoder_levels)])
        self.encoder = nn.Module()
        self.encoder.layers = nn.ModuleList([
            DeformableEncoderLayer(C, num_heads, num_encoder_levels, num_points,
                                   feedforward_channels or C * 4, dtype=dtype)
            for _ in range(num_encoder_layers)])
        self.level_encoding = nn.Embedding(num_encoder_levels, C, dtype=dtype)
        n_fpn = n_in - num_encoder_levels
        # the FPN's convolutions: at the tiny test model's shapes, with
        # cuDNN's TF32 off, cuDNN's default backward algorithms vary from run
        # to run (ROADMAP C.8)
        self.lateral_convs = nn.ModuleList([
            _ConvGN(in_channels[i], C, 1, False, num_groups, dtype, fixed_order=True)
            for i in range(n_fpn)])
        self.output_convs = nn.ModuleList([
            _ConvGN(C, C, 3, False, num_groups, dtype, fixed_order=True) for i in range(n_fpn)])
        self.mask_feature = nn.Conv3d(C, out_channels, 1, bias=True, dtype=dtype)
        # per (shapes, device) host constants moved to the device once
        self._const: Dict[Tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def _constants(self, shapes, device):
        key = (tuple(shapes), str(device))
        if key not in self._const:
            C = self.feat_channels
            pos = [sine_positional_encoding_3d(s, self.pos_num_feats)[..., :C]
                   .reshape(-1, C) for s in shapes]
            self._const[key] = (
                [torch.from_numpy(np.ascontiguousarray(p)).to(device) for p in pos],
                torch.from_numpy(reference_points(shapes)).to(device))
        return self._const[key]

    def forward(self, feats):
        n_in = len(feats)
        B = feats[0].shape[0]
        tokens, shapes = [], []
        for i in range(self.n_enc):
            f = feats[n_in - i - 1]  # coarsest first
            proj = self.input_convs[i](f)
            tokens.append(proj.flatten(2).transpose(1, 2))  # [B, XYZ, C]
            shapes.append(tuple(f.shape[2:]))
        poses, ref = self._constants(shapes, feats[0].device)
        x = torch.cat(tokens, dim=1)
        pos = torch.cat([p + self.level_encoding.weight[i].float()
                         for i, p in enumerate(poses)], dim=0)
        pos = pos[None].to(x.dtype)
        ref = ref[None, :, None, :].expand(B, -1, self.n_enc, 3)
        for layer in self.encoder.layers:
            x = layer(x, pos, ref, shapes)

        outs, start = [], 0
        for (X, Y, Z) in shapes:
            n = X * Y * Z
            outs.append(x[:, start:start + n].transpose(1, 2).reshape(B, -1, X, Y, Z))
            start += n

        for i in range(n_in - self.n_enc - 1, -1, -1):
            f = feats[i]
            up = resize_trilinear(outs[-1].permute(0, 2, 3, 4, 1), f.shape[2:],
                                  align_corners=False).permute(0, 4, 1, 2, 3)
            y = self.lateral_convs[i](f) + up
            outs.append(F.relu(self.output_convs[i](y)))

        outs[-1] = self.mask_feature(outs[-1])
        return outs[::-1]
