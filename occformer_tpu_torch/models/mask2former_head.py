"""Mask2Former occupancy head: 3D-query transformer decoder over voxel scales.

Port of ``occformer_tpu/models/mask2former_head.py`` (reference
mask2former/{mask2former_occ.py,mask2former_nusc_occ.py}), inference
forward, with the checkpoint's names.  Learnable queries run through the
DETR decoder layers (masked cross-attn -> self-attn -> FFN) cycling over the
3 coarse voxel scales; after every layer a head gives class logits and mask
embeddings, and the next layer's attention mask is the max-pooled,
thresholded mask prediction ("preserve pooling", :477-486), or with
``pooling_attn_mask=False`` the prediction resized trilinearly
(``align_corners=True``, JAX ``:161-165``).  True means masked out; rows
masked everywhere reset to attend everywhere (:636).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.sampling import resize_trilinear
from .layers import FFN, MultiheadAttention
from .pos_embed import sine_positional_encoding_3d


# the decoder cycles over the 3 coarsest voxel scales
NUM_FEAT_LEVELS = 3


class _MMCVAttention(nn.Module):
    """mmcv's MultiheadAttention wraps torch's at ``.attn``."""

    def __init__(self, embed_dims, num_heads, dtype):
        super().__init__()
        self.attn = MultiheadAttention(embed_dims, num_heads, dtype=dtype)

    def forward(self, *args, **kwargs):
        return self.attn(*args, **kwargs)


class DetrDecoderLayer(nn.Module):
    """cross_attn -> LN -> self_attn -> LN -> FFN -> LN."""

    def __init__(self, embed_dims, num_heads, feedforward_channels,
                 dtype=torch.float32):
        super().__init__()
        self.attentions = nn.ModuleList([_MMCVAttention(embed_dims, num_heads, dtype)
                                         for _ in range(2)])
        self.ffns = nn.ModuleList([FFN(embed_dims, feedforward_channels, act="relu",
                                       add_identity=False, dtype=dtype)])
        self.norms = nn.ModuleList([nn.LayerNorm(embed_dims, dtype=dtype)
                                    for _ in range(3)])

    def forward(self, query, query_pos, key_tokens, key_pos, attn_mask):
        y = self.attentions[0](query + query_pos, key_tokens + key_pos, key_tokens,
                               attn_mask=attn_mask)
        query = self.norms[0](query + y)
        qp = query + query_pos
        y = self.attentions[1](qp, qp, query)
        query = self.norms[1](query + y)
        return self.norms[2](query + self.ffns[0](query))


def mask_logits_from_embeds(mask_embeds: torch.Tensor,
                            mask_feature: torch.Tensor) -> torch.Tensor:
    """[., B, Q, C] x [B, X, Y, Z, C] -> [., B, Q, X, Y, Z] mask logits."""
    if mask_embeds.dim() == 3:
        return torch.einsum("bqc,bxyzc->bqxyz", mask_embeds, mask_feature)
    return torch.einsum("lbqc,bxyzc->lbqxyz", mask_embeds, mask_feature)


def _no_autocast(t: torch.Tensor):
    """Turns autocast off on the tensor's device: a float32 island stays
    float32 under the train step's ``torch.autocast``."""
    return torch.autocast(t.device.type, enabled=False)


def format_results(cls_logits: torch.Tensor, mask_logits: torch.Tensor) -> torch.Tensor:
    """softmax(cls)[:-1] . sigmoid(mask) -> per-class voxel scores
    [B, X, Y, Z, num_classes], in float32 (reference mask2former_occ.py:673-678)."""
    with _no_autocast(cls_logits):
        cls_prob = torch.softmax(cls_logits.float(), dim=-1)[..., :-1]
        mask_prob = torch.sigmoid(mask_logits.float())
        return torch.einsum("bqc,bqxyz->bxyzc", cls_prob, mask_prob)


class Mask2FormerOccHead(nn.Module):
    """voxel_feats [mask_feature, fine..coarse] (channels-first) ->
    (cls [L+1, B, Q, C+1], mask_embeds [L+1, B, Q, Cout],
    mask_feature [B, X, Y, Z, Cout]).  The SemanticKITTI head; the
    nuScenes one is the same decoder (their losses differ:
    ``engine/train.py:build_loss_cfg``)."""

    def __init__(self, feat_channels: int, out_channels: int,
                 num_occupancy_classes: int = 20, num_queries: int = 100,
                 num_heads: int = 8, num_decoder_layers: int = 9,
                 feedforward_channels: Optional[int] = None,
                 pos_num_feats: Optional[int] = None, pooling_attn_mask: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        C = feat_channels
        self.pooling_attn_mask = pooling_attn_mask
        self.feat_channels = C
        self.nlvl = NUM_FEAT_LEVELS
        self.pos_num_feats = pos_num_feats or C // 3
        self.query_embed = nn.Embedding(num_queries, C, dtype=dtype)
        self.query_feat = nn.Embedding(num_queries, C, dtype=dtype)
        self.level_embed = nn.Embedding(self.nlvl, C, dtype=dtype)
        self.cls_embed = nn.Linear(C, num_occupancy_classes + 1, dtype=dtype)
        self.mask_embed = nn.Sequential(
            nn.Linear(C, C, dtype=dtype), nn.ReLU(), nn.Linear(C, C, dtype=dtype),
            nn.ReLU(), nn.Linear(C, out_channels, dtype=dtype))
        self.transformer_decoder = nn.Module()
        self.transformer_decoder.post_norm = nn.LayerNorm(C, dtype=dtype)
        self.transformer_decoder.layers = nn.ModuleList([
            DetrDecoderLayer(C, num_heads, feedforward_channels or C * 8, dtype=dtype)
            for _ in range(num_decoder_layers)])
        self._pos: Dict[Tuple, torch.Tensor] = {}

    def _key_pos(self, shape, device, dtype):
        key = (tuple(shape), str(device), dtype)
        if key not in self._pos:
            C = self.feat_channels
            pos = sine_positional_encoding_3d(tuple(shape), self.pos_num_feats)[..., :C]
            self._pos[key] = torch.from_numpy(
                np.ascontiguousarray(pos.reshape(1, -1, C))).to(device, dtype)
        return self._pos[key]

    def _forward_head(self, q, mask_feature, target_size):
        d = self.transformer_decoder.post_norm(q)
        cls_pred = self.cls_embed(d)
        emb = self.mask_embed(d)
        # attention-mask logits in the embeddings' dtype (as the JAX head's
        # compute dtype), pooled in float32; autocast off so that training
        # rounds them as serving does
        with _no_autocast(emb):
            mask = torch.einsum("bqc,bcxyz->bqxyz", emb,
                                mask_feature.to(emb.dtype)).float()
        if self.pooling_attn_mask:
            pooled = F.adaptive_max_pool3d(mask, tuple(target_size))
        else:  # the mask carries no gradient
            pooled = resize_trilinear(mask.detach().permute(0, 2, 3, 4, 1), target_size,
                                      align_corners=True).permute(0, 4, 1, 2, 3)
        attn_mask = torch.sigmoid(pooled.flatten(2)) < 0.5  # [B, Q, K], True = masked
        return cls_pred, emb, attn_mask

    def forward(self, voxel_feats: Sequence[torch.Tensor]):
        mask_feature = voxel_feats[0]  # [B, C, X, Y, Z]
        B = mask_feature.shape[0]
        memories = list(voxel_feats[:0:-1])  # coarsest first
        key_tokens, key_pos, shapes = [], [], []
        for i in range(self.nlvl):
            m = memories[i]
            key_tokens.append(m.flatten(2).transpose(1, 2) + self.level_embed.weight[i])
            key_pos.append(self._key_pos(m.shape[2:], m.device, m.dtype))
            shapes.append(tuple(m.shape[2:]))

        q = self.query_feat.weight[None].expand(B, -1, -1)
        qpos = self.query_embed.weight[None].expand(B, -1, -1)
        cls_pred, emb, attn_mask = self._forward_head(q, mask_feature, shapes[0])
        cls_list, emb_list = [cls_pred], [emb]
        for i, layer in enumerate(self.transformer_decoder.layers):
            lvl = i % self.nlvl
            attn_mask = attn_mask & ~attn_mask.all(dim=-1, keepdim=True)
            q = layer(q, qpos, key_tokens[lvl], key_pos[lvl], attn_mask[:, None])
            cls_pred, emb, attn_mask = self._forward_head(
                q, mask_feature, shapes[(i + 1) % self.nlvl])
            cls_list.append(cls_pred)
            emb_list.append(emb)
        return (torch.stack(cls_list), torch.stack(emb_list),
                mask_feature.permute(0, 2, 3, 4, 1))


class Mask2FormerNuscOccHead(Mask2FormerOccHead):
    """The nuScenes head: the same decoder, supervised at LiDAR points."""


class Mask2FormerNuscPanopticOccHead(Mask2FormerNuscOccHead):
    """The panoptic head (reference mask2former_nusc_panoptic_occ.py:25-835):
    the nuScenes decoder, with more queries in its config (150).  What
    differs lives outside it: the GT slots are panoptic segments
    (``losses/mask2former_loss.py:preprocess_panoptic_gt``) and serving
    formats the queries into instances on the host
    (``utils/panoptic.py:format_panoptic_results``).  ``stuff_indices`` and
    ``thing_indices`` are kept for that formatting, as JAX keeps them."""

    def __init__(self, *args, stuff_indices: Optional[Sequence[int]] = None,
                 thing_indices: Optional[Sequence[int]] = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.stuff_indices = tuple(stuff_indices or ())
        self.thing_indices = tuple(thing_indices or ())
