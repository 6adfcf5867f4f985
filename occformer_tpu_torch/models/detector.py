"""OccupancyFormer: the full model, config-driven.

Port of ``occformer_tpu/models/detector.py`` (reference
detectors/occupancyformer.py:14-237): camera images + geometry -> image
backbone (a ResNet; SemanticKITTI's EfficientNet) + SECONDFPN -> LSS
lift/splat -> dual-path 3D encoder -> deformable pixel decoder ->
Mask2Former head; ``OccupancyFormer4D`` runs the image encoder and the view
transformer once per frame of a two-frame batch.  ``model.eval()`` is the
serving forward;
``model.train()`` turns on BatchNorm batch statistics, drop-path in the 3D
encoder and the EfficientNet, gradient checkpointing (``with_cp``) and the
frozen image stem
(``frozen_stages``), as the JAX package's ``train=True`` does.

``translate_cfg`` maps a component's ``type`` straight to its class and
picks the keys the port uses (for the panoptic head its ``stuff_indices``
and ``thing_indices``; for the image ResNet also the R101-DCN's
``style``, ``dcn``, ``stage_with_dcn`` and ``with_cp``; its
``norm_cfg.requires_grad=False`` is the optimizer's freeze,
``engine/optim.py:backbone_freeze_mask``).  The shared configs also carry TPU-only knobs
(``gather_impl``, ``gather_window``, ``gather_s_block``, ``gather_fused``,
``query_chunks``, ``gt_label_kernel``, ``pack_windows``, ``scan_layers``,
``spatial_shard_axis``) and loss settings (among them ``mxu_readout``, which
``engine/train.py:build_loss_cfg`` reads); the model ignores them.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple, Union

import torch
import torch.nn as nn
from torch.profiler import record_function

from .dcn import DeformConv2d
from .deform_attn import MultiScaleDeformableAttention3D
from .layers import MultiheadAttention
from .lss import ViewTransformerLiftSplatShootVoxel
from .efficientnet import CustomEfficientNet
from .mask2former_head import (Mask2FormerNuscOccHead, Mask2FormerNuscPanopticOccHead,
                               Mask2FormerOccHead)
from .occnet import OccupancyEncoder
from .pixel_decoder import MSDeformAttnPixelDecoder3D
from .resnet import ResNet
from .second_fpn import SECONDFPN
from .swin import WindowMSA

# the heads by config type; they share one decoder (the panoptic head also
# keeps its stuff and thing classes)
HEADS = {"Mask2FormerOccHead": Mask2FormerOccHead,
         "Mask2FormerNuscOccHead": Mask2FormerNuscOccHead,
         "Mask2FormerNuscPanopticOccHead": Mask2FormerNuscPanopticOccHead}


def translate_cfg(cfg: Dict) -> Tuple[type, Dict[str, Any]]:
    """Map an mmdet-style component config onto a port class + kwargs."""
    t = cfg["type"]
    if t == "ResNet":
        dcn = cfg.get("dcn")
        if dcn and (dcn.get("type") != "DCNv2" or dcn.get("deform_groups", 1) != 1):
            raise NotImplementedError(f"backbone dcn {dcn}: only mmdet's DCNv2 with one "
                                      "deform group is ported")
        stage_with_dcn = cfg.get("stage_with_dcn", (False, False, True, True))
        return ResNet, dict(depth=cfg.get("depth", 50),
                            out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))),
                            frozen_stages=cfg.get("frozen_stages", -1),
                            norm_eval=cfg.get("norm_eval", False),
                            style=cfg.get("style", "pytorch"),
                            dcn_stages=(tuple(i for i, f in enumerate(stage_with_dcn) if f)
                                        if dcn else ()),
                            with_cp=cfg.get("with_cp", False))
    if t == "CustomEfficientNet":
        return CustomEfficientNet, dict(arch=cfg.get("arch", "b0"),
                                        out_indices=tuple(cfg.get("out_indices", (6,))),
                                        drop_path_rate=cfg.get("drop_path_rate", 0.0),
                                        with_cp=cfg.get("with_cp", True))
    if t == "SECONDFPN":
        return SECONDFPN, dict(in_channels=tuple(cfg["in_channels"]),
                               out_channels=tuple(cfg["out_channels"]),
                               upsample_strides=tuple(cfg["upsample_strides"]))
    if t == "ViewTransformerLiftSplatShootVoxel":
        return ViewTransformerLiftSplatShootVoxel, dict(
            grid_config=dict(cfg["grid_config"]), data_config=dict(cfg["data_config"]),
            numC_input=cfg.get("numC_input", 512), numC_Trans=cfg.get("numC_Trans", 128),
            downsample=cfg.get("downsample", 16), cam_channels=cfg.get("cam_channels", 27),
            loss_depth_weight=cfg.get("loss_depth_weight", 1.0),
            use_voxel_net=bool(cfg.get("use_voxel_net", False)))
    if t == "OccupancyEncoder":
        norm = cfg.get("norm_cfg")
        return OccupancyEncoder, dict(
            in_channels=cfg.get("in_channels", 128), num_stage=cfg.get("num_stage", 4),
            block_numbers=tuple(cfg.get("block_numbers", (2, 2, 2, 2))),
            block_inplanes=tuple(cfg.get("block_inplanes", (128, 256, 512, 1024))),
            block_strides=tuple(cfg.get("block_strides", (1, 2, 2, 2))),
            out_indices=tuple(cfg.get("out_indices", (0, 1, 2, 3))),
            num_groups=norm.get("num_groups", 32) if isinstance(norm, dict) else 32,
            with_cp=cfg.get("with_cp", True))
    if t == "MSDeformAttnPixelDecoder3D":
        enc = cfg.get("encoder", {}) or {}
        layers = enc.get("transformerlayers", {}) or {}
        attn = layers.get("attn_cfgs", {}) or {}
        return MSDeformAttnPixelDecoder3D, dict(
            in_channels=tuple(cfg["in_channels"]),
            feat_channels=cfg.get("feat_channels", 256),
            out_channels=cfg.get("out_channels", 256),
            num_encoder_levels=attn.get("num_levels", 3),
            num_encoder_layers=enc.get("num_layers", 6),
            num_heads=attn.get("num_heads", 8), num_points=attn.get("num_points", 4),
            feedforward_channels=layers.get("feedforward_channels"),
            pos_num_feats=int(cfg.get("positional_encoding", {}).get("num_feats", 0)) or None,
            num_groups=(cfg.get("norm_cfg") or {}).get("num_groups", 32))
    if t in HEADS:
        dec = cfg.get("transformer_decoder", {}) or {}
        layers = dec.get("transformerlayers", {}) or {}
        attn = layers.get("attn_cfgs", {}) or {}
        kwargs = dict(
            feat_channels=cfg["feat_channels"], out_channels=cfg["out_channels"],
            num_occupancy_classes=cfg.get("num_occupancy_classes", 20),
            num_queries=cfg.get("num_queries", 100), num_heads=attn.get("num_heads", 8),
            num_decoder_layers=dec.get("num_layers", 9),
            feedforward_channels=layers.get("feedforward_channels"),
            pos_num_feats=int(cfg.get("positional_encoding", {}).get("num_feats", 0)) or None,
            pooling_attn_mask=bool(cfg.get("pooling_attn_mask", True)))
        if t == "Mask2FormerNuscPanopticOccHead":
            kwargs.update(stuff_indices=cfg.get("stuff_indices"),
                          thing_indices=cfg.get("thing_indices"))
        return HEADS[t], kwargs
    raise KeyError(f"no translation for component type {t}")


class OccupancyFormer(nn.Module):
    """``forward(batch)`` -> dict of outputs.

    batch: imgs [B, N, H, W, 3], rots/trans/intrins/post_rots/post_trans,
    bda.  Output: cls_preds [L+1, B, Q, C+1], mask_embeds [L+1, B, Q, Cout],
    mask_feature [B, X, Y, Z, Cout], depth_prob [B*N, fH, fW, D].
    """

    def __init__(self, img_backbone: Dict, img_neck: Dict, img_view_transformer: Dict,
                 img_bev_encoder_backbone: Dict, img_bev_encoder_neck: Dict,
                 pts_bbox_head: Dict, train_cfg: Optional[Dict] = None,
                 test_cfg: Optional[Dict] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype

        def build(cfg):
            cls, kwargs = translate_cfg(cfg)
            return cls(dtype=dtype, **kwargs)

        self.img_backbone = build(img_backbone)
        self.img_neck = build(img_neck)
        self.img_view_transformer = build(img_view_transformer)
        self.img_bev_encoder_backbone = build(img_bev_encoder_backbone)
        self.img_bev_encoder_neck = build(img_bev_encoder_neck)
        self.pts_bbox_head = build(pts_bbox_head)

    def image_encoder(self, imgs):
        """[B, N, H, W, 3] -> [B, N, C, fH, fW]."""
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2).to(self.dtype)
        x = self.img_neck(list(self.img_backbone(x)))
        return x.reshape(B, N, *x.shape[1:])

    def extract_volume(self, batch):
        """(volume [B, X, Y, Z, C], depth_prob [B*N, fH, fW, D])."""
        with record_function("stage:image_encoder"):
            x = self.image_encoder(batch["imgs"])
        with record_function("stage:view_transformer"):
            return self.img_view_transformer(
                x, batch["rots"], batch["trans"], batch["intrins"],
                batch["post_rots"], batch["post_trans"], batch["bda"])

    def forward(self, batch):
        # each stage is a named range for torch.profiler (chip_smoke.py reads them)
        volume, depth_prob = self.extract_volume(batch)
        with record_function("stage:occupancy_encoder"):
            scales = self.img_bev_encoder_backbone(volume.permute(0, 4, 1, 2, 3))
        with record_function("stage:pixel_decoder"):
            voxel_feats = self.img_bev_encoder_neck(list(scales))
        with record_function("stage:head"):
            cls_preds, mask_embeds, mask_feature = self.pts_bbox_head(voxel_feats)
        return {"cls_preds": cls_preds, "mask_embeds": mask_embeds,
                "mask_feature": mask_feature, "depth_prob": depth_prob}


class OccupancyFormer4D(OccupancyFormer):
    """The two-frame temporal variant (JAX ``models/detector.py:254-288``,
    reference occupancyformer.py:256-312).

    ``batch["imgs"]`` holds 2N camera slots with the frame axis minor,
    ``[cam0 key, cam0 previous, cam1 key, ...]``, and so do ``rots``,
    ``trans``, ``intrins``, ``post_rots`` and ``post_trans``; ``bda`` is
    shared.  Each frame runs the image encoder and the view transformer with
    its own cameras, the key frame (0) first, then the previous one (1)
    without gradient (JAX's ``stop_gradient``): in train mode each
    BatchNorm sees the key frame's batch, then the previous frame's, as
    flax's updates run in call order, and the DepthNet normalises each
    frame's N camera embeddings apart.  The two volumes concatenate on
    channels (key first) into the occupancy encoder, whose input convolutions
    take ``2 * numC_Trans`` channels; ``depth_prob`` is the key frame's.
    (The JAX docstring says the key frame's sensor2ego feeds both frames'
    camera embeddings; its code, which this follows, gives each frame its
    own: ROADMAP §C.)"""

    def extract_volume(self, batch):
        B, N2 = batch["imgs"].shape[:2]
        N = N2 // 2

        def frame(key, i):
            a = batch[key]
            return a.reshape(B, N, 2, *a.shape[2:])[:, :, i]

        def view_transformer(x, i):
            cams = [frame(k, i) for k in ("rots", "trans", "intrins", "post_rots",
                                         "post_trans")]
            return self.img_view_transformer(x, *cams, batch["bda"])

        with record_function("stage:image_encoder"):
            x_key = self.image_encoder(frame("imgs", 0))
            with torch.no_grad():
                x_prev = self.image_encoder(frame("imgs", 1))
        with record_function("stage:view_transformer"):
            vol_key, depth_prob = view_transformer(x_key, 0)
            with torch.no_grad():
                vol_prev, _ = view_transformer(x_prev, 1)
            return torch.cat([vol_key, vol_prev], dim=-1), depth_prob


# the detectors by config type (the JAX package's DETECTORS registry)
DETECTORS = {"OccupancyFormer": OccupancyFormer, "OccupancyFormer4D": OccupancyFormer4D}


@torch.no_grad()
def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from ``generator``: torch's default uniform bounds for
    convs, linears and packed projections (+-1/sqrt(fan_in)), unit norms,
    N(0, 1) embeddings, N(0, 0.02) relative-position tables clipped at 2
    sigma, zero DCN offset convs (mmcv) and the deformable attention's
    reference init (zero offset and weight kernels, radial offset bias)."""

    def uniform(w, fan_in):
        bound = 1.0 / math.sqrt(fan_in)
        w.uniform_(-bound, bound, generator=generator)

    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.Linear)):
            uniform(m.weight, m.weight[0].numel())
            if m.bias is not None:
                uniform(m.bias, m.weight[0].numel())
        elif isinstance(m, (nn.BatchNorm1d, nn.BatchNorm2d)):
            m.reset_parameters()
        elif isinstance(m, (nn.GroupNorm, nn.LayerNorm)):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(m, WindowMSA):
            m.relative_position_bias_table.normal_(0.0, 0.02, generator=generator)
            m.relative_position_bias_table.clamp_(-0.04, 0.04)
        elif isinstance(m, MultiheadAttention):
            uniform(m.in_proj_weight, m.in_proj_weight.shape[1])
            m.in_proj_bias.zero_()
    # after the loop, which has given these modules' children generic values
    for m in model.modules():
        if isinstance(m, DeformConv2d):
            uniform(m.weight, m.weight[0].numel())
            m.conv_offset.weight.zero_()
            m.conv_offset.bias.zero_()
        elif isinstance(m, MultiScaleDeformableAttention3D):
            m.reset_offsets()
    return model


def build_model(model_cfg: Dict, device: Union[str, torch.device, None] = None,
                dtype: torch.dtype = torch.float32, seed: int = 0) -> OccupancyFormer:
    """The port model of a config's ``model`` dict, in eval mode, on ``device``:
    the ``DETECTORS`` class its ``type`` names (a ``KeyError`` for any other).

    ``device`` is ``cuda`` by default, and a CUDA device without a card
    raises: nothing falls back to the CPU unless the caller passes
    ``device="cpu"``.  Weights are random, from a ``torch.Generator`` seeded
    with ``seed``; ``device="meta"`` builds shapes only.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run "
                           "the port's plain PyTorch path on the CPU")
    if model_cfg["type"] not in DETECTORS:
        raise KeyError(f"no detector of type {model_cfg['type']!r}; the port builds "
                       f"{sorted(DETECTORS)}")
    cfg = {k: v for k, v in model_cfg.items() if k != "type"}
    with dev:
        model = DETECTORS[model_cfg["type"]](**cfg, dtype=dtype)
    model = model.to(dev)  # buffers made from numpy constants start on the host
    if dev.type != "meta":
        init_weights(model, torch.Generator(device=dev).manual_seed(seed))
    return model.eval()
