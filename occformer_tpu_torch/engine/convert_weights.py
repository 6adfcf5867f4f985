"""Weight bridge: JAX package variables -> the port's state dict.

The port's copy of ``occformer_tpu/engine/convert_weights.py``'s inverse
converter (``convert_occformer``, ``build_export_permutation``,
``export_torch_state_dict``) with the numpy primitives of
``occformer_tpu/engine/checkpoint.py`` it needs.  The port's modules carry
the reference checkpoints' key space, so the reference-format state dict the
exporter produces loads into a port model with ``load_state_dict(strict=True)``.

Every forward conversion rule below is a pure element permutation
(transposes, spatial flips, slices of packed in_proj, channel-permutation
tables).  The export therefore recovers the permutation numerically: a probe
state dict holding unique element indices runs through ``convert_occformer``
and each flax leaf reads off where its elements came from.  float64 probes
hold exact integers to 2^53.  Inputs are numpy arrays; nothing here imports
JAX.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..models.swin import relative_position_index
from ..ops.geometry import gen_dx_bx


# ---------------------------------------------------------------------------
# torch -> flax layout primitives (engine/checkpoint.py)
# ---------------------------------------------------------------------------

def t2f_conv(w: np.ndarray) -> np.ndarray:
    """torch conv (O, I, *K) -> flax (*K, I, O)."""
    nd = w.ndim
    return np.transpose(w, tuple(range(2, nd)) + (1, 0))


def t2f_deconv(w: np.ndarray) -> np.ndarray:
    """torch ConvTranspose (I, O, *K) -> flax ConvTranspose (*K, I, O).

    flax ``nn.ConvTranspose`` (lax.conv_transpose, transpose_kernel=False)
    convolves with the kernel as-is, whereas torch's ConvTranspose2d scatters
    it — equivalent only after flipping every spatial axis (verified by
    tests/test_secondfpn_convert.py numeric parity).
    """
    nd = w.ndim
    t = np.transpose(w, tuple(range(2, nd)) + (0, 1))
    return t[(slice(None, None, -1),) * (nd - 2)].copy()


def t2f_linear(w: np.ndarray) -> np.ndarray:
    """torch Linear (O, I) -> flax Dense (I, O)."""
    return w.T


def convert_bn(sd: Dict[str, np.ndarray], prefix: str) -> Tuple[Dict, Dict]:
    """torch BN subtree -> (params {scale, bias}, stats {mean, var})."""
    return (
        {"scale": sd[prefix + ".weight"], "bias": sd[prefix + ".bias"]},
        {"mean": sd[prefix + ".running_mean"], "var": sd[prefix + ".running_var"]},
    )


def split_inproj(sd: Dict[str, np.ndarray], prefix: str) -> Dict[str, Dict]:
    """torch nn.MultiheadAttention packed in_proj -> q/k/v Dense kernels."""
    w = sd[prefix + ".in_proj_weight"]
    b = sd[prefix + ".in_proj_bias"]
    d = w.shape[0] // 3
    out = {}
    for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
        out[name] = {"kernel": t2f_linear(w[i * d : (i + 1) * d]),
                     "bias": b[i * d : (i + 1) * d]}
    out["out_proj"] = {
        "kernel": t2f_linear(sd[prefix + ".out_proj.weight"]),
        "bias": sd[prefix + ".out_proj.bias"],
    }
    return out


# ---------------------------------------------------------------------------
# reference checkpoint -> flax tree (engine/convert_weights.py)
# ---------------------------------------------------------------------------

class TreeBuilder:
    """Accumulate nested dict assignments via path strings."""

    def __init__(self):
        self.params: Dict[str, Any] = {}
        self.stats: Dict[str, Any] = {}

    def _set(self, root, path, value):
        keys = path.split("/")
        node = root
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(value)

    def p(self, path, value):
        self._set(self.params, path, value)

    def s(self, path, value):
        self._set(self.stats, path, value)

    def bn(self, sd, tprefix, dst):
        pr, st = convert_bn(sd, tprefix)
        self.p(dst + "/BatchNorm_0/scale", pr["scale"])
        self.p(dst + "/BatchNorm_0/bias", pr["bias"])
        self.s(dst + "/BatchNorm_0/mean", st["mean"])
        self.s(dst + "/BatchNorm_0/var", st["var"])

    def gn(self, sd, tprefix, dst):
        self.p(dst + "/GroupNorm_0/scale", sd[tprefix + ".weight"])
        self.p(dst + "/GroupNorm_0/bias", sd[tprefix + ".bias"])

    def ln(self, sd, tprefix, dst):
        self.p(dst + "/LayerNorm_0/scale", sd[tprefix + ".weight"])
        self.p(dst + "/LayerNorm_0/bias", sd[tprefix + ".bias"])

    def conv(self, sd, tprefix, dst, bias=None):
        self.p(dst + "/Conv_0/kernel", t2f_conv(sd[tprefix + ".weight"]))
        bkey = tprefix + ".bias"
        if bias is None:
            bias = bkey in sd
        if bias:
            self.p(dst + "/Conv_0/bias", sd[bkey])

    def deconv(self, sd, tprefix, dst):
        self.p(dst + "/ConvTranspose_0/kernel", t2f_deconv(sd[tprefix + ".weight"]))

    def linear(self, sd, tprefix, dst):
        self.p(dst + "/Dense_0/kernel", t2f_linear(sd[tprefix + ".weight"]))
        if tprefix + ".bias" in sd:
            self.p(dst + "/Dense_0/bias", sd[tprefix + ".bias"])


def _reverse_offset_triples(w: np.ndarray, axis: int) -> np.ndarray:
    """Reverse each (z, y, x) triple to (x, y, z) along ``axis``."""
    shape = list(w.shape)
    n = shape[axis]
    view = np.moveaxis(w, axis, 0).reshape(n // 3, 3, -1)
    view = view[:, ::-1, :]
    return np.moveaxis(view.reshape(n, -1).reshape([n] + shape[:axis] + shape[axis + 1:]), 0, axis)


def convert_deform_attn(tb: TreeBuilder, sd, tp: str, dst: str):
    # sampling_offsets: torch Linear (O=H*L*P*3, I); reverse each triple
    w = sd[tp + ".sampling_offsets.weight"]
    b = sd[tp + ".sampling_offsets.bias"]
    w = _reverse_offset_triples(w, axis=0)
    b = _reverse_offset_triples(b[:, None], axis=0)[:, 0]
    tb.p(dst + "/sampling_offsets/Dense_0/kernel", t2f_linear(w))
    tb.p(dst + "/sampling_offsets/Dense_0/bias", b)
    for name in ("attention_weights", "value_proj", "output_proj"):
        tb.linear(sd, f"{tp}.{name}", f"{dst}/{name}")


def convert_mmcv_mha(tb: TreeBuilder, sd, tp: str, dst: str):
    """mmcv MultiheadAttention wraps torch nn.MultiheadAttention at .attn."""
    proj = split_inproj(sd, tp + ".attn")
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        tb.p(f"{dst}/{name}/Dense_0/kernel", proj[name]["kernel"])
        tb.p(f"{dst}/{name}/Dense_0/bias", proj[name]["bias"])


def convert_ffn(tb: TreeBuilder, sd, tp: str, dst: str):
    """mmcv FFN: layers.0.0 (fc1) and layers.1 (fc2)."""
    tb.linear(sd, tp + ".layers.0.0", dst + "/fc1")
    tb.linear(sd, tp + ".layers.1", dst + "/fc2")


def convert_aspp2d(tb: TreeBuilder, sd, tp: str, dst: str, norm: str):
    """ASPP (reference aspp.py:49-130): aspp1..4, global_avg_pool, conv1/bn1."""
    nm = tb.gn if norm == "gn" else tb.bn
    for i in range(1, 5):
        tb.conv(sd, f"{tp}.aspp{i}.atrous_conv", f"{dst}/aspp{i}_conv")
        nm(sd, f"{tp}.aspp{i}.bn", f"{dst}/aspp{i}_gn" if norm == "gn" else f"{dst}/aspp{i}_bn")
    tb.conv(sd, f"{tp}.global_avg_pool.1", f"{dst}/gap_conv")
    nm(sd, f"{tp}.global_avg_pool.2", f"{dst}/gap_gn" if norm == "gn" else f"{dst}/gap_bn")
    tb.conv(sd, f"{tp}.conv1", f"{dst}/project_conv")
    nm(sd, f"{tp}.bn1", f"{dst}/project_gn" if norm == "gn" else f"{dst}/project_bn")


def _dcn_offset_perm(K: int, groups: int, modulated: bool) -> np.ndarray:
    """Output-channel permutation mapping our conv_offset layout onto mmcv's.

    mmcv (deform_conv kernels): per deform-group the offset channels are
    interleaved (y_k, x_k) pairs per tap (channel g*2KK + 2k + {0,1}); the
    DCNv2 mask third sits after all offsets (channel 2GKK + g*KK + k).
    Ours (models/dcn.py): per group contiguous blocks [dy(KK), dx(KK), mask?].
    """
    KK = K * K
    T = 3 if modulated else 2
    perm = np.empty(groups * T * KK, np.int64)
    for g in range(groups):
        for t in range(T):
            for k in range(KK):
                ours = g * T * KK + t * KK + k
                if t < 2:
                    perm[ours] = g * 2 * KK + 2 * k + t
                else:
                    perm[ours] = 2 * groups * KK + g * KK + k
    return perm


def convert_dcn(tb: TreeBuilder, sd, tp: str, dst: str,
                modulated: bool = False, deform_groups: int = 1):
    """mmcv DCN/DCNv2 ((Modulated)DeformConv2dPack): .weight (O, I/g, K, K),
    .conv_offset with mmcv's channel ordering (see _dcn_offset_perm)."""
    w = sd[tp + ".weight"]
    O, Ig, K, _ = w.shape
    tb.p(dst + "/weight", w.transpose(2, 3, 1, 0).reshape(K * K, Ig, O))
    if tp + ".bias" in sd:
        tb.p(dst + "/bias", sd[tp + ".bias"])
    perm = _dcn_offset_perm(K, deform_groups, modulated)
    ow = sd[tp + ".conv_offset.weight"][perm]
    tb.p(dst + "/conv_offset/Conv_0/kernel", t2f_conv(ow))
    if tp + ".conv_offset.bias" in sd:
        tb.p(dst + "/conv_offset/Conv_0/bias", sd[tp + ".conv_offset.bias"][perm])


def convert_depthnet(tb: TreeBuilder, sd, tp: str, dst: str):
    """DepthNet (ViewTransformerLSSBEVDepth.py:450-504)."""
    tb.conv(sd, tp + ".reduce_conv.0", dst + "/reduce_conv")
    tb.bn(sd, tp + ".reduce_conv.1", dst + "/reduce_bn")
    tb.conv(sd, tp + ".context_conv", dst + "/context_conv")
    tb.bn(sd, tp + ".bn", dst + "/bn_cam")
    def lin1x1(t, d):
        # torch 1x1 Conv2d (O, I, 1, 1) -> our Dense (I, O)
        tb.p(d + "/Dense_0/kernel", t2f_linear(sd[t + ".weight"][:, :, 0, 0]))
        if t + ".bias" in sd:
            tb.p(d + "/Dense_0/bias", sd[t + ".bias"])

    for branch in ("depth", "context"):
        tb.linear(sd, f"{tp}.{branch}_mlp.fc1", f"{dst}/{branch}_mlp/fc1")
        tb.linear(sd, f"{tp}.{branch}_mlp.fc2", f"{dst}/{branch}_mlp/fc2")
        lin1x1(f"{tp}.{branch}_se.conv_reduce", f"{dst}/{branch}_se/conv_reduce")
        lin1x1(f"{tp}.{branch}_se.conv_expand", f"{dst}/{branch}_se/conv_expand")
    # depth_conv: 0-2 BasicBlocks, 3 ASPP, 4 DCN, 5 1x1
    for i in range(3):
        bp = f"{tp}.depth_conv.{i}"
        tb.conv(sd, bp + ".conv1", f"{dst}/depth_block{i}/conv1")
        tb.bn(sd, bp + ".norm1" if bp + ".norm1.weight" in sd else bp + ".bn1",
              f"{dst}/depth_block{i}/bn1")
        tb.conv(sd, bp + ".conv2", f"{dst}/depth_block{i}/conv2")
        tb.bn(sd, bp + ".norm2" if bp + ".norm2.weight" in sd else bp + ".bn2",
              f"{dst}/depth_block{i}/bn2")
    convert_aspp2d(tb, sd, tp + ".depth_conv.3", dst + "/aspp", norm="bn")
    if tp + ".depth_conv.4.weight" in sd:
        convert_dcn(tb, sd, tp + ".depth_conv.4", dst + "/dcn")
        tb.conv(sd, tp + ".depth_conv.5", dst + "/depth_pred")
    else:
        tb.conv(sd, tp + ".depth_conv.4", dst + "/depth_pred")


def convert_depth_aggregation(tb: TreeBuilder, sd, tp: str, dst: str):
    """The ``use_voxel_net`` DepthAggregation (ViewTransformerLSSBEVDepth.py:
    506-561): three 3x3 conv + BatchNorm pairs and the out conv."""
    for conv, bn in (("reduce_conv", "reduce_bn"), ("conv1", "bn1"), ("conv2", "bn2")):
        tb.conv(sd, f"{tp}.{conv}", f"{dst}/{conv}")
        tb.bn(sd, f"{tp}.{bn}", f"{dst}/{bn}")
    tb.conv(sd, tp + ".out_conv", dst + "/out_conv")


def convert_resnet(sd: Dict[str, np.ndarray], prefix: str = "") -> Tuple[Dict, Dict]:
    """torchvision/mmdet ResNet state dict -> (params, batch_stats) for
    models/resnet.py.  Handles bottleneck + basic blocks and downsample."""
    params: Dict[str, Any] = {}
    stats: Dict[str, Any] = {}

    def bn(dst_p, dst_s, name, tname):
        p, s = convert_bn(sd, prefix + tname)
        dst_p[name] = {"BatchNorm_0": p}
        dst_s[name] = {"BatchNorm_0": s}

    params["conv1"] = {"Conv_0": {"kernel": t2f_conv(sd[prefix + "conv1.weight"])}}
    bn(params, stats, "bn1", "bn1")

    layer_re = re.compile(rf"^{re.escape(prefix)}layer(\d+)\.(\d+)\.")
    blocks = sorted({
        (int(m.group(1)), int(m.group(2)))
        for k in sd if (m := layer_re.match(k))
    })
    for li, bi in blocks:
        tpre = f"{prefix}layer{li}.{bi}."
        dst = f"layer{li}_{bi}"
        bp: Dict[str, Any] = {}
        bs: Dict[str, Any] = {}
        n_convs = 3 if tpre + "conv3.weight" in sd else 2
        for ci in range(1, n_convs + 1):
            key = tpre + f"conv{ci}.weight"
            if tpre + f"conv{ci}.conv_offset.weight" in sd:
                # DCNv2 block conv (mmdet ResNet dcn stages); channel-order
                # permutation handled by the shared DCN converter
                tb = TreeBuilder()
                convert_dcn(tb, sd, tpre + f"conv{ci}", f"conv{ci}",
                            modulated=True)
                bp[f"conv{ci}"] = tb.params[f"conv{ci}"]
            elif key in sd:  # plain conv
                bp[f"conv{ci}"] = {"Conv_0": {"kernel": t2f_conv(sd[key])}}
            p, s = convert_bn(sd, tpre + f"bn{ci}")
            bp[f"bn{ci}"] = {"BatchNorm_0": p}
            bs[f"bn{ci}"] = {"BatchNorm_0": s}
        if tpre + "downsample.0.weight" in sd:
            bp["downsample_conv"] = {
                "Conv_0": {"kernel": t2f_conv(sd[tpre + "downsample.0.weight"])}
            }
            p, s = convert_bn(sd, tpre + "downsample.1")
            bp["downsample_bn"] = {"BatchNorm_0": p}
            bs["downsample_bn"] = {"BatchNorm_0": s}
        params[dst] = bp
        stats[dst] = bs
    return params, stats



def _stack_trees(trees):
    """Stack same-structured nested dicts of arrays on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in first}
    return np.stack(trees, axis=0)


def convert_efficientnet(tb: TreeBuilder, sd, tp: str, dst: str):
    """CustomEfficientNet (reference efficientnet.py:275-533; mmcv
    ConvModule naming): ``layers.0`` the stem, ``layers.{L}.{B}`` the blocks
    (InvertedResidual: expand_conv?/depthwise_conv/se/linear_conv;
    EdgeResidual: conv1/se/conv2), an optional trailing final 1x1
    ConvModule.  The JAX modules hold their raw ``nn.Conv``s directly under
    their names (no Conv_0 wrapper); the SE convolutions carry biases."""

    def conv(t, d):
        tb.p(d + "/kernel", t2f_conv(sd[t + ".weight"]))
        if t + ".bias" in sd:
            tb.p(d + "/bias", sd[t + ".bias"])

    pre = tp + "." if tp else ""
    conv(f"{pre}layers.0.conv", f"{dst}/stem_conv")
    tb.bn(sd, f"{pre}layers.0.bn", f"{dst}/stem_bn")
    L = 1
    while True:
        base = f"{pre}layers.{L}"
        if f"{base}.conv.weight" in sd:  # the trailing final 1x1 ConvModule
            conv(f"{base}.conv", f"{dst}/final_conv")
            tb.bn(sd, f"{base}.bn", f"{dst}/final_bn")
            break
        if f"{base}.0.depthwise_conv.conv.weight" not in sd and \
                f"{base}.0.conv1.conv.weight" not in sd:
            break
        B = 0
        while True:
            bb = f"{base}.{B}"
            dd = f"{dst}/layer{L}_block{B}"
            if f"{bb}.depthwise_conv.conv.weight" in sd:  # InvertedResidual
                if f"{bb}.expand_conv.conv.weight" in sd:
                    conv(f"{bb}.expand_conv.conv", f"{dd}/expand_conv")
                    tb.bn(sd, f"{bb}.expand_conv.bn", f"{dd}/expand_bn")
                conv(f"{bb}.depthwise_conv.conv", f"{dd}/dw_conv")
                tb.bn(sd, f"{bb}.depthwise_conv.bn", f"{dd}/dw_bn")
                project = "linear_conv"
            elif f"{bb}.conv1.conv.weight" in sd:  # EdgeResidual
                conv(f"{bb}.conv1.conv", f"{dd}/expand_conv")
                tb.bn(sd, f"{bb}.conv1.bn", f"{dd}/expand_bn")
                project = "conv2"
            else:
                break
            if f"{bb}.se.conv1.conv.weight" in sd:
                conv(f"{bb}.se.conv1.conv", f"{dd}/se/reduce")
                conv(f"{bb}.se.conv2.conv", f"{dd}/se/expand")
            conv(f"{bb}.{project}.conv", f"{dd}/project_conv")
            tb.bn(sd, f"{bb}.{project}.bn", f"{dd}/project_bn")
            B += 1
        L += 1


def convert_swin_block(tb: TreeBuilder, sd, tp: str, dst: str):
    tb.ln(sd, tp + ".norm1", dst + "/norm1")
    tb.p(dst + "/attn/w_msa/relative_position_bias_table",
         sd[tp + ".attn.w_msa.relative_position_bias_table"])
    tb.linear(sd, tp + ".attn.w_msa.qkv", dst + "/attn/w_msa/qkv")
    tb.linear(sd, tp + ".attn.w_msa.proj", dst + "/attn/w_msa/proj")
    tb.ln(sd, tp + ".norm2", dst + "/norm2")
    convert_ffn(tb, sd, tp + ".ffn", dst + "/ffn")


def convert_dualpath_block(tb: TreeBuilder, sd, tp: str, dst: str):
    tb.conv(sd, tp + ".input_conv.0", dst + "/input_conv")
    tb.gn(sd, tp + ".input_conv.1", dst + "/input_gn")
    convert_swin_block(tb, sd, tp + ".bev_encoder", dst + "/bev_encoder")
    # BottleNeckASPP (aspp.py:132-171)
    tb.conv(sd, tp + ".aspp.input_conv.0", dst + "/aspp/input_conv")
    tb.gn(sd, tp + ".aspp.input_conv.1", dst + "/aspp/input_gn")
    convert_aspp2d(tb, sd, tp + ".aspp.aspp", dst + "/aspp/aspp", norm="gn")
    tb.conv(sd, tp + ".aspp.output_conv.0", dst + "/aspp/output_conv")
    tb.gn(sd, tp + ".aspp.output_conv.1", dst + "/aspp/output_gn")
    tb.conv(sd, tp + ".combine_coeff", dst + "/combine_coeff")
    if tp + ".downsample.0.weight" in sd:
        tb.conv(sd, tp + ".downsample.0", dst + "/downsample_conv")
        tb.gn(sd, tp + ".downsample.1", dst + "/downsample_gn")


def convert_occformer(sd: Dict[str, np.ndarray],
                      num_encoder_levels: int = 3) -> Dict[str, Any]:
    """Full reference checkpoint -> {'params': ..., 'batch_stats': ...}."""
    tb = TreeBuilder()

    # ---- image backbone (ResNet or EfficientNet naming) ----
    if "img_backbone.layers.0.conv.weight" in sd:
        convert_efficientnet(tb, sd, "img_backbone", "backbone")
    else:
        rp, rs = convert_resnet(sd, "img_backbone.")
        tb.params["backbone"] = rp
        tb.stats["backbone"] = rs

    # ---- SECONDFPN ----
    i = 0
    while f"img_neck.deblocks.{i}.0.weight" in sd:
        w = sd[f"img_neck.deblocks.{i}.0.weight"]
        # conv (stride<1 path) vs deconv: mmcv deconv weight is (I, O, K, K);
        # both 4D — disambiguate by module class is impossible from the dict,
        # so rely on OccFormer's configs: stride>=1 levels are deconvs except
        # fractional strides whose conv kernels equal the stride.  We detect
        # conv when in_channels (dim0) matches the known neck input.
        # For OccFormer checkpoints both cases appear; deconv has
        # shape (I, O, k, k) with I > O, fractional-stride conv has (O, I, k, k)
        # with O < I as well — fall back to trying deconv first and let shape
        # validation against the model tree settle it in `match_to_tree`.
        tb.deconv(sd, f"img_neck.deblocks.{i}.0", f"neck/deblock{i}_up")
        tb.p(f"neck/deblock{i}_conv/Conv_0/kernel", t2f_conv(w))
        tb.bn(sd, f"img_neck.deblocks.{i}.1", f"neck/deblock{i}_bn")
        i += 1

    # ---- view transformer ----
    convert_depthnet(tb, sd, "img_view_transformer.depth_net",
                     "view_transformer/depth_net")
    if "img_view_transformer.depth_aggregation_net.reduce_conv.weight" in sd:
        convert_depth_aggregation(tb, sd, "img_view_transformer.depth_aggregation_net",
                                  "view_transformer/depth_aggregation_net")

    # ---- 3D encoder ----
    pat = re.compile(r"^img_bev_encoder_backbone\.layers\.(\d+)\.(\d+)\.")
    blocks = sorted({(int(m.group(1)), int(m.group(2)))
                     for k in sd if (m := pat.match(k))})
    for si, bi in blocks:
        convert_dualpath_block(
            tb, sd, f"img_bev_encoder_backbone.layers.{si}.{bi}",
            f"bev_backbone/stage{si}_block{bi}",
        )

    # ---- pixel decoder ----
    neck = "img_bev_encoder_neck"
    for i in range(num_encoder_levels):
        tb.conv(sd, f"{neck}.input_convs.{i}.conv", f"bev_neck/input_conv{i}")
        tb.gn(sd, f"{neck}.input_convs.{i}.gn", f"bev_neck/input_gn{i}")
    li = 0
    while f"{neck}.encoder.layers.{li}.attentions.0.value_proj.weight" in sd:
        base = f"{neck}.encoder.layers.{li}"
        dst = f"bev_neck/layer{li}"
        convert_deform_attn(tb, sd, base + ".attentions.0", dst + "/attn")
        convert_ffn(tb, sd, base + ".ffns.0", dst + "/ffn")
        tb.ln(sd, base + ".norms.0", dst + "/norm1")
        tb.ln(sd, base + ".norms.1", dst + "/norm2")
        li += 1
    if li > 1:
        # scan-with-stacked-params layout (pixel_decoder.scan_layers=True):
        # torch encoder.layers.{i}.* -> layers/layer/* with a stacked leading
        # axis.  Stacking the converted per-layer trees preserves element
        # provenance, so the export permutation round-trip stays bit-exact.
        neck_p = tb.params["bev_neck"]
        stacked = [neck_p.pop(f"layer{i}") for i in range(li)]
        neck_p["layers"] = {"layer": _stack_trees(stacked)}
    tb.p("bev_neck/level_encoding", sd[f"{neck}.level_encoding.weight"])
    i = 0
    while f"{neck}.lateral_convs.{i}.conv.weight" in sd:
        tb.conv(sd, f"{neck}.lateral_convs.{i}.conv", f"bev_neck/lateral_conv{i}")
        tb.gn(sd, f"{neck}.lateral_convs.{i}.gn", f"bev_neck/lateral_gn{i}")
        tb.conv(sd, f"{neck}.output_convs.{i}.conv", f"bev_neck/output_conv{i}")
        tb.gn(sd, f"{neck}.output_convs.{i}.gn", f"bev_neck/output_gn{i}")
        i += 1
    tb.conv(sd, f"{neck}.mask_feature", "bev_neck/mask_feature")

    # ---- Mask2Former head ----
    head = "pts_bbox_head"
    tb.p("head/query_embed", sd[f"{head}.query_embed.weight"])
    tb.p("head/query_feat", sd[f"{head}.query_feat.weight"])
    tb.p("head/level_embed", sd[f"{head}.level_embed.weight"])
    tb.linear(sd, f"{head}.cls_embed", "head/cls_embed")
    tb.linear(sd, f"{head}.mask_embed.0", "head/mask_embed_fc1")
    tb.linear(sd, f"{head}.mask_embed.2", "head/mask_embed_fc2")
    tb.linear(sd, f"{head}.mask_embed.4", "head/mask_embed_fc3")
    tb.ln(sd, f"{head}.transformer_decoder.post_norm", "head/post_norm")
    li = 0
    while f"{head}.transformer_decoder.layers.{li}.norms.0.weight" in sd:
        base = f"{head}.transformer_decoder.layers.{li}"
        dst = f"head/layer{li}"
        # operation order: cross_attn (attentions.0), self_attn (attentions.1)
        convert_mmcv_mha(tb, sd, base + ".attentions.0", dst + "/cross_attn")
        convert_mmcv_mha(tb, sd, base + ".attentions.1", dst + "/self_attn")
        convert_ffn(tb, sd, base + ".ffns.0", dst + "/ffn")
        tb.ln(sd, base + ".norms.0", dst + "/norm1")
        tb.ln(sd, base + ".norms.1", dst + "/norm2")
        tb.ln(sd, base + ".norms.2", dst + "/norm3")
        li += 1

    return {"params": tb.params, "batch_stats": tb.stats}


def _walk_leaves(conv_node, tgt_node, path, out):
    """Pair converted entries with target-tree leaves (same selection rule as
    `match_to_tree`: target names pick among converted candidates)."""
    for k, tgt_v in tgt_node.items():
        if isinstance(tgt_v, dict):
            sub = conv_node.get(k, {}) if isinstance(conv_node, dict) else {}
            _walk_leaves(sub, tgt_v, path + "/" + k, out)
        else:
            v = conv_node.get(k) if isinstance(conv_node, dict) else None
            if v is not None and tuple(v.shape) == tuple(
                    np.shape(tgt_v) if not hasattr(tgt_v, "shape") else tgt_v.shape):
                out[path + "/" + k] = v


def build_export_permutation(manifest: Dict[str, Any], variables: Dict,
                             convert=convert_occformer):
    """For each flax leaf, the flat torch-buffer indices its elements came
    from.  ``manifest`` maps torch key -> shape (the released-checkpoint key
    space, see tests/fixtures/key_manifests); ``variables`` is the model tree
    (concrete arrays or ShapeDtypeStructs); ``convert`` the forward
    conversion of a state dict to ``{'params', 'batch_stats'}`` (the whole
    model's by default).  Returns
    (index_map {flax_path: int64 array}, offsets {torch_key: (start, shape)},
    total_elements)."""
    probe: Dict[str, np.ndarray] = {}
    offsets: Dict[str, Tuple[int, Tuple[int, ...]]] = {}
    total = 0
    for k, shape in manifest.items():
        shape = tuple(int(s) for s in shape)
        n = int(np.prod(shape)) if shape else 1
        probe[k] = np.arange(total, total + n, dtype=np.float64).reshape(shape)
        offsets[k] = (total, shape)
        total += n

    conv = convert(probe)
    leaves: Dict[str, np.ndarray] = {}
    _walk_leaves(conv.get("params", {}), variables.get("params", {}),
                 "params", leaves)
    _walk_leaves(conv.get("batch_stats", {}), variables.get("batch_stats", {}),
                 "batch_stats", leaves)
    index_map = {p: np.rint(v).astype(np.int64) for p, v in leaves.items()}
    return index_map, offsets, total




def _to_numpy_tree(node):
    if isinstance(node, dict) or hasattr(node, "items"):
        return {k: _to_numpy_tree(v) for k, v in node.items()}
    return np.asarray(node)


def resnet_tree(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``convert_resnet`` as a ``convert`` of ``flax_to_torch_state_dict``:
    a standalone ResNet's state dict -> ``{'params', 'batch_stats'}``."""
    params, stats = convert_resnet(sd)
    return {"params": params, "batch_stats": stats}


def convert_spconv(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``ops/spconv.py:SubMConv3d`` or ``SparseConv3d``'s state dict ->
    ``{'params'}`` of the JAX package's module of that name (either
    backend: both keep the dense ``Conv``'s tree, ``conv/Conv_0/kernel``
    [k, k, k, C, D] and ``bias``), as a ``convert`` of
    ``flax_to_torch_state_dict``."""
    tb = TreeBuilder()
    tb.conv(sd, "conv", "conv")
    return {"params": tb.params, "batch_stats": tb.stats}


def convert_bevstereo(sd: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """``models/bevstereo.py:ViewTransformerLSSBEVStereo``'s state dict ->
    ``{'params', 'batch_stats'}`` of the JAX package's module of that name
    (``occformer_tpu/models/bevstereo.py:203``), as a ``convert`` of
    ``flax_to_torch_state_dict``.  The port's modules carry JAX's names; the
    transposed convolutions' kernels flip (``t2f_deconv``) and sit directly
    under ``msr_up{i}``."""
    tb = TreeBuilder()
    dn, dst = "depth_net", "depth_net"
    tb.bn(sd, dn + ".bn_cam", dst + "/bn_cam")
    tb.conv(sd, dn + ".reduce_conv", dst + "/reduce_conv")
    tb.bn(sd, dn + ".reduce_bn", dst + "/reduce_bn")

    def lin1x1(t, d):  # torch 1x1 Conv2d (O, I, 1, 1) -> flax Dense (I, O)
        tb.p(d + "/Dense_0/kernel", t2f_linear(sd[t + ".weight"][:, :, 0, 0]))
        tb.p(d + "/Dense_0/bias", sd[t + ".bias"])

    def block(t, d):
        for i in (1, 2):
            tb.conv(sd, f"{t}.conv{i}", f"{d}/conv{i}")
            tb.bn(sd, f"{t}.bn{i}", f"{d}/bn{i}")

    for branch in ("context", "depth"):
        tb.linear(sd, f"{dn}.{branch}_mlp.fc1", f"{dst}/{branch}_mlp/fc1")
        tb.linear(sd, f"{dn}.{branch}_mlp.fc2", f"{dst}/{branch}_mlp/fc2")
        lin1x1(f"{dn}.{branch}_se.conv_reduce", f"{dst}/{branch}_se/conv_reduce")
        lin1x1(f"{dn}.{branch}_se.conv_expand", f"{dst}/{branch}_se/conv_expand")
    tb.conv(sd, dn + ".context_conv", dst + "/context_conv")
    for name in ("depth_block0", "depth_block1", "mono_block", "msr_block"):
        block(f"{dn}.{name}", f"{dst}/{name}")
    convert_aspp2d(tb, sd, dn + ".aspp", dst + "/aspp", norm="bn")
    convert_dcn(tb, sd, dn + ".dcn", dst + "/dcn")
    for name in ("mono_pred", "msr_pred"):
        tb.conv(sd, f"{dn}.{name}", f"{dst}/{name}")
    for i in range(2):
        tb.p(f"{dst}/msr_up{i}/kernel", t2f_deconv(sd[f"{dn}.msr_up{i}.weight"]))
        tb.p(f"{dst}/msr_up{i}/bias", sd[f"{dn}.msr_up{i}.bias"])
        tb.bn(sd, f"{dn}.msr_up_bn{i}", f"{dst}/msr_up_bn{i}")
    for name in ("sim_conv1", "sim_conv2", "sim_out", "dds_conv1", "dds_conv2", "dds_out",
                 "mask_conv", "mask_out"):
        if name + ".weight" in sd:
            tb.conv(sd, name, name)
    for name in ("sim_bn1", "sim_bn2", "dds_bn1", "dds_bn2", "mask_bn"):
        if name + ".weight" in sd:
            tb.bn(sd, name, name)
    for name in ("mask_block0", "mask_block1"):
        if name + ".conv1.weight" in sd:
            block(name, name)
    return {"params": tb.params, "batch_stats": tb.stats}


def flax_to_torch_state_dict(variables: Dict, model, manifest: Optional[Dict] = None,
                             window_size: int = 7,
                             convert=convert_occformer) -> Dict[str, "torch.Tensor"]:
    """JAX package ``{'params', 'batch_stats'}`` (numpy arrays) -> the port
    model's ``state_dict`` in the reference key space.

    ``manifest`` maps key -> shape; by default it is the port ``model``'s own
    ``state_dict()`` shapes.  ``convert`` is the forward conversion whose
    permutation is inverted: the whole model's (``convert_occformer``) or a
    part's (``resnet_tree`` for a ``models/resnet.py:ResNet``,
    ``convert_bevstereo`` for a ``models/bevstereo.py`` view transformer,
    ``convert_spconv`` for an ``ops/spconv.py`` sparse conv).  Keys the
    converter never consumes are synthesized as the exporter does:
    ``num_batches_tracked`` zeros, the Swin ``relative_position_index``, and
    the view transformer's ``dx/bx/nx`` from the model's grid config.  Raises
    if any other key stays unfilled.
    """
    import torch

    variables = _to_numpy_tree(variables)
    if manifest is None:
        manifest = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    index_map, offsets, total = build_export_permutation(manifest, variables, convert)

    def tree_get(root, path):
        node = root
        for k in path.split("/"):
            node = node[k]
        return node

    flat = np.zeros((total,), np.float64)
    filled = np.zeros((total,), bool)
    for path, idx in index_map.items():
        leaf = np.asarray(tree_get(variables, path), np.float64)
        flat[idx.ravel()] = leaf.ravel()
        filled[idx.ravel()] = True

    grid_consts = {}
    if hasattr(model, "img_view_transformer"):
        grid = model.img_view_transformer.grid_config
        dx, bx, nx = gen_dx_bx(grid["xbound"], grid["ybound"], grid["zbound"])
        grid_consts = {"img_view_transformer.dx": dx, "img_view_transformer.bx": bx,
                       "img_view_transformer.nx": nx.astype(np.float32)}
    out: Dict[str, np.ndarray] = {}
    missing = []
    for k, (start, shape) in offsets.items():
        n = int(np.prod(shape)) if shape else 1
        if filled[start:start + n].all():
            out[k] = flat[start:start + n].reshape(shape).astype(np.float32)
        elif k.endswith(".num_batches_tracked"):
            out[k] = np.zeros(shape, np.int64)
        elif k.endswith(".relative_position_index"):
            out[k] = relative_position_index(window_size, window_size).astype(np.int64)
        elif k in grid_consts:
            out[k] = grid_consts[k]
        else:
            missing.append(k)
    if missing:
        raise ValueError(
            f"{len(missing)} manifest keys not reachable from the flax tree "
            f"(first: {missing[:10]}): model/manifest mismatch")
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in out.items()}
