"""The port's modules against the JAX package's, on the CPU in float32.

Each port module is built at a small size with randomized parameters (and
BatchNorm statistics); its ``state_dict`` is moved into the JAX module with
the JAX package's own ``convert_*`` functions, as the existing
tests/test_*_convert.py do, and both run on the same seeded inputs.
Tolerance rtol/atol 1e-4: the same float32 math through different conv and
matmul libraries and summation orders.
"""
import numpy as np
import pytest
import torch
import torch.nn as tnn

import jax
import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.engine.checkpoint import convert_resnet
from occformer_tpu.engine.convert_weights import (
    TreeBuilder,
    convert_dcn,
    convert_deform_attn,
    convert_depthnet,
    convert_dualpath_block,
    convert_ffn,
    convert_mmcv_mha,
    match_to_tree,
    t2f_conv,
)
from occformer_tpu.models import layers as jl
from occformer_tpu.models.dcn import DeformConv2d as JaxDCN
from occformer_tpu.models.depthnet import DepthNet as JaxDepthNet
from occformer_tpu.models.lss import ViewTransformerLiftSplatShootVoxel as JaxLSS
from occformer_tpu.models.mask2former_head import Mask2FormerOccHead as JaxHead
from occformer_tpu.models.mask2former_head import mask_logits_from_embeds as j_logits
from occformer_tpu.models.occnet import OccupancyEncoder as JaxEncoder
from occformer_tpu.models.pixel_decoder import MSDeformAttnPixelDecoder3D as JaxDecoder
from occformer_tpu.models.resnet import Bottleneck as JaxBottleneck
from occformer_tpu.models.resnet import ResNet as JaxResNet
from occformer_tpu.models.second_fpn import SECONDFPN as JaxFPN
from occformer_tpu_torch.models import layers as tl
from occformer_tpu_torch.models.dcn import DeformConv2d
from occformer_tpu_torch.models.depthnet import DepthNet
from occformer_tpu_torch.models.lss import ViewTransformerLiftSplatShootVoxel
from occformer_tpu_torch.models.mask2former_head import Mask2FormerNuscOccHead
from occformer_tpu_torch.models.mask2former_head import mask_logits_from_embeds
from occformer_tpu_torch.models.occnet import OccupancyEncoder
from occformer_tpu_torch.models.pixel_decoder import MSDeformAttnPixelDecoder3D
from occformer_tpu_torch.models.resnet import Bottleneck, ResNet
from occformer_tpu_torch.models.second_fpn import SECONDFPN

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomize(module, seed=0):
    """Non-trivial parameters and norm statistics, from a seeded generator."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (tnn.BatchNorm1d, tnn.BatchNorm2d)):
                m.running_mean.uniform_(-0.2, 0.2, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
            if isinstance(m, (tnn.BatchNorm1d, tnn.BatchNorm2d, tnn.GroupNorm, tnn.LayerNorm)):
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.uniform_(-0.2, 0.2, generator=g)
        for name, p in module.named_parameters():
            if "norm" in name or ".bn" in name or "gn" in name:
                continue
            if p.dim() >= 2 and not any(s in name for s in ("embed", "bias_table")):
                continue  # keep the torch default bounds for kernels
            if "sampling_offsets" in name:
                continue
            p.uniform_(-0.3, 0.3, generator=g)
    return module


def _sd(module, prefix):
    return {prefix + k: v.detach().numpy() for k, v in module.state_dict().items()}


def _jax_vars(tb, dst, init):
    target = {"params": init["params"], "batch_stats": init.get("batch_stats", {})}
    conv = {"params": tb.params[dst], "batch_stats": tb.stats.get(dst, {})}
    variables, missing = match_to_tree(conv, target)
    assert not missing, missing
    return variables


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), **tol)


# ---- layers ---------------------------------------------------------------

def test_multihead_attention_with_mask_matches_jax():
    rng = np.random.RandomState(0)
    C, H, Q, K = 24, 4, 6, 9
    torch.manual_seed(0)
    tm = _randomize(tl.MultiheadAttention(C, H))
    tb = TreeBuilder()
    convert_mmcv_mha(tb, _sd(tm, "x.attn."), "x", "mha")
    q, k = rng.randn(2, Q, C).astype(np.float32), rng.randn(2, K, C).astype(np.float32)
    mask = rng.rand(2, 1, Q, K) > 0.6
    mask[..., 0] = False
    jm = jl.MultiheadAttention(C, H)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), q, k, k, mask)
    ref = jax.jit(jm.apply)(_jax_vars(tb, "mha", init), q, k, k, mask)
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(k),
                 torch.from_numpy(mask))
    _close(got, ref)


@pytest.mark.parametrize("act", ["gelu", "relu"])
def test_ffn_matches_jax(act):
    rng = np.random.RandomState(1)
    torch.manual_seed(1)
    tm = _randomize(tl.FFN(16, 40, act=act))
    tb = TreeBuilder()
    convert_ffn(tb, _sd(tm, "f."), "f", "ffn")
    x = rng.randn(3, 5, 16).astype(np.float32)
    jm = jl.FFN(16, 40, act=jax.nn.relu if act == "relu" else jax.nn.gelu)
    ref = jax.jit(jm.apply)(_jax_vars(tb, "ffn", jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)), x)
    with torch.no_grad():
        _close(tm(torch.from_numpy(x)), ref)


# ---- image path ------------------------------------------------------------

def test_resnet18_matches_jax():
    rng = np.random.RandomState(2)
    torch.manual_seed(2)
    tm = _randomize(ResNet(depth=18)).eval()
    params, stats = convert_resnet(_sd(tm, ""))
    jm = JaxResNet(depth=18)
    x = rng.randn(1, 64, 96, 3).astype(np.float32)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables, missing = match_to_tree({"params": params, "batch_stats": stats},
                                       {"params": init["params"],
                                        "batch_stats": init["batch_stats"]})
    assert not missing, missing
    refs = jax.jit(jm.apply)(variables, x)
    with torch.no_grad():
        gots = tm(_nchw(x))
    for g, r in zip(gots, refs):
        _close(np.moveaxis(g.numpy(), 1, -1), r)


def test_bottleneck_matches_jax():
    rng = np.random.RandomState(3)
    torch.manual_seed(3)
    tm = _randomize(Bottleneck(16, 8, stride=2, downsample=True)).eval()
    sd = _sd(tm, "layer1.0.")
    sd["conv1.weight"] = np.zeros((8, 3, 7, 7), np.float32)  # stem, not compared
    for k, v in (("weight", 1), ("bias", 0), ("running_mean", 0), ("running_var", 1)):
        sd[f"bn1.{k}"] = np.full(8, v, np.float32)
    params, stats = convert_resnet(sd)
    jm = JaxBottleneck(planes=8, stride=2, has_downsample=True)
    x = rng.randn(2, 10, 12, 16).astype(np.float32)
    ref = jax.jit(jm.apply)({"params": params["layer1_0"], "batch_stats": stats["layer1_0"]}, x)
    with torch.no_grad():
        _close(np.moveaxis(tm(_nchw(x)).numpy(), 1, -1), ref)


def test_secondfpn_matches_jax():
    rng = np.random.RandomState(4)
    cin, cout, strides = (8, 12, 16, 20), (6, 6, 6, 6), (0.5, 1, 2, 4)
    torch.manual_seed(4)
    tm = _randomize(SECONDFPN(cin, cout, strides)).eval()
    sd = _sd(tm, "img_neck.")
    tb = TreeBuilder()
    for i in range(4):
        tb.deconv(sd, f"img_neck.deblocks.{i}.0", f"neck/deblock{i}_up")
        tb.p(f"neck/deblock{i}_conv/Conv_0/kernel", t2f_conv(sd[f"img_neck.deblocks.{i}.0.weight"]))
        tb.bn(sd, f"img_neck.deblocks.{i}.1", f"neck/deblock{i}_bn")
    feats = [rng.randn(2, 16 // 2 ** i, 24 // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(cin)]
    jm = JaxFPN(in_channels=cin, out_channels=cout, upsample_strides=strides)
    ref = jax.jit(jm.apply)(_jax_vars(tb, "neck", jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)), feats)
    with torch.no_grad():
        got = tm([_nchw(f) for f in feats])
    _close(np.moveaxis(got.numpy(), 1, -1), ref)


def test_deform_conv_matches_jax():
    rng = np.random.RandomState(5)
    torch.manual_seed(5)
    tm = DeformConv2d(16, 12, groups=4)
    with torch.no_grad():
        tm.conv_offset.weight.uniform_(-0.2, 0.2)
        tm.conv_offset.bias.uniform_(-1.0, 1.0)
    tb = TreeBuilder()
    convert_dcn(tb, _sd(tm, "dcn."), "dcn", "dcn")
    x = rng.randn(2, 7, 9, 16).astype(np.float32)
    jm = JaxDCN(12, kernel_size=3, groups=4)
    ref = jax.jit(jm.apply)(_jax_vars(tb, "dcn", jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)), x)
    with torch.no_grad():
        _close(np.moveaxis(tm(_nchw(x)).numpy(), 1, -1), ref)


def _depthnet_pair(mid, ctx, d, seed):
    torch.manual_seed(seed)
    tm = _randomize(DepthNet(mid, ctx, d), seed).eval()
    with torch.no_grad():
        dcn = tm.depth_conv[4]
        dcn.conv_offset.weight.uniform_(-0.05, 0.05)
        dcn.conv_offset.bias.uniform_(-1.0, 1.0)
    return tm


def test_depthnet_matches_jax():
    rng = np.random.RandomState(6)
    MID, CTX, D = 16, 8, 12
    tm = _depthnet_pair(MID, CTX, D, 6)
    tb = TreeBuilder()
    convert_depthnet(tb, _sd(tm, "dn."), "dn", "depth_net")
    x = rng.randn(2, 6, 8, MID).astype(np.float32)
    mlp = rng.randn(2, 27).astype(np.float32)
    jm = JaxDepthNet(mid_channels=MID, context_channels=CTX, depth_channels=D)
    dep_j, ctx_j = jax.jit(jm.apply)(
        _jax_vars(tb, "depth_net", jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, mlp)), x, mlp)
    with torch.no_grad():
        dep_t, ctx_t = tm(_nchw(x), torch.from_numpy(mlp))
    _close(np.moveaxis(dep_t.numpy(), 1, -1), dep_j)
    _close(np.moveaxis(ctx_t.numpy(), 1, -1), ctx_j)


def test_lss_view_transformer_matches_jax():
    rng = np.random.RandomState(7)
    C_IN, C_T = 16, 8
    cfg = dict(grid_config=tiny_cfg.GRID_CONFIG, data_config=tiny_cfg.DATA_CONFIG,
               numC_input=C_IN, numC_Trans=C_T, downsample=tiny_cfg.DOWNSAMPLE)
    torch.manual_seed(7)
    tm = ViewTransformerLiftSplatShootVoxel(**cfg)
    D = tm.D
    tm.depth_net = _depthnet_pair(C_IN, C_T, D, 7)
    tb = TreeBuilder()
    convert_depthnet(tb, _sd(tm, ""), "depth_net", "vt/depth_net")
    batch = tiny_cfg.make_batch(rng, B=1)
    fH, fW = tiny_cfg.INPUT_SIZE[0] // 8, tiny_cfg.INPUT_SIZE[1] // 8
    x = rng.randn(1, tiny_cfg.NUM_CAMS, fH, fW, C_IN).astype(np.float32)
    geo = [batch[k] for k in ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")]
    jm = JaxLSS(**cfg)
    variables = _jax_vars(tb, "vt", jax.eval_shape(jm.init, jax.random.PRNGKey(0), x, *geo))
    vol_j, dp_j = jax.jit(jm.apply)(variables, x, *geo)
    with torch.no_grad():
        vol_t, dp_t = tm(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 2))),
                         *(torch.from_numpy(g) for g in geo))
    assert np.abs(np.asarray(vol_j)).max() > 0  # the scatter hit the grid
    _close(vol_t.numpy(), vol_j)
    _close(dp_t.numpy(), dp_j)


# ---- 3D encoder, pixel decoder, head -----------------------------------------

def test_occupancy_encoder_matches_jax():
    """Swin (shifted and not, with window padding), BottleNeckASPP and the
    dual-path fusion, through all four stages."""
    rng = np.random.RandomState(8)
    kw = dict(in_channels=32, num_stage=4, block_numbers=(1, 1, 1, 1),
              block_inplanes=(32, 32, 64, 64), block_strides=(1, 2, 2, 2), num_groups=8)
    torch.manual_seed(8)
    tm = _randomize(OccupancyEncoder(**kw), 8).eval()
    sd = _sd(tm, "enc.")
    tb = TreeBuilder()
    for i in range(4):
        convert_dualpath_block(tb, sd, f"enc.layers.{i}.0", f"enc/stage{i}_block0")
    x = rng.randn(1, 10, 10, 4, 32).astype(np.float32)
    jm = JaxEncoder(**kw, with_cp=False)
    refs = jax.jit(jm.apply)(_jax_vars(tb, "enc", jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)), x)
    with torch.no_grad():
        gots = tm(torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))))
    for g, r in zip(gots, refs):
        _close(np.moveaxis(g.numpy(), 1, -1), r)


def test_pixel_decoder_matches_jax():
    rng = np.random.RandomState(9)
    C, IN = 24, (16, 16, 32, 32)
    kw = dict(in_channels=IN, feat_channels=C, out_channels=C, num_encoder_levels=3,
              num_encoder_layers=2, num_heads=2, num_points=2, feedforward_channels=2 * C,
              num_groups=4, pos_num_feats=C // 3)
    torch.manual_seed(9)
    tm = _randomize(MSDeformAttnPixelDecoder3D(**kw), 9).eval()
    with torch.no_grad():
        for layer in tm.encoder.layers:
            layer.attentions[0].sampling_offsets.weight.uniform_(-0.05, 0.05)
    sd = _sd(tm, "n.")
    tb = TreeBuilder()
    for i in range(3):
        tb.conv(sd, f"n.input_convs.{i}.conv", f"n/input_conv{i}")
        tb.gn(sd, f"n.input_convs.{i}.gn", f"n/input_gn{i}")
    for li in range(2):
        base = f"n.encoder.layers.{li}"
        convert_deform_attn(tb, sd, base + ".attentions.0", f"n/layer{li}/attn")
        convert_ffn(tb, sd, base + ".ffns.0", f"n/layer{li}/ffn")
        tb.ln(sd, base + ".norms.0", f"n/layer{li}/norm1")
        tb.ln(sd, base + ".norms.1", f"n/layer{li}/norm2")
    tb.p("n/level_encoding", sd["n.level_encoding.weight"])
    tb.conv(sd, "n.lateral_convs.0.conv", "n/lateral_conv0")
    tb.gn(sd, "n.lateral_convs.0.gn", "n/lateral_gn0")
    tb.conv(sd, "n.output_convs.0.conv", "n/output_conv0")
    tb.gn(sd, "n.output_convs.0.gn", "n/output_gn0")
    tb.conv(sd, "n.mask_feature", "n/mask_feature")

    shapes = [(16, 16, 8), (8, 8, 4), (4, 4, 2), (2, 2, 2)]
    feats = [rng.randn(1, *s, c).astype(np.float32) for s, c in zip(shapes, IN)]
    jm = JaxDecoder(**kw, scan_layers=False)
    refs = jax.jit(jm.apply)(_jax_vars(tb, "n", jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)), feats)
    with torch.no_grad():
        gots = tm([torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 1)))
                   for f in feats])
    assert len(gots) == len(refs) == 4
    for g, r in zip(gots, refs):
        _close(np.moveaxis(g.numpy(), 1, -1), r)


@pytest.mark.parametrize("bias", [True, False])
@pytest.mark.parametrize("k", [1, 3])
def test_conv3d_fixed_order_backward_is_conv3d(bias, k):
    """The pixel decoder's FPN convolution (C.8): the same output as
    ``F.conv3d`` and, through ``aten.convolution_backward``, the same
    gradients as autograd's in input, weight and bias, on the CPU; the
    module is ``nn.Conv3d`` with the same parameters."""
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randn(2, 6, 5, 4, 3).astype(np.float32))
    w = torch.from_numpy(rng.randn(8, 6, k, k, k).astype(np.float32))
    b = torch.from_numpy(rng.randn(8).astype(np.float32)) if bias else None
    gout = torch.from_numpy(rng.randn(2, 8, 5, 4, 3).astype(np.float32))
    pad = (k // 2,) * 3
    leaves = [t.clone().requires_grad_(True) for t in (x, w) + ((b,) if bias else ())]
    got = tl.conv3d_fixed_order_backward(leaves[0], leaves[1], leaves[2] if bias else None,
                                        padding=pad)
    grads = torch.autograd.grad(got, leaves, gout)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w) + ((b,) if bias else ())]
    ref = torch.nn.functional.conv3d(ref_leaves[0], ref_leaves[1],
                                     ref_leaves[2] if bias else None, padding=pad)
    ref_grads = torch.autograd.grad(ref, ref_leaves, gout)
    assert torch.equal(got, ref)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-6)
    m = tl.Conv3dFixedOrderBackward(6, 8, k, padding=k // 2, bias=bias)
    assert isinstance(m, tnn.Conv3d) and list(m.state_dict()) == (
        ["weight", "bias"] if bias else ["weight"])
    assert torch.equal(m(x), torch.nn.functional.conv3d(x, m.weight, m.bias, padding=pad))


@pytest.mark.parametrize("dilation", [1, 6, 18])
def test_conv2d_im2col_backward_is_conv2d(dilation):
    """The DepthNet's dilated ASPP convolution (C.8): ``F.conv2d``'s output,
    and through im2col and matrix products autograd's gradients in input,
    weight and bias, on the CPU (float32, 1e-5 of max |grad|: the same sums
    in another order), on a map smaller than the dilation."""
    rng = np.random.RandomState(dilation)
    x = torch.from_numpy(rng.randn(2, 5, 16, 11).astype(np.float32))
    w = torch.from_numpy(rng.randn(7, 5, 3, 3).astype(np.float32))
    b = torch.from_numpy(rng.randn(7).astype(np.float32))
    gout = torch.from_numpy(rng.randn(2, 7, 16, 11).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    got = tl.conv2d_im2col_backward(*leaves, padding=(dilation,) * 2, dilation=(dilation,) * 2)
    grads = torch.autograd.grad(got, leaves, gout)
    ref_leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
    ref = torch.nn.functional.conv2d(*ref_leaves, padding=dilation, dilation=dilation)
    ref_grads = torch.autograd.grad(ref, ref_leaves, gout)
    assert torch.equal(got, ref)
    for g, r in zip(grads, ref_grads):
        torch.testing.assert_close(g, r, rtol=0, atol=1e-5 * r.abs().max().item())
    m = tl.Conv2dIm2colBackward(5, 7, 3, padding=dilation, dilation=dilation, bias=False)
    assert isinstance(m, tnn.Conv2d) and list(m.state_dict()) == ["weight"]
    with pytest.raises(ValueError, match="same"):
        tl.Conv2dIm2colBackward(5, 7, 3, padding=1, dilation=2)


def test_mask2former_head_matches_jax():
    rng = np.random.RandomState(10)
    C, NQ, NH, NL, NCLS = 24, 5, 3, 4, 6
    torch.manual_seed(10)
    tm = _randomize(Mask2FormerNuscOccHead(C, C, NCLS, NQ, num_heads=NH,
                                           num_decoder_layers=NL,
                                           feedforward_channels=2 * C), 10).eval()
    sd = _sd(tm, "h.")
    tb = TreeBuilder()
    for k in ("query_embed", "query_feat", "level_embed"):
        tb.p(f"head/{k}", sd[f"h.{k}.weight"])
    tb.linear(sd, "h.cls_embed", "head/cls_embed")
    for i, t in enumerate((0, 2, 4)):
        tb.linear(sd, f"h.mask_embed.{t}", f"head/mask_embed_fc{i + 1}")
    tb.ln(sd, "h.transformer_decoder.post_norm", "head/post_norm")
    for li in range(NL):
        base = f"h.transformer_decoder.layers.{li}"
        convert_mmcv_mha(tb, sd, base + ".attentions.0", f"head/layer{li}/cross_attn")
        convert_mmcv_mha(tb, sd, base + ".attentions.1", f"head/layer{li}/self_attn")
        convert_ffn(tb, sd, base + ".ffns.0", f"head/layer{li}/ffn")
        for i in range(3):
            tb.ln(sd, f"{base}.norms.{i}", f"head/layer{li}/norm{i + 1}")

    shapes = [(8, 8, 4), (8, 8, 4), (4, 4, 2), (2, 2, 1)]
    feats = [rng.randn(1, *s, C).astype(np.float32) for s in shapes]
    jm = JaxHead(feat_channels=C, out_channels=C, num_occupancy_classes=NCLS,
                 num_queries=NQ, num_heads=NH, num_decoder_layers=NL,
                 feedforward_channels=2 * C)
    cls_j, emb_j, mf_j = jax.jit(jm.apply)(
        _jax_vars(tb, "head", jax.eval_shape(jm.init, jax.random.PRNGKey(0), feats)), feats)
    with torch.no_grad():
        cls_t, emb_t, mf_t = tm([torch.from_numpy(np.ascontiguousarray(np.moveaxis(f, -1, 1)))
                                 for f in feats])
    _close(cls_t.numpy(), cls_j)
    _close(emb_t.numpy(), emb_j)
    _close(mf_t.numpy(), mf_j)
    _close(mask_logits_from_embeds(emb_t, mf_t).numpy(), j_logits(emb_j, mf_j))
