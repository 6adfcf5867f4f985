"""The DepthNet's deformable convolution read through K4, held to JAX.

``models/dcn.py:DeformConv2d`` reads its nine taps with
``ops/trilerp_fused.py:fused_multilevel_gather`` at Z = 1 (K4 on the card,
its plain version here on the CPU).  At the tiny DepthNet's widths (64
channels, 4 groups, the 4 x 8 feature map of 2 cameras) the port's output
and its gradients in the input, the offsets' conv and the weight must
match ``occformer_tpu/models/dcn.py:DeformConv2d`` on the same weights and
inputs: outputs within 1e-5 and gradients within 1e-4 of max |JAX| (the
same float32 math in another summation order).  The JAX gradients come
back in the JAX layout; the port's are moved into it with the JAX
package's own ``convert_dcn`` (a pure re-layout).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.engine.convert_weights import TreeBuilder, convert_dcn, match_to_tree
from occformer_tpu.models.dcn import DeformConv2d as JaxDCN
from occformer_tpu_torch.models.dcn import DeformConv2d
from occformer_tpu_torch.ops.sampling import grid_sample_2d
from occformer_tpu_torch.ops.trilerp_fused import fused_multilevel_gather

MID, GROUPS = 64, 4  # tests/tiny_cfg.py: numC_input 64; the DepthNet's DCN groups
FEAT = (2, 4, 8)  # 2 cameras, INPUT_SIZE (32, 64) / DOWNSAMPLE 8


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rel, name):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    scale = np.abs(ref).max()
    err = np.abs(got - ref).max()
    assert err <= rel * scale, f"{name}: max|diff| {err} > {rel} * {scale}"


def _pair(seed):
    torch.manual_seed(seed)
    tm = DeformConv2d(MID, MID, 3, padding=1, groups=GROUPS)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # offsets of up to a few pixels: taps off the grid and outside it
        tm.conv_offset.weight.uniform_(-0.05, 0.05, generator=g)
        tm.conv_offset.bias.uniform_(-1.5, 1.5, generator=g)
    sd = {"dcn." + k: v.detach().numpy() for k, v in tm.state_dict().items()}
    tb = TreeBuilder()
    convert_dcn(tb, sd, "dcn", "dcn")
    return tm, tb


@pytest.mark.parametrize("seed", [0, 1])
def test_dcn_through_k4_matches_jax(seed):
    rng = np.random.RandomState(seed)
    B, H, W = FEAT
    x = rng.randn(B, H, W, MID).astype(np.float32)
    probe = rng.randn(B, H, W, MID).astype(np.float32)
    tm, tb = _pair(seed)

    jm = JaxDCN(MID, kernel_size=3, groups=GROUPS)
    init = jax.eval_shape(jm.init, jax.random.PRNGKey(0), x)
    variables, missing = match_to_tree({"params": tb.params["dcn"]}, {"params": init["params"]})
    assert not missing, missing

    def loss(params, xj):
        return jnp.sum(jm.apply({"params": params}, xj) * probe)

    ref = jax.jit(jm.apply)(variables, x)
    d_params, d_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(variables["params"], x)

    xt = torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, 1))).requires_grad_(True)
    out = tm(xt)
    (out * torch.from_numpy(np.ascontiguousarray(np.moveaxis(probe, -1, 1)))).sum().backward()
    _close(np.moveaxis(out.detach().numpy(), 1, -1), ref, 1e-5, "output")
    _close(np.moveaxis(xt.grad.numpy(), 1, -1), d_x, 1e-4, "d_input")

    grads = TreeBuilder()
    convert_dcn(grads, {"dcn." + k: p.grad.numpy() for k, p in tm.named_parameters()},
                "dcn", "dcn")
    got = jax.tree_util.tree_leaves_with_path(grads.params["dcn"])
    want = dict(jax.tree_util.tree_leaves_with_path(d_params))
    assert len(got) == len(want) == 3
    for path, g in got:
        _close(g, want[path], 1e-4, jax.tree_util.keystr(path))
    # the offsets really move the taps: their conv has a gradient
    assert np.abs(tm.conv_offset.weight.grad.numpy()).max() > 0


@pytest.mark.parametrize("align_corners", [True, False])
def test_k4_at_one_z_level_is_the_bilinear_sample(align_corners):
    """One level of Z = 1 read at (y, x, 0): ``grid_sample_2d``'s values and
    its gradients in the image and the coordinates (float32, 1e-5 / 1e-4)."""
    rng = np.random.RandomState(3)
    B, H, W, C, S = 2, 5, 7, 6, 40
    img = torch.from_numpy(rng.randn(B, H, W, C).astype(np.float32)).requires_grad_(True)
    yx = torch.from_numpy(rng.uniform(-1.2, 1.2, (B, S, 2)).astype(np.float32))
    yx.requires_grad_(True)
    gout = torch.from_numpy(rng.randn(B, S, C).astype(np.float32))

    ref = grid_sample_2d(img, yx, align_corners=align_corners)  # [B, S, C]
    d_img_ref, d_yx_ref = torch.autograd.grad(ref, (img, yx), gout)
    coords = torch.cat([yx, torch.zeros_like(yx[..., :1])], -1)
    got = fused_multilevel_gather([img.reshape(B, H * W, C)], [(H, W, 1)], C, [coords],
                                  align_corners)[0]  # [B, C, S]
    d_img, d_yx = torch.autograd.grad(got, (img, yx), gout.transpose(1, 2))
    _close(got.detach().transpose(1, 2).numpy(), ref.detach().numpy(), 1e-5, "values")
    _close(d_img.numpy(), d_img_ref.numpy(), 1e-4, "d_img")
    _close(d_yx.numpy(), d_yx_ref.numpy(), 1e-4, "d_coords")
