"""The port's BEVStereo view transformer (``models/bevstereo.py``) against the
JAX package's (``occformer_tpu/models/bevstereo.py``), on the CPU in float32.

At the module sizes of ``tests/test_bevstereo.py`` (a 64 x 96 image, stereo
features at 1/4, 16 depth bins in two ranges, two EM iterations, three
samples, four groups), JAX's variables drawn at random and carried into the
port by ``flax_to_torch_state_dict(..., convert=convert_bevstereo)``:

* ``depth_sampling_k_list`` and ``create_depth_sample_frustum`` exactly;
* ``homo_warping`` (the bilinear read through K4's plain version) within
  1e-5 * max|ref| + 1e-6 of JAX's and of the reference's math in torch
  (``test_bevstereo.py:_torch_homo_warp``), with points behind the sweep
  camera;
* the stride-2 ``"SAME"`` transposed convolution on odd and even sides
  within 1e-6 of flax's, where torch's usual ``padding=1, output_padding=1``
  differs;
* ``DepthNetStereo`` in eval and in train mode (outputs, then the running
  statistics), within 1e-4 * max|ref| + 1e-6;
* the whole path, each sweep's DepthNet -> ``forward_stereo`` ->
  ``fuse_depth`` -> the lift-splat into the voxel grid, within 1e-4 *
  max|ref| + 1e-6 in eval mode and 2e-4 in train mode (measured 8.9e-5,
  the port's own float32 error against a float64 run of it); and the
  gradients of a fixed random weighting of ``fuse_depth``'s output with
  respect to every input and parameter against ``jax.grad``, within 1e-4 *
  max|ref| + 1e-6 each in eval mode (measured 2.1e-5) and 1e-3 in train
  mode (measured 3.4e-4; the ASPP's pooled branch normalises two values a
  channel): this holds every detach of the grid, the mask's inputs and the
  other sweep's DepthNet.

The JAX side runs flax's BatchNorm with its two-pass batch variance
(``use_fast_variance=False``), as torch and the reference compute it: flax's
default one-pass E[x^2] - E[x]^2 loses float32 digits to cancellation,
which the EM softmaxes amplify (JAX's stereo depth then lies 6.9e-4 * max
from a float64 run of the port, and its gradients up to 6e-3 from the port's).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp
import flax.linen as fnn

from occformer_tpu.models import bevstereo as jbs
from occformer_tpu_torch.engine.convert_weights import (convert_bevstereo,
                                                        flax_to_torch_state_dict, t2f_deconv)
from occformer_tpu_torch.models import bevstereo as tbs
from test_bevstereo import INPUT_SIZE, _random_mats, _torch_homo_warp
from test_torch_r101_backbone import _random_variables

GRID = {"xbound": [-8.0, 8.0, 2.0], "ybound": [-8.0, 8.0, 2.0],
        "zbound": [-2.0, 2.0, 1.0], "dbound": [2.0, 10.0, 0.5]}
MODULE = dict(grid_config=GRID, data_config={"input_size": INPUT_SIZE}, numC_input=16,
              numC_Trans=8, downsample=16, num_ranges=2, range_list=((2.0, 6.0), (6.0, 10.0)),
              em_iteration=2, num_samples=3, num_groups=4, stereo_downsample_factor=4)
D, CIN, CTX, CST = 16, 16, 8, 8  # depth bins, image / context / stereo channels
B, N = 1, 2
HS, WS = INPUT_SIZE[0] // 4, INPUT_SIZE[1] // 4
FH, FW = INPUT_SIZE[0] // 16, INPUT_SIZE[1] // 16


class _TwoPassBatchNorm(fnn.BatchNorm):
    use_fast_variance: bool = False


_TwoPassBatchNorm.__name__ = "BatchNorm"  # flax names its variables by the class name


@pytest.fixture(autouse=True)
def _two_pass_statistics(monkeypatch):
    """flax's BatchNorm with its two-pass batch variance, as torch computes it."""
    monkeypatch.setattr(fnn, "BatchNorm", _TwoPassBatchNorm)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, ref, rel, name, atol=1e-6):
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    assert got.shape == ref.shape, (name, got.shape, ref.shape)
    err, tol = np.abs(got - ref).max(), rel * np.abs(ref).max() + atol
    assert err <= tol, f"{name}: max|diff| {err} > {tol}"


def _first(a):
    """channels-last -> channels-first, as a tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def _last(t):
    return np.moveaxis(t.detach().numpy(), 1, -1)


# ---------------------------------------------------------------------------
# the sampling helpers and the warp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sampling_range,num_samples", [(3.0, 3), (2.0, 5), (1.5, 4)])
def test_depth_sampling_k_list_is_jax_exactly(sampling_range, num_samples):
    got = tbs.depth_sampling_k_list(sampling_range, num_samples)
    np.testing.assert_array_equal(got, jbs.depth_sampling_k_list(sampling_range, num_samples))


@pytest.mark.parametrize("shape,input_size,factor", [((2, 3, 16, 24), (64, 96), 4),
                                                      ((1, 1, 4, 6), (64, 96), 16),
                                                      ((3, 2, 7, 13), (49, 100), 7)])
def test_create_depth_sample_frustum_is_jax_exactly(shape, input_size, factor):
    depth = np.random.default_rng(0).uniform(1, 60, shape).astype(np.float32)
    got = tbs.create_depth_sample_frustum(torch.from_numpy(depth), input_size, factor)
    ref = jbs.create_depth_sample_frustum(jnp.asarray(depth), input_size, factor)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _warp_inputs(rng, behind):
    bn, S = 2, 3
    feat = rng.standard_normal((bn, CST, HS, WS)).astype(np.float32)
    key_int, key_ida, _ = _random_mats(rng, bn)
    swp_int, swp_ida, s2s = _random_mats(rng, bn)
    depth = (5 + 35 * rng.random((bn, S, HS, WS))).astype(np.float32)
    if behind:  # the second sweep camera 20 m ahead: the hypotheses past it lie behind it
        s2s[1, 2, 3] = -20.0
    frustum = np.array(jbs.create_depth_sample_frustum(jnp.asarray(depth), INPUT_SIZE, 4))
    return feat, key_int, swp_int, s2s, key_ida, swp_ida, depth, frustum


@pytest.mark.parametrize("behind", [False, True])
def test_homo_warping_matches_jax_and_the_reference_math(behind):
    feat, key_int, swp_int, s2s, key_ida, swp_ida, depth, frustum = _warp_inputs(
        np.random.default_rng(3), behind)
    mats = (key_int, swp_int, s2s, key_ida, swp_ida)
    got = tbs.homo_warping(torch.from_numpy(feat), *map(torch.from_numpy, mats),
                           torch.from_numpy(depth), torch.from_numpy(frustum), 4)
    ref = jbs.homo_warping(jnp.asarray(np.moveaxis(feat, 1, -1)), *map(jnp.asarray, mats),
                           jnp.asarray(depth), jnp.asarray(frustum), 4)
    # JAX [BN, S, H, W, C]; the port, as the reference, [BN, C, S, H, W]
    _close(got.numpy(), np.moveaxis(np.asarray(ref), -1, 1), 1e-5, "homo_warping vs JAX")
    oracle = _torch_homo_warp(feat, key_int, swp_int, s2s, key_ida, swp_ida, depth, frustum, 4)
    _close(got.numpy(), oracle, 1e-5, "homo_warping vs the reference math")
    if behind:
        # the second sample's hypotheses behind the camera all go to the
        # full image's (W, H), which the mixed normalisation puts a quarter
        # pixel inside the feature map: they read its last pixel at about 1/16
        grid = tbs.warp_grid(*map(torch.from_numpy, mats), torch.from_numpy(depth),
                             torch.from_numpy(frustum), (HS, WS), 4)[1]
        ny, nx = 4 * HS / ((4 * HS - 1) / 2.0) - 1.0, 4 * WS / ((4 * WS - 1) / 2.0) - 1.0
        pushed = ((grid[:, 0] - ny).abs() < 1e-6) & ((grid[:, 1] - nx).abs() < 1e-6)
        assert 0.2 < float(pushed.float().mean()) < 1.0
        wy = HS - ((ny + 1) * HS - 1) / 2
        wx = WS - ((nx + 1) * WS - 1) / 2
        want = feat[1, :, HS - 1, WS - 1, None] * (wy * wx)
        _close(got[1].reshape(CST, -1)[:, pushed].numpy(),
               np.broadcast_to(want, (CST, int(pushed.sum()))), 1e-5, "behind the camera")


# ---------------------------------------------------------------------------
# the transposed convolution's alignment
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw", [(5, 7), (4, 6), (3, 8), (1, 2)])
def test_same_conv_transpose_is_flax_on_odd_and_even_sides(hw):
    rng = np.random.default_rng(4)
    C = 6
    x = rng.standard_normal((2, *hw, C)).astype(np.float32)
    layer = fnn.ConvTranspose(C, (3, 3), strides=(2, 2), padding="SAME")
    params = _random_variables(layer.init(jax.random.PRNGKey(0), x), np.random.RandomState(0))
    ref = np.asarray(layer.apply(params, x))
    # flax's (kh, kw, I, O) kernel, as torch's (I, O, kh, kw): t2f_deconv's inverse
    w = np.ascontiguousarray(np.transpose(params["params"]["kernel"][::-1, ::-1], (2, 3, 0, 1)))
    np.testing.assert_array_equal(t2f_deconv(w), params["params"]["kernel"])
    mine = tbs._SameConvTranspose2d(C)
    with torch.no_grad():
        mine.weight.copy_(torch.from_numpy(w))
        mine.bias.copy_(torch.from_numpy(params["params"]["bias"]))
        got = mine(_first(x))
        usual = F.conv_transpose2d(_first(x), mine.weight, mine.bias, stride=2, padding=1,
                                   output_padding=1)
    assert got.shape[2:] == (2 * hw[0], 2 * hw[1])
    _close(_last(got), ref, 0.0, "the SAME transposed convolution")
    assert np.abs(_last(usual) - ref).max() > 0.1  # the usual padding shifts by a pixel


# ---------------------------------------------------------------------------
# DepthNetStereo and the whole path
# ---------------------------------------------------------------------------

def _cams(rng):
    """Two cameras at the grid's centre, facing +x and -x (camera z forward,
    x right, y down), so that the frustum lands in the 16 m grid."""
    fwd = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    back = np.diag([-1.0, -1.0, 1.0]).astype(np.float32) @ fwd
    rots = np.stack([fwd, back])[None]
    intrins = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    intrins[..., 0, 0] = intrins[..., 1, 1] = 40.0
    intrins[..., 0, 2], intrins[..., 1, 2] = INPUT_SIZE[1] / 2, INPUT_SIZE[0] / 2
    eye = np.tile(np.eye(3, dtype=np.float32), (B, N, 1, 1))
    return [rots, rng.uniform(-0.5, 0.5, (B, N, 3)).astype(np.float32), intrins, eye,
            np.zeros((B, N, 3), np.float32), np.eye(3, dtype=np.float32)[None]]


def _path_inputs(seed=5):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal((B * N, FH, FW, CIN)).astype(np.float32) for _ in range(2)]
    mlps = [rng.standard_normal((B * N, 27)).astype(np.float32) for _ in range(2)]
    feats = [rng.standard_normal((B * N, HS, WS, CST)).astype(np.float32) for _ in range(2)]
    ints, idas, s2ss = zip(*(_random_mats(rng, B * N) for _ in range(2)))
    mats = {"intrin_mats": np.stack(ints, 1), "ida_mats": np.stack(idas, 1),
            "sensor2sensor_mats": np.stack(s2ss, 1)}
    return xs, mlps, feats, mats, _cams(rng)


def _jax_path(self, xs, mlps, feats, mats, cams):
    """Each sweep's DepthNet, the stereo depth, the fusion and the splat."""
    outs = [self.depth_net(x, m) for x, m in zip(xs, mlps)]
    _, ctxs, mus, sigmas, rss, monos = (list(o) for o in zip(*outs))
    sd, ms = self.forward_stereo(0, feats, monos, mats, mus, sigmas, rss)
    prob = self.fuse_depth(monos[0], sd, ms)
    vol = self(ctxs[0].reshape(B, N, FH, FW, CTX), prob, *cams)
    return sd, ms, prob, vol


def _torch_path(module, xs, mlps, feats, mats, cams):
    outs = [module.depth_net(x, m) for x, m in zip(xs, mlps)]
    _, ctxs, mus, sigmas, rss, monos = (list(o) for o in zip(*outs))
    sd, ms = module.forward_stereo(0, feats, monos, mats, mus, sigmas, rss)
    prob = module.fuse_depth(monos[0], sd, ms)
    vol = module(ctxs[0].reshape(B, N, CTX, FH, FW), prob, *cams)
    return sd, ms, prob, vol


def _to_torch(xs, mlps, feats, mats, cams, grad=False):
    t = lambda a: torch.from_numpy(np.asarray(a)).requires_grad_(grad)
    return ([_first(x).requires_grad_(grad) for x in xs], [t(m) for m in mlps],
            [_first(f).requires_grad_(grad) for f in feats],
            {k: torch.from_numpy(v) for k, v in mats.items()},
            [torch.from_numpy(c) for c in cams])


def _both_modules(train, inputs):
    jm = jbs.ViewTransformerLSSBEVStereo(**MODULE, train=train)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *inputs, method=_jax_path))
    variables = _random_variables(shapes, np.random.RandomState(1))
    tm = tbs.ViewTransformerLSSBEVStereo(**MODULE)
    tm.load_state_dict(flax_to_torch_state_dict(variables, tm, convert=convert_bevstereo),
                       strict=True)
    return jm, variables, tm.train(train)


def _carry(variables, tm, only=""):
    """JAX's variables as the port's state dict (its keys starting with
    ``only``)."""
    manifest = {k: tuple(v.shape) for k, v in tm.state_dict().items() if k.startswith(only)}
    return flax_to_torch_state_dict(variables, tm, manifest=manifest, convert=convert_bevstereo)


@pytest.mark.parametrize("train", [False, True])
def test_depthnet_stereo_matches_jax(train):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 7, CIN)).astype(np.float32)
    mlp = rng.standard_normal((3, 27)).astype(np.float32)
    jd = jbs.DepthNetStereo(mid_channels=CIN, context_channels=CTX, depth_channels=D,
                            num_ranges=2, train=train)
    variables = _random_variables(jax.eval_shape(jd.init, jax.random.PRNGKey(0), x, mlp),
                                  np.random.RandomState(2))
    ref, new = jd.apply(variables, x, mlp, mutable=["batch_stats"])
    tm = tbs.ViewTransformerLSSBEVStereo(**MODULE)
    nest = lambda v: {k: {"depth_net": t} for k, t in v.items()}
    td = tm.depth_net
    td.load_state_dict({k[len("depth_net."):]: v
                        for k, v in _carry(nest(variables), tm, "depth_net.").items()},
                       strict=True)
    td.train(train)
    with torch.no_grad():
        got = td(_first(x), torch.from_numpy(mlp))
    names = ("y", "ctx", "mu", "sigma", "range_score", "mono")
    for name, g, r in zip(names, got, ref):
        assert g.dtype == torch.float32, name
        _close(_last(g), r, 1e-4, name)
    assert float(got[3].min()) > 0.0
    if train:
        want = _carry(nest(dict(variables, batch_stats=new["batch_stats"])), tm, "depth_net.")
        for k, v in td.state_dict().items():
            if "running" in k:
                _close(v.numpy(), want["depth_net." + k].numpy(), 1e-5, k)


@pytest.mark.parametrize("train", [False, True])
def test_stereo_path_matches_jax(train):
    inputs = _path_inputs()
    jm, variables, tm = _both_modules(train, inputs)
    ref, new = jax.jit(lambda v, *a: jm.apply(v, *a, method=_jax_path,
                                              mutable=["batch_stats"]))(variables, *inputs)
    with torch.no_grad():
        got = _torch_path(tm, *_to_torch(*inputs))
    rel = 2e-4 if train else 1e-4
    for name, g, r in zip(("stereo_depth", "mask_score", "depth_prob"), got[:3], ref[:3]):
        _close(_last(g), r, rel, name)
    vol = got[3].numpy()
    assert vol.shape == (B, 8, 8, 4, CTX) and np.abs(vol).max() > 0
    _close(vol, ref[3], rel, "volume")
    np.testing.assert_allclose(got[2].sum(1).numpy(), 1.0, rtol=1e-5)
    if train:
        want = _carry(dict(variables, batch_stats=new["batch_stats"]), tm)
        for k, v in tm.state_dict().items():
            if "running" in k:
                _close(v.numpy(), want[k].numpy(), 1e-5, k)


@pytest.mark.parametrize("train", [False, True])
def test_stereo_gradients_match_jax_grad(train):
    """d(sum(w * fuse_depth(...))) with respect to the stereo features, the
    images' features, the camera embeddings and every parameter: the warp's
    grid, the mask's inputs and nothing else detached."""
    inputs = _path_inputs(seed=7)
    jm, variables, tm = _both_modules(train, inputs)
    rel = 1e-3 if train else 1e-4
    w = np.random.default_rng(8).standard_normal((B * N, FH, FW, D)).astype(np.float32)

    def loss(params, xs, mlps, feats):
        v = {"params": params, "batch_stats": variables["batch_stats"]}
        (_, _, prob, _), _ = jm.apply(v, xs, mlps, feats, *inputs[3:], method=_jax_path,
                                      mutable=["batch_stats"])
        return jnp.sum(prob * w)

    ref = jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(variables["params"], *inputs[:3])
    xs, mlps, feats, mats, cams = _to_torch(*inputs, grad=True)
    prob = _torch_path(tm, xs, mlps, feats, mats, cams)[2]
    (prob * _first(w)).sum().backward()
    for i in range(2):
        _close(_last(feats[i].grad), ref[3][i], rel, f"d stereo feature {i}")
    assert np.abs(ref[3][1]).max() > 0  # through the warp
    _close(_last(xs[0].grad), ref[1][0], rel, "d image feature 0")
    _close(mlps[0].grad.numpy(), ref[2][0], rel, "d camera embedding 0")
    # the other sweep's DepthNet reaches the depth only through the mask's
    # detached input
    assert xs[1].grad is None and mlps[1].grad is None
    assert np.abs(ref[1][1]).max() == 0.0 and np.abs(ref[2][1]).max() == 0.0
    want = flax_to_torch_state_dict({"params": ref[0], "batch_stats": variables["batch_stats"]},
                                    tm, convert=convert_bevstereo)
    # gradients that are 0 up to rounding: the similarity's output bias (the
    # softmax over the samples ignores a constant) and, in train mode, the
    # biases of the convolutions a BatchNorm follows; held to 1e-5 of the
    # largest gradient on both sides
    flat = {"sim_out.bias"} | ({f"{m}.bias" for m in (
        "depth_net.reduce_conv", "depth_net.msr_up0", "depth_net.msr_up1", "dds_conv1",
        "dds_conv2", "mask_conv")} if train else set())
    top = max(np.abs(v.numpy()).max() for k, v in want.items() if k in dict(tm.named_parameters()))
    seen = 0
    for k, p in tm.named_parameters():
        if p.grad is None:  # a parameter off the path to the depth: JAX's gradient is 0
            assert np.abs(want[k].numpy()).max() == 0.0, k
        elif k in flat:
            assert max(np.abs(p.grad.numpy()).max(), np.abs(want[k].numpy()).max()) <= 1e-5 * top
        else:
            _close(p.grad.numpy(), want[k].numpy(), rel, k)
            seen += 1
    assert seen > 60


def test_registered_in_necks():
    from occformer_tpu_torch.registry import NECKS

    module = NECKS.build(dict(MODULE, type="ViewTransformerLSSBEVStereo"))
    assert isinstance(module, tbs.ViewTransformerLSSBEVStereo) and module.D == D


def test_forward_stereo_without_the_mask_and_with_even_ranges_matches_jax():
    """``use_mask=False`` (``forward_stereo`` returns the stereo depth alone,
    the module has no mask net, ``fuse_depth`` takes no mask) and
    ``range_list=None`` (the depth bins split into ``num_ranges`` even
    ranges), eval mode, within 1e-4 * max|ref| + 1e-6 of JAX's."""
    kw = dict(MODULE, use_mask=False, range_list=None)
    rng = np.random.default_rng(9)
    xs, mlps, feats, mats, _ = _path_inputs(seed=9)
    monos = [rng.standard_normal((B * N, FH, FW, D)).astype(np.float32) for _ in range(2)]
    est = [[rng.standard_normal((B * N, HS, WS, 2)).astype(np.float32) for _ in range(2)]
           for _ in range(3)]

    def run(self, x, mlp, feats, monos, mats, *est):
        sd = self.forward_stereo(0, feats, monos, mats, *est)
        return sd, self.fuse_depth(monos[0], sd), self.depth_net(x, mlp)[0]

    args = (xs[0], mlps[0], feats, monos, mats, *est)
    jm = jbs.ViewTransformerLSSBEVStereo(**kw)
    variables = _random_variables(
        jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *args, method=run)),
        np.random.RandomState(4))
    ref = jax.jit(lambda v, *a: jm.apply(v, *a, method=run))(variables, *args)
    tm = tbs.ViewTransformerLSSBEVStereo(**kw)
    assert not hasattr(tm, "mask_conv") and tm.ranges == [(2.0, 6.0), (6.0, 10.0)]
    tm.load_state_dict(_carry(variables, tm), strict=True)
    with torch.no_grad():
        sd = tm.eval().forward_stereo(
            0, [_first(f) for f in feats], [_first(m) for m in monos],
            {k: torch.from_numpy(v) for k, v in mats.items()},
            *[[_first(e) for e in group] for group in est])
        prob = tm.fuse_depth(_first(monos[0]), sd)
    assert torch.is_tensor(sd)
    _close(_last(sd), ref[0], 1e-4, "stereo depth without the mask")
    _close(_last(prob), ref[1], 1e-4, "depth without the mask")
