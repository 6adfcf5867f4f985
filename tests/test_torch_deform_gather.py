"""K1, the deformable-attention gather, against the JAX package's Pallas kernel.

The port's plain version (``ms_deform_gather_3d_plain``, what the wrapper
runs for CPU tensors) is held against
``occformer_tpu.ops.trilerp_fused.fused_multilevel_weighted_gather`` run in
Pallas interpret mode and summed over levels, and the port's
``MultiScaleDeformableAttention3D`` against the JAX module with
``gather_impl="mxu_interpret"``, so the real Pallas body runs.  Levels have
power-of-two sides (the JAX escape pass can read past the padded table on
other sizes, trilerp_fused.py:323).  Tolerance atol 1e-5: float32 on both
sides, different summation order.  The backward (autograd through the plain
version) is held against ``jax.vjp`` of the Pallas gather (K1-bwd,
``_wfold_bwd_body``), and the module's VJP against ``jax.vjp`` of the flax
module; their tolerances are stated where they are used.

The CUDA kernel itself is held against the plain version on the card by
tests/test_torch_gpu.py (skipped without a GPU) and by chip_smoke.py.
"""
from functools import partial

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.engine.convert_weights import TreeBuilder, convert_deform_attn, match_to_tree
from occformer_tpu.models.deform_attn import MultiScaleDeformableAttention3D as JaxMSDA
from occformer_tpu.ops.trilerp_fused import fused_multilevel_weighted_gather
from occformer_tpu_torch.models.deform_attn import MultiScaleDeformableAttention3D
from occformer_tpu_torch.ops import trilerp_fused as k1

SHAPES = [(4, 4, 2), (2, 2, 2)]
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(P, seed=0, B=2, H=2, hd=8, Nq=12, spill=0.2):
    rng = np.random.RandomState(seed)
    Nv = sum(x * y * z for x, y, z in SHAPES)
    L = len(SHAPES)
    value = rng.randn(B, Nv, H, hd).astype(np.float32)
    locs = rng.uniform(-spill, 1 + spill, (B, Nq, H, L, P, 3)).astype(np.float32)
    w = rng.rand(B, Nq, H, L, P).astype(np.float32)
    return value, locs, w


def _jax_k1(value, locs, w):
    """The Pallas weighted gather in the layout deform_attn.py gives it
    (jnp throughout, so that ``jax.vjp`` reaches the kernel's VJP)."""
    B, Nv, H, hd = value.shape
    Nq, P = locs.shape[1], locs.shape[4]
    tables, coords, weights, start = [], [], [], 0
    for l, (X, Y, Z) in enumerate(SHAPES):
        n = X * Y * Z
        v = value[:, start:start + n].reshape(B, X, Y, Z, H, hd)
        tables.append(v.transpose(0, 4, 1, 2, 3, 5).reshape(B * H, X * Y, Z * hd))
        g = locs[:, :, :, l] * 2.0 - 1.0
        coords.append(g.transpose(0, 2, 1, 3, 4).reshape(B * H, Nq * P, 3))
        weights.append(w[:, :, :, l].transpose(0, 2, 1, 3).reshape(B * H, Nq * P))
        start += n
    outs = fused_multilevel_weighted_gather(tables, SHAPES, hd, coords, weights, P,
                                            s_block=P * 8, interpret=True)
    out = sum(outs[1:], outs[0])  # [B*H, hd, Nq]
    return out.reshape(B, H, hd, Nq).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("P", [2, 4])
def test_plain_version_matches_pallas_kernel(P):
    value, locs, w = _inputs(P)
    outside = ((locs < 0) | (locs > 1)).any(-1).mean()
    assert 0.2 < outside < 0.9  # some samples reach past the volume
    got = k1.ms_deform_gather_3d_plain(torch.from_numpy(value), SHAPES,
                                       torch.from_numpy(locs), torch.from_numpy(w))
    ref = _jax_k1(*(jnp.asarray(a) for a in (value, locs, w)))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("P", [2, 4])
def test_plain_version_backward_matches_pallas_vjp(P):
    """d_value, d_locs and d_weights: autograd through the plain version
    against the Pallas kernel's VJP.  atol 1e-5 for d_value and d_weights;
    d_locs scales the trilinear slope by the level size (up to 4 here), so
    1e-4."""
    value, locs, w = _inputs(P, seed=5)
    gout = np.random.RandomState(6).randn(*value.shape[:1], locs.shape[1],
                                          *value.shape[2:]).astype(np.float32)
    _, vjp = jax.vjp(_jax_k1, *(jnp.asarray(a) for a in (value, locs, w)))
    refs = vjp(jnp.asarray(gout))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (value, locs, w)]
    k1.ms_deform_gather_3d(leaves[0], SHAPES, leaves[1], leaves[2]).backward(
        torch.from_numpy(gout))
    for name, got, ref, atol in zip(("d_value", "d_locs", "d_weights"), leaves, refs,
                                    (ATOL, 1e-4, ATOL)):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), atol=atol,
                                   err_msg=name)


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    value, locs, w = _inputs(4, seed=1)
    before = k1.LAUNCHES
    args = (torch.from_numpy(value), SHAPES, torch.from_numpy(locs), torch.from_numpy(w))
    got = k1.ms_deform_gather_3d(*args)
    assert k1.LAUNCHES == before
    torch.testing.assert_close(got, k1.ms_deform_gather_3d_plain(*args), rtol=0, atol=0)


def test_wrapper_rejects_bad_shapes():
    value, locs, w = _inputs(4, seed=2)
    with pytest.raises(ValueError):
        k1.ms_deform_gather_3d(torch.from_numpy(value), SHAPES[:1],
                               torch.from_numpy(locs), torch.from_numpy(w))
    with pytest.raises(ValueError):
        k1.ms_deform_gather_3d(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(locs[..., :2]), torch.from_numpy(w))


def test_module_matches_jax_pallas_path():
    C, H, L, P = 16, 2, len(SHAPES), 2
    B = 2
    Nq = sum(x * y * z for x, y, z in SHAPES)
    torch.manual_seed(0)
    tm = MultiScaleDeformableAttention3D(C, H, L, P).eval()
    with torch.no_grad():  # non-trivial offsets and weights
        tm.sampling_offsets.weight.uniform_(-0.05, 0.05)
        tm.sampling_offsets.bias.uniform_(-1.5, 1.5)
        tm.attention_weights.weight.uniform_(-0.1, 0.1)
    sd = {"m." + k: v.detach().numpy() for k, v in tm.state_dict().items()}
    tb = TreeBuilder()
    convert_deform_attn(tb, sd, "m", "m")

    rng = np.random.RandomState(3)
    q = rng.randn(B, Nq, C).astype(np.float32)
    pos = rng.randn(B, Nq, C).astype(np.float32)
    ref_pts = rng.uniform(0, 1, (B, Nq, L, 3)).astype(np.float32)
    jm = JaxMSDA(embed_dims=C, num_heads=H, num_levels=L, num_points=P,
                 gather_impl="mxu_interpret", gather_s_block=P * 8)
    args = (jnp.asarray(q), jnp.asarray(q), jnp.asarray(ref_pts))
    kw = dict(spatial_shapes=SHAPES, query_pos=jnp.asarray(pos))
    init = jax.eval_shape(partial(jm.init, **kw), jax.random.PRNGKey(0), *args)
    variables, missing = match_to_tree({"params": tb.params["m"]}, {"params": init["params"]})
    assert not missing, missing
    ref = np.asarray(jm.apply(variables, *args, **kw))
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(ref_pts),
                 SHAPES, query_pos=torch.from_numpy(pos)).numpy()
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_radial_offset_init_matches_jax():
    """The port stores the reference's (z, y, x) triples; flipped, its init
    bias is the JAX package's (x, y, z) radial init."""
    from occformer_tpu.models.deform_attn import deform_attn_offset_bias_init as j_init

    m = MultiScaleDeformableAttention3D(48, 4, 3, 2)
    b = m.sampling_offsets.bias.detach().numpy().reshape(-1, 3)[:, ::-1].reshape(-1)
    np.testing.assert_array_equal(b, j_init(4, 3, 2))
    assert not m.sampling_offsets.weight.any() and not m.attention_weights.weight.any()


def test_module_vjp_matches_jax():
    """The deformable-attention layer's backward (through K1's plain
    version) against ``jax.vjp`` of the flax module with the Pallas gather:
    gradients of the query, the value and every parameter, the port's
    parameter gradients carried into the flax layout by the same converter
    as the weights.  Tolerance 1e-4 * max|ref| + 1e-6: float32 both sides,
    the offset gradients sum many samples' location slopes."""
    C, H, L, P = 16, 2, len(SHAPES), 2
    B = 1
    Nq = sum(x * y * z for x, y, z in SHAPES)
    torch.manual_seed(1)
    tm = MultiScaleDeformableAttention3D(C, H, L, P)
    with torch.no_grad():
        tm.sampling_offsets.weight.uniform_(-0.05, 0.05)
        tm.sampling_offsets.bias.uniform_(-1.5, 1.5)
        tm.attention_weights.weight.uniform_(-0.1, 0.1)

    def to_flax(sd):
        tb = TreeBuilder()
        convert_deform_attn(tb, {"m." + k: v for k, v in sd.items()}, "m", "m")
        return tb.params["m"]

    rng = np.random.RandomState(7)
    q = rng.randn(B, Nq, C).astype(np.float32)
    pos = rng.randn(B, Nq, C).astype(np.float32)
    ref_pts = rng.uniform(0, 1, (B, Nq, L, 3)).astype(np.float32)
    gout = rng.randn(B, Nq, C).astype(np.float32)
    jm = JaxMSDA(embed_dims=C, num_heads=H, num_levels=L, num_points=P,
                 gather_impl="mxu_interpret", gather_s_block=P * 8)
    kw = dict(spatial_shapes=SHAPES, query_pos=jnp.asarray(pos))
    init = jax.eval_shape(partial(jm.init, **kw), jax.random.PRNGKey(0),
                          jnp.asarray(q), jnp.asarray(q), jnp.asarray(ref_pts))
    sd = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    variables, missing = match_to_tree({"params": to_flax(sd)}, {"params": init["params"]})
    assert not missing, missing

    def f(params, query, value):
        return jm.apply({"params": params}, query, value, jnp.asarray(ref_pts), **kw)

    _, vjp = jax.vjp(f, variables["params"], jnp.asarray(q), jnp.asarray(q))
    d_params, d_query, d_value = vjp(jnp.asarray(gout))

    query = torch.from_numpy(q).requires_grad_(True)
    value = torch.from_numpy(q.copy()).requires_grad_(True)
    tm(query, value, torch.from_numpy(ref_pts), SHAPES,
       query_pos=torch.from_numpy(pos)).backward(torch.from_numpy(gout))
    grads = to_flax({k: p.grad.numpy() for k, p in tm.named_parameters()})
    got_params, _ = match_to_tree({"params": grads}, {"params": init["params"]})

    def close(got, ref, name):
        ref = np.asarray(ref)
        tol = 1e-4 * np.abs(ref).max() + 1e-6
        assert np.abs(np.asarray(got) - ref).max() <= tol, name

    close(query.grad.numpy(), d_query, "d_query")
    close(value.grad.numpy(), d_value, "d_value")
    flat_ref = jax.tree_util.tree_flatten_with_path(d_params)[0]
    flat_got = dict(jax.tree_util.tree_flatten_with_path(got_params["params"])[0])
    assert len(flat_ref) == len(flat_got) == 8
    for path, ref in flat_ref:
        close(flat_got[path], ref, jax.tree_util.keystr(path))
