"""The port's sparse convolutions against the JAX package's, on the CPU.

The 12 cases of tests/test_spconv.py.  Each JAX module is initialised, its
parameters carried into the port's module by
``flax_to_torch_state_dict(..., convert=convert_spconv)`` and loaded
strictly, and both run on the same seeded inputs: features within
rtol/atol 1e-5 in float32 (the same products through other conv and matmul
libraries), active sets (coords, validity, output grid) equal.  The port's
two backends agree with each other as JAX's do (bf16: within 0.05, the
tap-sum order differs).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.ops import spconv as J
from occformer_tpu_torch.engine.convert_weights import convert_spconv, flax_to_torch_state_dict
from occformer_tpu_torch.ops import spconv as T


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _sites(rng, n, grid, cap, C=4):
    coords = np.stack([rng.randint(0, g, cap) for g in grid], -1).astype(np.int32)
    lin = (coords[:, 0] * grid[1] + coords[:, 1]) * grid[2] + coords[:, 2]
    _, first = np.unique(lin, return_index=True)
    valid = np.zeros(cap, bool)
    valid[first[:n]] = True
    feats = rng.randn(cap, C).astype(np.float32) * valid[:, None]
    return feats, coords, valid


def _j(*a):
    return tuple(jnp.asarray(x) for x in a)


def _t(*a):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in a)


def _port(jmod, params, cls, in_ch, backend="dense", **kw):
    """The port's module with the JAX module's parameters."""
    m = cls(in_ch, jmod.features, kernel_size=jmod.kernel_size,
            bias=jmod.use_bias, backend=backend, **kw)
    m.load_state_dict(flax_to_torch_state_dict(jax.tree_util.tree_map(np.asarray, params), m,
                                               convert=convert_spconv), strict=True)
    return m


def _close(got, ref, tol=1e-5):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(ref, np.float32),
                               rtol=tol, atol=tol)


def test_densify_sparsify_roundtrip(rng):
    grid = (6, 6, 4)
    feats, coords, valid = _sites(rng, 20, grid, 32)
    dense = T.densify(*_t(feats, coords, valid), grid)
    _close(dense, J.densify(*_j(feats, coords, valid), grid), 0)
    back = T.sparsify(dense, *_t(coords, valid))
    _close(back, feats, 1e-6)
    assert int(dense.ne(0).any(-1).sum()) <= 20


@pytest.mark.parametrize("backend", ["dense", "gather"])
def test_subm_conv_preserves_active_set(rng, backend):
    grid = (6, 6, 4)
    feats, coords, valid = _sites(rng, 15, grid, 32)
    jm = J.SubMConv3d(features=8)
    p = jm.init(jax.random.PRNGKey(0), *_j(feats, coords, valid), grid)
    ref, _, _ = jm.apply(p, *_j(feats, coords, valid), grid)
    out, oc, ov = _port(jm, p, T.SubMConv3d, 4, backend)(*_t(feats, coords, valid), grid)
    assert out.shape == (32, 8)
    assert torch.equal(ov, torch.from_numpy(valid))
    assert float(out[~ov].detach().abs().sum()) == 0.0
    _close(out, ref)


def test_sparse_conv_stride_downsamples(rng):
    grid = (8, 8, 4)
    feats, coords, valid = _sites(rng, 25, grid, 64)
    jm = J.SparseConv3d(features=6, stride=2, max_out_sites=128)
    p = jm.init(jax.random.PRNGKey(0), *_j(feats, coords, valid), grid)
    ref, roc, rov, rog = jm.apply(p, *_j(feats, coords, valid), grid)
    m = _port(jm, p, T.SparseConv3d, 4, stride=2, max_out_sites=128)
    out, oc, ov, og = m(*_t(feats, coords, valid), grid)
    assert og == rog == (4, 4, 2)
    assert out.shape == (32, 6)
    assert torch.equal(ov, torch.from_numpy(np.array(rov)))
    sel = np.asarray(rov)
    np.testing.assert_array_equal(oc.numpy()[sel], np.asarray(roc)[sel])
    _close(out, ref)
    oc = oc.numpy()[ov.numpy()]
    assert (oc >= 0).all() and (oc < np.array(og)).all()


def test_sparse_max_pool(rng):
    grid = (4, 4, 2)
    feats, coords, valid = _sites(rng, 10, grid, 16)
    out, oc, ov, og = T.sparse_max_pool(*_t(feats, coords, valid), grid, 2, 2)
    ref, roc, rov, rog = J.sparse_max_pool(*_j(feats, coords, valid), grid, 2, 2)
    assert og == rog == (2, 2, 1)
    assert out.shape == feats.shape
    _close(out, ref, 0)
    np.testing.assert_array_equal(oc.numpy(), np.asarray(roc))


def test_subm_gather_matches_dense(rng):
    grid = (7, 6, 5)
    feats, coords, valid = _sites(rng, 22, grid, 40)
    jm = J.SubMConv3d(features=8, use_bias=True)
    p = jm.init(jax.random.PRNGKey(0), *_j(feats, coords, valid), grid)
    ref, _, _ = jm.apply(p, *_j(feats, coords, valid), grid)
    out_d, _, _ = _port(jm, p, T.SubMConv3d, 4)(*_t(feats, coords, valid), grid)
    out_g, _, ov = _port(jm, p, T.SubMConv3d, 4, "gather")(*_t(feats, coords, valid), grid)
    assert torch.equal(ov, torch.from_numpy(valid))
    _close(out_g, out_d.detach().numpy())
    _close(out_g, ref)


@pytest.mark.parametrize("stride,kernel", [(2, 3), (1, 3), (2, 2)])
def test_strided_gather_matches_dense(rng, stride, kernel):
    """The same active set and features from the port's two backends and
    JAX's dense one, compared as linear index -> feature maps."""
    grid = (8, 8, 6)
    feats, coords, valid = _sites(rng, 25, grid, 64)
    mk = dict(stride=stride, max_out_sites=128)
    jm = J.SparseConv3d(features=6, kernel_size=kernel, **mk)
    p = jm.init(jax.random.PRNGKey(0), *_j(feats, coords, valid), grid)
    ref = jm.apply(p, *_j(feats, coords, valid), grid)

    def as_map(out, oc, ov, og):
        out, oc, ov = (np.asarray(a.detach() if torch.is_tensor(a) else a) for a in (out, oc, ov))
        lin = (oc[:, 0].astype(np.int64) * og[1] + oc[:, 1]) * og[2] + oc[:, 2]
        return {int(l): out[i] for i, l in enumerate(lin) if ov[i]}

    mr = as_map(*ref)
    assert mr
    for backend in ("dense", "gather"):
        got = _port(jm, p, T.SparseConv3d, 4, backend, **mk)(*_t(feats, coords, valid), grid)
        assert got[3] == ref[3]
        mg = as_map(*got)
        assert set(mg) == set(mr), backend
        for l in mr:
            np.testing.assert_allclose(mg[l], mr[l], rtol=1e-5, atol=1e-5, err_msg=f"cell {l}")


def test_subm_gather_matches_dense_bf16(rng):
    grid = (7, 6, 5)
    feats, coords, valid = _sites(rng, 22, grid, 40)
    jm = J.SubMConv3d(features=8, dtype=jnp.bfloat16)
    p = jm.init(jax.random.PRNGKey(0), *_j(feats.astype(jnp.bfloat16), coords, valid), grid)
    ref, _, _ = jm.apply(p, *_j(feats.astype(jnp.bfloat16), coords, valid), grid)
    f, c, v = _t(feats, coords, valid)
    f = f.to(torch.bfloat16)
    out_d, _, _ = _port(jm, p, T.SubMConv3d, 4, dtype=torch.bfloat16)(f, c, v, grid)
    out_g, _, _ = _port(jm, p, T.SubMConv3d, 4, "gather", dtype=torch.bfloat16)(f, c, v, grid)
    _close(out_g, out_d.detach().float().numpy(), 0.05)
    _close(out_d, ref, 0.05)


def test_subm_gather_precomputed_neighbor_table(rng):
    grid = (7, 6, 5)
    feats, coords, valid = _sites(rng, 22, grid, 40)
    table = T.build_neighbor_table(*_t(coords, valid), grid, 3)
    np.testing.assert_array_equal(table.numpy(), np.asarray(
        J.build_neighbor_table(*_j(coords, valid), grid, 3)))
    jm = J.SubMConv3d(features=8)
    p = jm.init(jax.random.PRNGKey(0), *_j(feats, coords, valid), grid)
    m = _port(jm, p, T.SubMConv3d, 4, "gather")
    out_a, _, _ = m(*_t(feats, coords, valid), grid)
    out_b, _, _ = m(*_t(feats, coords, valid), grid, nbr=table)
    assert torch.equal(out_a, out_b)


def test_strided_gather_capacity_overflow_keeps_lowest_lin(rng):
    grid = (8, 8, 6)
    feats, coords, valid = _sites(rng, 40, grid, 64)
    cap = 5
    jm = J.SparseConv3d(features=4, stride=2, max_out_sites=cap)
    p = jm.init(jax.random.PRNGKey(0), *_j(feats, coords, valid), grid)
    _, roc, rov, og = jm.apply(p, *_j(feats, coords, valid), grid)

    def lins(oc, ov):
        oc = np.asarray(oc)[np.asarray(ov)].astype(np.int64)
        return sorted((oc[:, 0] * og[1] + oc[:, 1]) * og[2] + oc[:, 2])

    want = lins(roc, rov)
    assert len(want) == cap
    # the lowest linear indices of all the non-empty output cells
    every = _port(J.SparseConv3d(features=4, stride=2, max_out_sites=10 ** 6), p,
                  T.SparseConv3d, 4, stride=2, max_out_sites=10 ** 6)
    _, aoc, aov, _ = every(*_t(feats, coords, valid), grid)
    assert lins(aoc, aov)[:cap] == want
    for backend in ("dense", "gather"):
        _, oc, ov, _ = _port(jm, p, T.SparseConv3d, 4, backend, stride=2,
                             max_out_sites=cap)(*_t(feats, coords, valid), grid)
        assert int(ov.sum()) == cap
        assert lins(oc, ov) == want


def test_gather_backend_large_grid_and_grads(rng):
    """SECOND-scale grid through the gather backend (no dense volume), the
    submanifold and strided convs chained, against JAX's outputs and its
    gradient with respect to the features."""
    grid = (41, 160, 140)
    feats, coords, valid = _sites(rng, 1500, grid, 2048)
    subm = J.SubMConv3d(features=8, backend="gather")
    down = J.SparseConv3d(features=8, stride=2, max_out_sites=2048, backend="gather")
    p1 = subm.init(jax.random.PRNGKey(0), *_j(feats, coords, valid), grid)
    out1, _, _ = subm.apply(p1, *_j(feats, coords, valid), grid)
    p2 = down.init(jax.random.PRNGKey(1), out1, *_j(coords, valid), grid)

    def total(f):
        o1, c1, v1 = subm.apply(p1, f, *_j(coords, valid), grid)
        o2, _, _, _ = down.apply(p2, o1, c1, v1, grid)
        return jnp.sum(o2 ** 2)

    ref_g = np.asarray(jax.grad(total)(jnp.asarray(feats)))
    tsub = _port(subm, p1, T.SubMConv3d, 4, "gather")
    tdown = _port(down, p2, T.SparseConv3d, 8, "gather", stride=2, max_out_sites=2048)
    f, c, v = _t(feats, coords, valid)
    f.requires_grad_(True)
    o1, c1, v1 = tsub(f, c, v, grid)
    _close(o1, out1)
    o2, _, _, _ = tdown(o1, c1, v1, grid)
    (o2 ** 2).sum().backward()
    assert np.isfinite(f.grad.numpy()).all() and float(f.grad.abs().sum()) > 0
    np.testing.assert_allclose(f.grad.numpy(), ref_g, rtol=1e-4,
                               atol=1e-4 * np.abs(ref_g).max())


def test_subm_gather_batched_samples(rng):
    """Per-sample active sets (SECOND-style batches): each sample through the
    port equals JAX's vmap over the batch."""
    grid = (6, 6, 4)
    per = [_sites(np.random.RandomState(s), 12, grid, 24) for s in (1, 2, 3)]
    feats, coords, valid = (np.stack([p[i] for p in per]) for i in range(3))
    jm = J.SubMConv3d(features=8, backend="gather")
    p0 = jm.init(jax.random.PRNGKey(0), *_j(feats[0], coords[0], valid[0]), grid)
    batched = jax.vmap(lambda f, c, v: jm.apply(p0, f, c, v, grid)[0])(
        *_j(feats, coords, valid))
    m = _port(jm, p0, T.SubMConv3d, 4, "gather")
    for i in range(3):
        single, _, _ = m(*_t(feats[i], coords[i], valid[i]), grid)
        _close(single, np.asarray(batched[i]), 1e-6)


def test_assign_score_withk(rng):
    B, N, K, M, C = 2, 5, 3, 4, 6
    scores = rng.rand(B, N, K, M).astype(np.float32)
    pf = rng.randn(B, N, K, M, C).astype(np.float32)
    cf = rng.randn(B, N, K, M, C).astype(np.float32)
    for agg in ("sum", "avg", "max"):
        out = T.assign_score_withk(*_t(scores, pf, cf), agg)
        _close(out, J.assign_score_withk(*_j(scores, pf, cf), agg))
    ref = (scores[..., None] * (pf - cf)).sum(3)
    _close(T.assign_score_withk(*_t(scores, pf, cf)), ref)
