"""K2, the loss's point sampler, against the JAX package.

The port's plain version (``trilerp_sample_plain``, what the wrapper runs
for CPU tensors) and its autograd are held against
``occformer_tpu.ops.trilerp.trilerp_gather_slab`` run in Pallas interpret
mode and its VJP (d_table, d_coords), for zeros and border padding and both
``align_corners``; ``point_sample_3d`` against the JAX package's XLA
``point_sample_3d``.  Tolerance atol 1e-5: float32 on both sides, another
summation order.  The CUDA kernels themselves are held against the plain
version on the card by tests/test_torch_gpu.py and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.ops.sampling import point_sample_3d as jax_point_sample_3d
from occformer_tpu.ops.trilerp import trilerp_gather_slab
from occformer_tpu_torch.ops import trilerp as k2
from occformer_tpu_torch.ops.sampling import point_sample_3d

SPATIAL = (4, 8, 4)
ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed=0, G=2, C=6, S=96, spill=1.2):
    rng = np.random.RandomState(seed)
    table = rng.randn(G, *SPATIAL, C).astype(np.float32)
    coords = rng.uniform(-spill, spill, (G, S, 3)).astype(np.float32)
    return table, coords


def _jax_k2(table, coords, align_corners, padding_mode):
    """The Pallas sampler on the slab view of the table, as [G, S, C]."""
    G, X, Y, Z, C = table.shape
    out = trilerp_gather_slab(table.reshape(G, X * Y, Z * C), SPATIAL, C, coords,
                              align_corners, interpret=True, padding_mode=padding_mode)
    return jnp.transpose(out, (0, 2, 1))


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_plain_version_and_its_backward_match_pallas_kernel(align_corners, padding_mode):
    table, coords = _inputs()
    gout = np.random.RandomState(1).randn(*coords.shape[:2], table.shape[-1]).astype(np.float32)
    ref, vjp = jax.vjp(lambda t, c: _jax_k2(t, c, align_corners, padding_mode),
                       jnp.asarray(table), jnp.asarray(coords))
    d_table_ref, d_coords_ref = vjp(jnp.asarray(gout))

    t = torch.from_numpy(table).requires_grad_(True)
    c = torch.from_numpy(coords).requires_grad_(True)
    got = k2.trilerp_sample_plain(t, c, align_corners, padding_mode)
    got.backward(torch.from_numpy(gout))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=ATOL)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(d_table_ref), atol=ATOL)
    # border clipping: the gradient is 0 where the coordinate is clipped on
    # both sides; the few samples within float rounding of a clip limit are
    # not drawn here
    np.testing.assert_allclose(c.grad.numpy(), np.asarray(d_coords_ref), atol=1e-4)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_point_sample_matches_jax_xla_path(align_corners, padding_mode):
    rng = np.random.RandomState(2)
    vol = rng.randn(2, *SPATIAL, 5).astype(np.float32)
    mask = rng.rand(2, *SPATIAL, 3) > 0.5
    pts = rng.uniform(-0.1, 1.1, (2, 50, 3)).astype(np.float32)
    for v in (vol, mask):
        ref = jax_point_sample_3d(jnp.asarray(v), jnp.asarray(pts), align_corners,
                                  padding_mode)
        got = point_sample_3d(torch.from_numpy(v), torch.from_numpy(pts), align_corners,
                              padding_mode)
        assert got.dtype == torch.float32 and ref.dtype == jnp.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_wrapper_on_cpu_runs_the_plain_version_without_launching():
    table, coords = _inputs(seed=3)
    before = (k2.LAUNCHES, k2.BWD_LAUNCHES)
    t = torch.from_numpy(table).requires_grad_(True)
    got = k2.trilerp_sample(t, torch.from_numpy(coords), False, "border")
    got.sum().backward()
    assert (k2.LAUNCHES, k2.BWD_LAUNCHES) == before
    ref = k2.trilerp_sample_plain(torch.from_numpy(table), torch.from_numpy(coords),
                                  False, "border")
    torch.testing.assert_close(got.detach(), ref, rtol=0, atol=0)


def test_wrapper_rejects_bad_arguments():
    table, coords = _inputs(seed=4)
    t, c = torch.from_numpy(table), torch.from_numpy(coords)
    with pytest.raises(ValueError):
        k2.trilerp_sample(t, c[..., :2])
    with pytest.raises(ValueError):
        k2.trilerp_sample(t[:1], c)
    with pytest.raises(ValueError):
        k2.trilerp_sample(t, c, padding_mode="reflection")
