"""The plain versions of FPS and S1-rows at the edge cases their kernels are
held to on the card (tests/test_torch_gpu.py), on the CPU.

* ``furthest_point_sample_plain`` (which the FPS kernel must equal bit for
  bit at every thread-block cluster size) against the numpy oracle of
  tests/test_torch_pointcloud_ops.py at: one point and one sample; fewer
  points than one cluster has threads; a count that no cluster size splits
  evenly; more samples than valid points; a cloud with no valid point; a
  lattice, whose equal distances are ties that go to the lowest index; more
  clouds than the card holds clusters at once; a cloud larger than the
  kernel keeps in registers.  On clouds with every point valid it is held to
  JAX's op too; with invalid points the JAX op is at fault (ROADMAP §C).
* ``voxel_scatter_plain_rows`` (which S1-rows must equal bit for bit)
  against JAX's ``voxel_scatter``, within 1e-5 of the largest |value| (the
  same float32 sums in another order), at C = 128, 40 and 7, over two batch
  items, with a voxel of more than 1,024 rows and with every row invalid.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occformer_tpu.ops import pointcloud as J
from occformer_tpu.ops.scatter import voxel_scatter as jax_voxel_scatter
from occformer_tpu_torch.ops import pointcloud as T
from occformer_tpu_torch.ops.scatter import voxel_rows, voxel_scatter_plain_rows
from test_torch_pointcloud_ops import _fps_oracle


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fps(xyz, npoint, valid=None):
    got = T.furthest_point_sample_plain(torch.from_numpy(xyz), npoint,
                                        None if valid is None else torch.from_numpy(valid))
    assert got.dtype == torch.int32 and got.shape == (xyz.shape[0], npoint)
    return got.numpy()


def _cloud(rng, B, N, frac_valid=0.67):
    xyz = rng.uniform(0, 4, (B, N, 3)).astype(np.float32)
    return xyz, rng.rand(B, N) < frac_valid


# (clouds, points, samples): one point and one sample; fewer points than a
# 32-thread CTA per cluster member; 1003 points, which no cluster of 2-16
# splits evenly; more clouds than 132 SMs hold 16-CTA clusters; a cloud over
# the 8192 points a 16-CTA cluster keeps in registers per CTA
FPS_CASES = [(1, 1, 1), (2, 5, 8), (3, 1003, 64), (40, 37, 12), (1, 9000, 24)]


@pytest.mark.parametrize("B,N,npoint", FPS_CASES)
def test_fps_plain_matches_oracle_at_edges(B, N, npoint):
    rng = np.random.RandomState(N)
    xyz, valid = _cloud(rng, B, N)
    _np = np.testing.assert_array_equal
    _np(_fps(xyz, npoint), _fps_oracle(xyz, npoint, np.ones((B, N), bool)))
    got = _fps(xyz, npoint, valid)
    _np(got, _fps_oracle(xyz, npoint, valid))
    # a valid point keeps a distance of 0 or more, so no step takes an
    # invalid one while the cloud has a valid point
    for b in range(B):
        assert valid[b, got[b, 1:]].all() or not valid[b].any()


def test_fps_plain_matches_jax_on_unmasked_clouds():
    """JAX's op is right where every point is valid: the same indices."""
    rng = np.random.RandomState(1)
    for B, N, npoint in ((3, 1003, 64), (2, 5, 8)):
        xyz, _ = _cloud(rng, B, N)
        np.testing.assert_array_equal(_fps(xyz, npoint),
                                      np.asarray(J.furthest_point_sample(jnp.asarray(xyz),
                                                                         npoint)))


def test_fps_plain_past_the_valid_points_and_without_any():
    """More samples than valid points: once each valid point is taken (its
    distance 0), the lowest valid index, never an invalid one; a cloud with
    no valid point takes index 0 at every step."""
    rng = np.random.RandomState(2)
    xyz, _ = _cloud(rng, 2, 50)
    valid = np.zeros((2, 50), bool)
    valid[0, [3, 17, 40]] = True
    got = _fps(xyz, 9, valid)
    np.testing.assert_array_equal(got, _fps_oracle(xyz, 9, valid))
    assert set(got[0, 1:].tolist()) <= {3, 17, 40} and (got[0, 3:] == 3).all()
    np.testing.assert_array_equal(got[1], np.zeros(9, np.int32))


def test_fps_plain_on_a_lattice_takes_ties_lowest_first():
    side = np.arange(5, dtype=np.float32)
    grid = np.stack(np.meshgrid(side, side, side, indexing="ij"), -1).reshape(1, -1, 3)
    grid = np.ascontiguousarray(grid)
    every = np.ones((1, grid.shape[1]), bool)
    few = np.zeros_like(every)
    few[0, ::7] = True
    for v in (every, few):
        np.testing.assert_array_equal(_fps(grid, 40, v), _fps_oracle(grid, 40, v))
    np.testing.assert_array_equal(_fps(grid, 40),
                                  np.asarray(J.furthest_point_sample(jnp.asarray(grid), 40)))


def _rows_case(rng, C, hot, all_invalid):
    B, P, nx = 2, 1600, (5, 4, 3)
    feats = rng.randn(B, P, C).astype(np.float32)
    coords = rng.randint(-1, 6, (B, P, 3)).astype(np.int32)
    if hot:
        coords[0, :1500] = (2, 1, 1)  # about 1,200 valid rows in one voxel
    valid = np.zeros((B, P), bool) if all_invalid else rng.rand(B, P) > 0.2
    return feats, coords, valid, nx


@pytest.mark.parametrize("C", [128, 40, 7])
@pytest.mark.parametrize("case", ["hot", "all_invalid"])
def test_rows_plain_matches_jax_at_edges(C, case):
    rng = np.random.RandomState(C)
    feats, coords, valid, nx = _rows_case(rng, C, case == "hot", case == "all_invalid")
    B = feats.shape[0]
    n_rows = B * int(np.prod(nx))
    rows = voxel_rows(torch.from_numpy(coords), torch.from_numpy(valid), nx)
    got = voxel_scatter_plain_rows(torch.from_numpy(feats), rows, n_rows)
    ref = np.asarray(jax_voxel_scatter(jnp.asarray(feats), jnp.asarray(coords),
                                       jnp.asarray(valid), nx)).reshape(n_rows, C)
    scale = max(float(np.abs(ref).max()), 1.0)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * scale)
    if case == "all_invalid":
        assert not got.any()
    else:
        # the hot voxel is the ascending sum of its rows, as the kernel adds them
        r = (2 * 4 + 1) * 3 + 1  # voxel (2, 1, 1) of batch item 0
        members = np.nonzero(rows.numpy()[0] == r)[0]
        assert len(members) > 1024
        want = np.zeros(C, np.float32)
        for p in members:
            want = want + feats[0, p]
        np.testing.assert_array_equal(got.numpy()[r], want)
