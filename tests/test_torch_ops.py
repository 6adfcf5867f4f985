"""The port's ops against the JAX package's, on the CPU in float32.

Inputs come from a seeded numpy generator and go through both functions.
Tolerance: atol 1e-5 — the same float32 arithmetic, in another library and
summation order.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tiny_cfg
from occformer_tpu.ops import geometry as jgeo
from occformer_tpu.ops.pooling import adaptive_max_pool3d as j_pool
from occformer_tpu.ops.sampling import grid_sample_2d as j_gs2
from occformer_tpu.ops.sampling import grid_sample_3d as j_gs3
from occformer_tpu.ops.sampling import resize_trilinear as j_resize
from occformer_tpu.ops.scatter import voxel_scatter_lifted as j_scatter
from occformer_tpu_torch.ops import geometry as tgeo
from occformer_tpu_torch.ops.pooling import adaptive_max_pool3d
from occformer_tpu_torch.ops.sampling import grid_sample_2d, grid_sample_3d, resize_trilinear
from occformer_tpu_torch.ops import scatter as scatter_mod
from occformer_tpu_torch.ops.scatter import voxel_scatter_lifted

ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.array(a))


def _geometry_inputs(rng):
    B, N = 2, 2
    batch = tiny_cfg.make_batch(rng, B=B)
    # non-trivial rotations, aug homographies and a BDA
    ang = rng.uniform(-0.3, 0.3, (B, N))
    c, s = np.cos(ang), np.sin(ang)
    rots = np.zeros((B, N, 3, 3), np.float32)
    rots[..., 0, 0], rots[..., 0, 1], rots[..., 1, 0], rots[..., 1, 1] = c, -s, s, c
    rots[..., 2, 2] = 1
    batch["rots"] = rots
    batch["post_rots"] = (batch["post_rots"] * rng.uniform(0.9, 1.1, (B, N, 1, 1))
                          ).astype(np.float32)
    batch["post_trans"] = rng.uniform(-2, 2, (B, N, 3)).astype(np.float32)
    batch["bda"] = (np.eye(3, dtype=np.float32)[None]
                    * np.array([1, -1, 1], np.float32)[None, :, None])
    batch["bda"] = np.repeat(batch["bda"], B, 0)
    return batch


def test_geometry_matches_jax():
    rng = np.random.RandomState(0)
    cfg = tiny_cfg.GRID_CONFIG
    for a, b in zip(tgeo.gen_dx_bx(cfg["xbound"], cfg["ybound"], cfg["zbound"]),
                    jgeo.gen_dx_bx(cfg["xbound"], cfg["ybound"], cfg["zbound"])):
        np.testing.assert_array_equal(a, b)
    fr = tgeo.create_frustum(cfg, tiny_cfg.INPUT_SIZE, tiny_cfg.DOWNSAMPLE)
    np.testing.assert_array_equal(
        fr, jgeo.create_frustum(cfg, tiny_cfg.INPUT_SIZE, tiny_cfg.DOWNSAMPLE))

    b = _geometry_inputs(rng)
    keys = ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")
    got = tgeo.get_geometry(_t(fr), *(_t(b[k]) for k in keys)).numpy()
    ref = np.asarray(jgeo.get_geometry(jnp.asarray(fr), *(jnp.asarray(b[k]) for k in keys)))
    np.testing.assert_allclose(got, ref, atol=ATOL)

    dx, bx, nx = jgeo.gen_dx_bx(cfg["xbound"], cfg["ybound"], cfg["zbound"])
    c_t, v_t = tgeo.compute_voxel_coords(_t(ref), dx, bx, nx)
    c_j, v_j = jgeo.compute_voxel_coords(jnp.asarray(ref), dx, bx, nx)
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))
    assert 0 < v_t.float().mean() < 1  # some points fall outside the grid


def test_voxel_scatter_lifted_matches_jax():
    rng = np.random.RandomState(1)
    B, N, D, fH, fW, C = 2, 3, 4, 3, 5, 6
    nx = (4, 5, 3)
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    ctx = rng.randn(B, N, fH, fW, C).astype(np.float32)
    coords = rng.randint(-1, 6, (B, N, D, fH, fW, 3)).astype(np.int32)
    valid = ((coords >= 0) & (coords < np.array(nx))).all(-1) & (rng.rand(B, N, D, fH, fW) > 0.2)
    assert not valid.all() and valid.any()
    got = voxel_scatter_lifted(_t(depth), _t(ctx), _t(coords), _t(valid), nx).numpy()
    ref = np.asarray(j_scatter(jnp.asarray(depth), jnp.asarray(ctx), jnp.asarray(coords),
                               jnp.asarray(valid), nx))
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_voxel_scatter_function_and_plain_autograd_agree():
    """The scatter's autograd Function (its gather backward; on the CPU its
    forward is the plain version) against autograd through the plain
    version: the same volume and the same depth and context gradients
    within float32 rounding."""
    rng = np.random.RandomState(3)
    B, N, D, fH, fW, C = 2, 3, 5, 4, 6, 7
    nx = (4, 4, 3)
    n_rows = B * int(np.prod(nx))
    depth = _t(rng.rand(B, N, D, fH, fW).astype(np.float32)).requires_grad_(True)
    ctx = _t(rng.randn(B, N, fH, fW, C).astype(np.float32)).requires_grad_(True)
    coords = _t(rng.randint(-1, 5, (B, N, D, fH, fW, 3)).astype(np.int32))
    valid = _t(rng.rand(B, N, D, fH, fW) > 0.2)
    probe = _t(rng.randn(n_rows, C).astype(np.float32))
    got = voxel_scatter_lifted(depth, ctx, coords, valid, nx).reshape(n_rows, C)
    ref = scatter_mod.voxel_scatter_plain(depth, ctx, scatter_mod.voxel_rows(coords, valid, nx),
                                          n_rows)
    g_got = torch.autograd.grad((got * probe).sum(), [depth, ctx])
    g_ref = torch.autograd.grad((ref * probe).sum(), [depth, ctx])
    for a, b in zip((got, *g_got), (ref, *g_ref)):
        torch.testing.assert_close(a, b, rtol=0, atol=ATOL)


def test_splat_kernel_formulation_matches_the_plain_version():
    """csrc/voxel_splat.cu's formulation in numpy: the points sorted by
    voxel (``segments``), each voxel's sum of depth[p] * ctx[pixel p] taken
    in ascending point order, the dummy row never read; against the plain
    version, and every segment in ascending point order."""
    rng = np.random.RandomState(4)
    B, N, D, fH, fW, C = 2, 2, 4, 3, 5, 6
    nx = (3, 4, 2)
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    ctx = rng.randn(B, N, fH, fW, C).astype(np.float32)
    coords = _t(rng.randint(-1, 4, (B, N, D, fH, fW, 3)).astype(np.int32))
    valid = _t(rng.rand(B, N, D, fH, fW) > 0.3)
    n_rows = B * int(np.prod(nx))
    rows = scatter_mod.voxel_rows(coords, valid, nx)
    order, offsets = scatter_mod.segments(rows, n_rows)
    order, offsets = order.numpy(), offsets.numpy()
    flat_depth, flat_ctx = depth.reshape(-1), ctx.reshape(-1, C)
    HW = fH * fW
    out = np.zeros((n_rows, C), np.float32)
    for r in range(n_rows):
        seg = order[offsets[r]:offsets[r + 1]]
        assert (np.diff(seg) > 0).all()
        for p in seg:
            out[r] += flat_depth[p] * flat_ctx[p // (D * HW) * HW + p % HW]
    ref = scatter_mod.voxel_scatter_plain(_t(depth), _t(ctx), rows, n_rows)
    np.testing.assert_allclose(out, ref.numpy(), atol=ATOL)
    assert offsets[-1] == int(valid.sum())  # the dummy row's points lie past the last voxel


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_3d_matches_jax(padding_mode, align_corners):
    rng = np.random.RandomState(2)
    vol = rng.randn(2, 5, 4, 3, 6).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 7, 4, 3)).astype(np.float32)
    got = grid_sample_3d(_t(vol), _t(coords), align_corners, padding_mode).numpy()
    ref = np.asarray(j_gs3(jnp.asarray(vol), jnp.asarray(coords), align_corners,
                           padding_mode))
    assert got.shape == ref.shape == (2, 7, 4, 6)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_grid_sample_2d_matches_jax(padding_mode, align_corners):
    rng = np.random.RandomState(5)
    img = rng.randn(2, 6, 5, 4).astype(np.float32)
    coords = rng.uniform(-1.3, 1.3, (2, 3, 7, 2)).astype(np.float32)
    got = grid_sample_2d(_t(img), _t(coords), align_corners, padding_mode).numpy()
    ref = np.asarray(j_gs2(jnp.asarray(img), jnp.asarray(coords), align_corners,
                           padding_mode))
    assert got.shape == ref.shape == (2, 3, 7, 4)
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("size", [(8, 6, 4), (7, 5, 3)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_trilinear_matches_jax(size, align_corners):
    rng = np.random.RandomState(3)
    vol = rng.randn(1, 4, 3, 2, 5).astype(np.float32)
    got = resize_trilinear(_t(vol), size, align_corners).numpy()
    ref = np.asarray(j_resize(jnp.asarray(vol), size, align_corners))
    np.testing.assert_allclose(got, ref, atol=ATOL)


@pytest.mark.parametrize("out_size", [(4, 2, 2), (3, 5, 2)])
def test_adaptive_max_pool3d_matches_jax(out_size):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 10, 4, 3).astype(np.float32)
    got = adaptive_max_pool3d(_t(x), out_size).numpy()
    ref = np.asarray(j_pool(jnp.asarray(x), out_size))
    np.testing.assert_allclose(got, ref, atol=ATOL)
