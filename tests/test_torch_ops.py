"""The port's ops against the JAX package's, on the CPU in float32.

Inputs come from a seeded numpy generator and go through both functions.
Tolerance: atol 1e-5 — the same float32 arithmetic, in another library and
summation order.
"""
import os

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


def _splat_counting_sort(coords, valid, nx, depth):
    """S1's counting sort (csrc/voxel_splat.cu with segment_sort.cuh) in
    torch: each valid point's voxel row in int32 (no dummy row), a histogram,
    its exclusive scan, and each point placed at its row's offset plus its
    rank among the row's points by point index; each entry is the point's
    pixel in int32 and its depth as a float.  -> (offsets, points, pixels,
    depths)."""
    B, N, D, fH, fW = valid.shape
    X, Y, Z = nx
    c = coords.to(torch.int32)
    x, y, z = (c[..., i].clamp(0, n - 1) for i, n in enumerate(nx))
    b = torch.arange(B, dtype=torch.int32).view(B, 1, 1, 1, 1)
    rows = (b * (X * Y * Z) + (x * Y + y) * Z + z).reshape(-1)
    p = torch.nonzero(valid.reshape(-1)).reshape(-1).to(torch.int32)
    r = rows[p.long()]
    offs = torch.zeros(B * X * Y * Z + 1, dtype=torch.int32)
    offs[1:] = torch.cumsum(torch.bincount(r, minlength=B * X * Y * Z), 0)
    rank = ((r[None, :] == r[:, None]) & (p[None, :] < p[:, None])).sum(1).to(torch.int32)
    points = torch.empty_like(p)
    points[(offs[r.long()] + rank).long()] = p
    HW = fH * fW
    return (offs, points, points // (D * HW) * HW + points % HW,
            depth.reshape(-1)[points.long()].float())


@pytest.mark.parametrize("clustered", [False, True])
def test_splat_counting_sort_gives_the_stable_sort_order(clustered):
    """S1's on-card sort in torch against ``segments`` (a stable argsort of
    ``voxel_rows``) on the valid points: the same order and offsets, at
    random geometry and at clustered geometry (hundreds of points in the hot
    voxels, as near a camera); the pixels as the first design computed them
    and the entries' depths those of the points in that order."""
    rng = np.random.RandomState(7)
    B, N, D, fH, fW = 2, 3, 16, 6, 8
    nx = (6, 5, 4)
    if clustered:
        coords = rng.randint(0, 2, (B, N, D, fH, fW, 3))
        coords[:, :, ::3] = rng.randint(-1, 7, (B, N, (D + 2) // 3, fH, fW, 3))
    else:
        coords = rng.randint(-1, 7, (B, N, D, fH, fW, 3))
    coords = _t(coords.astype(np.int32))
    valid = ((coords >= 0) & (coords < _t(nx))).all(-1) & _t(rng.rand(B, N, D, fH, fW) > 0.2)
    n_rows = B * int(np.prod(nx))
    depth = _t(rng.rand(B, N, D, fH, fW).astype(np.float32)).to(torch.bfloat16)
    offs, points, pixels, depths = _splat_counting_sort(coords, valid, nx, depth)
    order, offsets = scatter_mod.segments(scatter_mod.voxel_rows(coords, valid, nx), n_rows)
    assert torch.equal(offs.long(), offsets)
    assert torch.equal(points.long(), order[:int(valid.sum())])
    HW = fH * fW
    assert torch.equal(pixels.long(), order[:len(points)] // (D * HW) * HW
                       + order[:len(points)] % HW)
    assert torch.equal(depths, depth.reshape(-1)[order[:len(points)]].float())
    if clustered:
        assert int(torch.diff(offsets).max()) >= 100


def test_nuscenes_rig_looks_out_along_each_camera_yaw():
    """S1's timing rig (``tools/time_backwards.py:NUSCENES_RIG``) at the
    flagship's frustum: the port's geometry equals the JAX package's; each
    camera's frustum, seen from the camera, is centred on its yaw and looks
    down (the crop keeps the image's lower rows); more than half the points
    fall in the grid, against under 5% at the synthetic cameras, which look
    straight up."""
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.tools import time_backwards as tb

    cfg = load_config(os.path.join(os.path.dirname(tgeo.__file__), "..", "configs",
                                   "occformer_nusc_r50_256x704.py"))
    vt = cfg["model"]["img_view_transformer"]
    gc, size = vt["grid_config"], tuple(vt["data_config"]["input_size"])
    fr = tgeo.create_frustum(gc, size, vt.get("downsample", 16))
    cams = tb.nuscenes_rig_cameras(size)
    keys = ("rots", "trans", "intrins", "post_rots", "post_trans", "bda")
    geom = tgeo.get_geometry(_t(fr), *(_t(cams[k]) for k in keys))
    ref = np.asarray(jgeo.get_geometry(jnp.asarray(fr), *(jnp.asarray(cams[k]) for k in keys)))
    np.testing.assert_allclose(geom.numpy(), ref, rtol=1e-5, atol=1e-4)
    rays = (geom[0] - _t(cams["trans"][0])[:, None, None, None]).reshape(6, -1, 3).mean(1)
    yaws = torch.rad2deg(torch.atan2(rays[:, 1], rays[:, 0]))
    want = torch.tensor([yaw for _, yaw, _, _ in tb.NUSCENES_RIG])
    assert float(((yaws - want + 180) % 360 - 180).abs().max()) < 1.0
    assert bool((rays[:, 2] < 0).all())
    stats = {rig: tb.segment_stats(*tb.s1_geometry(rig, device="cpu")[:3])
             for rig in ("nuscenes", "synthetic")}
    assert stats["nuscenes"]["points_valid"] > 0.5 * stats["nuscenes"]["points"]
    assert stats["synthetic"]["points_valid"] < 0.05 * stats["synthetic"]["points"]


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


@pytest.mark.parametrize("size", [(8, 6, 4), (7, 5, 3), (4, 3, 2)])
@pytest.mark.parametrize("align_corners", [False, True])
def test_resize_trilinear_backward_matches_jax_vjp(size, align_corners):
    """The resize's backward (the separable adjoint through the 1-D
    interpolation matrices, which repeats itself on the card) against
    ``jax.vjp`` of the JAX resize and autograd through ``F.interpolate``,
    atol 1e-5 (float32, other summation orders); (8, 6, 4) is the FPN's
    factor-2 upsample, (4, 3, 2) the identity."""
    import jax

    rng = np.random.RandomState(5)
    vol = rng.randn(1, 4, 3, 2, 5).astype(np.float32)
    g = rng.randn(1, *size, 5).astype(np.float32)
    leaf = _t(vol).requires_grad_(True)
    resize_trilinear(leaf, size, align_corners).backward(_t(g))
    _, vjp = jax.vjp(lambda v: j_resize(v, size, align_corners), jnp.asarray(vol))
    np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), atol=ATOL)
    ref = _t(vol).requires_grad_(True)
    torch.nn.functional.interpolate(ref.permute(0, 4, 1, 2, 3), size=size, mode="trilinear",
                                    align_corners=align_corners).permute(0, 2, 3, 4, 1).backward(
        _t(g))
    np.testing.assert_allclose(leaf.grad.numpy(), ref.grad.numpy(), atol=ATOL)


@pytest.mark.parametrize("out_size", [(4, 2, 2), (3, 5, 2)])
def test_adaptive_max_pool3d_matches_jax(out_size):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 8, 10, 4, 3).astype(np.float32)
    got = adaptive_max_pool3d(_t(x), out_size).numpy()
    ref = np.asarray(j_pool(jnp.asarray(x), out_size))
    np.testing.assert_allclose(got, ref, atol=ATOL)
