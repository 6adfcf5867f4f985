"""K2, the loss's point sampler, against the JAX package.

The port's plain version (``trilerp_sample_plain``, what the wrapper runs
for CPU tensors) and its autograd are held against
``occformer_tpu.ops.trilerp.trilerp_gather_slab`` run in Pallas interpret
mode and its VJP (d_table, d_coords), for zeros and border padding and both
``align_corners``; ``point_sample_3d`` against the JAX package's XLA
``point_sample_3d``.  Tolerance atol 1e-5: float32 on both sides, another
summation order.  The CUDA kernels themselves are held against the plain
version on the card by tests/test_torch_gpu.py and by chip_smoke.py.

K2-bwd's two paths (``csrc/trilerp_sample3d.cu``) have no CPU mode; torch
models of their formulations here (the segmented path: corner keys and
weights with the kernel's ``make_axis`` arithmetic, a stable sort by key,
segment sums in ascending point order; the narrow path: one (x, y) column
key a point, lists in ascending point order, each column's sums over the
four lists that touch it) pin the index and weight rules they follow
against autograd of the plain version, and ``bwd_path`` and ``fwd_path``, the
wrapper's choices of path, and ``narrow_vec`` and ``narrow_lanes``, the
narrow forward's load width and lane group, are tested as the pure
functions they are.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.ops.sampling import point_sample_3d as jax_point_sample_3d
from occformer_tpu.ops.trilerp import trilerp_gather_slab
from occformer_tpu_torch.ops import trilerp as k2
from occformer_tpu_torch.ops.loss_gather import sort_points_by_row
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
    before = (k2.LAUNCHES, k2.BWD_LAUNCHES, k2.BWD_NARROW_LAUNCHES)
    t = torch.from_numpy(table).requires_grad_(True)
    got = k2.trilerp_sample(t, torch.from_numpy(coords), False, "border")
    got.sum().backward()
    assert (k2.LAUNCHES, k2.BWD_LAUNCHES, k2.BWD_NARROW_LAUNCHES) == before
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


def _axis(coord, size, align_corners, border):
    """csrc/trilerp_sample3d.cu:make_axis: lower corner and the two lerp
    weights of one axis."""
    if align_corners:
        pix = (coord + 1.0) * 0.5 * (size - 1)
    else:
        pix = ((coord + 1.0) * size - 1.0) * 0.5
    pix = pix.clamp(0.0, size - 1) if border else pix.clamp(-2.0, size + 1.0)
    i0 = pix.floor()
    w1 = pix - i0
    return i0.long(), (1.0 - w1, w1)


def _segmented_d_table(table_shape, coords, gout, align_corners, padding_mode):
    """The segmented K2-bwd formulation in torch: one entry per (point,
    in-range corner) keyed by its voxel row g*X*Y*Z + (x*Y + y)*Z + z,
    entries stably sorted by key from ascending point order, and each row's
    sum of w * gout[point] taken in that order.  -> (d_table, sorted keys,
    sorted points)."""
    G, X, Y, Z, C = table_shape
    S = coords.shape[1]
    border = padding_mode == "border"
    axes = [_axis(coords[..., i], n, align_corners, border) for i, n in enumerate((X, Y, Z))]
    point = torch.arange(G * S).view(G, S)
    row0 = torch.arange(G).view(G, 1) * (X * Y * Z)
    keys, points, weights = [], [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                idx = [a[0] + d for a, d in zip(axes, (dx, dy, dz))]
                ok = torch.ones_like(point, dtype=torch.bool)
                for i, n in zip(idx, (X, Y, Z)):
                    ok &= (i >= 0) & (i < n)
                w = axes[0][1][dx] * axes[1][1][dy] * axes[2][1][dz]
                key = row0 + (idx[0] * Y + idx[1]) * Z + idx[2]
                keys.append(key[ok])
                points.append(point[ok])
                weights.append(w[ok])
    key, pt, w = torch.cat(keys), torch.cat(points), torch.cat(weights)
    by_point = torch.argsort(pt, stable=True)
    order = by_point[torch.argsort(key[by_point], stable=True)]
    key, pt, w = key[order], pt[order], w[order]
    d = torch.zeros(G * X * Y * Z, C)
    d.index_add_(0, key, w[:, None] * gout.reshape(G * S, C)[pt])
    return d.view(G, X, Y, Z, C), key, pt


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_segmented_backward_formulation_matches_plain_autograd(align_corners, padding_mode):
    """On a 5x7x3 volume (sides not powers of two), with points drawn over
    [-1.15, 1.15] plus points exactly on the upper and lower edges, just
    beyond them, and well beyond them."""
    rng = np.random.RandomState(5)
    G, C, spatial = 2, 16, (5, 7, 3)
    table = rng.randn(G, *spatial, C).astype(np.float32)
    edge = np.array([[1.0, 1.0, 1.0], [1.0, 0.3, -1.0], [-1.0, -1.0, 1.0],
                     [1.0 + 1e-6, 0.0, 1.0 - 1e-6], [1.3, 1.0, 0.2], [-1.2, 1.07, 1.4],
                     [1.0, 1.0, 0.999], [0.0, 1.0, 1.0]], np.float32)
    coords = np.concatenate([rng.uniform(-1.15, 1.15, (G, 120, 3)).astype(np.float32),
                             np.broadcast_to(edge, (G,) + edge.shape)], axis=1)
    gout = rng.randn(G, coords.shape[1], C).astype(np.float32)
    t = torch.from_numpy(table).requires_grad_(True)
    k2.trilerp_sample_plain(t, torch.from_numpy(coords), align_corners,
                            padding_mode).backward(torch.from_numpy(gout))
    got, key, pt = _segmented_d_table(table.shape, torch.from_numpy(coords),
                                      torch.from_numpy(gout), align_corners, padding_mode)
    np.testing.assert_allclose(got.numpy(), t.grad.numpy(), atol=ATOL)
    # every segment lists its points in ascending order, each at most once
    same = key[1:] == key[:-1]
    assert bool((pt[1:][same] > pt[:-1][same]).all())


def _column_d_table(table_shape, coords, gout, align_corners, padding_mode):
    """The narrow K2-bwd formulation in torch: one entry per point with a
    corner inside its table, keyed by its column g*X*Y + x0*Y + y0 (the
    lower corner clamped into the table), entries stably sorted by key from
    ascending point order; each output column (g, x, y) walks the lists of
    the key columns (x-1, y-1), (x-1, y), (x, y-1), (x, y) in that order,
    the kernel's (``trilerp_bwd_tiles_kernel``), and adds w * gout[point] to
    its two z corners.  -> (d_table, sorted keys,
    sorted points)."""
    G, X, Y, Z, C = table_shape
    S = coords.shape[1]
    border = padding_mode == "border"
    axes = [_axis(coords[..., i].reshape(-1), n, align_corners, border)
            for i, n in enumerate((X, Y, Z))]
    (x0, wx), (y0, wy), (z0, wz) = axes
    has = torch.ones(G * S, dtype=torch.bool)
    for i0, n in ((x0, X), (y0, Y), (z0, Z)):
        has &= (i0 >= -1) & (i0 < n)
    g = torch.arange(G).repeat_interleave(S)
    key = g * (X * Y) + x0.clamp(0, X - 1) * Y + y0.clamp(0, Y - 1)
    pt = torch.arange(G * S)[has]
    key = key[has]
    order = torch.argsort(key, stable=True)
    key, pt = key[order], pt[order]
    offs = torch.zeros(G * X * Y + 1, dtype=torch.long)
    offs[1:] = torch.cumsum(torch.bincount(key, minlength=G * X * Y), 0)
    go = gout.reshape(G * S, C)
    d = torch.zeros(G, X, Y, Z, C)
    for col in range(G * X * Y):
        x, y = col % (X * Y) // Y, col % Y
        for dx, dy in ((1, 1), (1, 0), (0, 1), (0, 0)):
            if x < dx or y < dy:
                continue
            k = col - dx * Y - dy
            for p in pt[offs[k]:offs[k + 1]].tolist():
                ex, ey = x - int(x0[p]), y - int(y0[p])
                if ex not in (0, 1) or ey not in (0, 1):
                    continue
                wxy = wx[ex][p] * wy[ey][p]
                for ez in (0, 1):
                    z = int(z0[p]) + ez
                    if 0 <= z < Z:
                        d[col // (X * Y), x, y, z] += wxy * wz[ez][p] * go[p]
    return d, key, pt


@pytest.mark.parametrize("C", [1, 17])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("by_column", [False, True])
def test_column_backward_formulation_matches_plain_autograd(C, align_corners, padding_mode,
                                                            by_column):
    """On a 5x7x3 volume with points over [-1.15, 1.15] plus points on and
    beyond the edges, in random order or sorted by ``sort_points_by_row`` as
    the batched loss sends them (then the sort keeps the input order): the
    narrow formulation within 1e-5 of autograd of the plain version, the same
    bits on two calls, every list in ascending point order."""
    rng = np.random.RandomState(6)
    G, spatial = 2, (5, 7, 3)
    table = rng.randn(G, *spatial, C).astype(np.float32)
    edge = np.array([[1.0, 1.0, 1.0], [1.0, 0.3, -1.0], [-1.0, -1.0, 1.0],
                     [1.0 + 1e-6, 0.0, 1.0 - 1e-6], [1.3, 1.0, 0.2], [-1.2, 1.07, 1.4],
                     [-1.1, -1.1, 0.0], [0.0, 1.0, 1.0]], np.float32)
    coords = torch.from_numpy(np.concatenate(
        [rng.uniform(-1.15, 1.15, (G, 100, 3)).astype(np.float32),
         np.broadcast_to(edge, (G,) + edge.shape)], axis=1))
    if by_column:
        coords = sort_points_by_row((coords + 1) / 2, spatial, align_corners) * 2 - 1
    gout = torch.from_numpy(rng.randn(G, coords.shape[1], C).astype(np.float32))
    t = torch.from_numpy(table).requires_grad_(True)
    k2.trilerp_sample_plain(t, coords, align_corners, padding_mode).backward(gout)
    got, key, pt = _column_d_table(table.shape, coords, gout, align_corners, padding_mode)
    again, _, _ = _column_d_table(table.shape, coords, gout, align_corners, padding_mode)
    assert torch.equal(got, again)
    torch.testing.assert_close(got, t.grad, rtol=0, atol=1e-5 * t.grad.abs().max().item())
    same = key[1:] == key[:-1]
    assert bool((pt[1:][same] > pt[:-1][same]).all())
    if by_column:  # sorted by column already: the sort returns the input order
        assert bool((pt[1:] > pt[:-1]).all())


def test_column_lanes():
    assert [k2.column_lanes(c) for c in (1, 2, 5, 8, 17, 32, 40, 100)] == \
        [1, 2, 8, 8, 32, 32, 32, 32]


@pytest.mark.parametrize("shape,points,want", [
    ((1, 128, 128, 16, 192), 150528, "segmented"),  # per-layer route: candidates
    ((1, 128, 128, 16, 192), 213248, "segmented"),  # per-layer route: random fill
    ((10, 128, 128, 16, 17), 150528, "narrow"),     # batched route: candidates
    ((170, 128, 128, 16, 1), 12544, "narrow"),      # batched route: random fill
    ((1, 16, 16, 8, 48), 100, "segmented"),         # the tiny test model's feature
])
def test_bwd_path_at_the_loss_shapes(shape, points, want):
    assert k2.bwd_path(shape, points) == want


def test_bwd_path_threshold_and_limits():
    m = k2.SEGMENTED_MIN_C
    assert m % 8 == 0
    assert k2.bwd_path((2, 8, 8, 4, m), 1000) == "segmented"
    assert k2.bwd_path((2, 8, 8, 4, m - 8), 1000) == "narrow"       # below the threshold
    assert k2.bwd_path((2, 8, 8, 4, m + 12), 1000) == "narrow"      # not whole 8-channel chunks
    assert k2.bwd_path((2, 8, 8, 4, 8 * m), 1000) == "segmented"
    assert k2.bwd_path((2, 1024, 1024, 1024, m), 10) == "narrow"    # rows past int32
    assert k2.bwd_path((1, 8, 8, 4, m), 2 ** 28) == "narrow"        # entries past int32
    assert k2.bwd_path((1, 8, 8, 4, m), 2 ** 28 - 1) == "segmented"


@pytest.mark.parametrize("shape,dtype,ptr,want", [
    ((1, 128, 128, 16, 192), torch.bfloat16, 0, "row"),      # per-layer route: the feature
    ((1, 16, 16, 8, 48), torch.bfloat16, 0, "row"),          # the tiny test model's feature
    ((1, 8, 8, 4, 8), torch.bfloat16, 0, "row"),             # one 16-byte vector a row
    ((2, 8, 8, 4, 4), torch.float32, 0, "row"),
    ((2, 8, 8, 4, 40), torch.float32, 256, "row"),
    ((10, 128, 128, 16, 17), torch.float32, 0, "scalar"),    # batched route: candidates
    ((170, 128, 128, 16, 1), torch.float32, 0, "scalar"),    # batched route: random fill
    ((10, 128, 128, 16, 100), torch.bfloat16, 0, "scalar"),  # batched route: match volumes
    ((1, 8, 8, 4, 12), torch.bfloat16, 0, "scalar"),         # 24-byte rows
    ((17, 256, 256, 32, 1), torch.uint8, 0, "scalar"),       # the GT masks
    ((1, 8, 8, 4, 16), torch.uint8, 0, "scalar"),            # uint8 rows stay scalar
    ((1, 8, 8, 4, 192), torch.bfloat16, 8, "scalar"),        # a table not 16-byte aligned
    ((2, 1024, 1024, 64, 16), torch.bfloat16, 0, "row"),     # a table of 2^30 elements
    ((1, 1024, 1024, 64, 32), torch.bfloat16, 0, "scalar"),  # a table past int32 elements
])
def test_fwd_path_at_the_loss_shapes_and_limits(shape, dtype, ptr, want):
    assert k2.fwd_path(shape, dtype, ptr) == want


@pytest.mark.parametrize("C,dtype,ptr,vec,lanes", [
    (1, torch.uint8, 0, 1, 1),             # per-layer route: the GT masks (a z pair a lane)
    (5, torch.uint8, 0, 1, 2),             # the tiny test model's GT masks
    (17, torch.float32, 0, 1, 8),          # batched route: candidates, 4-byte loads
    (1, torch.float32, 0, 1, 1),           # batched route: random fill
    (100, torch.bfloat16, 0, 4, 8),        # batched route: match volumes, 8-byte loads
    (16, torch.uint8, 0, 4, 1),            # uint8 chunks of 4 (16 bytes of float32 out)
    (12, torch.bfloat16, 0, 4, 1),         # 24-byte rows
    (192, torch.bfloat16, 0, 8, 8),        # a whole-vector row forced onto the narrow path
    (192, torch.bfloat16, 8, 4, 16),       # a table 8 bytes past a 16-byte boundary
    (8, torch.float32, 4, 1, 2),           # ... 4 bytes past one
    (6, torch.float32, 8, 2, 1),
    (1024, torch.bfloat16, 0, 8, 32),
    (4096, torch.bfloat16, 0, 8, 32),      # at most 32 lanes; the chunks take passes
])
def test_narrow_vec_and_lanes_at_the_loss_shapes_and_limits(C, dtype, ptr, vec, lanes):
    """K2's narrow forward loads the widest chunk (at most 16 bytes, and at
    most 4 elements of a uint8 table, whose float32 output chunk is 4x as
    wide) that divides the row and the table's alignment, and sizes its
    lane group to hold the row at NARROW_CHUNKS_PER_LANE chunks a lane."""
    assert k2.narrow_vec(C, dtype, ptr) == vec
    assert k2.narrow_lanes(C, vec) == lanes
    chunks = C // vec
    assert lanes == 32 or k2.NARROW_CHUNKS_PER_LANE * lanes >= chunks
    assert lanes == 1 or k2.NARROW_CHUNKS_PER_LANE * lanes // 2 < chunks
    assert vec * dtype.itemsize <= 16 and C % vec == 0 and ptr % (vec * dtype.itemsize) == 0


@pytest.mark.parametrize("C,dtype,lanes", [(192, torch.bfloat16, 8), (8, torch.bfloat16, 1),
                                           (48, torch.bfloat16, 2), (24, torch.float32, 2),
                                           (1024, torch.bfloat16, 32)])
def test_row_lanes_hold_three_vectors_a_lane(C, dtype, lanes):
    assert k2.row_lanes(C, dtype) == lanes
