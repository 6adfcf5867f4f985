"""K4 (the unweighted multi-level trilerp) and the probe kernels P1, P2,
against the JAX package.

The port's plain K4 (``fused_multilevel_gather_plain``, what
``fused_multilevel_gather`` runs for CPU tensors) and its autograd are held
against ``occformer_tpu.ops.trilerp_fused.fused_multilevel_gather`` run in
Pallas interpret mode with ``s_block=32`` (as ``tests/test_trilerp_fused.py``
runs it) and its VJP, on levels (8,8,4), (4,4,2), (2,2,2) with C = 6,
G = 3, S = 57, coordinates spilling 0 and 0.6 past [-1, 1], both
``align_corners``.  Values within 1e-5 and the gradients of
``sum(sin(out))`` with respect to tables and coords within 1e-4, each
relative to max |JAX|: float32 on both sides, the same corner terms summed
in another order (the Pallas kernel through one-hot matmuls).  P1 and P2
live inside the JAX probe's ``main()`` and cannot be imported, so their
plain versions are held to that probe's own numpy checks
(``tools/probe_pallas_viability.py:43-44, 77-78``).  The CUDA kernels are
held against the plain versions on the card by tests/test_torch_gpu.py and
chip_smoke.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.ops.trilerp_fused import fused_multilevel_gather as jax_multi
from occformer_tpu_torch.ops import probe as kp
from occformer_tpu_torch.ops import trilerp_fused as k4

SPATIALS = [(8, 8, 4), (4, 4, 2), (2, 2, 2)]
C, G, S = 6, 3, 57


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(spill, seed=0):
    """Per level the slab [G, X*Y, Z*C] (channels-last memory) and coords."""
    rng = np.random.RandomState(seed)
    tables = [rng.randn(G, X * Y, Z * C).astype(np.float32) for X, Y, Z in SPATIALS]
    coords = [rng.uniform(-1 - spill, 1 + spill, (G, S, 3)).astype(np.float32)
              for _ in SPATIALS]
    return tables, coords


def _close(got, ref, rel, name):
    ref = np.asarray(ref)
    err = np.abs(np.asarray(got, np.float64) - ref).max()
    assert err <= rel * np.abs(ref).max(), f"{name}: max|diff| {err} > {rel} * {np.abs(ref).max()}"


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("spill", [0.0, 0.6])
def test_plain_version_and_its_backward_match_pallas_kernel(spill, align_corners):
    tables, coords = _inputs(spill)

    def jax_fn(ts, cs):
        return jax_multi(ts, SPATIALS, C, cs, align_corners, s_block=32, interpret=True)

    ref = jax_fn([jnp.asarray(t) for t in tables], [jnp.asarray(c) for c in coords])
    d_tables_ref, d_coords_ref = jax.grad(
        lambda ts, cs: sum(jnp.sum(jnp.sin(o)) for o in jax_fn(ts, cs)), argnums=(0, 1))(
        [jnp.asarray(t) for t in tables], [jnp.asarray(c) for c in coords])

    ts = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    cs = [torch.from_numpy(c).requires_grad_(True) for c in coords]
    got = k4.fused_multilevel_gather(ts, SPATIALS, C, cs, align_corners)
    sum(torch.sin(o).sum() for o in got).backward()
    for l in range(len(SPATIALS)):
        assert got[l].shape == (G, C, S) and got[l].dtype == torch.float32
        _close(got[l].detach(), ref[l], 1e-5, f"level {l} values")
        _close(ts[l].grad, d_tables_ref[l], 1e-4, f"level {l} d_table")
        _close(cs[l].grad, d_coords_ref[l], 1e-4, f"level {l} d_coords")


def _fixed_order_d_tables(coords, gouts, align_corners):
    """K4-bwd's d_tables as csrc/multilevel_gather3d.cu and
    csrc/ordered_rows.cuh form them, in float32: a term (row, corner, item,
    corner_weight) for every in-range corner (dx, dy, dz) of every item
    (level, g, s), numbered level after level, the row being the d_table row
    (level, g, voxel) of the levels back to back and the corner dx * 4 + dy
    * 2 + dz; the terms sorted by (row, corner, item); each row's
    corner_weight * gout[item] added in that order, gout read as rows
    [sum_l G * S_l, C]."""
    rows, corners, items, wts = [], [], [], []
    row0 = item0 = 0
    for (X, Y, Z), c in zip(SPATIALS, coords):
        axes = []
        for i, n in enumerate((X, Y, Z)):  # ops/sampling.py's unnormalize, the kernel's clamp
            v = c[..., i]
            pix = (v + 1) * 0.5 * (n - 1) if align_corners else ((v + 1) * n - 1) * 0.5
            pix = pix.clamp(-2.0, n + 1.0)
            f = pix.floor()
            axes.append((f.long(), (1.0 - (pix - f), pix - f)))
        g = torch.arange(G).view(G, 1)
        item = item0 + torch.arange(G * S).view(G, S)
        for dx in (0, 1):
            for dy in (0, 1):
                for dz in (0, 1):
                    xi, yi, zi = (ax[0] + d for ax, d in zip(axes, (dx, dy, dz)))
                    ok = (xi >= 0) & (xi < X) & (yi >= 0) & (yi < Y) & (zi >= 0) & (zi < Z)
                    rows.append((row0 + g * X * Y * Z + (xi * Y + yi) * Z + zi)[ok])
                    corners.append(torch.full_like(rows[-1], dx * 4 + dy * 2 + dz))
                    items.append(item[ok])
                    wts.append((axes[0][1][dx] * axes[1][1][dy] * axes[2][1][dz])[ok])
        row0 += G * X * Y * Z
        item0 += G * S
    rows, corners, items, wts = (torch.cat(t) for t in (rows, corners, items, wts))
    order = torch.argsort((rows * 8 + corners) * item0 + items)
    rows, items, wts = rows[order], items[order], wts[order]
    rank = torch.arange(rows.numel()) - torch.searchsorted(rows, rows)
    src = torch.cat([go.transpose(1, 2).reshape(-1, C) for go in gouts])
    d = torch.zeros(row0, C)
    for k in range(int(rank.max()) + 1):
        sel = rank == k  # at most one entry of each row: the rows' k-th terms
        d[rows[sel]] = d[rows[sel]] + wts[sel, None] * src[items[sel]]
    out, r = [], 0
    for X, Y, Z in SPATIALS:
        out.append(d[r:r + G * X * Y * Z].view(G, X * Y, Z * C))
        r += G * X * Y * Z
    return out


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("spill", [0.0, 0.6])
def test_fixed_order_d_tables_match_plain_and_pallas_vjp(spill, align_corners):
    """K4-bwd's d_tables have no CPU mode: their formulation (each row's
    terms corner by corner, each corner's in ascending item order) in torch against
    autograd through the plain version and ``jax.vjp`` of the Pallas
    kernel, within 1e-5 of max |ref| (float32, other summation orders), on
    the three levels, with a third of the points on the lattice of voxel
    centres and faces or at exactly -1 and 1, the rest spilling ``spill``
    past [-1, 1]."""
    tables, coords = _inputs(spill, seed=3)
    rng = np.random.RandomState(4)
    for c, (X, Y, Z) in zip(coords, SPATIALS):
        n = np.asarray((X, Y, Z), np.float32)
        lattice = rng.randint(0, 2 * n.max() + 1, c.shape) / (2 * n) * 2 - 1
        edge = np.where(rng.rand(*c.shape) < 0.2, rng.choice([-1.0, 1.0], c.shape), lattice)
        c[:] = np.where(rng.rand(G, S, 1) < 1 / 3, edge, c).astype(np.float32)
    gouts = [rng.randn(G, C, S).astype(np.float32) for _ in SPATIALS]
    got = _fixed_order_d_tables([torch.from_numpy(c) for c in coords],
                                [torch.from_numpy(g) for g in gouts], align_corners)
    ts = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    out = k4.fused_multilevel_gather(ts, SPATIALS, C, [torch.from_numpy(c) for c in coords],
                                     align_corners)
    torch.autograd.backward(out, [torch.from_numpy(g) for g in gouts])
    _, vjp = jax.vjp(lambda t: jax_multi(t, SPATIALS, C, [jnp.asarray(c) for c in coords],
                                         align_corners, s_block=32, interpret=True),
                     [jnp.asarray(t) for t in tables])
    refs = vjp([jnp.asarray(g) for g in gouts])[0]
    for l in range(len(SPATIALS)):
        _close(got[l], ts[l].grad.numpy(), 1e-5, f"level {l} against the plain version")
        _close(got[l], refs[l], 1e-5, f"level {l} against the Pallas VJP")


def test_bf16_tables_keep_their_dtype_and_round_once():
    """bf16 tables: the result is the float32 sum rounded once to bf16."""
    tables, coords = _inputs(0.3, seed=1)
    tb = [torch.from_numpy(t).to(torch.bfloat16) for t in tables]
    cs = [torch.from_numpy(c) for c in coords]
    got = k4.fused_multilevel_gather(tb, SPATIALS, C, cs)
    ref = k4.fused_multilevel_gather_plain([t.float() for t in tb], SPATIALS, C, cs)
    for g, r in zip(got, ref):
        assert g.dtype == torch.bfloat16
        assert torch.equal(g, r.to(torch.bfloat16))


def test_wrapper_checks_shapes_and_devices():
    tables, coords = _inputs(0.0)
    ts = [torch.from_numpy(t) for t in tables]
    cs = [torch.from_numpy(c) for c in coords]
    with pytest.raises(ValueError, match="table"):
        k4.fused_multilevel_gather([ts[0][:, :-1]] + ts[1:], SPATIALS, C, cs)
    with pytest.raises(ValueError, match="coords"):
        k4.fused_multilevel_gather(ts, SPATIALS, C, [cs[0][..., :2]] + cs[1:])
    with pytest.raises(ValueError, match="tables"):
        k4.fused_multilevel_gather(ts[:2], SPATIALS, C, cs)
    before = (k4.MULTI_LAUNCHES, k4.MULTI_BWD_LAUNCHES)
    k4.fused_multilevel_gather(ts, SPATIALS, C, cs)  # CPU: the plain version
    assert (k4.MULTI_LAUNCHES, k4.MULTI_BWD_LAUNCHES) == before


def test_probe_plain_versions_pass_the_jax_probe_checks():
    x = torch.arange(8 * 128, dtype=torch.float32).reshape(8, 128)
    y = kp.add_one(x)
    assert np.allclose(y.numpy(), x.numpy() + 1.0)  # probe_pallas_viability.py:43-44
    rng = np.random.RandomState(0)
    table = rng.randn(1024, 128).astype(np.float32)
    idx = rng.randint(0, 1024, size=(2048,)).astype(np.int32)
    got = kp.row_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert np.allclose(got.numpy(), table[idx])  # probe_pallas_viability.py:77-78
    assert kp.ADD_ONE_LAUNCHES == 0 and kp.ROW_GATHER_LAUNCHES == 0
    with pytest.raises(ValueError):
        kp.row_gather(torch.from_numpy(table), torch.from_numpy(idx)[None])


@pytest.mark.parametrize("C,dtype,ptrs,want", [
    (24, torch.bfloat16, (0, 256, 512), 16),    # the deformable attention's, bf16
    (24, torch.float32, (0, 256, 512), 16),     # ... and float32
    (8, torch.bfloat16, (), 16),
    (4, torch.float32, (), 16),
    (6, torch.float32, (), 8),                  # 24-byte rows
    (17, torch.float32, (), 4),
    (12, torch.bfloat16, (), 8),
    (5, torch.bfloat16, (), 2),
    (24, torch.float16, (), TypeError),         # not a dtype of the kernel
    (24, torch.bfloat16, (0, 8, 512), 8),       # a table 8 bytes past a 16-byte boundary
    (24, torch.float32, (0, 4, 512), 4),
])
def test_multi_fwd_path(C, dtype, ptrs, want):
    if want is TypeError:
        with pytest.raises(TypeError):
            k4.multi_fwd_path(C, dtype, ptrs)
    else:
        assert k4.multi_fwd_path(C, dtype, ptrs) == want
