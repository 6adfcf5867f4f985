"""S1's and S1-rows' backwards (the ops ``occformer::s1_bwd`` and
``occformer::s1_rows_bwd``) on the CPU.

* S1's d_depth and d_ctx against ``jax.vjp`` of
  ``occformer_tpu/ops/scatter.py:voxel_scatter_lifted``, atol 1e-5 (the same
  float32 sums in another order), and S1-rows' d_feats against ``jax.vjp``
  of ``voxel_scatter`` exactly (both gather one row of the cotangent a
  point, zeros for an invalid one).
* ``csrc/voxel_splat.cu:voxel_splat_bwd``'s formulation in numpy float32
  (a block per pixel, its warps on contiguous chunks of the depth bins, a
  lane on VEC channels over passes of 32 * VEC, the xor-shuffle tree over
  the lanes for d_depth, each warp's d_ctx in ascending bin and the warps
  added in order) against the plain backward, atol 1e-5.
* The CPU op's gradients (the plain versions, which every CPU parity test
  reaches) bit for bit the formula the backward had before it became an op,
  copied here, in every dtype pairing; autograd reaches each backward op
  once and launches no kernel; the launchers hand a transposed gradient to
  the kernels as it is and refuse what the kernels do not take before any
  build, so nothing falls back to the plain formula.

Inputs come from a seeded numpy generator: B = 2, C in {4, 7, 128}, about
a fifth of the points invalid and coordinates outside the grid (clamped).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from occformer_tpu.ops.scatter import voxel_scatter as jax_voxel_scatter
from occformer_tpu.ops.scatter import voxel_scatter_lifted as jax_voxel_scatter_lifted
from occformer_tpu_torch import ops
from occformer_tpu_torch.ops import library, scatter

ATOL = 1e-5
WIDTHS = [4, 7, 128]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lift_inputs(C, seed=0, B=2, N=3, D=9, fH=4, fW=5, nx=(4, 5, 3)):
    rng = np.random.RandomState(seed)
    depth = rng.rand(B, N, D, fH, fW).astype(np.float32)
    ctx = rng.randn(B, N, fH, fW, C).astype(np.float32)
    coords = rng.randint(-1, 6, (B, N, D, fH, fW, 3)).astype(np.int32)
    valid = rng.rand(B, N, D, fH, fW) > 0.2
    gout = rng.randn(B, *nx, C).astype(np.float32)
    return depth, ctx, coords, valid, gout, nx


def _rows_inputs(C, seed=0, B=2, P=60, nx=(4, 3, 3)):
    rng = np.random.RandomState(seed)
    feats = rng.randn(B, P, C).astype(np.float32)
    coords = rng.randint(-1, 5, (B, P, 3)).astype(np.int32)
    valid = rng.rand(B, P) > 0.2
    gout = rng.randn(B, *nx, C).astype(np.float32)
    return feats, coords, valid, gout, nx


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("C", WIDTHS)
def test_s1_gradients_match_jax_vjp(C):
    depth, ctx, coords, valid, gout, nx = _lift_inputs(C, seed=C)
    assert 0 < valid.mean() < 1
    _, vjp = jax.vjp(lambda d, c: jax_voxel_scatter_lifted(d, c, jnp.asarray(coords),
                                                           jnp.asarray(valid), nx),
                     jnp.asarray(depth), jnp.asarray(ctx))
    ref_depth, ref_ctx = (np.asarray(g) for g in vjp(jnp.asarray(gout)))
    d, c = (_t(a).requires_grad_(True) for a in (depth, ctx))
    out = scatter.voxel_scatter_lifted(d, c, _t(coords), _t(valid), nx)
    got_depth, got_ctx = torch.autograd.grad(out, (d, c), _t(gout))
    np.testing.assert_allclose(got_depth.numpy(), ref_depth, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_ctx.numpy(), ref_ctx, rtol=0, atol=ATOL)
    assert not got_depth.numpy()[~valid].any()


@pytest.mark.parametrize("C", WIDTHS)
def test_s1_rows_gradient_matches_jax_vjp_exactly(C):
    feats, coords, valid, gout, nx = _rows_inputs(C, seed=C)
    _, vjp = jax.vjp(lambda f: jax_voxel_scatter(f, jnp.asarray(coords), jnp.asarray(valid),
                                                 nx), jnp.asarray(feats))
    (ref,) = vjp(jnp.asarray(gout))
    f = _t(feats).requires_grad_(True)
    out = scatter.voxel_scatter(f, _t(coords), _t(valid), nx)
    (got,) = torch.autograd.grad(out, f, _t(gout))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got.numpy()[~valid].any()


def _xor_tree(s):
    """The warp's ``s += __shfl_xor_sync(s, off)`` for off = 16 ... 1 over
    the last axis (32 lanes), in float32: every lane ends with the sum."""
    for off in (16, 8, 4, 2, 1):
        s = (s + s[..., np.arange(32) ^ off]).astype(np.float32)
    return s


def _s1_bwd_formulation(depth, ctx, coords, valid, gout, nx, warps=4, vec=4):
    """S1-bwd as ``voxel_splat_bwd_kernel`` takes it, in numpy float32: a
    block per pixel; warp w on bins [w * per, (w + 1) * per), per =
    ceil(D / warps); lane l of pass k on channels (k * 32 + l) * vec ...;
    each valid bin's row of g (an invalid bin loads nothing and adds
    nothing); d_depth: the lane's channels in order, the xor tree, the
    passes added in order; d_ctx: each warp's sums in ascending bin, then
    the warps in order."""
    B, N, D, fH, fW = depth.shape
    C = ctx.shape[-1]
    X, Y, Z = nx
    rows = scatter.voxel_rows(_t(coords), _t(valid), nx).numpy()
    g_all = gout.reshape(-1, C)
    passes = -(-C // (32 * vec))
    width = passes * 32 * vec
    per = -(-D // warps)
    d_depth = np.zeros_like(depth)
    d_ctx = np.zeros_like(ctx)
    for b in range(B):
        for n in range(N):
            for h in range(fH):
                for w in range(fW):
                    cv = np.zeros(width, np.float32)
                    cv[:C] = ctx[b, n, h, w]
                    dd = np.zeros(D, np.float32)
                    parts = []
                    for warp in range(warps):
                        acc = np.zeros(width, np.float32)
                        for d in range(min(D, warp * per), min(D, warp * per + per)):
                            if not valid[b, n, d, h, w]:
                                continue
                            g = np.zeros(width, np.float32)
                            g[:C] = g_all[rows[b, n, d, h, w]]
                            dep = np.float32(depth[b, n, d, h, w])
                            acc = (acc + dep * g).astype(np.float32)
                            lane = (g * cv).reshape(passes, 32, vec)
                            s = np.zeros((passes, 32), np.float32)
                            for e in range(vec):
                                s = (s + lane[..., e]).astype(np.float32)
                            total = np.float32(0)
                            for k in range(passes):
                                total = np.float32(total + _xor_tree(s[k])[0])
                            dd[d] = total
                        parts.append(acc)
                    d_depth[b, n, :, h, w] = dd
                    out = parts[0]
                    for acc in parts[1:]:
                        out = (out + acc).astype(np.float32)
                    d_ctx[b, n, h, w] = out[:C]
    return d_depth, d_ctx


@pytest.mark.parametrize("C,vec,D", [(4, 4, 9), (7, 1, 9), (128, 4, 9), (130, 2, 37)])
def test_s1_bwd_kernel_formulation_matches_the_plain_version(C, vec, D):
    """The kernel's formulation at one pass (C = 4, 7, 128) and at more
    (C = 130 over two-channel lanes: 3 passes), with D = 37 bins split
    unevenly over the warps (10, 10, 10, 7), against the plain backward."""
    depth, ctx, coords, valid, gout, nx = _lift_inputs(C, seed=11, D=D)
    got_depth, got_ctx = _s1_bwd_formulation(depth, ctx, coords, valid, gout, nx, vec=vec)
    ref_depth, ref_ctx = scatter.voxel_scatter_backward_plain(
        _t(depth), _t(ctx), _t(coords), _t(valid), _t(gout).reshape(-1, C), nx)
    np.testing.assert_allclose(got_depth, ref_depth.numpy(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(got_ctx, ref_ctx.numpy(), rtol=0, atol=ATOL)


def _parent_s1_backward(depth, ctx, coords, valid, gout, nx):
    """The S1 backward's formula before it became the op (a copy)."""
    rows = scatter.voxel_rows(coords, valid, nx)
    g = F.pad(gout.float(), (0, 0, 0, 1)).index_select(0, rows.reshape(-1))
    g = g.view(*rows.shape, gout.shape[-1])
    d_depth = (g * ctx[:, :, None].float()).sum(-1).to(depth.dtype)
    d_ctx = (g * depth[..., None].float()).sum(2).to(ctx.dtype)
    return d_depth, d_ctx


def _parent_s1_rows_backward(gout, coords, valid, nx, dtype):
    """The S1-rows backward's formula before it became the op (a copy)."""
    rows = scatter.voxel_rows(coords, valid, nx)
    g = F.pad(gout, (0, 0, 0, 1)).index_select(0, rows.reshape(-1))
    return g.view(*rows.shape, gout.shape[-1]).to(dtype)


@pytest.mark.parametrize("depth_dtype,ctx_dtype", [("float32", "float32"),
                                                   ("float32", "bfloat16"),
                                                   ("bfloat16", "float32"),
                                                   ("bfloat16", "bfloat16")])
def test_s1_cpu_op_keeps_the_parents_bits(depth_dtype, ctx_dtype):
    depth, ctx, coords, valid, gout, nx = _lift_inputs(7, seed=3)
    d = _t(depth).to(getattr(torch, depth_dtype)).requires_grad_(True)
    c = _t(ctx).to(getattr(torch, ctx_dtype)).requires_grad_(True)
    coords, valid = _t(coords), _t(valid)
    out = scatter.voxel_scatter_lifted(d, c, coords, valid, nx)
    g = _t(gout).to(out.dtype)
    ops.reset_launch_counts()
    with library.OpCalls() as calls:
        got = torch.autograd.grad(out, (d, c), g)
    assert calls.counts()["S1-bwd"] == 1
    assert not any(ops.launch_counts().values())  # no kernel launches on the CPU
    want = _parent_s1_backward(d.detach(), c.detach(), coords, valid, g.reshape(-1, 7), nx)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_s1_rows_cpu_op_keeps_the_parents_bits(dtype):
    feats, coords, valid, gout, nx = _rows_inputs(7, seed=4)
    f = _t(feats).to(getattr(torch, dtype)).requires_grad_(True)
    coords, valid = _t(coords), _t(valid)
    out = scatter.voxel_scatter(f, coords, valid, nx)
    g = _t(gout).to(out.dtype)
    ops.reset_launch_counts()
    with library.OpCalls() as calls:
        (got,) = torch.autograd.grad(out, f, g)
    assert calls.counts()["S1-rows-bwd"] == 1
    assert not any(ops.launch_counts().values())
    want = _parent_s1_rows_backward(g.reshape(-1, 7), coords, valid, nx, f.dtype)
    assert got.dtype == want.dtype and torch.equal(got, want)


def test_gradient_layouts_the_kernels_take():
    """The volume's gradient as the launchers hand it to the kernels: rows
    as they are, a transposed view (the encoder's permute at batch 1) as it
    is with room for the kernel's own transpose, anything else made
    contiguous."""
    g = torch.randn(12, 5)
    t = g.t().contiguous().t()
    rows, transposed, buf = scatter._grad_rows(t)
    assert t.stride() == (1, 12) and rows is t and transposed == 1 and buf.shape == (12, 5)
    rows, transposed, buf = scatter._grad_rows(g)
    assert rows is g and transposed == 0 and buf is None
    odd = torch.randn(12, 10)[:, ::2]
    rows, transposed, buf = scatter._grad_rows(odd)
    assert rows.is_contiguous() and torch.equal(rows, odd) and transposed == 0 and buf is None


def test_launchers_refuse_what_the_kernels_do_not_take():
    """A dtype or shape the kernels do not take raises in the launcher
    before any build or launch, and counts no launch."""
    depth, ctx, coords, valid, gout, nx = _lift_inputs(4, seed=5)
    depth, ctx, coords, valid = _t(depth), _t(ctx), _t(coords), _t(valid)
    g = _t(gout).reshape(-1, 4)
    ops.reset_launch_counts()
    with pytest.raises(TypeError):
        scatter._launch_bwd(depth.half(), ctx, coords, valid, g.half(), nx)
    with pytest.raises(TypeError):
        scatter._launch_bwd(depth, ctx, coords, valid, g.to(torch.bfloat16), nx)
    with pytest.raises(ValueError):
        scatter._launch_bwd(depth, ctx, coords, valid, g[:-1], nx)
    feats, rcoords, rvalid, rgout, rnx = _rows_inputs(4, seed=5)
    rg = _t(rgout).reshape(-1, 4)
    with pytest.raises(TypeError):
        scatter._launch_rows_bwd(rg.double(), _t(rcoords), _t(rvalid), rnx)
    with pytest.raises(ValueError):
        scatter._launch_rows_bwd(rg[1:], _t(rcoords), _t(rvalid), rnx)
    assert not any(ops.launch_counts().values())
