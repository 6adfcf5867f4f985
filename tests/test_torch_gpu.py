"""The port's CUDA kernels against their plain versions, on the card.

K1 (``ms_deform_gather_3d``) and its backward K1-bwd, and K2
(``trilerp_sample``) and its backward K2-bwd.  These tests need a CUDA device
and skip without one; the kernels have no CPU mode.  The file imports no
JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances, relative to max |plain|: float32 1e-5 for the forwards and 1e-4
for the gradients (the same float32 sums in another order; the gradients
add up to 8 * hd atomics per element in an order that changes from run to
run); bfloat16 1e-2 (the kernels round their outputs to bf16; the plain
versions run in float32 on the same bf16-rounded inputs).
"""
import numpy as np
import pytest
import torch

from occformer_tpu_torch.ops import trilerp as k2
from occformer_tpu_torch.ops import trilerp_fused as k1

SHAPES = [(4, 4, 2), (2, 2, 2), (8, 6, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _tol(dtype, grad=False):
    if dtype == torch.float32:
        return 1e-4 if grad else 1e-5
    return 1e-2


def _close(got, ref, rel, name):
    scale = ref.abs().max().item()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= rel * scale + 1e-6, f"{name}: max|diff| {err} > {rel} * {scale}"


def _inputs(dev, dtype, P=4, B=2, H=3, hd=24, Nq=300, seed=0):
    rng = np.random.RandomState(seed)
    Nv = sum(x * y * z for x, y, z in SHAPES)
    L = len(SHAPES)
    value = torch.from_numpy(rng.randn(B, Nv, H, hd).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(-0.2, 1.2, (B, Nq, H, L, P, 3)).astype(np.float32))
    w = torch.from_numpy(rng.rand(B, Nq, H, L, P).astype(np.float32))
    return value.to(dev, dtype), locs.to(dev), w.to(dev, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [24, 12])
def test_kernel_matches_plain(cuda, dtype, hd):
    dt = getattr(torch, dtype)
    value, locs, w = _inputs(cuda, dt, hd=hd)
    before = k1.LAUNCHES
    got = k1.ms_deform_gather_3d(value, SHAPES, locs, w)
    torch.cuda.synchronize()
    assert k1.LAUNCHES == before + 1
    assert got.dtype == dt and got.shape == (2, 300, 3, hd)
    ref = k1.ms_deform_gather_3d_plain(value.float(), SHAPES, locs, w.float())
    _close(got, ref, _tol(dt), "K1")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [24, 40])
def test_k1_backward_matches_plain_autograd(cuda, dtype, hd):
    """K1-bwd's d_value, d_locs, d_weights against autograd through the
    plain version; hd = 40 spans two 32-lane channel chunks."""
    dt = getattr(torch, dtype)
    value, locs, w = _inputs(cuda, dt, hd=hd, seed=1)
    gout = torch.randn(value.shape[0], locs.shape[1], value.shape[2], hd,
                       device=cuda).to(dt)
    leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, w)]
    out = k1.ms_deform_gather_3d(leaves[0], SHAPES, leaves[1], leaves[2])
    assert out.grad_fn is not None
    before = k1.BWD_LAUNCHES
    out.backward(gout)
    torch.cuda.synchronize()
    assert k1.BWD_LAUNCHES == before + 1
    refs = [t.detach().float().requires_grad_(True) for t in (value, locs, w)]
    k1.ms_deform_gather_3d_plain(refs[0], SHAPES, refs[1], refs[2]).backward(gout.float())
    for name, got, ref in zip(("d_value", "d_locs", "d_weights"), leaves, refs):
        assert got.grad.dtype == got.dtype
        _close(got.grad, ref.grad, _tol(dt, grad=True), f"K1-bwd {name}")


def test_kernel_rejects_what_it_does_not_take(cuda):
    value, locs, w = _inputs(cuda, torch.float32)
    before = k1.LAUNCHES
    with pytest.raises(TypeError):
        k1.ms_deform_gather_3d(value.half(), SHAPES, locs, w.half())
    with pytest.raises(TypeError):
        k1.ms_deform_gather_3d(value, SHAPES, locs.double(), w)
    with pytest.raises(ValueError):
        k1.ms_deform_gather_3d(value, SHAPES, locs.cpu(), w)
    with pytest.raises(ValueError):
        k1.ms_deform_gather_3d(value.transpose(1, 2).contiguous().transpose(1, 2),
                               SHAPES, locs, w)
    assert k1.LAUNCHES == before


def _k2_inputs(dev, dtype, G=3, spatial=(8, 6, 5), C=17, S=500, seed=0):
    rng = np.random.RandomState(seed)
    if dtype == "bool":
        table = torch.from_numpy(rng.rand(G, *spatial, C) > 0.5).to(dev)
    else:
        table = torch.from_numpy(rng.randn(G, *spatial, C).astype(np.float32))
        table = table.to(dev, getattr(torch, dtype))
    coords = torch.from_numpy(rng.uniform(-1.15, 1.15, (G, S, 3)).astype(np.float32))
    return table, coords.to(dev)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "bool"])
@pytest.mark.parametrize("C", [1, 17, 192])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k2_matches_plain(cuda, dtype, C, align_corners, padding_mode):
    table, coords = _k2_inputs(cuda, dtype, C=C)
    before = k2.LAUNCHES
    got = k2.trilerp_sample(table, coords, align_corners, padding_mode)
    torch.cuda.synchronize()
    assert k2.LAUNCHES == before + 1
    want_dtype = torch.float32 if dtype == "bool" else table.dtype
    assert got.dtype == want_dtype and got.shape == (3, 500, C)
    ref = k2.trilerp_sample_plain(table, coords, align_corners, padding_mode)
    _close(got, ref, _tol(want_dtype), "K2")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [1, 40])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k2_backward_matches_plain_autograd(cuda, dtype, C, align_corners, padding_mode):
    table, coords = _k2_inputs(cuda, dtype, C=C, seed=2)
    gout = torch.randn(3, 500, C, device=cuda).to(table.dtype)
    t = table.detach().clone().requires_grad_(True)
    c = coords.detach().clone().requires_grad_(True)
    out = k2.trilerp_sample(t, c, align_corners, padding_mode)
    before = k2.BWD_LAUNCHES
    out.backward(gout)
    torch.cuda.synchronize()
    assert k2.BWD_LAUNCHES == before + 1
    tr = table.detach().float().requires_grad_(True)
    cr = coords.detach().clone().requires_grad_(True)
    k2.trilerp_sample_plain(tr, cr, align_corners, padding_mode).backward(gout.float())
    assert t.grad.dtype == t.dtype and c.grad.dtype == torch.float32
    _close(t.grad, tr.grad, _tol(t.dtype, grad=True), "K2-bwd d_table")
    _close(c.grad, cr.grad, _tol(t.dtype, grad=True), "K2-bwd d_coords")


def test_k2_backward_without_coordinate_gradient(cuda):
    """The loss's case: coordinates without grad, one K2-bwd launch for
    d_table only."""
    table, coords = _k2_inputs(cuda, "bfloat16", C=40, seed=3)
    t = table.detach().clone().requires_grad_(True)
    out = k2.trilerp_sample(t, coords, False, "border")
    out.float().sum().backward()
    tr = table.detach().float().requires_grad_(True)
    k2.trilerp_sample_plain(tr, coords, False, "border").sum().backward()
    _close(t.grad, tr.grad, 1e-2, "K2-bwd d_table")


def test_k2_rejects_what_it_does_not_take(cuda):
    table, coords = _k2_inputs(cuda, "float32")
    before = k2.LAUNCHES
    with pytest.raises(TypeError):
        k2.trilerp_sample(table.half(), coords)
    with pytest.raises(TypeError):
        k2.trilerp_sample(table, coords.double())
    with pytest.raises(ValueError):
        k2.trilerp_sample(table, coords.cpu())
    with pytest.raises(ValueError):
        k2.trilerp_sample(table.transpose(1, 2), coords)
    with pytest.raises(ValueError):
        k2.trilerp_sample(table, coords, padding_mode="reflection")
    assert k2.LAUNCHES == before
