"""The port's CUDA kernels against their plain versions, on the card.

K1 (``ms_deform_gather_3d``) and its backward K1-bwd, K2 (``trilerp_sample``)
and its backward K2-bwd, K3 (``sample_id_masks``), and the all-layer batched
loss on the card (K2, K2-bwd, K3) against the same loss on the CPU.  These
tests need a CUDA device and skip without one; the kernels have no CPU mode.
The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances, relative to max |plain|: float32 1e-5 for the forwards and 1e-4
for the gradients (the same float32 sums in another order; the gradients
add up to 8 * hd atomics per element in an order that changes from run to
run); bfloat16 1e-2 (the kernels round their outputs to bf16; the plain
versions run in float32 on the same bf16-rounded inputs).  K3 1e-6
absolute: it adds the plain version's float32 terms in its order.
"""
import numpy as np
import pytest
import torch

from occformer_tpu_torch.losses.mask2former_loss import (
    MaskLossConfig,
    make_loss_draws,
    mask2former_loss,
)
from occformer_tpu_torch.ops import loss_gather as k3
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


def _k3_inputs(dev, spatial, B=2, N=4, G=17, S=3000, P=200, seed=0):
    rng = np.random.RandomState(seed)
    grid = rng.randint(0, G + 2, (B, *spatial)).astype(np.int32)
    grid[:, :2] = 255
    ids = np.stack([np.arange(G), np.arange(G)[::-1]]).astype(np.int32)
    shared = rng.uniform(-0.15, 1.15, (N, S, 3)).astype(np.float32)
    per_slot = rng.uniform(-0.15, 1.15, (N, G, P, 3)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (grid, ids, shared, per_slot)]


@pytest.mark.parametrize("spatial", [(16, 8, 4), (40, 24, 12)])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k3_matches_plain(cuda, spatial, align_corners, padding_mode):
    grid, ids, shared, per_slot = _k3_inputs(cuda, spatial)
    for pts in (shared, per_slot):
        before = k3.LAUNCHES
        got = k3.sample_id_masks(grid, ids, pts, align_corners, padding_mode)
        torch.cuda.synchronize()
        assert k3.LAUNCHES == before + 1
        ref = k3.sample_id_masks_plain(grid.cpu(), ids.cpu(), pts.cpu(), align_corners,
                                       padding_mode)
        assert got.dtype == torch.float32 and got.shape == ref.shape
        assert (got.cpu() - ref).abs().max().item() <= 1e-6


def test_k3_rejects_what_it_does_not_take(cuda):
    grid, ids, shared, _ = _k3_inputs(cuda, (8, 8, 4))
    before = k3.LAUNCHES
    with pytest.raises(TypeError):
        k3.sample_id_masks(grid.long(), ids, shared)
    with pytest.raises(TypeError):
        k3.sample_id_masks(grid, ids, shared.double())
    with pytest.raises(ValueError):
        k3.sample_id_masks(grid, ids.cpu(), shared)
    with pytest.raises(ValueError):
        k3.sample_id_masks(grid, ids, shared.transpose(0, 1).contiguous().transpose(0, 1))
    assert k3.LAUNCHES == before


@pytest.mark.parametrize("B", [1, 2])
def test_batched_loss_on_the_card_matches_the_cpu(cuda, B):
    """The all-layer batched loss at a small size, float32: the card (K2,
    K2-bwd, K3) against the CPU (plain versions) on the same inputs and
    draws.  Losses to 1e-4 relative, gradients (through K2-bwd) to 1e-3 of
    their max: the same float32 sums in another order."""
    rng = np.random.RandomState(0)
    L, Q, nc, C, P = 3, 8, 5, 24, 100
    X, Y, Z = 16, 16, 8
    gt = rng.randint(0, nc, (B, 32, 32, 16)).astype(np.int32)
    gt[:, :3] = 255
    x = dict(cls_preds=rng.randn(L, B, Q, nc + 1), mask_embeds=0.4 * rng.randn(L, B, Q, C),
             mask_feature=0.4 * rng.randn(B, X, Y, Z, C))
    lidar_xyz = torch.from_numpy(rng.uniform(-0.1, 1.1, (B, P, 3)).astype(np.float32))
    lidar_valid = torch.from_numpy(np.arange(P)[None].repeat(B, 0) < 80)
    cfg = MaskLossConfig(num_classes=nc, num_points=64, oversample_ratio=2.0,
                         class_weight=(1.0,) * nc + (0.1,), mxu_readout="on")
    draws = make_loss_draws(torch.Generator().manual_seed(1), cfg, lidar_valid, L)

    def run(dev):
        leaves = {k: torch.from_numpy(v.astype(np.float32)).to(dev).requires_grad_(True)
                  for k, v in x.items()}
        losses = mask2former_loss(leaves["cls_preds"], leaves["mask_embeds"],
                                  leaves["mask_feature"], torch.from_numpy(gt).to(dev), cfg,
                                  lidar_xyz.to(dev), lidar_valid.to(dev), draws)
        sum(v for k, v in losses.items() if "loss" in k).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: t.grad.cpu() for k, t in leaves.items()})

    before = (k2.LAUNCHES, k2.BWD_LAUNCHES, k3.LAUNCHES)
    got, got_g = run(cuda)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES - before[0], k2.BWD_LAUNCHES - before[1],
            k3.LAUNCHES - before[2]) == (3, 2, 3)
    ref, ref_g = run("cpu")
    for k, r in ref.items():
        assert abs(got[k] - r) <= 1e-4 * abs(r) + 1e-6, (k, got[k], r)
    for k, r in ref_g.items():
        _close(got_g[k], r, 1e-3, f"batched loss d_{k}")
