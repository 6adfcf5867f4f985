"""The port's CUDA kernels against their plain versions, on the card.

K1 (``ms_deform_gather_3d``) and its backward K1-bwd, K2 (``trilerp_sample``)
and its backward K2-bwd, K3 (``sample_id_masks``), K4
(``fused_multilevel_gather``) and its backward K4-bwd, the probe's P1
(``add_one``) and P2 (``row_gather``), the all-layer batched loss on the
card (K2, K2-bwd, K3) against the same loss on the CPU, and a checkpoint
round trip of a model and optimizer on the card.  These
tests need a CUDA device and skip without one; the kernels have no CPU mode.
The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances, relative to max |plain|: float32 1e-5 for the forwards and 1e-4
for the gradients (the same float32 sums in another order; the gradients
add up to 8 * hd atomics per element in an order that changes from run to
run); bfloat16 1e-2 (the kernels round their outputs to bf16; the plain
versions run in float32 on the same bf16-rounded inputs).  K3 1e-6
absolute: it adds the plain version's float32 terms in its order.  P1 and
P2 exactly (one float32 add; a copy).
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
from occformer_tpu_torch.ops import probe as kp
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


K4_PYRAMID = [(64, 64, 8), (32, 32, 4), (16, 16, 2)]


def _k4_inputs(dev, dtype, spatials, G, C, S, spill, seed=0):
    """Slabs [G, X*Y, Z*C] and coords [G, S, 3] uniform in [-spill, spill]."""
    rng = np.random.RandomState(seed)
    tables = [torch.from_numpy(rng.randn(G, X * Y, Z * C).astype(np.float32)).to(dev, dtype)
              for X, Y, Z in spatials]
    coords = [torch.from_numpy(rng.uniform(-spill, spill, (G, S, 3)).astype(np.float32)).to(dev)
              for _ in spatials]
    return tables, coords


def _k4_against_plain(tables, coords, spatials, C, align_corners, dtype):
    """K4 and K4-bwd (through the autograd Function) against the plain
    version and its autograd on the same inputs; gradients of a random
    linear probe of the outputs."""
    tl = [t.detach().clone().requires_grad_(True) for t in tables]
    cl = [c.detach().clone().requires_grad_(True) for c in coords]
    before = (k1.MULTI_LAUNCHES, k1.MULTI_BWD_LAUNCHES)
    got = k1.fused_multilevel_gather(tl, spatials, C, cl, align_corners)
    gen = torch.Generator(device=tables[0].device).manual_seed(1)
    gouts = [torch.randn(o.shape, device=o.device, generator=gen).to(dtype) for o in got]
    torch.autograd.backward(got, gouts)
    torch.cuda.synchronize()
    assert (k1.MULTI_LAUNCHES - before[0], k1.MULTI_BWD_LAUNCHES - before[1]) == (1, 1)
    pl = [t.detach().float().requires_grad_(True) for t in tables]
    pc = [c.detach().clone().requires_grad_(True) for c in coords]
    ref = k1.fused_multilevel_gather_plain(pl, spatials, C, pc, align_corners)
    torch.autograd.backward(ref, [g.float() for g in gouts])
    for l, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == dtype and g.shape == r.shape
        _close(g, r, _tol(dtype), f"K4 level {l}")
        assert tl[l].grad.dtype == dtype and cl[l].grad.dtype == torch.float32
        _close(tl[l].grad, pl[l].grad, _tol(dtype, grad=True), f"K4-bwd level {l} d_table")
        _close(cl[l].grad, pc[l].grad, _tol(dtype, grad=True), f"K4-bwd level {l} d_coords")


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_matches_plain_small(cuda, dtype, align_corners):
    spatials = [(8, 8, 4), (4, 4, 2), (2, 2, 2), (5, 3, 7)]
    dt = getattr(torch, dtype)
    tables, coords = _k4_inputs(cuda, dt, spatials, G=3, C=6, S=57, spill=1.6)
    _k4_against_plain(tables, coords, spatials, 6, align_corners, dt)


@pytest.mark.parametrize("align_corners", [False, True])
def test_k4_matches_plain_at_the_parity_gate_shapes(cuda, align_corners):
    """bench.py's kernel-parity shapes: the decoder pyramid, G = 8, C = 24,
    S = 512 per level, coords in [-1.1, 1.1], float32."""
    tables, coords = _k4_inputs(cuda, torch.float32, K4_PYRAMID, G=8, C=24, S=512, spill=1.1)
    _k4_against_plain(tables, coords, K4_PYRAMID, 24, align_corners, torch.float32)


def test_k4_matches_plain_at_the_deformable_attention_shapes(cuda):
    """The flagship's deformable attention: G = 8 (B * H), C = 24, S_l =
    37376 * 4 per level, bf16 tables, locations spilling 1.8% past the
    volume."""
    tables, coords = _k4_inputs(cuda, torch.bfloat16, K4_PYRAMID, G=8, C=24, S=149504,
                                spill=1.036)
    _k4_against_plain(tables, coords, K4_PYRAMID, 24, False, torch.bfloat16)


def test_k4_without_coordinate_gradient_and_rejects(cuda):
    tables, coords = _k4_inputs(cuda, torch.float32, K4_PYRAMID[1:], G=2, C=8, S=100, spill=1.2)
    tl = [t.clone().requires_grad_(True) for t in tables]
    out = k1.fused_multilevel_gather(tl, K4_PYRAMID[1:], 8, coords)
    sum(o.sum() for o in out).backward()
    ref = [t.clone().requires_grad_(True) for t in tables]
    sum(o.sum() for o in k1.fused_multilevel_gather_plain(
        [r.float() for r in ref], K4_PYRAMID[1:], 8, coords)).backward()
    for a, b in zip(tl, ref):
        _close(a.grad, b.grad, 1e-4, "K4-bwd d_table without d_coords")
    before = k1.MULTI_LAUNCHES
    with pytest.raises(TypeError):
        k1.fused_multilevel_gather([t.half() for t in tables], K4_PYRAMID[1:], 8, coords)
    with pytest.raises(TypeError):
        k1.fused_multilevel_gather(tables, K4_PYRAMID[1:], 8, [c.double() for c in coords])
    with pytest.raises(ValueError):
        k1.fused_multilevel_gather(tables, K4_PYRAMID[1:], 8, [coords[0].cpu(), coords[1]])
    with pytest.raises(ValueError):
        k1.fused_multilevel_gather([tables[0]] * 9, [K4_PYRAMID[1]] * 9, 8, [coords[0]] * 9)
    assert k1.MULTI_LAUNCHES == before


def test_probe_kernels_match_plain_exactly(cuda):
    from occformer_tpu_torch.tools.probe_viability import probe_inputs

    inp = probe_inputs(cuda)
    before = (kp.ADD_ONE_LAUNCHES, kp.ROW_GATHER_LAUNCHES)
    y = kp.add_one(inp["x"])
    g = kp.row_gather(inp["table"], inp["idx"])
    odd = torch.randn((50, 37), device=cuda)  # rows not a multiple of 4 floats
    idx = torch.tensor([3, 0, 49, 7, 3], device=cuda, dtype=torch.int32)
    g_odd = kp.row_gather(odd, idx)
    torch.cuda.synchronize()
    assert (kp.ADD_ONE_LAUNCHES - before[0], kp.ROW_GATHER_LAUNCHES - before[1]) == (1, 2)
    assert torch.equal(y, kp.add_one_plain(inp["x"]))
    assert torch.equal(g, kp.row_gather_plain(inp["table"], inp["idx"]))
    assert torch.equal(g_odd, kp.row_gather_plain(odd, idx))
    with pytest.raises(TypeError):
        kp.row_gather(inp["table"], inp["idx"].long())
    with pytest.raises(TypeError):
        kp.add_one(inp["x"].double())


def test_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """A train step of the tiny CLI model on the card, a save, and a load
    into a fresh model and optimizer on the card: every parameter, buffer,
    AdamW moment and step bit-equal, and the next step alike."""
    import os

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset
    from occformer_tpu_torch.engine.checkpoint import load_checkpoint, save_checkpoint
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "occformer_tpu_torch", "configs", "synthetic_tiny.py"),
                      {"model.img_backbone.frozen_stages": 0})
    m = cfg["model"]
    batch = next(iter(build_dataloader(build_dataset(cfg["data"]["train"]), max_points=512)))
    batch.pop("_meta")

    def setup(seed):
        model = build_model(m, device=cuda, seed=seed).train()
        opt = build_optimizer_from_config(model, cfg, 16)
        return model, opt, build_train_step(
            model, opt, build_loss_cfg(m["pts_bbox_head"], m["train_cfg"]["pts"]), device=cuda)

    model, opt, step = setup(0)
    step(batch, torch.Generator(device=cuda).manual_seed(0))
    path = save_checkpoint(str(tmp_path), model, opt, 1)
    model2, opt2, step2 = setup(1)
    assert load_checkpoint(path, model2, opt2) == 1
    for (k, a), b in zip(model.state_dict().items(), model2.state_dict().values()):
        assert b.is_cuda and torch.equal(a, b), k
    s1, s2 = opt.state_dict()["adamw"]["state"], opt2.state_dict()["adamw"]["state"]
    assert s1.keys() == s2.keys()
    for i in s1:
        for k in s1[i]:
            assert torch.equal(s1[i][k], s2[i][k]), (i, k)
    assert opt2.step_count == 1
    m1 = step(batch, torch.Generator(device=cuda).manual_seed(1))
    m2 = step2(batch, torch.Generator(device=cuda).manual_seed(1))
    # the same inputs through kernels with float32 atomics: alike, not bit-equal
    for k, v in m1.items():
        assert abs(float(m2[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-5, k
