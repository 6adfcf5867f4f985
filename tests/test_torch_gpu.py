"""The port's CUDA kernels against their plain versions, on the card.

K1 (``ms_deform_gather_3d``) and its backward K1-bwd, K2 (``trilerp_sample``)
and its backward K2-bwd, K3 (``sample_id_masks``), K4
(``fused_multilevel_gather``) and its backward K4-bwd, the probe's P1
(``add_one``) and P2 (``row_gather``), the LSS splat S1
(``voxel_scatter_lifted``), the all-layer batched loss on the card (K2,
K2-bwd, K3) against the same loss on the CPU, and a checkpoint round trip
of a model and optimizer on the card.  These
tests need a CUDA device and skip without one; the kernels have no CPU mode.
The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances, relative to max |plain|: float32 1e-5 for the forwards and 1e-4
for the gradients (the same float32 sums in another order; K1-bwd's d_value
and the narrow K2-bwd path add atomics per element in an order that changes
from run to run, while the segmented K2-bwd path sums each row in ascending
point order and repeats itself bit for bit); bfloat16 1e-2 (the kernels round their outputs to bf16; the plain
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
@pytest.mark.parametrize("lanes", [1, 2, 4, 8, 16, 32])
def test_k1_row_path_matches_plain(cuda, dtype, hd, lanes):
    """K1's row-wide path (rows of whole 16-byte vectors) against the plain
    version at every lane count of the sweep and 1-3 samples a lane at a
    time; hd = 40 in float32 takes passes of 4 vectors.  Two calls of the
    default are bit-equal and counted on the row path."""
    dt = getattr(torch, dtype)
    value, locs, w = _inputs(cuda, dt, hd=hd, seed=11)
    assert k1.ms_deform_fwd_path(hd, dt, (value.data_ptr(),)) == "row"
    ref = k1.ms_deform_gather_3d_plain(value.float(), SHAPES, locs, w.float())
    for samples in (1, 2, 3):
        got = k1._launch_fwd(value, SHAPES, locs, w, path="row", lanes=lanes, samples=samples)
        _close(got, ref, _tol(dt), f"K1 row path, {lanes} lanes x {samples} samples")
    before = (k1.LAUNCHES, k1.ROW_LAUNCHES)
    got = k1.ms_deform_gather_3d(value, SHAPES, locs, w)
    again = k1.ms_deform_gather_3d(value, SHAPES, locs, w)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES - before[0], k1.ROW_LAUNCHES - before[1]) == (2, 2)
    assert got.dtype == dt and torch.equal(got, again)
    _close(got, ref, _tol(dt), "K1 row path")


def test_k1_scalar_path_for_other_rows(cuda):
    """hd = 12 in bf16 (24-byte rows) and a float32 value 4 bytes past a
    16-byte boundary keep one thread per channel."""
    value, locs, w = _inputs(cuda, torch.bfloat16, hd=12, seed=12)
    assert k1.ms_deform_fwd_path(12, torch.bfloat16, (value.data_ptr(),)) == "scalar"
    v32, _, w32 = _inputs(cuda, torch.float32, hd=24, seed=13)
    odd = torch.empty(v32.numel() + 1, device=cuda)[1:].view(v32.shape).copy_(v32)
    assert odd.data_ptr() % 16 and k1.ms_deform_fwd_path(24, torch.float32,
                                                         (odd.data_ptr(),)) == "scalar"
    for v, ww, rel in ((value, w, 1e-2), (odd, w32, 1e-5)):
        before = (k1.LAUNCHES, k1.ROW_LAUNCHES)
        got = k1.ms_deform_gather_3d(v, SHAPES, locs, ww)
        torch.cuda.synchronize()
        assert (k1.LAUNCHES - before[0], k1.ROW_LAUNCHES - before[1]) == (1, 0)
        _close(got, k1.ms_deform_gather_3d_plain(v.float(), SHAPES, locs, ww.float()), rel,
               "K1 scalar path")
    with pytest.raises(RuntimeError):  # the row path refuses a misaligned value
        k1._launch_fwd(odd, SHAPES, locs, w32, path="row")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [24, 40, 12])
def test_k1_backward_matches_plain_autograd(cuda, dtype, hd):
    """K1-bwd's d_value, d_locs, d_weights against autograd through the
    plain version; a 4-lane group walks 8 * hd / 4 (corner, quad) units, 3
    at a time: twelve per lane at hd = 24, twenty at 40, six at 12."""
    dt = getattr(torch, dtype)
    value, locs, w = _inputs(cuda, dt, hd=hd, seed=1)
    _k1_backward_against_plain(value, locs, w)


def _k1_backward_against_plain(value, locs, w, shapes=SHAPES):
    dt, hd = value.dtype, value.shape[-1]
    gout = torch.randn(value.shape[0], locs.shape[1], value.shape[2], hd,
                       device=value.device).to(dt)
    leaves = [t.detach().clone().requires_grad_(True) for t in (value, locs, w)]
    out = k1.ms_deform_gather_3d(leaves[0], shapes, leaves[1], leaves[2])
    assert out.grad_fn is not None
    before = k1.BWD_LAUNCHES
    out.backward(gout)
    torch.cuda.synchronize()
    assert k1.BWD_LAUNCHES == before + 1
    refs = [t.detach().float().requires_grad_(True) for t in (value, locs, w)]
    k1.ms_deform_gather_3d_plain(refs[0], shapes, refs[1], refs[2]).backward(gout.float())
    for name, got, ref in zip(("d_value", "d_locs", "d_weights"), leaves, refs):
        assert got.grad.dtype == got.dtype
        _close(got.grad, ref.grad, _tol(dt, grad=True), f"K1-bwd {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [12, 24, 40])
def test_k1_backward_at_local_locations(cuda, dtype, hd):
    """The model's locations: every query at its own voxel centre of every
    level (the pixel decoder's reference points) plus up to +-2 voxels, so
    that neighbouring queries' reductions hit the same d_value rows."""
    from occformer_tpu_torch.models.pixel_decoder import reference_points

    dt = getattr(torch, dtype)
    rng = np.random.RandomState(2)
    B, H, P, L = 2, 3, 4, len(SHAPES)
    ref = reference_points(SHAPES)                      # [Nq, 3] in [0, 1]
    Nq, Nv = ref.shape[0], sum(x * y * z for x, y, z in SHAPES)
    size = np.asarray(SHAPES, np.float32)[None, None, None, :, None, :]
    locs = ref[None, :, None, None, None, :] + rng.uniform(-2, 2, (B, Nq, H, L, P, 3)) / size
    value = torch.from_numpy(rng.randn(B, Nv, H, hd).astype(np.float32)).to(cuda, dt)
    w = torch.from_numpy(rng.rand(B, Nq, H, L, P).astype(np.float32)).to(cuda, dt)
    _k1_backward_against_plain(value, torch.from_numpy(locs.astype(np.float32)).to(cuda), w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_backward_with_one_channel_units(cuda, dtype):
    """hd = 6 (not a multiple of 4) and a value tensor 2 elements into its
    storage (not aligned for vector access) take the scalar units."""
    dt = getattr(torch, dtype)
    value, locs, w = _inputs(cuda, dt, hd=6, seed=3)
    _k1_backward_against_plain(value, locs, w)
    value8, _, _ = _inputs(cuda, dt, hd=8, seed=4)
    offset = torch.empty(value8.numel() + 2, device=cuda, dtype=dt)[2:].view(value8.shape)
    offset.copy_(value8)
    assert offset.data_ptr() % 16 != 0
    _k1_backward_against_plain(offset, locs, w)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [8, 24, 192])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k2_row_path_matches_plain(cuda, dtype, C, align_corners, padding_mode):
    """K2's row-wide forward (rows of whole 16-byte vectors) against the
    plain version, coordinates up to +-1.15, at the default lane group and
    at 1 and 32 lanes per point; two calls bit-equal."""
    table, coords = _k2_inputs(cuda, dtype, C=C, seed=7)
    assert k2.fwd_path(table.shape, table.dtype, table.data_ptr()) == "row"
    before = (k2.LAUNCHES, k2.ROW_LAUNCHES)
    got = k2.trilerp_sample(table, coords, align_corners, padding_mode)
    again = k2.trilerp_sample(table, coords, align_corners, padding_mode)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES - before[0], k2.ROW_LAUNCHES - before[1]) == (2, 2)
    assert got.dtype == table.dtype and got.shape == (3, 500, C)
    ref = k2.trilerp_sample_plain(table, coords, align_corners, padding_mode)
    _close(got, ref, _tol(table.dtype), "K2 row path")
    assert torch.equal(got, again)
    for lanes in (1, 32):
        other = k2._launch_fwd(table, coords, align_corners, padding_mode, "row", lanes)
        _close(other, ref, _tol(table.dtype), f"K2 row path, {lanes} lanes")
    scalar = k2._launch_fwd(table, coords, align_corners, padding_mode, "scalar")
    _close(scalar, ref, _tol(table.dtype), "K2 scalar path")


@pytest.mark.parametrize("dtype,C", [("float32", 17), ("float32", 1), ("bfloat16", 100),
                                     ("bool", 1), ("bool", 16)])
def test_k2_scalar_path_for_other_rows(cuda, dtype, C):
    """Rows that are not 16-byte vectors, and uint8 masks, keep one thread
    per channel; so does a table that is not 16-byte aligned."""
    table, coords = _k2_inputs(cuda, dtype, C=C, seed=8)
    t = table.view(torch.uint8) if dtype == "bool" else table
    assert k2.fwd_path(t.shape, t.dtype, t.data_ptr()) == "scalar"
    before = (k2.LAUNCHES, k2.ROW_LAUNCHES)
    got = k2.trilerp_sample(table, coords, False, "zeros")
    torch.cuda.synchronize()
    assert (k2.LAUNCHES - before[0], k2.ROW_LAUNCHES - before[1]) == (1, 0)
    _close(got, k2.trilerp_sample_plain(table, coords, False, "zeros"),
           _tol(got.dtype), "K2 scalar path")
    if dtype == "float32":  # one float past an aligned start
        buf = torch.empty(table.numel() * 8 + 1, device=cuda)[1:1 + 3 * 8 * 6 * 5 * 8]
        odd = buf.view(3, 8, 6, 5, 8).copy_(torch.randn(3, 8, 6, 5, 8, device=cuda))
        assert odd.data_ptr() % 16 and k2.fwd_path(odd.shape, odd.dtype, odd.data_ptr()) == "scalar"
        _close(k2.trilerp_sample(odd, coords), k2.trilerp_sample_plain(odd, coords), 1e-5,
               "K2 unaligned table")


@pytest.mark.parametrize("case", ["uint8 C1", "float32 C1", "float32 C17", "bfloat16 C100",
                                  "bool C16", "float32 C8 unaligned"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k2_narrow_path_matches_plain(cuda, case, align_corners, padding_mode):
    """K2's narrow forward (the "scalar" path) against the plain version,
    coordinates up to +-1.15, at its default and at every lane count (C > 1)
    or points per lane (C = 1).  Two calls are bit-equal."""
    dtype, C = case.split()[0], int(case.split()[1][1:])
    table, coords = _k2_inputs(cuda, "bool" if dtype == "uint8" else dtype, C=C, seed=9)
    if dtype == "uint8":
        table = table.view(torch.uint8)
    if case.endswith("unaligned"):  # one float past a 16-byte boundary
        buf = torch.empty(table.numel() + 1, device=cuda)[1:]
        table = buf.view(table.shape).copy_(table)
        assert table.data_ptr() % 16
    t = table.view(torch.uint8) if table.dtype == torch.bool else table
    assert k2.fwd_path(t.shape, t.dtype, t.data_ptr()) == "scalar"
    ref = k2.trilerp_sample_plain(table, coords, align_corners, padding_mode)
    tol = _tol(ref.dtype)
    before = (k2.LAUNCHES, k2.ROW_LAUNCHES)
    got = k2.trilerp_sample(table, coords, align_corners, padding_mode)
    again = k2.trilerp_sample(table, coords, align_corners, padding_mode)
    torch.cuda.synchronize()
    assert (k2.LAUNCHES - before[0], k2.ROW_LAUNCHES - before[1]) == (2, 0)
    assert got.dtype == ref.dtype and torch.equal(got, again)
    _close(got, ref, tol, f"K2 narrow {case}")
    opts = ([{"points": n} for n in (1, 2, 4)] if C == 1 else
            [{"lanes": n} for n in (1, 2, 4, 8, 16, 32)])
    for o in opts:
        _close(k2._launch_fwd(t, coords, align_corners, padding_mode, "scalar", **o), ref, tol,
               f"K2 narrow {case} {o}")


def _k2_bwd_on(path, table, coords, gout, align_corners=False, padding_mode="border"):
    """K2-bwd on ``path`` alone: (d_table, the launch counts it added)."""
    before = (k2.BWD_LAUNCHES, k2.BWD_NARROW_LAUNCHES)
    d_table, _ = k2._launch_bwd(table, coords, gout, align_corners, padding_mode,
                                want_coords=False, path=path)
    torch.cuda.synchronize()
    return d_table, (k2.BWD_LAUNCHES - before[0], k2.BWD_NARROW_LAUNCHES - before[1])


def _k2_plain_d_table(table, coords, gout, align_corners=False, padding_mode="border"):
    leaf = table.detach().float().requires_grad_(True)
    k2.trilerp_sample_plain(leaf, coords, align_corners, padding_mode).backward(gout.float())
    return leaf.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [192, 48])
def test_k2_backward_both_paths_at_the_per_layer_shapes(cuda, dtype, C):
    """The per-layer loss route's feature readout at a sixteenth of its size
    (table [1, 32, 32, 8, C], 9408 points, border, align_corners=False): the
    segmented and the narrow path against plain autograd, the autograd
    Function on the segmented path, and two segmented calls bit-identical."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(5)
    table = torch.randn((1, 32, 32, 8, C), device=cuda, generator=gen).to(dt)
    coords = torch.rand((1, 9408, 3), device=cuda, generator=gen) * 2 - 1
    gout = torch.randn((1, 9408, C), device=cuda, generator=gen).to(dt)
    ref = _k2_plain_d_table(table, coords, gout)
    seg, n_seg = _k2_bwd_on("segmented", table, coords, gout)
    seg2, _ = _k2_bwd_on("segmented", table, coords, gout)
    narrow, n_narrow = _k2_bwd_on("narrow", table, coords, gout)
    assert (n_seg, n_narrow) == ((1, 0), (1, 1))
    assert seg.dtype == narrow.dtype == dt
    _close(seg, ref, _tol(dt, grad=True), "K2-bwd segmented")
    _close(narrow, ref, _tol(dt, grad=True), "K2-bwd narrow")
    assert torch.equal(seg, seg2)
    leaf = table.detach().clone().requires_grad_(True)
    before = (k2.BWD_LAUNCHES, k2.BWD_NARROW_LAUNCHES)
    k2.trilerp_sample(leaf, coords, False, "border").backward(gout)
    assert (k2.BWD_LAUNCHES - before[0], k2.BWD_NARROW_LAUNCHES - before[1]) == (1, 0)
    assert torch.equal(leaf.grad, seg)


@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("align_corners", [False, True])
def test_k2_segmented_backward_with_crowded_and_empty_rows(cuda, padding_mode, align_corners):
    """Most points far outside a 6x5x7 table: border clipping piles them onto
    the edge voxels (segments of hundreds of entries), zeros drops them; and
    a call with no points at all, which must give zeros."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    table = torch.randn((2, 6, 5, 7, 16), device=cuda, generator=gen)
    coords = torch.rand((2, 3000, 3), device=cuda, generator=gen) * 8 - 4
    gout = torch.randn((2, 3000, 16), device=cuda, generator=gen)
    ref = _k2_plain_d_table(table, coords, gout, align_corners, padding_mode)
    seg, _ = _k2_bwd_on("segmented", table, coords, gout, align_corners, padding_mode)
    seg2, _ = _k2_bwd_on("segmented", table, coords, gout, align_corners, padding_mode)
    _close(seg, ref, 1e-4, "K2-bwd segmented, crowded rows")
    assert torch.equal(seg, seg2)
    none, _ = _k2_bwd_on("segmented", table, coords[:, :0].contiguous(), gout[:, :0].contiguous(),
                         align_corners, padding_mode)
    assert torch.equal(none, torch.zeros_like(table))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gate", "flagship", "C8"])
def test_k4_row_path_matches_plain(cuda, dtype, case):
    """K4's row-wide forward against the plain version and against the
    scalar path at bench.py's parity-gate shapes (S = 512, coords in
    [-1.1, 1.1]), at the flagship's (S_l = 149504) and at C = 8; two calls
    bit-equal."""
    dt = getattr(torch, dtype)
    C, S, spill = {"gate": (24, 512, 1.1), "flagship": (24, 149504, 1.036),
                   "C8": (8, 3000, 1.1)}[case]
    tables, coords = _k4_inputs(cuda, dt, K4_PYRAMID, G=8, C=C, S=S, spill=spill)
    assert k1.multi_fwd_path(C, dt, [t.data_ptr() for t in tables]) == "row"
    before = (k1.MULTI_LAUNCHES, k1.MULTI_ROW_LAUNCHES)
    got = k1.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    again = k1.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    torch.cuda.synchronize()
    assert (k1.MULTI_LAUNCHES - before[0], k1.MULTI_ROW_LAUNCHES - before[1]) == (2, 2)
    scalar = k1._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False, path="scalar")
    ref = k1.fused_multilevel_gather_plain(tables, K4_PYRAMID, C, coords)
    for l in range(len(K4_PYRAMID)):
        assert got[l].dtype == dt and torch.equal(got[l], again[l])
        _close(got[l], ref[l], _tol(dt), f"K4 row path level {l}")
        _close(scalar[l], ref[l], _tol(dt), f"K4 scalar path level {l}")


def test_k4_scalar_path_for_other_rows(cuda):
    """Rows that are not 16-byte vectors (C = 6), and a table that is not
    16-byte aligned, keep the scalar path."""
    tables, coords = _k4_inputs(cuda, torch.float32, K4_PYRAMID[1:], G=2, C=6, S=300, spill=1.2)
    assert k1.multi_fwd_path(6, torch.float32) == "scalar"
    X, Y, Z = K4_PYRAMID[1]
    odd = torch.empty(2 * X * Y * Z * 8 + 1, device=cuda)[1:].view(2, X * Y, Z * 8)
    odd.copy_(torch.randn(odd.shape, device=cuda))
    ok = torch.randn((2, 16 * 16, 2 * 8), device=cuda)
    assert k1.multi_fwd_path(8, torch.float32, [odd.data_ptr(), ok.data_ptr()]) == "scalar"
    cases = ((tables, K4_PYRAMID[1:], 6, coords),
             ([odd, ok], K4_PYRAMID[1:], 8, coords))
    for tbl, spatials, C, crd in cases:
        before = (k1.MULTI_LAUNCHES, k1.MULTI_ROW_LAUNCHES)
        got = k1.fused_multilevel_gather(tbl, spatials, C, crd)
        torch.cuda.synchronize()
        assert (k1.MULTI_LAUNCHES - before[0], k1.MULTI_ROW_LAUNCHES - before[1]) == (1, 0)
        for g, r in zip(got, k1.fused_multilevel_gather_plain(tbl, spatials, C, crd)):
            _close(g, r, 1e-5, f"K4 scalar path C={C}")


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


def _splat_inputs(dev, depth_dtype, ctx_dtype, B=1, N=3, D=20, fH=6, fW=9, C=40,
                  nx=(10, 12, 4), seed=0):
    """Random frustum points clustered into few voxels (hundreds of points in
    the hot ones, as near a camera), a fifth invalid."""
    rng = np.random.RandomState(seed)
    depth = torch.from_numpy(rng.rand(B, N, D, fH, fW).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(B, N, fH, fW, C).astype(np.float32))
    coords = rng.randint(0, 3, (B, N, D, fH, fW, 3)) * rng.randint(1, 4, (1, 1, 1, 1, 1, 3))
    coords[:, :, ::2] = rng.randint(-1, 13, (B, N, (D + 1) // 2, fH, fW, 3))
    valid = rng.rand(B, N, D, fH, fW) > 0.2
    return (depth.to(dev, getattr(torch, depth_dtype)), ctx.to(dev, getattr(torch, ctx_dtype)),
            torch.from_numpy(coords.astype(np.int32)).to(dev), torch.from_numpy(valid).to(dev),
            nx)


@pytest.mark.parametrize("depth_dtype,ctx_dtype", [("float32", "float32"), ("float32", "bfloat16"),
                                                   ("bfloat16", "bfloat16")])
def test_splat_matches_plain_and_repeats_itself(cuda, depth_dtype, ctx_dtype):
    """S1 (the LSS splat) against the plain version (atomic index_add_ on the
    card) and its autograd: the volume and the depth and context gradients;
    two calls, forward and backward, bit-equal."""
    from occformer_tpu_torch.ops import scatter

    depth, ctx, coords, valid, nx = _splat_inputs(cuda, depth_dtype, ctx_dtype)
    gen = torch.Generator(device=cuda).manual_seed(2)
    probe = torch.randn((1, *nx, ctx.shape[-1]), device=cuda, generator=gen)
    runs = []
    for _ in range(2):
        d, c = (t.detach().clone().requires_grad_(True) for t in (depth, ctx))
        before = scatter.LAUNCHES
        out = scatter.voxel_scatter_lifted(d, c, coords, valid, nx)
        (out.float() * probe).sum().backward()
        torch.cuda.synchronize()
        assert scatter.LAUNCHES == before + 1 and out.dtype == depth.dtype
        runs.append((out, d.grad, c.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    d, c = (t.detach().float().requires_grad_(True) for t in (depth, ctx))
    ref = scatter.voxel_scatter_plain(d, c, scatter.voxel_rows(coords, valid, nx),
                                      int(np.prod(nx))).reshape(probe.shape)
    (ref * probe).sum().backward()
    tol = 1e-5 if depth_dtype == ctx_dtype == "float32" else 1e-2
    _close(runs[0][0], ref, tol, "S1 volume")
    _close(runs[0][1], d.grad, 1e-4 if tol == 1e-5 else tol, "S1 d_depth")
    _close(runs[0][2], c.grad, 1e-4 if tol == 1e-5 else tol, "S1 d_ctx")


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
    # the same state and inputs: the forward sums in a fixed order (the LSS
    # splat, S1, has no atomics), so every loss repeats bit for bit; the
    # backward kernels' float32 atomics still move grad_norm in its last
    # bits: alike, not bit-equal
    m1 = step(batch, torch.Generator(device=cuda).manual_seed(1))
    m2 = step2(batch, torch.Generator(device=cuda).manual_seed(1))
    for k, v in m1.items():
        if "loss" in k:
            assert float(m2[k]) == float(v), k
        assert abs(float(m2[k]) - float(v)) <= 1e-4 * abs(float(v)) + 1e-5, k
