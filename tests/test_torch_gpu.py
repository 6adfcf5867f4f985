"""The port's CUDA kernels against their plain versions, on the card.

K1 (``ms_deform_gather_3d``) and its backward K1-bwd, K2 (``trilerp_sample``)
and its backward K2-bwd, K3 (``sample_id_masks``), K4
(``fused_multilevel_gather``) and its backward K4-bwd (also as the
DepthNet's and the R101-DCN backbone's deformable convolutions run them,
and those modules on the card against themselves on the CPU), the convolutions and the attention whose
backward the port sums in a fixed order, the probe's P1
(``add_one``) and P2 (``row_gather``), the LSS splat S1
(``voxel_scatter_lifted``) and its backward S1-bwd, S1-rows
(``voxel_scatter``) and its backward S1-rows-bwd (bit for bit the plain
gather), the all-layer batched loss on the card (K2,
K2-bwd, K3) against the same loss on the CPU, the panoptic shapes (K3 at
panoptic ids over 100 slots, K2 and K2-bwd at a random fill of many slots,
the 100-slot GT table, the panoptic loss on both routes against the CPU),
and a checkpoint round trip
of a model and optimizer on the card.  These
tests need a CUDA device and skip without one; the kernels have no CPU mode.
The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances, relative to max |plain|: float32 1e-5 for the forwards and 1e-4
for the gradients (the same float32 sums in another order; every backward
sums each output in a fixed order and repeats itself bit for bit: K1-bwd's
d_value and K4-bwd's d_tables each row's terms in ascending sample order,
the segmented K2-bwd each voxel's points in ascending point order, the
narrow one each (x, y) column's); bfloat16 1e-2 (the kernels round their
outputs to bf16; the plain versions run in float32 on the same bf16-rounded
inputs).  K3 1e-6 absolute, and exactly where the test says so: it adds
the plain version's float32 terms in its order.  P1 and P2 exactly (one
float32 add; a copy).
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
    version at every lane count of the sweep; hd = 40 in float32 takes
    passes of 4 vectors.  Two calls of the default are bit-equal and counted
    on the row path."""
    dt = getattr(torch, dtype)
    value, locs, w = _inputs(cuda, dt, hd=hd, seed=11)
    assert k1.ms_deform_fwd_path(hd, dt, (value.data_ptr(),)) == 16
    ref = k1.ms_deform_gather_3d_plain(value.float(), SHAPES, locs, w.float())
    got = k1._launch_fwd(value, SHAPES, locs, w, vec=16, lanes=lanes)
    _close(got, ref, _tol(dt), f"K1 row path, {lanes} lanes")
    before = (k1.LAUNCHES, k1.ROW_LAUNCHES)
    got = k1.ms_deform_gather_3d(value, SHAPES, locs, w)
    again = k1.ms_deform_gather_3d(value, SHAPES, locs, w)
    torch.cuda.synchronize()
    assert (k1.LAUNCHES - before[0], k1.ROW_LAUNCHES - before[1]) == (2, 2)
    assert got.dtype == dt and torch.equal(got, again)
    _close(got, ref, _tol(dt), "K1 row path")


# row widths of K1's and K4's other rows: one to 256 channels, vectors of 2,
# 4, 8 and 16 bytes, rows of 1 to 256 vectors
OTHER_WIDTHS = [1, 2, 3, 5, 6, 7, 12, 20, 24, 33, 64, 256]
OFFSETS = [0, 2, 4, 8]  # bytes past a 16-byte boundary


def _offset_copy(t, offset):
    """``t``'s values in a view ``offset`` bytes past a 16-byte boundary."""
    k = offset // t.element_size()
    out = torch.empty(t.numel() + k, dtype=t.dtype, device=t.device)[k:].view(t.shape)
    assert out.data_ptr() % 16 == offset
    return out.copy_(t)


def _widths(channels, dtype, offset):
    """Every vector width the kernels take for such rows at such an address."""
    esize = 2 if dtype == torch.bfloat16 else 4
    return [vb for vb in (16, 8, 4, 2)
            if vb >= esize and (channels * esize) % vb == 0 and offset % vb == 0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", OTHER_WIDTHS)
def test_k1_other_rows_at_every_vector_width(cuda, dtype, hd):
    """K1 at every vector width its row and the value's address allow, the
    value 0, 2 (bf16), 4 and 8 bytes past a 16-byte boundary, against the
    plain version, two calls bit-equal; the default takes the row's own
    width (a misaligned value copied to an aligned buffer) and every launch
    is the row-wide kernel's; a width the row or the address does not take
    raises."""
    dt = getattr(torch, dtype)
    base, locs, w = _inputs(cuda, dt, hd=hd, Nq=120, seed=12)
    ref = k1.ms_deform_gather_3d_plain(base.float(), SHAPES, locs, w.float())
    for offset in OFFSETS:
        if offset % base.element_size():
            continue
        value = _offset_copy(base, offset) if offset else base
        widths = _widths(hd, dt, offset)
        assert k1.ms_deform_fwd_path(hd, dt, (value.data_ptr(),)) == widths[0]
        for vb in widths:
            got = k1._launch_fwd(value, SHAPES, locs, w, vec=vb)
            again = k1._launch_fwd(value, SHAPES, locs, w, vec=vb)
            torch.cuda.synchronize()
            assert torch.equal(got, again), (offset, vb)
            _close(got, ref, _tol(dt), f"K1 hd={hd} +{offset} bytes, {vb}-byte vectors")
        before = (k1.LAUNCHES, k1.ROW_LAUNCHES)
        got = k1.ms_deform_gather_3d(value, SHAPES, locs, w)
        torch.cuda.synchronize()
        assert (k1.LAUNCHES - before[0], k1.ROW_LAUNCHES - before[1]) == (1, 1)
        _close(got, ref, _tol(dt), f"K1 hd={hd} +{offset} bytes")
        for vb in {16, 8, 4, 2} - set(widths):
            with pytest.raises(RuntimeError):
                k1._launch_fwd(value, SHAPES, locs, w, vec=vb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [24, 40, 12])
def test_k1_backward_matches_plain_autograd(cuda, dtype, hd):
    """K1-bwd's d_value, d_locs, d_weights against autograd through the
    plain version: rows of three, five and one and a half 16-byte chunks
    (hd = 12 in bf16 and float32 takes 8-byte and 16-byte chunks)."""
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
    again = k1._launch_bwd(value, shapes, locs, w, gout)
    for name, got, ref, rep in zip(("d_value", "d_locs", "d_weights"), leaves, refs, again):
        assert got.grad.dtype == got.dtype
        assert torch.equal(got.grad, rep), f"K1-bwd {name}: two calls differ"
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
    storage (not aligned for 16-byte access) take narrower chunks on the same
    fixed-order path (there is no atomic path)."""
    dt = getattr(torch, dtype)
    value, locs, w = _inputs(cuda, dt, hd=6, seed=3)
    _k1_backward_against_plain(value, locs, w)
    value8, _, _ = _inputs(cuda, dt, hd=8, seed=4)
    offset = torch.empty(value8.numel() + 2, device=cuda, dtype=dt)[2:].view(value8.shape)
    offset.copy_(value8)
    assert offset.data_ptr() % 16 != 0
    _k1_backward_against_plain(offset, locs, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("local", [False, True])
def test_k1_backward_at_the_flagship_shapes(cuda, dtype, local):
    """K1-bwd at the pixel decoder's shapes (Nq = 37376, H = 8, hd = 24,
    levels (16,16,2), (32,32,4), (64,64,8), P = 4), at uniform and at local
    locations: within the gradient tolerance of the plain version's
    autograd, two calls bit-equal."""
    from occformer_tpu_torch.tools.time_backwards import flagship_gather_inputs

    value, shapes, locs, w = flagship_gather_inputs(getattr(torch, dtype), local)
    _k1_backward_against_plain(value, locs, w, shapes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_backward_with_crowded_and_empty_rows(cuda, dtype):
    """Every sample of the first level inside its 2 x 2 x 2 voxels (4800
    samples a (b, h): rows too long to sort in shared memory, summed by the
    heavy-row kernel), the second level's samples crowded into one corner
    (rows of hundreds, sorted by a block; most rows empty)."""
    dt = getattr(torch, dtype)
    shapes = [(2, 2, 2), (16, 16, 4)]
    rng = np.random.RandomState(7)
    B, H, hd, Nq, P = 1, 2, 8, 1200, 4
    Nv = sum(x * y * z for x, y, z in shapes)
    locs = np.empty((B, Nq, H, 2, P, 3), np.float32)
    locs[:, :, :, 0] = rng.uniform(0.3, 0.7, (B, Nq, H, P, 3))
    locs[:, :, :, 1] = rng.uniform(0.0, 0.2, (B, Nq, H, P, 3))
    value = torch.from_numpy(rng.randn(B, Nv, H, hd).astype(np.float32)).to(cuda, dt)
    w = torch.from_numpy(rng.rand(B, Nq, H, 2, P).astype(np.float32)).to(cuda, dt)
    _k1_backward_against_plain(value, torch.from_numpy(locs).to(cuda), w, shapes)


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


@pytest.mark.parametrize("case", ["float32 C1", "float32 C17", "bfloat16 C17", "float32 C5",
                                  "float32 C40"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
@pytest.mark.parametrize("order", ["random", "by_column"])
def test_k2_narrow_backward_column_gather(cuda, case, align_corners, padding_mode, order):
    """K2-bwd's narrow path (the per-column gather) against plain autograd,
    with points in random order and sorted by column as the loss sends them
    (``sort_points_by_row``), a quarter of them outside the table: two calls
    and every lane count give the same bits (each output's sum runs over the
    column's entries in one order whatever the lanes), and one lane per
    column at C = 17 takes the column in passes of 32 outputs."""
    dtype, C = case.split(" C")
    C = int(C)
    table, coords = _k2_inputs(cuda, dtype, G=2, spatial=(9, 7, 6), C=C, S=3000, seed=11)
    if order == "by_column":
        pts = k3.sort_points_by_row((coords + 1) / 2, (9, 7, 6), align_corners)
        coords = (pts * 2 - 1).contiguous()
    gout = torch.randn(coords.shape[:2] + (C,), device=cuda).to(table.dtype)
    assert k2.bwd_path(table.shape, coords.shape[1]) == "narrow"
    ref = _k2_plain_d_table(table, coords, gout, align_corners, padding_mode)
    got, n = _k2_bwd_on("narrow", table, coords, gout, align_corners, padding_mode)
    again, _ = _k2_bwd_on("narrow", table, coords, gout, align_corners, padding_mode)
    assert n == (1, 1) and got.dtype == table.dtype and torch.equal(got, again)
    _close(got, ref, _tol(table.dtype, grad=True), f"K2-bwd narrow {case}")
    for lanes in (1, 2, 4, 8, 16, 32):
        d, _ = k2._launch_bwd(table, coords, gout, align_corners, padding_mode, False,
                              path="narrow", lanes=lanes)
        assert torch.equal(d, got), lanes


def test_k2_narrow_backward_at_the_batched_shapes(cuda):
    """The batched route's per-slot readouts at a quarter of their size
    (float32 [10, 32, 32, 16, 17] at 10 x 9408 candidates and [170, 32, 32,
    16, 1] at 170 x 784 random-fill points, both sorted by column, border,
    align_corners=False): against plain autograd, two calls bit-equal, and
    the autograd Function on the narrow path."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    for G, C, S in ((10, 17, 9408), (170, 1, 784)):
        table = torch.randn((G, 32, 32, 16, C), device=cuda, generator=gen)
        pts = k3.sort_points_by_row(torch.rand((G, S, 3), device=cuda, generator=gen),
                                    (32, 32, 16))
        coords = (pts * 2 - 1).contiguous()
        gout = torch.randn((G, S, C), device=cuda, generator=gen)
        ref = _k2_plain_d_table(table, coords, gout)
        leaf = table.detach().clone().requires_grad_(True)
        before = (k2.BWD_LAUNCHES, k2.BWD_NARROW_LAUNCHES)
        k2.trilerp_sample(leaf, coords, False, "border").backward(gout)
        torch.cuda.synchronize()
        assert (k2.BWD_LAUNCHES - before[0], k2.BWD_NARROW_LAUNCHES - before[1]) == (1, 1)
        again, _ = _k2_bwd_on("narrow", table, coords, gout)
        assert torch.equal(leaf.grad, again)
        _close(leaf.grad, ref, 1e-4, f"K2-bwd narrow G={G} C={C}")


def _k3_inputs(dev, spatial, B=2, N=4, G=17, S=3000, P=200, seed=0):
    rng = np.random.RandomState(seed)
    grid = rng.randint(0, G + 2, (B, *spatial)).astype(np.int32)
    grid[:, :2] = 255
    ids = np.stack([np.arange(G), np.arange(G)[::-1]]).astype(np.int32)
    shared = rng.uniform(-0.15, 1.15, (N, S, 3)).astype(np.float32)
    per_slot = rng.uniform(-0.15, 1.15, (N, G, P, 3)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (grid, ids, shared, per_slot)]


@pytest.mark.parametrize("S", [3000, 3001, 3])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k3_is_the_plain_version_bit_for_bit(cuda, S, align_corners, padding_mode):
    """K3 equals the plain version exactly: the shared kernel (a point a
    thread) and the per-slot one (two points a thread, 8-byte stores where
    the row's length keeps them aligned, paired label loads), at per-slot
    point counts that are and are not even."""
    grid, ids, shared, per_slot = _k3_inputs(cuda, (40, 24, 12), S=S, P=S + 1)
    for pts in (shared, per_slot):
        got = k3.sample_id_masks(grid, ids, pts, align_corners, padding_mode)
        ref = k3.sample_id_masks_plain(grid, ids, pts, align_corners, padding_mode)
        assert torch.equal(got, ref)


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


def _panoptic_grid(rng, B, spatial, G=100):
    """Panoptic ids (``class * 1000 + instance``: stuff 11000-16000, 40
    instances of the thing classes, 0 empty, 65535 noise) on ``spatial`` and
    each sample's [G] id table, -1 after its ids."""
    ids = np.concatenate([np.arange(11, 17) * 1000,
                          (rng.randint(1, 11, 40) * 1000 + rng.randint(1, 999, 40))])
    vals = np.concatenate([[0, 65535], np.unique(ids)])
    grid = vals[rng.randint(0, len(vals), (B, *spatial))].astype(np.int32)
    table = np.full((B, G), -1, np.int32)
    for b in range(B):
        present = np.unique(grid[b])
        present = present[(present > 0) & (present < 17000)][:G]
        table[b, :len(present)] = present
    return grid, table


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("padding_mode", ["zeros", "border"])
def test_k3_at_panoptic_ids_is_the_plain_version(cuda, align_corners, padding_mode):
    """K3 reads panoptic ids (1000 and above, -1 padding slots, 65535
    noise) over 100 slots: the shared and the per-slot kernel equal the
    plain version on the card bit for bit and on the CPU within 1e-6, and
    equal the trilinear read of each slot's one-hot mask (K2) within 1e-5:
    K2 takes the points as 2 * p - 1, whose rounding moves a coordinate by
    up to about half the grid's width times 2^-24 (20 x 2^-24 here), and
    the two kernels form the corner weights in another order."""
    rng = np.random.RandomState(3)
    grid, table = _panoptic_grid(rng, 2, (40, 24, 12))
    grid, table = torch.from_numpy(grid).to(cuda), torch.from_numpy(table).to(cuda)
    shared = (torch.rand((4, 3001, 3), device=cuda) * 1.3 - 0.15).contiguous()
    per_slot = (torch.rand((4, 100, 257, 3), device=cuda) * 1.3 - 0.15).contiguous()
    for pts in (shared, per_slot):
        before = k3.LAUNCHES
        got = k3.sample_id_masks(grid, table, pts, align_corners, padding_mode)
        torch.cuda.synchronize()
        assert k3.LAUNCHES == before + 1
        assert torch.equal(got, k3.sample_id_masks_plain(grid, table, pts, align_corners,
                                                         padding_mode))
        ref = k3.sample_id_masks_plain(grid.cpu(), table.cpu(), pts.cpu(), align_corners,
                                       padding_mode)
        assert (got.cpu() - ref).abs().max().item() <= 1e-6
    masks = (grid[:, None] == table[:, :, None, None, None]).permute(0, 2, 3, 4, 1)
    one_hot = k2.trilerp_sample(masks.repeat(2, 1, 1, 1, 1).contiguous(), shared * 2 - 1,
                                align_corners, padding_mode)
    got = k3.sample_id_masks(grid, table, shared, align_corners, padding_mode)
    assert (got.transpose(1, 2) - one_hot).abs().max().item() <= 1e-5
    for n in range(4):  # a padding slot's id (-1) is nowhere in the grid
        assert got[n, table[n % 2] < 0].abs().max().item() == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_at_a_panoptic_random_fill(cuda, dtype):
    """The per-layer route's random-fill readout at the panoptic slot count
    (100 slots x 784 points, a sixteenth of 12544, on a [1, 32, 32, 8, 192]
    feature): K2 against its plain version, K2-bwd's segmented path against
    plain autograd and two of its calls bit-equal; and K2's narrow path at a
    100-slot bool GT table [1, 64, 64, 16, 100] against its plain version."""
    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda).manual_seed(7)
    table = torch.randn((1, 32, 32, 8, 192), device=cuda, generator=gen).to(dt)
    coords = torch.rand((1, 100 * 784, 3), device=cuda, generator=gen) * 2 - 1
    gout = torch.randn((1, 100 * 784, 192), device=cuda, generator=gen).to(dt)
    ref = k2.trilerp_sample_plain(table.float(), coords, False, "border")
    _close(k2.trilerp_sample(table, coords, False, "border"), ref, _tol(dt), "K2 random fill")
    d_ref = _k2_plain_d_table(table, coords, gout)
    seg, n_seg = _k2_bwd_on("segmented", table, coords, gout)
    seg2, _ = _k2_bwd_on("segmented", table, coords, gout)
    assert n_seg == (1, 0) and torch.equal(seg, seg2)
    _close(seg, d_ref, _tol(dt, grad=True), "K2-bwd random fill")
    rng = np.random.RandomState(8)
    grid, ids = _panoptic_grid(rng, 1, (64, 64, 16))
    gt = torch.from_numpy(grid).to(cuda)
    gt_table = (gt[:, None] == torch.from_numpy(ids).to(cuda)[:, :, None, None, None])
    gt_table = gt_table.permute(0, 2, 3, 4, 1).contiguous()
    pts = torch.rand((1, 5000, 3), device=cuda, generator=gen) * 2 - 1
    assert k2.fwd_path(tuple(gt_table.shape), gt_table.dtype, gt_table.data_ptr()) == "scalar"
    got = k2.trilerp_sample(gt_table, pts, False, "border")
    _close(got, k2.trilerp_sample_plain(gt_table, pts, False, "border"), 1e-5, "K2 GT table")


@pytest.mark.parametrize("route", ["off", "on"])
def test_panoptic_loss_on_the_card_matches_the_cpu(cuda, route):
    """The panoptic loss (150 queries, 100 slots of panoptic ids, the GT as
    the override; on the batched route read through K3 at the ids) on the
    card against the CPU on the same inputs and draws, float32: losses to
    1e-4 relative, gradients to 1e-3 of their max, the assignments equal."""
    rng = np.random.RandomState(0)
    B, L, Q, nc, C, P = 1, 2, 150, 17, 24, 100
    grid, table = _panoptic_grid(rng, B, (32, 32, 16))
    x = dict(cls_preds=rng.randn(L, B, Q, nc + 1), mask_embeds=0.4 * rng.randn(L, B, Q, C),
             mask_feature=0.4 * rng.randn(B, 16, 16, 8, C))
    lidar_xyz = torch.from_numpy(rng.uniform(-0.1, 1.1, (B, P, 3)).astype(np.float32))
    lidar_valid = torch.from_numpy(np.arange(P)[None].repeat(B, 0) < 80)
    cfg = MaskLossConfig(num_classes=nc, num_points=64, oversample_ratio=2.0,
                         class_weight=(1.0,) * nc + (0.1,), mxu_readout=route, panoptic=True)
    draws = make_loss_draws(torch.Generator().manual_seed(1), cfg, lidar_valid, L,
                            num_slots=100)

    def run(dev):
        gt, ids = torch.from_numpy(grid).to(dev), torch.from_numpy(table).to(dev)
        leaves = {k: torch.from_numpy(v.astype(np.float32)).to(dev).requires_grad_(True)
                  for k, v in x.items()}
        losses = mask2former_loss(leaves["cls_preds"], leaves["mask_embeds"],
                                  leaves["mask_feature"], gt, cfg, lidar_xyz.to(dev),
                                  lidar_valid.to(dev), draws,
                                  panoptic_ids=ids)
        sum(v for k, v in losses.items() if "loss" in k).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {k: t.grad.cpu() for k, t in leaves.items()})

    before = k3.LAUNCHES
    got, got_g = run(cuda)
    torch.cuda.synchronize()
    assert k3.LAUNCHES - before == (3 if route == "on" else 0)
    ref, ref_g = run("cpu")
    assert ref["unassigned_gt"] == got["unassigned_gt"] == 0.0
    for k, r in ref.items():
        assert abs(got[k] - r) <= 1e-4 * abs(r) + 1e-6, (k, got[k], r)
    for k, r in ref_g.items():
        _close(got_g[k], r, 1e-3, f"panoptic loss d_{k}")


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
    d_tables, d_coords = k1._launch_multi_bwd(tables, spatials, C, coords, gouts, align_corners,
                                              True)
    for l, (g, r) in enumerate(zip(got, ref)):
        assert g.dtype == dtype and g.shape == r.shape
        _close(g, r, _tol(dtype), f"K4 level {l}")
        assert tl[l].grad.dtype == dtype and cl[l].grad.dtype == torch.float32
        assert torch.equal(tl[l].grad, d_tables[l]) and torch.equal(cl[l].grad, d_coords[l]), \
            f"K4-bwd level {l}: two calls differ"
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


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_backward_with_crowded_and_empty_rows(cuda, align_corners, dtype):
    """A 2 x 2 x 2 level every sample of which lies inside (4400 samples a
    g: rows summed by the heavy-row kernel) and a 16 x 16 x 4 level whose
    samples crowd one corner (rows of hundreds, sorted by a block; most rows
    empty), C = 8 and C = 6 (narrower chunks)."""
    rng = np.random.RandomState(11)
    spatials = [(2, 2, 2), (16, 16, 4)]
    dt = getattr(torch, dtype)
    for C in (8, 6):
        tables = [torch.from_numpy(rng.randn(2, X * Y, Z * C).astype(np.float32)).to(cuda, dt)
                  for X, Y, Z in spatials]
        coords = [torch.from_numpy(rng.uniform(lo, hi, (2, 4400, 3)).astype(np.float32)).to(cuda)
                  for lo, hi in ((-0.4, 0.4), (-1.0, -0.6))]
        _k4_against_plain(tables, coords, spatials, C, align_corners, dt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["gate", "flagship", "C8"])
def test_k4_row_path_matches_plain(cuda, dtype, case):
    """K4's row-wide forward with 16-byte vectors against the plain version
    at bench.py's parity-gate shapes (S = 512, coords in [-1.1, 1.1]), at the
    flagship's (S_l = 149504) and at C = 8; two calls bit-equal."""
    dt = getattr(torch, dtype)
    C, S, spill = {"gate": (24, 512, 1.1), "flagship": (24, 149504, 1.036),
                   "C8": (8, 3000, 1.1)}[case]
    tables, coords = _k4_inputs(cuda, dt, K4_PYRAMID, G=8, C=C, S=S, spill=spill)
    assert k1.multi_fwd_path(C, dt, [t.data_ptr() for t in tables]) == 16
    before = (k1.MULTI_LAUNCHES, k1.MULTI_ROW_LAUNCHES)
    got = k1.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    again = k1.fused_multilevel_gather(tables, K4_PYRAMID, C, coords)
    torch.cuda.synchronize()
    assert (k1.MULTI_LAUNCHES - before[0], k1.MULTI_ROW_LAUNCHES - before[1]) == (2, 2)
    ref = k1.fused_multilevel_gather_plain(tables, K4_PYRAMID, C, coords)
    for l in range(len(K4_PYRAMID)):
        assert got[l].dtype == dt and torch.equal(got[l], again[l])
        _close(got[l], ref[l], _tol(dt), f"K4 row path level {l}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", OTHER_WIDTHS)
def test_k4_other_rows_at_every_vector_width(cuda, dtype, C):
    """K4 at every vector width its row and the tables' addresses allow, the
    tables 0, 2 (bf16), 4 and 8 bytes past a 16-byte boundary, against the
    plain version, two calls bit-equal; the default takes the row's own
    width (a misaligned table copied to an aligned buffer) and every launch
    is the row-wide kernel's; a width the row or an address does not take
    raises."""
    dt = getattr(torch, dtype)
    spatials = K4_PYRAMID[1:]
    base, coords = _k4_inputs(cuda, dt, spatials, G=2, C=C, S=300, spill=1.2)
    ref = k1.fused_multilevel_gather_plain(base, spatials, C, coords)
    for offset in OFFSETS:
        if offset % base[0].element_size():
            continue
        # the first table at the offset, the other aligned
        tables = [_offset_copy(base[0], offset) if offset else base[0], base[1]]
        widths = _widths(C, dt, offset)
        assert k1.multi_fwd_path(C, dt, [t.data_ptr() for t in tables]) == widths[0]
        for vb in widths:
            got = k1._launch_multi_fwd(tables, spatials, C, coords, False, vec=vb)
            again = k1._launch_multi_fwd(tables, spatials, C, coords, False, vec=vb)
            torch.cuda.synchronize()
            for l, (g, a, r) in enumerate(zip(got, again, ref)):
                assert torch.equal(g, a), (offset, vb, l)
                _close(g, r, _tol(dt), f"K4 C={C} +{offset} bytes, {vb}-byte vectors, level {l}")
        before = (k1.MULTI_LAUNCHES, k1.MULTI_ROW_LAUNCHES)
        got = k1.fused_multilevel_gather(tables, spatials, C, coords)
        torch.cuda.synchronize()
        assert (k1.MULTI_LAUNCHES - before[0], k1.MULTI_ROW_LAUNCHES - before[1]) == (1, 1)
        for l, (g, r) in enumerate(zip(got, ref)):
            _close(g, r, _tol(dt), f"K4 C={C} +{offset} bytes, level {l}")
        for vb in {16, 8, 4, 2} - set(widths):
            with pytest.raises(RuntimeError):
                k1._launch_multi_fwd(tables, spatials, C, coords, False, vec=vb)


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
    two calls, forward and backward, bit-equal; the backward one launch of
    S1-bwd."""
    from occformer_tpu_torch.ops import scatter

    depth, ctx, coords, valid, nx = _splat_inputs(cuda, depth_dtype, ctx_dtype)
    gen = torch.Generator(device=cuda).manual_seed(2)
    probe = torch.randn((1, *nx, ctx.shape[-1]), device=cuda, generator=gen)
    runs = []
    for _ in range(2):
        d, c = (t.detach().clone().requires_grad_(True) for t in (depth, ctx))
        before, before_bwd = scatter.LAUNCHES, scatter.BWD_LAUNCHES
        out = scatter.voxel_scatter_lifted(d, c, coords, valid, nx)
        (out.float() * probe).sum().backward()
        torch.cuda.synchronize()
        assert scatter.LAUNCHES == before + 1 and out.dtype == depth.dtype
        assert scatter.BWD_LAUNCHES == before_bwd + 1  # the backward is S1-bwd
        runs.append((out, d.grad, c.grad))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    # the encoder reads the volume channels-first: at batch 1 its gradient
    # reaches S1-bwd as a transposed view, with the same bits
    d, c = (t.detach().clone().requires_grad_(True) for t in (depth, ctx))
    out = scatter.voxel_scatter_lifted(d, c, coords, valid, nx).permute(0, 4, 1, 2, 3)
    (out.contiguous().float() * probe.permute(0, 4, 1, 2, 3)).sum().backward()
    assert torch.equal(d.grad, runs[0][1]) and torch.equal(c.grad, runs[0][2])
    d, c = (t.detach().float().requires_grad_(True) for t in (depth, ctx))
    ref = scatter.voxel_scatter_plain(d, c, scatter.voxel_rows(coords, valid, nx),
                                      int(np.prod(nx))).reshape(probe.shape)
    (ref * probe).sum().backward()
    tol = 1e-5 if depth_dtype == ctx_dtype == "float32" else 1e-2
    _close(runs[0][0], ref, tol, "S1 volume")
    _close(runs[0][1], d.grad, 1e-4 if tol == 1e-5 else tol, "S1 d_depth")
    _close(runs[0][2], c.grad, 1e-4 if tol == 1e-5 else tol, "S1 d_ctx")


def _misaligned(t):
    """``t``'s values in a view one element past its allocation's start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view_as(t)
    out.copy_(t)
    return out


@pytest.mark.parametrize("depth_dtype,ctx_dtype", [("float32", "float32"), ("float32", "bfloat16"),
                                                   ("bfloat16", "float32"),
                                                   ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("C", [128, 7, 130])
def test_splat_bwd_matches_plain_and_repeats_itself(cuda, depth_dtype, ctx_dtype, C):
    """S1-bwd (``_launch_bwd``) against its plain version on the card
    (``voxel_scatter_backward_plain``): d_depth and d_ctx within float32
    1e-5 / bf16 1e-2 of max |plain| (float32 sums in another order), over
    two batch items with hot voxels, at a whole vector of channels (128), a
    width that is not (7) and more than one pass (130); with a misaligned
    ctx (narrower loads), with every point invalid (zeros) and with the
    gradient as a transposed view (the kernel's own transpose: the same
    bits); two calls bit-equal, one launch each."""
    from occformer_tpu_torch.ops import scatter

    depth, ctx, coords, valid, nx = _splat_inputs(cuda, depth_dtype, ctx_dtype, B=2, C=C,
                                                  seed=C)
    n_rows = 2 * int(np.prod(nx))
    gen = torch.Generator(device=cuda).manual_seed(C)
    gout = torch.randn((n_rows, C), device=cuda, generator=gen).to(depth.dtype)
    tol = 1e-5 if depth_dtype == ctx_dtype == "float32" else 1e-2
    for name, c, v in (("", ctx, valid), (" misaligned ctx", _misaligned(ctx), valid),
                       (" all invalid", ctx, torch.zeros_like(valid))):
        before = scatter.BWD_LAUNCHES
        a = scatter._launch_bwd(depth, c, coords, v, gout, nx)
        b = scatter._launch_bwd(depth, c, coords, v, gout, nx)
        torch.cuda.synchronize()
        assert scatter.BWD_LAUNCHES == before + 2
        assert all(torch.equal(x, y) for x, y in zip(a, b)), f"S1-bwd{name}: two calls differ"
        assert a[0].dtype == depth.dtype and a[1].dtype == ctx.dtype
        ref = scatter.voxel_scatter_backward_plain(depth, c, coords, v, gout, nx)
        if not v.any():
            assert not a[0].any() and not a[1].any()
            continue
        _close(a[0], ref[0], tol, f"S1-bwd d_depth{name}")
        _close(a[1], ref[1], tol, f"S1-bwd d_ctx{name}")
        assert not a[0][~v].any()
    gout_t = gout.t().contiguous().t()
    assert gout_t.stride() == (1, n_rows)
    before = scatter.BWD_LAUNCHES
    a = scatter._launch_bwd(depth, ctx, coords, valid, gout, nx)
    b = scatter._launch_bwd(depth, ctx, coords, valid, gout_t, nx)
    torch.cuda.synchronize()
    assert scatter.BWD_LAUNCHES == before + 2
    assert all(torch.equal(x, y) for x, y in zip(a, b)), "S1-bwd: transposed gradient"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [128, 7, 130])
def test_splat_rows_bwd_equals_the_plain_gather(cuda, dtype, C):
    """S1-rows-bwd (``_launch_rows_bwd``) bit for bit its plain version
    (the padded gather) at a hot voxel, with a misaligned gradient (narrower
    vectors), with the gradient as a transposed view (the kernel's own
    transpose) and with every point invalid (zeros); two calls bit-equal,
    one launch each."""
    from occformer_tpu_torch.ops import scatter

    feats, coords, valid, nx = _rows_inputs(cuda, dtype, C, seed=C)
    n_rows = feats.shape[0] * int(np.prod(nx))
    g = torch.randn((n_rows, C), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(C)).to(feats.dtype)
    for name, gg, v in (("", g, valid), (" misaligned", _misaligned(g), valid),
                        (" transposed", g.t().contiguous().t(), valid),
                        (" all invalid", g, torch.zeros_like(valid))):
        before = scatter.ROWS_BWD_LAUNCHES
        a = scatter._launch_rows_bwd(gg, coords, v, nx)
        b = scatter._launch_rows_bwd(gg, coords, v, nx)
        torch.cuda.synchronize()
        assert scatter.ROWS_BWD_LAUNCHES == before + 2
        assert torch.equal(a, b), f"S1-rows-bwd{name}: two calls differ"
        want = scatter.voxel_scatter_rows_backward_plain(gg, coords, v, nx)
        assert a.dtype == want.dtype and torch.equal(a, want), f"S1-rows-bwd{name}"


def _splat_in_stable_order(depth, ctx, coords, valid, nx):
    """S1's sum emulated in numpy: each voxel's points in
    ``torch.argsort(stable=True)`` order (``segments``), each term added as
    one fused multiply-add rounded to float32 (taken in numpy's long double,
    which holds a float32 product exactly), the volume rounded once to
    depth's dtype."""
    from occformer_tpu_torch.ops import scatter

    B, N, D, fH, fW = depth.shape
    C = ctx.shape[-1]
    n_rows = B * int(np.prod(nx))
    order, offsets = scatter.segments(scatter.voxel_rows(coords, valid, nx), n_rows)
    order, offsets = order.cpu().numpy(), offsets.cpu().numpy()
    d = depth.float().cpu().numpy().reshape(-1).astype(np.longdouble)
    c = ctx.float().cpu().numpy().reshape(-1, C).astype(np.longdouble)
    HW = fH * fW
    out = np.zeros((n_rows, C), np.float32)
    for r in np.nonzero(np.diff(offsets))[0]:
        acc = np.zeros(C, np.float32)
        for p in order[offsets[r]:offsets[r + 1]]:
            acc = (d[p] * c[p // (D * HW) * HW + p % HW] + acc).astype(np.float32)
        out[r] = acc
    return torch.from_numpy(out).to(depth.device).to(depth.dtype)


@pytest.mark.parametrize("depth_dtype,ctx_dtype", [("float32", "float32"), ("float32", "bfloat16"),
                                                   ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("C", [40, 128, 7])
def test_splat_sums_each_voxel_in_stable_sort_order(cuda, depth_dtype, ctx_dtype, C):
    """S1's volume equals, bit for bit, each voxel's sum taken in
    ``torch.argsort(stable=True)`` order (the order of the sort the kernel
    replaced): hot voxels of hundreds of points, a fifth of the points
    invalid, rows of 7 (narrow loads), 40 and 128 channels."""
    from occformer_tpu_torch.ops import scatter

    depth, ctx, coords, valid, nx = _splat_inputs(cuda, depth_dtype, ctx_dtype, C=C, seed=5)
    got = scatter.voxel_scatter_lifted(depth, ctx, coords, valid, nx)
    ref = _splat_in_stable_order(depth, ctx, coords, valid, nx)
    assert got.dtype == depth.dtype
    assert torch.equal(got.reshape(ref.shape), ref)


def test_batched_train_step_repeats_its_losses_and_loss_gradients(cuda):
    """The tiny CLI model's train step on the batched loss route, twice from
    one state: every loss and the gradients the loss hands to the model (of
    the class logits, mask embeddings and mask feature) bit-equal.  (K1-bwd's
    float32 reductions still move the parameters' gradients in their last
    bits.)"""
    import copy
    import os

    import occformer_tpu_torch.engine.train as train_mod
    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "occformer_tpu_torch", "configs", "synthetic_tiny.py"),
                      {"model.img_backbone.frozen_stages": 0})
    m = cfg["model"]
    batch = next(iter(build_dataloader(build_dataset(cfg["data"]["train"]), max_points=512)))
    batch.pop("_meta")
    model = build_model(m, device=cuda, seed=0).train()
    opt = build_optimizer_from_config(model, cfg, 16)
    step = build_train_step(model, opt, build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout="on"),
                                                       m["train_cfg"]["pts"]), device=cuda)
    state = copy.deepcopy((model.state_dict(), opt.state_dict()))
    orig = train_mod.mask2former_loss

    def run():
        grads = {}

        def loss(*args, **kwargs):
            for name, t in zip(("cls_preds", "mask_embeds", "mask_feature"), args[:3]):
                t.register_hook(lambda g, name=name: grads.__setitem__(name, g.clone()))
            return orig(*args, **kwargs)

        model.load_state_dict(state[0])
        opt.load_state_dict(state[1])
        before = k2.BWD_NARROW_LAUNCHES
        train_mod.mask2former_loss = loss
        try:
            metrics = step(batch, torch.Generator(device=cuda).manual_seed(1))
        finally:
            train_mod.mask2former_loss = orig
        assert k2.BWD_NARROW_LAUNCHES == before + 2
        return {k: float(v) for k, v in metrics.items() if "loss" in k}, grads

    (la, ga), (lb, gb) = run(), run()
    assert la == lb
    assert sorted(ga) == sorted(gb) == ["cls_preds", "mask_embeds", "mask_feature"]
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(6, 512, 16, 44), (6, 256, 56, 100), (6, 512, 28, 50)])
def test_k4_at_the_dcn_shapes(cuda, dtype, shape):
    """K4 and K4-bwd as the deformable convolutions run them: one level of
    Z = 1, 9 taps a pixel at offsets of up to 1.5 pixels, align_corners=True;
    the flagship DepthNet's [6, 16*44, 512], the R101-DCN's layer3 [6,
    56*100, 256] and layer4 [6, 28*50, 512]; two K4-bwd calls bit-equal."""
    from occformer_tpu_torch.tools.time_backwards import dcn_inputs

    dt = getattr(torch, dtype)
    tables, coords, C, spatials = dcn_inputs(dt, shape=shape)
    _k4_against_plain(tables, coords, spatials, C, True, dt)


@pytest.mark.parametrize("shape", [(2, 64, 4, 8), (6, 512, 16, 44)])
def test_dcn_on_k4_matches_its_plain_version(cuda, shape):
    """``models/dcn.py`` on the card (its taps through K4, the gradient
    through K4-bwd) against the same module on the CPU (K4's plain
    version), float32, at the tiny and the flagship DepthNet's widths:
    outputs within 1e-5 and the gradients in the input, the offsets' conv
    and the weight within 1e-4 of max |CPU|; two backwards bit-equal.  The
    offsets' convolution runs without TF32, as a float32 reference must."""
    from occformer_tpu_torch.models.dcn import DeformConv2d

    B, C, H, W = shape
    torch.manual_seed(0)
    cpu = DeformConv2d(C, C, 3, padding=1, groups=4)
    with torch.no_grad():
        cpu.conv_offset.weight.uniform_(-0.02, 0.02)
        cpu.conv_offset.bias.uniform_(-1.5, 1.5)
    gpu = DeformConv2d(C, C, 3, padding=1, groups=4).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    gout = torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def run(module, dev):
        module.zero_grad()
        xl = x.to(dev).requires_grad_(True)
        before = (k1.MULTI_LAUNCHES, k1.MULTI_BWD_LAUNCHES)
        out = module(xl)
        out.backward(gout.to(dev))
        launched = (k1.MULTI_LAUNCHES - before[0], k1.MULTI_BWD_LAUNCHES - before[1])
        return [t.detach().cpu() for t in (out, xl.grad, module.conv_offset.weight.grad,
                                           module.conv_offset.bias.grad, module.weight.grad)], \
            launched

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        got, launched = run(gpu, cuda)
        again, _ = run(gpu, cuda)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    ref, none = run(cpu, "cpu")
    assert launched == (1, 1) and none == (0, 0)
    for name, g, a, r in zip(("output", "d_input", "d_offset_weight", "d_offset_bias",
                              "d_weight"), got, again, ref):
        assert torch.equal(g, a), f"{name}: two calls differ"
        _close(g, r, 1e-5 if name == "output" else 1e-4, name)


@pytest.mark.parametrize("shape,stride,deform_groups,cudnn_default", [
    ((2, 64, 9, 11), 2, 2, False), ((2, 64, 9, 11), 1, 1, False),
    ((2, 256, 28, 50), 1, 1, True)])
def test_dcnv2_on_k4_matches_its_plain_version(cuda, shape, stride, deform_groups,
                                               cudnn_default):
    """The R101-DCN backbone's modulated convolution (``models/dcn.py`` with
    ``modulated=True``: K4's samples scaled by the mask's sigmoid) on the
    card against the same module on the CPU, float32, at stride 1 and 2 and
    at 1 and 2 deform groups (the batch of K4's one call is (image, group)),
    and at half the layer3 map of the R101's cameras: outputs within 1e-5
    and the gradients in the input, the offsets' and mask's conv and the
    weight within 1e-4 of max |CPU|; one K4 and one K4-bwd a call; two
    backwards bit-equal.  Without TF32, as a float32 reference must run.
    The small maps run cuDNN's deterministic algorithms: there cuDNN's
    default backward for the offsets' 27-channel convolution adds the
    input's gradient in an order that varies from call to call (64 channels
    at 9 x 11, stride 1: 3 of 3 repeats differed on an H100 80GB HBM3 at
    700 W); at the R101's maps its default repeats (ROADMAP C, the note on
    cuDNN's defaults), so the R101-width case runs on the defaults."""
    from occformer_tpu_torch.models.dcn import DeformConv2d

    B, C, H, W = shape
    torch.manual_seed(0)
    cpu = DeformConv2d(C, C, 3, stride=stride, padding=1, deform_groups=deform_groups,
                       modulated=True)
    with torch.no_grad():
        cpu.conv_offset.weight.uniform_(-0.02, 0.02)
        cpu.conv_offset.bias.uniform_(-1.5, 1.5)
    gpu = DeformConv2d(C, C, 3, stride=stride, padding=1, deform_groups=deform_groups,
                       modulated=True).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    oh, ow = (H - 1) // stride + 1, (W - 1) // stride + 1
    gout = torch.from_numpy(rng.randn(B, C, oh, ow).astype(np.float32))

    def run(module, dev):
        module.zero_grad()
        xl = x.to(dev).requires_grad_(True)
        before = (k1.MULTI_LAUNCHES, k1.MULTI_BWD_LAUNCHES)
        out = module(xl)
        out.backward(gout.to(dev))
        launched = (k1.MULTI_LAUNCHES - before[0], k1.MULTI_BWD_LAUNCHES - before[1])
        return [t.detach().cpu() for t in (out, xl.grad, module.conv_offset.weight.grad,
                                           module.conv_offset.bias.grad, module.weight.grad)], \
            launched

    tf32, det = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = not cudnn_default
    try:
        got, launched = run(gpu, cuda)
        again, _ = run(gpu, cuda)
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det
    ref, none = run(cpu, "cpu")
    assert launched == (1, 1) and none == (0, 0)
    for name, g, a, r in zip(("output", "d_input", "d_offset_weight", "d_offset_bias",
                              "d_weight"), got, again, ref):
        assert torch.equal(g, a), f"{name}: two calls differ"
        _close(g, r, 1e-5 if name == "output" else 1e-4, name)


@pytest.mark.parametrize("dilation", [12, 18])
def test_conv2d_im2col_backward_repeats_at_the_depthnet_shapes(cuda, dilation):
    """The DepthNet's dilated ASPP convolution under bf16 autocast
    ([6, 512, 16, 44]): its im2col backward gives the same bits in two
    calls, and cuDNN's gradients within 1e-2 of max |cuDNN|."""
    from occformer_tpu_torch.models.layers import Conv2dIm2colBackward

    torch.manual_seed(dilation)
    conv = Conv2dIm2colBackward(512, 512, 3, padding=dilation, dilation=dilation,
                                bias=False).to(cuda)
    plain = torch.nn.Conv2d(512, 512, 3, padding=dilation, dilation=dilation, bias=False).to(cuda)
    plain.load_state_dict(conv.state_dict())
    gen = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((6, 512, 16, 44), device=cuda, generator=gen)
    gout = torch.randn((6, 512, 16, 44), device=cuda, generator=gen).to(torch.bfloat16)

    def grads(module):
        xl = x.clone().requires_grad_(True)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            out = module(xl)
        return [out.detach()] + list(torch.autograd.grad(out, (xl, module.weight), gout))

    got, again, ref = grads(conv), grads(conv), grads(plain)
    for name, g, a, r in zip(("output", "d_input", "d_weight"), got, again, ref):
        assert torch.equal(g, a), f"{name}: two calls differ"
        _close(g, r, 1e-2, name)


def test_fixed_order_modules_repeat_on_the_card(cuda):
    """The occupancy encoder's input convolution (cuDNN's deterministic
    backward) and the Swin window attention give the same gradients in
    four backwards, float32."""
    from occformer_tpu_torch.models.layers import Conv3dFixedOrderBackward
    from occformer_tpu_torch.models.swin import WindowMSA

    torch.manual_seed(0)
    gen = torch.Generator(device=cuda).manual_seed(3)
    for module, shape in ((Conv3dFixedOrderBackward(32, 64, 3, stride=2, padding=1,
                                                    bias=False), (1, 32, 8, 8, 4)),
                          (WindowMSA(64, 2, 7), (32, 49, 64))):
        module = module.to(cuda)
        with torch.no_grad():
            for p in module.parameters():
                p.uniform_(-0.1, 0.1)
        x = torch.randn(shape, device=cuda, generator=gen)
        out = module(x.clone().requires_grad_(True))
        gout = torch.randn(out.shape, device=cuda, generator=gen)
        runs = []
        for _ in range(4):
            xl = x.clone().requires_grad_(True)
            runs.append(torch.autograd.grad(module(xl), [xl] + list(module.parameters()), gout))
        for r in runs[1:]:
            assert all(torch.equal(a, b) for a, b in zip(runs[0], r)), type(module).__name__


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
    # the same state and inputs: the forward and the backward sum in a fixed
    # order (S1, K1-bwd, K4-bwd, the fixed-order convolutions; ROADMAP
    # C.4-C.8), so every loss and grad_norm repeats bit for bit
    m1 = step(batch, torch.Generator(device=cuda).manual_seed(1))
    m2 = step2(batch, torch.Generator(device=cuda).manual_seed(1))
    for k, v in m1.items():
        assert float(m2[k]) == float(v), k


# ---------------------------------------------------------------------------
# the temporal slice: BEVStereo's warps and shift_feature through K4, the
# "SAME" transposed convolution, BEVStereo on the card
# ---------------------------------------------------------------------------

# [G, H, W, C, hypotheses a pixel]: the stereo warp of a ResNet layer1's
# features at 1/4 of 256 x 704 (6 cameras, 3 depth samples), the mask's warp
# of the 112-bin mono depth at 1/16, shift_feature over a 128 x 128 BEV map
WARP_SHAPES = {"stereo": (6, 64, 176, 256, 3), "mask": (6, 16, 44, 112, 1),
               "bev": (1, 128, 128, 128, 1)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize("case", list(WARP_SHAPES))
def test_k4_at_the_warp_and_shift_shapes(cuda, case, align_corners, dtype):
    """K4 and K4-bwd as ``models/bevstereo.py``'s warps and
    ``models/lss.py:shift_feature`` run them: one level of Z = 1, the
    channels-last table [G, H*W, C] (C = 256 and 112 on the row-wide path),
    (y, x, 0) coordinates uniform in [-1.15, 1.15] (points off the image),
    against the plain version and its autograd; then K4-bwd without
    d_coords (the warp's grid carries no gradient) gives the same d_table
    bits."""
    G, H, W, C, S = WARP_SHAPES[case]
    dt = getattr(torch, dtype)
    rng = np.random.RandomState(3)
    table = torch.from_numpy(rng.randn(G, H * W, C).astype(np.float32)).to(cuda, dt)
    yx = rng.uniform(-1.15, 1.15, (G, S * H * W, 2)).astype(np.float32)
    coords = torch.from_numpy(np.concatenate([yx, np.zeros_like(yx[..., :1])], -1)).to(cuda)
    spatials = [(H, W, 1)]
    assert k1.multi_fwd_path(C, dt, [table.data_ptr()]) == 16
    _k4_against_plain([table], [coords], spatials, C, align_corners, dt)
    gen = torch.Generator(device=cuda).manual_seed(2)
    gout = [torch.randn((G, C, S * H * W), device=cuda, generator=gen).to(dt)]
    with_coords, _ = k1._launch_multi_bwd([table], spatials, C, [coords], gout, align_corners,
                                          True)
    without, none = k1._launch_multi_bwd([table], spatials, C, [coords], gout, align_corners,
                                         False)
    assert none is None and torch.equal(with_coords[0], without[0])


def test_same_conv_transpose_on_the_card(cuda):
    """``models/bevstereo.py:_SameConvTranspose2d`` (flax's stride-2 "SAME"
    transposed convolution) on the card against the CPU, float32 without
    TF32, on odd and even sides: output 2x the input, within 1e-5 of max
    |CPU|, the input's, weight's and bias's gradients within 1e-4."""
    from occformer_tpu_torch.models.bevstereo import _SameConvTranspose2d

    torch.manual_seed(0)
    cpu = _SameConvTranspose2d(64)
    gpu = _SameConvTranspose2d(64).to(cuda)
    gpu.load_state_dict(cpu.state_dict())
    rng = np.random.RandomState(4)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        for hw in ((16, 44), (5, 7)):
            x = torch.from_numpy(rng.randn(2, 64, *hw).astype(np.float32))
            gout = torch.from_numpy(rng.randn(2, 64, 2 * hw[0], 2 * hw[1]).astype(np.float32))
            res = []
            for module, dev in ((gpu, cuda), (cpu, "cpu")):
                module.zero_grad()
                xl = x.to(dev).requires_grad_(True)
                out = module(xl)
                out.backward(gout.to(dev))
                res.append([t.detach().cpu() for t in (out, xl.grad, module.weight.grad,
                                                        module.bias.grad)])
            assert res[0][0].shape == (2, 64, 2 * hw[0], 2 * hw[1])
            for name, g, r, rel in zip(("output", "d_input", "d_weight", "d_bias"), *res,
                                       (1e-5, 1e-4, 1e-4, 1e-4)):
                _close(g, r, rel, f"{name} at {hw}")
    finally:
        torch.backends.cudnn.allow_tf32 = tf32


def _stereo_case(dev, seed=0):
    """The tiny BEVStereo of tests/test_torch_bevstereo.py (64 x 96 image, 16
    depth bins in two ranges, two EM steps, four groups) with a seeded
    init, and two sweeps' inputs: image features, camera embeddings, stereo
    features, matrices, the lift-splat's cameras."""
    from occformer_tpu_torch.models.bevstereo import ViewTransformerLSSBEVStereo
    from occformer_tpu_torch.models.detector import init_weights

    grid = {"xbound": [-8.0, 8.0, 2.0], "ybound": [-8.0, 8.0, 2.0],
            "zbound": [-2.0, 2.0, 1.0], "dbound": [2.0, 10.0, 0.5]}
    module = ViewTransformerLSSBEVStereo(
        grid, {"input_size": (64, 96)}, numC_input=16, numC_Trans=8, num_ranges=2,
        range_list=((2.0, 6.0), (6.0, 10.0)), em_iteration=2, num_groups=4)
    init_weights(module, torch.Generator().manual_seed(seed))
    rng = np.random.RandomState(seed)
    bn = 2
    t = lambda *shape: torch.from_numpy(rng.randn(*shape).astype(np.float32))

    def mats():
        intrin = np.tile(np.eye(4, dtype=np.float32), (bn, 1, 1))
        intrin[:, 0, 0] = intrin[:, 1, 1] = 40.0
        intrin[:, 0, 2], intrin[:, 1, 2] = 48.0, 32.0
        ida = np.tile(np.eye(4, dtype=np.float32), (bn, 1, 1))
        ida[:, :2, 3] = rng.uniform(-1, 1, (bn, 2))
        s2s = np.tile(np.eye(4, dtype=np.float32), (bn, 1, 1))
        s2s[:, :3, 3] = rng.uniform(-0.15, 0.15, (bn, 3))
        return intrin, ida, s2s

    ints, idas, s2ss = zip(*(mats() for _ in range(2)))
    fwd = np.array([[0, 0, 1], [-1, 0, 0], [0, -1, 0]], np.float32)
    rots = np.stack([fwd, np.diag([-1.0, -1.0, 1.0]).astype(np.float32) @ fwd])[None]
    intrins = np.tile(np.diag([40.0, 40.0, 1.0]).astype(np.float32), (1, 2, 1, 1))
    intrins[..., 0, 2], intrins[..., 1, 2] = 48.0, 32.0
    eye = np.tile(np.eye(3, dtype=np.float32), (1, 2, 1, 1))
    cams = [rots, np.zeros((1, 2, 3), np.float32), intrins, eye, np.zeros((1, 2, 3), np.float32),
            np.eye(3, dtype=np.float32)[None]]
    inputs = {"xs": [t(bn, 16, 4, 6) for _ in range(2)], "mlps": [t(bn, 27) for _ in range(2)],
              "feats": [t(bn, 8, 16, 24) for _ in range(2)],
              "mats": {"intrin_mats": np.stack(ints, 1), "ida_mats": np.stack(idas, 1),
                       "sensor2sensor_mats": np.stack(s2ss, 1)},
              "cams": cams, "w": t(bn, 16, 4, 6)}
    return module.to(dev).train(), inputs


def _stereo_run(module, inputs, dev):
    """Each sweep's DepthNet, ``forward_stereo``, ``fuse_depth``, the splat;
    the backward of a fixed weighting of the depth probabilities.  Returns
    the outputs, the inputs' and parameters' gradients, the K4 / K4-bwd / S1
    launches."""
    from occformer_tpu_torch.ops import scatter

    module.zero_grad()
    to = lambda a: torch.as_tensor(a).to(dev)
    xs = [to(x).requires_grad_(True) for x in inputs["xs"]]
    feats = [to(f).requires_grad_(True) for f in inputs["feats"]]
    mlps = [to(m) for m in inputs["mlps"]]
    mats = {k: to(v) for k, v in inputs["mats"].items()}
    before = (k1.MULTI_LAUNCHES, k1.MULTI_BWD_LAUNCHES, scatter.LAUNCHES)
    outs = [module.depth_net(x, m) for x, m in zip(xs, mlps)]
    _, ctxs, mus, sigmas, rss, monos = (list(o) for o in zip(*outs))
    sd, ms = module.forward_stereo(0, feats, monos, mats, mus, sigmas, rss)
    prob = module.fuse_depth(monos[0], sd, ms)
    vol = module(ctxs[0].reshape(1, 2, 8, 4, 6), prob, *[to(c) for c in inputs["cams"]])
    (prob * to(inputs["w"])).sum().backward()
    launched = (k1.MULTI_LAUNCHES - before[0], k1.MULTI_BWD_LAUNCHES - before[1],
                scatter.LAUNCHES - before[2])
    grads = {"feat0": feats[0].grad, "feat1": feats[1].grad, "x0": xs[0].grad}
    grads.update({k: p.grad for k, p in module.named_parameters() if p.grad is not None})
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}
    return cpu({"stereo_depth": sd, "mask_score": ms, "depth_prob": prob, "volume": vol}), \
        cpu(grads), launched


def test_bevstereo_on_the_card_matches_the_cpu(cuda):
    """The tiny BEVStereo in train mode on the card (its warps and DCN
    through K4, their gradients through K4-bwd, the splat through S1)
    against the same module on the CPU (the plain versions), float32 without
    TF32: outputs within 1e-4 of max |CPU|, every gradient within 1e-3 (two
    EM steps of softmaxes; those that are 0 up to rounding within 1e-5 of the
    largest, as tests/test_torch_bevstereo.py holds them); K4 8 times (4 stereo warps, 2 mask warps, 2
    DCNs), K4-bwd 5 (the stereo warps and the key sweep's DCN: the other
    sweep's DepthNet reaches the depth only through the mask's detached
    input), S1 once.  Then two runs with cuDNN's deterministic algorithms
    repeat every output and gradient bit for bit: the port's own sums
    (K4-bwd, S1, the reductions) repeat.  (At these tiny shapes cuDNN's
    default backward of the mask net's 64-channel convolutions varies, TF32
    on or off, ROADMAP §C; at full width ``chip_smoke.py``'s ``stereo``
    phase holds the port's default settings bit for bit.)"""
    tf32, det = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    try:
        torch.backends.cudnn.allow_tf32 = False
        gpu, inputs = _stereo_case(cuda)
        out, grads, launched = _stereo_run(gpu, inputs, cuda)
        torch.backends.cudnn.deterministic = True
        runs = [_stereo_run(_stereo_case(cuda)[0], inputs, cuda)[:2] for _ in range(2)]
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = tf32, det
    cpu, _ = _stereo_case("cpu")
    ref, ref_grads, none = _stereo_run(cpu, inputs, "cpu")
    assert launched == (8, 5, 1) and none == (0, 0, 0)
    for k, r in ref.items():
        _close(out[k], r, 1e-4, k)
    assert set(grads) == set(ref_grads) and len(grads) > 60
    # gradients that are 0 up to rounding (the similarity's output bias: the
    # softmax over the samples ignores a constant; the biases of the
    # convolutions a train-mode BatchNorm follows) within 1e-5 of the largest
    flat = {f"{m}.bias" for m in ("sim_out", "depth_net.reduce_conv", "depth_net.msr_up0",
                                  "depth_net.msr_up1", "dds_conv1", "dds_conv2", "mask_conv")}
    top = max(r.abs().max().item() for r in ref_grads.values())
    for k, r in ref_grads.items():
        if k in flat:
            assert max(grads[k].abs().max().item(), r.abs().max().item()) <= 1e-5 * top, k
        else:
            _close(grads[k], r, 1e-3, f"d {k}")
    (a, da), (b, db) = runs
    differ = [k for k in a if not torch.equal(a[k], b[k])] + \
        [f"d {k}" for k in da if not torch.equal(da[k], db[k])]
    assert not differ, f"two runs differ in {differ}"


def _rows_inputs(dev, dtype, C=128, seed=0):
    """S1-rows' inputs: rows [2, 900, C], a third of them in one hot voxel
    (its heavy path), coordinates outside the grid (clamped), a fifth
    invalid, most voxels empty."""
    rng = np.random.RandomState(seed)
    B, P, nx = 2, 900, (6, 5, 4)
    feats = torch.from_numpy(rng.randn(B, P, C).astype(np.float32))
    coords = rng.randint(-1, 7, (B, P, 3))
    coords[:, ::3] = (2, 3, 1)
    valid = rng.rand(B, P) > 0.2
    return (feats.to(dev, getattr(torch, dtype)),
            torch.from_numpy(coords.astype(np.int32)).to(dev), torch.from_numpy(valid).to(dev),
            nx)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [128, 40, 7])
def test_splat_rows_matches_plain_and_repeats_itself(cuda, dtype, C):
    """S1-rows (``voxel_scatter``, the use_voxel_net splat) equals its plain
    version run on the CPU bit for bit (one index_add_ into float32 rows in
    point order: the kernel's order), is within tolerance of the plain
    version on the card (atomic), repeats itself over two calls, and its
    backward (one launch of S1-rows-bwd) is the plain gather d_feats[p] =
    g[row p] bit for bit."""
    import torch.nn.functional as F

    from occformer_tpu_torch.ops import scatter

    feats, coords, valid, nx = _rows_inputs(cuda, dtype, C)
    n_rows = feats.shape[0] * int(np.prod(nx))
    rows = scatter.voxel_rows(coords, valid, nx)
    g = torch.randn((feats.shape[0], *nx, C), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(3)).to(feats.dtype)
    runs = []
    for _ in range(2):
        f = feats.detach().clone().requires_grad_(True)
        before, before_bwd = scatter.ROWS_LAUNCHES, scatter.ROWS_BWD_LAUNCHES
        out = scatter.voxel_scatter(f, coords, valid, nx)
        (d,) = torch.autograd.grad(out, f, g)
        torch.cuda.synchronize()
        assert scatter.ROWS_LAUNCHES == before + 1 and out.dtype == feats.dtype
        assert scatter.ROWS_BWD_LAUNCHES == before_bwd + 1  # the backward is S1-rows-bwd
        runs.append((out, d))
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    cpu = scatter.voxel_scatter_plain_rows(feats.cpu(), rows.cpu(), n_rows).to(feats.dtype)
    assert torch.equal(runs[0][0].reshape(n_rows, C).cpu(), cpu)
    on_card = scatter.voxel_scatter_plain_rows(feats, rows, n_rows)
    _close(runs[0][0].reshape(n_rows, C), on_card, _tol(feats.dtype), "S1-rows volume")
    want = F.pad(g.reshape(n_rows, C), (0, 0, 0, 1)).index_select(0, rows.reshape(-1))
    assert torch.equal(runs[0][1].reshape(-1, C), want)
    assert not runs[0][1][~valid].any()


@pytest.mark.parametrize("N", [100, 3000, 40000])
def test_fps_matches_plain(cuda, N):
    """FPS against its plain version, indices equal: clouds that fit one
    point a thread, several a thread (registers) and more than 32 a thread
    (the global workspace); with a third of the points invalid (never taken
    while a valid one is left); on a lattice, whose equal distances are
    ties that go to the lowest index; more samples than valid points."""
    from occformer_tpu_torch.ops import pointcloud as pc

    gen = torch.Generator(device=cuda).manual_seed(N)
    xyz = torch.rand((3, N, 3), device=cuda, generator=gen) * 4
    valid = torch.rand((3, N), device=cuda, generator=gen) > 0.33
    npoint = min(N, 256)
    for v in (None, valid):
        before = pc.FPS_LAUNCHES
        got = pc.furthest_point_sample(xyz, npoint, v)
        assert pc.FPS_LAUNCHES == before + 1 and got.dtype == torch.int32
        assert torch.equal(got, pc.furthest_point_sample_plain(xyz, npoint, v))
        assert torch.equal(got, pc.furthest_point_sample_plain(xyz.cpu(), npoint,
                                                               None if v is None else v.cpu())
                           .to(cuda))
    taken = torch.gather(valid, 1, got.long()[:, 1:])
    assert taken.all()
    side = max(2, round(N ** (1 / 3)))
    r = torch.arange(side, device=cuda, dtype=torch.float32)
    lattice = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(1, -1, 3)
    n = lattice.shape[1]
    few = torch.zeros((1, n), dtype=torch.bool, device=cuda)
    few[0, ::7] = True
    for v in (None, few):
        k = min(n, 300)
        assert torch.equal(pc.furthest_point_sample(lattice, k, v),
                           pc.furthest_point_sample_plain(lattice, k, v))


# (clouds, points, samples) of the FPS kernel's edges: one point and one
# sample; fewer points than a cluster's CTAs have threads (CTAs with no
# points); a count no cluster size splits evenly; VoteNet's SA1 size; more
# clouds than the card holds clusters at once (waves)
FPS_EDGES = [(1, 1, 1), (2, 5, 8), (3, 1003, 64), (8, 20000, 256), (40, 3000, 32)]


@pytest.mark.parametrize("cluster", [0, 1, 2, 4, 8, 16])
def test_fps_cluster_sizes_match_plain(cuda, cluster):
    """The FPS kernel at each thread-block cluster size its launcher can take
    (forced through the kernel entry point's ``cluster`` argument; 0: the
    launcher's choice) equals the plain version, with and without invalid
    points, at the edges of ``FPS_EDGES`` (40 clouds of 16-CTA clusters are
    640 CTAs, about five waves), with more samples than valid points, on a
    cloud with no valid point and on a lattice (ties)."""
    from occformer_tpu_torch.ops import pointcloud as pc

    gen = torch.Generator(device=cuda).manual_seed(cluster)
    cases = []
    for B, N, npoint in FPS_EDGES:
        xyz = torch.rand((B, N, 3), device=cuda, generator=gen) * 4
        cases.append((xyz, npoint, None))
        cases.append((xyz, npoint, torch.rand((B, N), device=cuda, generator=gen) > 0.33))
    xyz = torch.rand((2, 300, 3), device=cuda, generator=gen)
    few = torch.zeros((2, 300), dtype=torch.bool, device=cuda)
    few[0, [5, 77, 210]] = True  # 8 samples of 3 valid points; no valid point in cloud 1
    cases.append((xyz, 8, few))
    r = torch.arange(9, device=cuda, dtype=torch.float32)
    lattice = torch.stack(torch.meshgrid(r, r, r, indexing="ij"), -1).reshape(1, -1, 3)
    cases.append((lattice, 200, None))
    cases.append((lattice, 200, torch.arange(729, device=cuda)[None] % 5 != 2))
    for xyz, npoint, v in cases:
        before = pc.FPS_LAUNCHES
        got = pc._launch_fps(xyz, npoint, v, cluster)
        assert pc.FPS_LAUNCHES == before + 1 and got.dtype == torch.int32
        assert pc.FPS_CLUSTER == cluster or (cluster == 0 and pc.FPS_CLUSTER in (1, 2, 4, 8, 16))
        want = pc.furthest_point_sample_plain(xyz, npoint, v)
        assert torch.equal(got, want), (tuple(xyz.shape), npoint, v is not None)
    assert (got[:, 1:] % 5 != 2).all()


def test_fps_large_cloud_path_matches_plain(cuda):
    """Clouds whose slices exceed what a thread keeps in registers (over
    16 x 8192 points, or over 8192 at a forced cluster of one CTA) keep their
    distances in the global workspace: the same indices as the plain
    version."""
    from occformer_tpu_torch.ops import pointcloud as pc

    gen = torch.Generator(device=cuda).manual_seed(9)
    xyz = torch.rand((2, 140000, 3), device=cuda, generator=gen) * 10
    valid = torch.rand((2, 140000), device=cuda, generator=gen) > 0.5
    for v in (None, valid):
        assert torch.equal(pc.furthest_point_sample(xyz, 48, v),
                           pc.furthest_point_sample_plain(xyz, 48, v))
        small = xyz[:, :9000].contiguous()
        sv = None if v is None else v[:, :9000].contiguous()
        assert torch.equal(pc._launch_fps(small, 48, sv, 1),
                           pc.furthest_point_sample_plain(small, 48, sv))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("C", [128, 40, 7])
def test_splat_rows_edges_match_cpu_plain(cuda, dtype, C):
    """S1-rows bit for bit the plain version on the CPU, two calls bit-equal,
    at a voxel of more than 1,024 rows (its rows span many of the splat's
    stages), over two batch items, with every row invalid (a volume of
    zeros), and with rows not 16-byte aligned in memory (gathered by plain
    loads instead of bulk copies)."""
    from occformer_tpu_torch.ops import scatter

    rng = np.random.RandomState(C)
    dt = getattr(torch, dtype)
    B, P, nx = 2, 3000, (8, 6, 5)
    coords = rng.randint(-1, 9, (B, P, 3))
    coords[0, :2500] = (3, 2, 1)
    coords = torch.from_numpy(coords.astype(np.int32)).to(cuda)
    valid = torch.from_numpy(rng.rand(B, P) > 0.1).to(cuda)
    feats = torch.from_numpy(rng.randn(B, P, C).astype(np.float32)).to(cuda, dt)
    unaligned = torch.empty(feats.numel() + 1, dtype=dt, device=cuda)[1:].view_as(feats)
    unaligned.copy_(feats)
    n_rows = B * int(np.prod(nx))
    for f, v in ((feats, valid), (feats, torch.zeros_like(valid)), (unaligned, valid)):
        rows = scatter.voxel_rows(coords, v, nx)
        assert int(torch.bincount(rows.reshape(-1)).max()) > 1024 or not v.any()
        before = scatter.ROWS_LAUNCHES
        a = scatter.voxel_scatter(f, coords, v, nx)
        b = scatter.voxel_scatter(f, coords, v, nx)
        torch.cuda.synchronize()
        assert scatter.ROWS_LAUNCHES == before + 2 and torch.equal(a, b)
        cpu = scatter.voxel_scatter_plain_rows(f.cpu(), rows.cpu(), n_rows).to(dt)
        assert torch.equal(a.reshape(n_rows, C).cpu(), cpu)
        if not v.any():
            assert not a.any()


def test_voxnet_tiny_train_step_repeats_itself(cuda):
    """The tiny CLI model with use_voxel_net and trilinear attention masks:
    its train step on the per-layer route takes S1-rows (no S1), and two
    steps from one state give every loss and every parameter's gradient bit
    for bit (cuDNN's deterministic algorithms, as the other tiny-width
    repeats here: at tiny widths some convolutions' default backward varies,
    ROADMAP §C)."""
    import copy
    import os

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.loader import build_dataloader, build_dataset
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.ops import scatter

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "occformer_tpu_torch", "configs", "synthetic_tiny.py"),
                      {"model.img_view_transformer.use_voxel_net": True,
                       "model.pts_bbox_head.pooling_attn_mask": False})
    m = cfg["model"]
    batch = next(iter(build_dataloader(build_dataset(cfg["data"]["train"]), max_points=512)))
    batch.pop("_meta")
    model = build_model(m, device=cuda, seed=0).train()
    opt = build_optimizer_from_config(model, cfg, 16)
    step = build_train_step(model, opt, build_loss_cfg(dict(m["pts_bbox_head"], mxu_readout="off"),
                                                       m["train_cfg"]["pts"]), device=cuda)
    state = copy.deepcopy((model.state_dict(), opt.state_dict()))

    def run():
        model.load_state_dict(state[0])
        opt.load_state_dict(state[1])
        grads = []
        orig = opt.step

        def keep_grads():
            grads.extend(p.grad.detach().clone() for p in model.parameters()
                         if p.grad is not None)
            return orig()

        opt.step = keep_grads
        before = (scatter.LAUNCHES, scatter.ROWS_LAUNCHES)
        try:
            metrics = step(batch, torch.Generator(device=cuda).manual_seed(1))
        finally:
            del opt.step
        assert (scatter.LAUNCHES, scatter.ROWS_LAUNCHES) == (before[0], before[1] + 1)
        return {k: float(v) for k, v in metrics.items() if "loss" in k}, grads

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        (la, ga), (lb, gb) = run(), run()
    finally:
        torch.backends.cudnn.deterministic = det
    assert la == lb and all(v == v for v in la.values())
    assert len(ga) == len(gb) > 0
    da = model.img_view_transformer.depth_aggregation_net
    assert da.reduce_conv.weight.grad is not None
    for a, b in zip(ga, gb):
        assert torch.equal(a, b)


def test_analytic_count_on_the_card_equals_the_plain_versions(cuda):
    """``utils/flops.py``'s count of a tiny frame (the deployment forward)
    and of a tiny train step on the card, with the kernels, equals the count
    on the CPU with the plain versions: K1 (forward and backward), S1 and
    the im2col backward of the DepthNet's dilated convolutions report what
    their plain versions run."""
    import os

    from occformer_tpu_torch.config import load_config
    from occformer_tpu_torch.data.synthetic import make_serving_batch, make_train_batch
    from occformer_tpu_torch.engine.optim import build_optimizer_from_config
    from occformer_tpu_torch.engine.train import build_loss_cfg, build_train_step
    from occformer_tpu_torch.models.detector import build_model
    from occformer_tpu_torch.tools.model_analysis import forward_flops
    from occformer_tpu_torch.utils.flops import count_flops

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg = load_config(os.path.join(repo, "occformer_tpu_torch", "configs", "synthetic_tiny.py"))
    m = cfg["model"]
    counts = {}
    for dev in (torch.device("cpu"), cuda):
        before = k1.LAUNCHES
        model = build_model(m, device=dev, seed=0)
        fwd = forward_flops(model, make_serving_batch(cfg, seed=0))
        step = build_train_step(model.train(), build_optimizer_from_config(model, cfg, 16),
                                build_loss_cfg(m["pts_bbox_head"], m["train_cfg"]["pts"]),
                                device=dev)
        train = count_flops(step, make_train_batch(cfg, seed=0),
                            torch.Generator(device=dev).manual_seed(0))
        counts[dev.type] = (fwd, train, k1.LAUNCHES - before)
    assert counts["cpu"][2] == 0 and counts["cuda"][2] > 0  # the kernels ran on the card
    for i in (0, 1):
        assert counts["cuda"][i] == counts["cpu"][i] and counts["cpu"][i]["total"] > 0
