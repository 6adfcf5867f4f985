"""K1's CUDA kernel against its plain version, on the card.

These tests need a CUDA device and skip without one; the kernel has no CPU
mode.  The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest tests/test_torch_gpu.py -q

Tolerances: float32 within 1e-5 * max|plain| (the same float32 sum in
another order); bfloat16 within 1e-2 * max|plain| (the kernel rounds its
output to bf16; the plain version runs in float32 on the same bf16 inputs).
"""
import numpy as np
import pytest
import torch

from occformer_tpu_torch.ops import trilerp_fused as k1

SHAPES = [(4, 4, 2), (2, 2, 2), (8, 6, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


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
    tol = (1e-5 if dt == torch.float32 else 1e-2) * ref.abs().max().item()
    assert (got.float() - ref).abs().max().item() <= tol


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
