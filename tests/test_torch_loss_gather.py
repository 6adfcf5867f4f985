"""The port's ``ops/loss_gather.py`` against the JAX package's.

* K3's plain version (``sample_id_masks_plain``, what the CPU runs and what
  the card's kernel is held to) against JAX ``_sample_id_masks``, in both
  padding modes, both ``align_corners``, on grids whose sides are and are not
  powers of two, with points outside [0, 1] and labels outside the slot ids
  (255); shared and per-slot points.
* The same against the Pallas kernel, ``labels_to_masks(gather_corner_labels(
  ..., interpret=True))`` (JAX ``mask2former_loss.py:458-479``, ``:596-614``):
  only with border padding on power-of-two grids, since the Pallas kernel
  always clamps to the border and its round trip through [-1, 1] can move
  ``floor()`` by one elsewhere.
* ``row_key`` and ``sort_points_by_row``: the same order as JAX's to the last
  index, with many points sharing a row.

Tolerance 1e-6 for the masks: both sides add the same 8 float32 weights in
the same order.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from occformer_tpu.losses.mask2former_loss import _corner_weights, _sample_id_masks
from occformer_tpu.ops.loss_gather import gather_corner_labels
from occformer_tpu.ops.loss_gather import row_key as jax_row_key
from occformer_tpu.ops.loss_gather import sort_points_by_row as jax_sort_points_by_row
from occformer_tpu_torch.ops.loss_gather import (
    row_key,
    sample_id_masks,
    sample_id_masks_plain,
    sort_points_by_row,
)

B, L, G = 2, 2, 5
N = L * B


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(spatial, seed=0, S=300, P=40):
    rng = np.random.RandomState(seed)
    grid = rng.randint(0, G + 2, (B, *spatial)).astype(np.int32)
    grid[:, :2] = 255
    ids = np.stack([np.arange(G), np.arange(G)[::-1]]).astype(np.int32)
    shared = rng.uniform(-0.15, 1.15, (N, S, 3)).astype(np.float32)
    per_slot = rng.uniform(-0.15, 1.15, (N, G, P, 3)).astype(np.float32)
    return grid, ids, shared, per_slot


def _jax_id_masks(grid, ids, shared, per_slot, align, padding):
    """JAX ``_sample_id_masks`` per entry n (grid n % B): shared [N, G, S]
    and per-slot [N, G, P] (each slot against its own id)."""
    out_s, out_p = [], []
    for n in range(N):
        b = n % B
        g, i = jnp.asarray(grid[b]), jnp.asarray(ids[b])
        out_s.append(np.asarray(_sample_id_masks(g, i, jnp.asarray(shared[n]), align,
                                                 padding)).T)
        out_p.append(np.stack([np.asarray(_sample_id_masks(
            g, i[k:k + 1], jnp.asarray(per_slot[n, k]), align, padding))[:, 0]
            for k in range(G)]))
    return np.stack(out_s), np.stack(out_p)


@pytest.mark.parametrize("spatial", [(16, 8, 4), (10, 6, 5)])
@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("padding", ["border", "zeros"])
def test_k3_plain_matches_jax_sample_id_masks(spatial, align, padding):
    grid, ids, shared, per_slot = _inputs(spatial)
    want_s, want_p = _jax_id_masks(grid, ids, shared, per_slot, align, padding)
    t = {k: torch.from_numpy(v) for k, v in
         dict(grid=grid, ids=ids, shared=shared, per_slot=per_slot).items()}
    got_s = sample_id_masks(t["grid"], t["ids"], t["shared"], align, padding)
    got_p = sample_id_masks(t["grid"], t["ids"], t["per_slot"], align, padding)
    assert got_s.shape == (N, G, 300) and got_p.shape == (N, G, 40)
    assert got_s.dtype == got_p.dtype == torch.float32
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), want_p, rtol=0, atol=1e-6)
    # the masks are soft: some points straddle two labels, and labels 255
    # and the ones past the slot ids fall in no slot
    assert 0 < (got_s.sum(1) < 1 - 1e-6).float().mean() < 1
    assert ((got_s > 0) & (got_s < 1)).any()


@pytest.mark.parametrize("align", [False, True])
def test_k3_plain_matches_the_pallas_label_kernel(align):
    """Against ``gather_corner_labels`` (interpret mode) and JAX's weights,
    as the batched JAX loss combines them, at border on power-of-two grids;
    row-sorted points, as that kernel requires."""
    spatial = (16, 8, 4)
    grid, ids, shared, per_slot = _inputs(spatial, seed=1)
    shared_s = np.array(jax_sort_points_by_row(jnp.asarray(shared), spatial, align))
    per_slot_s = np.array(jax_sort_points_by_row(jnp.asarray(per_slot), spatial, align))
    slab = jnp.asarray(np.stack([grid[n % B] for n in range(N)]).reshape(N, -1, spatial[2])
                       .astype(np.float32))
    label_op = jax.jit(lambda pts: gather_corner_labels(slab, spatial, pts, align,
                                                        interpret=True))
    ids_n = jnp.asarray(np.stack([ids[n % B] for n in range(N)]).astype(np.float32))
    lab8 = label_op(jnp.asarray(shared_s))                            # [N, S, 8]
    w8 = _corner_weights(jnp.asarray(shared_s), spatial, align, "border")
    want_s = sum(w8[..., j, None] * (lab8[..., j, None] == ids_n[:, None, :])
                 for j in range(8))                                   # [N, S, G]
    lab8r = label_op(jnp.asarray(per_slot_s.reshape(N, -1, 3))).reshape(N, G, -1, 8)
    w8r = _corner_weights(jnp.asarray(per_slot_s), spatial, align, "border")
    want_p = sum(w8r[..., j] * (lab8r[..., j] == ids_n[:, :, None]) for j in range(8))
    got_s = sample_id_masks_plain(torch.from_numpy(grid), torch.from_numpy(ids),
                                  torch.from_numpy(shared_s), align, "border")
    got_p = sample_id_masks_plain(torch.from_numpy(grid), torch.from_numpy(ids),
                                  torch.from_numpy(per_slot_s), align, "border")
    np.testing.assert_allclose(got_s.numpy(), np.asarray(want_s).transpose(0, 2, 1),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_p.numpy(), np.asarray(want_p), rtol=0, atol=1e-6)


def test_k3_rejects_what_it_does_not_take():
    grid, ids, shared, per_slot = (torch.from_numpy(a) for a in _inputs((4, 4, 2), S=8, P=4))
    with pytest.raises(ValueError):
        sample_id_masks(grid, ids, shared, padding_mode="reflection")
    with pytest.raises(ValueError):
        sample_id_masks(grid, ids, shared[:3])          # N not a multiple of B
    with pytest.raises(ValueError):
        sample_id_masks(grid, ids, per_slot[:, :3])     # per-slot axis is not G
    with pytest.raises(ValueError):
        sample_id_masks(grid[0], ids, shared)


@pytest.mark.parametrize("spatial", [(16, 16, 8), (10, 6, 5)])
@pytest.mark.parametrize("align", [False, True])
def test_row_key_and_sort_match_jax_to_the_last_index(spatial, align):
    """Points on a coarse lattice, so that many share a row: the stable sorts
    agree on every tie."""
    rng = np.random.RandomState(2)
    pts = (rng.randint(-2, 23, (2, 3, 500, 3)) / 20.0).astype(np.float32)
    np.testing.assert_array_equal(row_key(torch.from_numpy(pts), spatial, align).numpy(),
                                  np.asarray(jax_row_key(jnp.asarray(pts), spatial, align)))
    got = sort_points_by_row(torch.from_numpy(pts), spatial, align).numpy()
    want = np.asarray(jax_sort_points_by_row(jnp.asarray(pts), spatial, align))
    np.testing.assert_array_equal(got, want)
    keys = row_key(torch.from_numpy(pts[0, 0]), spatial, align)
    assert len(torch.unique(keys)) < 250  # ties are common here
