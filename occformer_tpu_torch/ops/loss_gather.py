"""Point readouts of the all-layer batched loss, and the GT corner-label
gather (K3).

Port of ``occformer_tpu/ops/loss_gather.py``:

* ``row_key`` / ``sort_points_by_row``: loss points sorted by their volume
  row.  Every consumer of the batched loss reduces over the point axis or
  indexes the sorted arrays consistently, so the permutation is never
  undone.  The sort is stable, as ``jnp.argsort`` is: with the same keys the
  port's sorted order is JAX's, and the top-k tie-breaks of the loss match.
* JAX's ``sample_volumes_packed_batched`` and ``sample_per_slot`` are the
  port's ``ops/sampling.py:point_sample_3d``: one K2 launch reads
  channels-last volumes ``[N, X, Y, Z, K]`` at points ``[N, S, 3]`` for
  every batch entry and channel.  The TPU's VMEM-sized channel chunks and
  row windows are not ported.
* ``sample_id_masks``: soft per-slot GT masks read from an integer label
  grid, ``sum_k w_k * (label_k == slot_id)`` over the 8 trilinear corners of
  each point (JAX ``_sample_id_masks`` and ``labels_to_masks(
  gather_corner_labels(...))``, ``mask2former_loss.py:335``, ``:458-479``).
  CUDA tensors launch K3 (``csrc/label_gather3d.cu``); CPU tensors run the
  plain version ``sample_id_masks_plain``.  A CUDA tensor never takes the
  plain version.  ``LAUNCHES`` counts K3's launches.

Points are in [0, 1] here (the reference's ``point_sample`` convention),
``pts[..., i]`` indexing spatial axis ``i`` (x, y, z).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_build, library

# launches of K3; a caller may reset it to 0
LAUNCHES = 0

_PADDING = ("zeros", "border")
_FNS = {}


def row_key(pts01: torch.Tensor, spatial: Tuple[int, int, int],
            align_corners: bool = False) -> torch.Tensor:
    """[..., S, 3] points in [0, 1] -> float32 row key ``x0 * Y + y0``, the
    lower corner's row clamped to the volume (so points outside it sort next
    to the edge rows they read)."""
    X, Y, _ = spatial

    def pix(v, n):  # [0, 1] -> [-1, 1] -> torch's pixel space, as JAX does
        c = v.float() * 2.0 - 1.0
        return (c + 1.0) * 0.5 * (n - 1) if align_corners else ((c + 1.0) * n - 1.0) * 0.5

    cx, cy = pix(pts01[..., 0], X), pix(pts01[..., 1], Y)
    return cx.floor().clamp(0, X - 1) * Y + cy.floor().clamp(0, Y - 1)


def sort_points_by_row(pts01: torch.Tensor, spatial: Tuple[int, int, int],
                       align_corners: bool = False) -> torch.Tensor:
    """[..., S, 3] points, stably sorted by ``row_key`` along the point axis."""
    order = torch.argsort(row_key(pts01, spatial, align_corners), dim=-1, stable=True)
    return torch.gather(pts01, -2, order.unsqueeze(-1).expand(pts01.shape))


def _corner_weights(pts01: torch.Tensor, spatial: Tuple[int, int, int],
                   align_corners: bool, padding_mode: str):
    """[..., 3] points in [0, 1] -> the trilinear weights ``[..., 8]`` and the
    flat grid indices ``[..., 8]`` of their 8 corners, in (dx, dy, dz)
    lexicographic order (JAX ``_corner_weights`` and the index arithmetic of
    ``_sample_id_masks``).  ``border`` clips the coordinate to the grid;
    ``zeros`` gives a corner outside the grid the weight 0.  Indices are
    clamped to the grid either way."""
    if padding_mode not in _PADDING:
        raise ValueError(f"padding_mode must be one of {_PADDING}; got {padding_mode!r}")
    Xg, Yg, Zg = spatial
    cs = []
    for i, n in enumerate(spatial):
        v = pts01[..., i].float()
        c = v * (n - 1) if align_corners else v * n - 0.5
        cs.append(c.clamp(0.0, n - 1) if padding_mode == "border" else c)
    x0, y0, z0 = (c.floor() for c in cs)
    wx, wy, wz = cs[0] - x0, cs[1] - y0, cs[2] - z0
    ws, idx = [], []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                fx, fy, fz = x0 + dx, y0 + dy, z0 + dz
                ok = ((fx >= 0) & (fx <= Xg - 1) & (fy >= 0) & (fy <= Yg - 1)
                      & (fz >= 0) & (fz <= Zg - 1))
                ws.append(((wx if dx else 1 - wx) * (wy if dy else 1 - wy)
                           * (wz if dz else 1 - wz)) * ok.float())
                xi = fx.clamp(0, Xg - 1).long()
                yi = fy.clamp(0, Yg - 1).long()
                zi = fz.clamp(0, Zg - 1).long()
                idx.append((xi * Yg + yi) * Zg + zi)
    return torch.stack(ws, -1), torch.stack(idx, -1)


def sample_id_masks_plain(id_grid: torch.Tensor, slot_ids: torch.Tensor,
                          pts01: torch.Tensor, align_corners: bool = False,
                          padding_mode: str = "border") -> torch.Tensor:
    """Plain PyTorch version of K3 (JAX ``_sample_id_masks``' arithmetic).

    ``id_grid [B, Xg, Yg, Zg]`` integer labels, ``slot_ids [B, G]``; entry
    ``n`` of the points reads grid ``n % B``.  Shared points ``[N, S, 3]``
    give ``[N, G, S]``; per-slot points ``[N, G, P, 3]``, each compared with
    its own slot's id only, give ``[N, G, P]``.  float32."""
    B = id_grid.shape[0]
    N = pts01.shape[0]
    w8, idx8 = _corner_weights(pts01, tuple(id_grid.shape[1:]), align_corners, padding_mode)
    grid_of = torch.arange(N, device=pts01.device) % B
    offset = (grid_of * id_grid[0].numel()).view((N,) + (1,) * (idx8.dim() - 1))
    lab = id_grid.reshape(-1)[offset + idx8]
    ids = slot_ids[grid_of]                                # [N, G]
    if pts01.dim() == 4:                                   # per-slot [N, G, P, 8]
        eq = lab == ids[:, :, None, None]
        acc = torch.zeros(pts01.shape[:-1], dtype=torch.float32, device=pts01.device)
        for j in range(8):
            acc = acc + w8[..., j] * eq[..., j]
        return acc
    acc = torch.zeros(pts01.shape[:-1] + (ids.shape[1],), dtype=torch.float32,
                      device=pts01.device)                 # [N, S, G]
    for j in range(8):
        acc = acc + w8[..., j, None] * (lab[..., j, None] == ids[:, None, :])
    return acc.transpose(1, 2)


def _kernel_fn(name: str):
    if name not in _FNS:
        fn = getattr(cuda_build.load("label_gather3d"), name)
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


@torch.library.custom_op(library.qualname("k3"), mutates_args=(), device_types="cuda")
def _k3(id_grid: torch.Tensor, slot_ids: torch.Tensor, pts01: torch.Tensor,
        align_corners: bool, padding_mode: str) -> torch.Tensor:
    """K3 (the op's CUDA implementation)."""
    global LAUNCHES
    per_slot = pts01.dim() == 4
    B, Xg, Yg, Zg = id_grid.shape
    G = slot_ids.shape[1]
    N = pts01.shape[0]
    S = pts01.shape[-2]
    out = torch.empty((N, G, S), dtype=torch.float32, device=id_grid.device)
    name = "label_gather3d_per_slot" if per_slot else "label_gather3d_shared"
    with torch.cuda.device(id_grid.device):
        stream = torch.cuda.current_stream(id_grid.device).cuda_stream
        rc = _kernel_fn(name)(
            id_grid.data_ptr(), slot_ids.data_ptr(), pts01.data_ptr(), out.data_ptr(),
            N, S, B, G, Xg, Yg, Zg, int(bool(align_corners)),
            int(padding_mode == "border"), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: cudaError {rc}")
    LAUNCHES += 1
    return out


@_k3.register_kernel("cpu")
def _(id_grid, slot_ids, pts01, align_corners, padding_mode):
    return sample_id_masks_plain(id_grid, slot_ids, pts01, align_corners, padding_mode)


@_k3.register_fake
def _(id_grid, slot_ids, pts01, align_corners, padding_mode):
    N, G, S = pts01.shape[0], slot_ids.shape[1], pts01.shape[-2]
    if id_grid.device.type == "cpu" and pts01.dim() == 3:  # the plain version's [N, S, G]
        return pts01.new_empty((N, S, G), dtype=torch.float32).transpose(1, 2)
    return pts01.new_empty((N, G, S), dtype=torch.float32)


def sample_id_masks(id_grid: torch.Tensor, slot_ids: torch.Tensor,
                    pts01: torch.Tensor, align_corners: bool = False,
                    padding_mode: str = "border") -> torch.Tensor:
    """Soft per-slot GT masks from an integer label grid (K3); arguments and
    result as in ``sample_id_masks_plain``.  Forward only: GT reads are
    detached.

    CPU tensors run the plain version.  CUDA tensors launch the kernel, which
    takes a contiguous int32 grid and int32 slot ids and contiguous float32
    points on one device, and raises on anything else."""
    if padding_mode not in _PADDING:
        raise ValueError(f"padding_mode must be one of {_PADDING}; got {padding_mode!r}")
    per_slot = pts01.dim() == 4
    if id_grid.dim() != 4 or slot_ids.dim() != 2 or slot_ids.shape[0] != id_grid.shape[0] \
            or pts01.dim() not in (3, 4) or pts01.shape[-1] != 3 \
            or pts01.shape[0] % id_grid.shape[0] != 0 \
            or (per_slot and pts01.shape[1] != slot_ids.shape[1]):
        raise ValueError("expected id_grid [B, Xg, Yg, Zg], slot_ids [B, G] and points "
                         "[N, S, 3] or [N, G, P, 3] with N a multiple of B; got "
                         f"{tuple(id_grid.shape)}, {tuple(slot_ids.shape)} and "
                         f"{tuple(pts01.shape)}")
    tensors = (id_grid, slot_ids, pts01)
    if all(t.device.type == "cpu" for t in tensors):
        return _k3(id_grid, slot_ids, pts01.detach(), bool(align_corners), padding_mode)
    if not (id_grid.is_cuda and all(t.device == id_grid.device for t in tensors)):
        raise ValueError("id_grid, slot_ids and points must lie on one CUDA device; got "
                         f"{[str(t.device) for t in tensors]}")
    if id_grid.dtype != torch.int32 or slot_ids.dtype != torch.int32 \
            or pts01.dtype != torch.float32:
        raise TypeError("id_grid and slot_ids must be int32 and points float32; got "
                        f"{id_grid.dtype}, {slot_ids.dtype} and {pts01.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("id_grid, slot_ids and points must be contiguous")
    return _k3(id_grid, slot_ids, pts01.detach(), bool(align_corners), padding_mode)
