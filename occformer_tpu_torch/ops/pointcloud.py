"""The point-cloud op family (the mmdet3d native-op surface).

Port of ``occformer_tpu/ops/pointcloud.py``, function for function, with
the same static-shape contracts: fixed capacities, validity masks, and -1
for "none"; indices and coordinates are int32, as the JAX package returns
them.  Every op is plain PyTorch on any device but one:
``furthest_point_sample``, whose loop of ``npoint`` steps is several
launches a step in plain PyTorch, runs ``csrc/furthest_point_sample.cu``
(FPS) for CUDA tensors and ``furthest_point_sample_plain`` for CPU tensors.
``FPS_LAUNCHES`` counts the kernel's launches.

Ops: hard/dynamic voxelization (ops/voxel), ball_query, knn,
gather_points, group_points, furthest_point_sample,
three_nn/three_interpolate (PointNet++ family), points_in_boxes,
roiaware_pool3d, rotated BEV/3D IoU and NMS (iou3d).

Where the JAX op is at fault, the port does not copy it:
``furthest_point_sample`` never takes an invalid point while a valid one
is left (the JAX op adds ``BIG`` to an invalid point's distance, which
makes the first invalid point the farthest, taken at every step).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from . import cuda_build

BIG = 1e10

# launches of the FPS kernel; a caller may reset it to 0
FPS_LAUNCHES = 0

_FNS = {}


# ---------------------------------------------------------------------------
# voxelization (mmdet3d/ops/voxel: hard + dynamic)
# ---------------------------------------------------------------------------

def _voxel_coords(points, valid, voxel_size, pc_range):
    dev = points.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev)
    lo = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    hi = torch.tensor(pc_range[3:], dtype=torch.float32, device=dev)
    grid = torch.round((hi - lo) / vs).to(torch.int32)
    coords = torch.floor((points[:, :3].float() - lo) / vs).to(torch.int32)
    ok = valid & ((coords >= 0) & (coords < grid)).all(-1)
    return coords, ok, grid


def dynamic_voxelize(points: torch.Tensor, valid: torch.Tensor, voxel_size: Sequence[float],
                     pc_range: Sequence[float]) -> torch.Tensor:
    """Per-point voxel coords [N, 3] int32, -1 where out of range; points
    [N, C] (xyz first), valid [N]."""
    coords, ok, _ = _voxel_coords(points, valid, voxel_size, pc_range)
    return torch.where(ok[:, None], coords, torch.full_like(coords, -1))


def hard_voxelize(points: torch.Tensor, valid: torch.Tensor, voxel_size: Sequence[float],
                  pc_range: Sequence[float], max_points: int = 35, max_voxels: int = 20000
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group points into at most ``max_voxels`` voxels of <= ``max_points``.

    The points are stably sorted by voxel rank (invalid last); each run of
    one voxel is numbered (voxel id, in rank order) and each point within
    its run (slot), so a voxel keeps its first ``max_points`` points and the
    grid its ``max_voxels`` lowest-ranked voxels: mmdet3d's first-fit.

    Returns (voxels [V, P, C], coords [V, 3] int32 (-1 padding), num_points
    [V] int32)."""
    N, C = points.shape
    dev = points.device
    coords, ok, grid = _voxel_coords(points, valid, voxel_size, pc_range)
    g = grid.long()
    rank = (coords[:, 0].long() * g[1] + coords[:, 1]) * g[2] + coords[:, 2]
    rank = torch.where(ok, rank, torch.full_like(rank, torch.iinfo(torch.int64).max))
    rank_s, order = torch.sort(rank, stable=True)
    pts_s, coords_s, ok_s = points[order], coords[order], ok[order]

    first = torch.ones(1, dtype=torch.bool, device=dev)
    new_run = torch.cat([first, rank_s[1:] != rank_s[:-1]]) & ok_s
    voxel_id = torch.cumsum(new_run.long(), 0) - 1
    ar = torch.arange(N, device=dev)
    run_start = torch.cummax(torch.where(new_run, ar, torch.full_like(ar, -1)), 0).values
    slot = ar - run_start.clamp(min=0)

    keep = ok_s & (voxel_id < max_voxels) & (slot < max_points)
    dummy = max_voxels * max_points
    flat = torch.where(keep, voxel_id * max_points + slot, torch.full_like(slot, dummy))
    voxels = torch.zeros((dummy + 1, C), dtype=points.dtype, device=dev)
    voxels[flat[keep]] = pts_s[keep]
    voxels = voxels[:-1].reshape(max_voxels, max_points, C)

    vid = torch.where(keep, voxel_id, torch.full_like(voxel_id, max_voxels))
    num_points = torch.bincount(vid, minlength=max_voxels + 1)[:max_voxels].to(torch.int32)

    vcoords = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32, device=dev)
    starts = new_run & keep
    vcoords[voxel_id[starts]] = coords_s[starts]
    return voxels, vcoords[:max_voxels], num_points


# ---------------------------------------------------------------------------
# PointNet++ family (ops/{ball_query,knn,furthest_point_sample,...})
# ---------------------------------------------------------------------------

def square_distance(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[.., N, 3] x [.., M, 3] -> [.., N, M] squared euclidean distances,
    (dx * dx + dy * dy) + dz * dz, one coordinate at a time (no [.., N, M, 3]
    temporary)."""
    d = [a[..., :, None, k] - b[..., None, :, k] for k in range(3)]
    return (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]


def ball_query(xyz: torch.Tensor, new_xyz: torch.Tensor, radius: float, nsample: int,
               valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Indices [B, S, nsample] int32 of the points of xyz [B, N, 3] within
    ``radius`` of each centre new_xyz [B, S, 3]; CUDA semantics: the first
    ``nsample`` in index order, the first hit repeated to fill (N where a
    centre has none)."""
    inside = square_distance(new_xyz, xyz) <= radius * radius
    if valid is not None:
        inside = inside & valid[:, None, :]
    N = xyz.shape[1]
    idx_row = torch.arange(N, device=xyz.device).expand(inside.shape)
    cand = torch.where(inside, idx_row, torch.full_like(idx_row, N))
    # the nsample smallest candidates in ascending order: the sort's prefix
    cand = torch.topk(cand, min(nsample, N), dim=-1, largest=False, sorted=True).values
    if nsample > N:
        cand = torch.cat([cand, cand.new_full((*cand.shape[:-1], nsample - N), N)], -1)
    first = cand[..., :1]
    return torch.where(cand == N, first, cand).to(torch.int32)


def knn(k: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
        valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbours: ([B, S, k] distances, [B, S, k] int32 indices),
    nearest first."""
    d2 = square_distance(new_xyz, xyz)
    if valid is not None:
        d2 = torch.where(valid[:, None, :], d2, torch.full_like(d2, BIG))
    d, idx = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
    return torch.sqrt(d.clamp(min=0.0)), idx.to(torch.int32)


def gather_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C], [B, S] -> [B, S, C] (ops/gather_points)."""
    C = feats.shape[-1]
    return torch.gather(feats, 1, idx.long()[..., None].expand(-1, -1, C))


def group_points(feats: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[B, N, C], [B, S, K] -> [B, S, K, C] (ops/group_points)."""
    B, S, K = idx.shape
    return gather_points(feats, idx.reshape(B, S * K)).reshape(B, S, K, feats.shape[-1])


def furthest_point_sample_plain(xyz: torch.Tensor, npoint: int,
                                valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of FPS: the greedy recursion of the CUDA op
    (starts at index 0), a loop of ``npoint - 1`` steps over a running
    minimum distance; each distance (dx * dx + dy * dy) + dz * dz in float32;
    an invalid point's distance stays -1, so it is not taken while a valid
    point is left; ties go to the lowest index.  -> [B, npoint] int32."""
    B, N, _ = xyz.shape
    xyz = xyz.float()
    dist = torch.full((B, N), BIG, dtype=torch.float32, device=xyz.device)
    if valid is not None:
        dist = torch.where(valid, dist, torch.full_like(dist, -1.0))
    idxs = torch.zeros((B, npoint), dtype=torch.int32, device=xyz.device)
    last = torch.zeros((B,), dtype=torch.int64, device=xyz.device)
    for i in range(1, npoint):
        lastp = torch.gather(xyz, 1, last[:, None, None].expand(B, 1, 3))
        d = xyz - lastp
        d = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        dist = torch.minimum(dist, d)
        last = torch.argmax(dist, dim=-1)
        idxs[:, i] = last.to(torch.int32)
    return idxs


def _fps_fn(name: str):
    if name not in _FNS:
        fn = getattr(cuda_build.load("furthest_point_sample"), name)
        if name == "furthest_point_sample_workspace":
            fn.argtypes, fn.restype = [ctypes.c_int] * 2, ctypes.c_longlong
        else:
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _FNS[name] = fn
    return _FNS[name]


def _launch_fps(xyz, npoint, valid):
    global FPS_LAUNCHES
    B, N, _ = xyz.shape
    xyz = xyz.float().contiguous()
    out = torch.empty((B, npoint), dtype=torch.int32, device=xyz.device)
    if B == 0 or npoint == 0:
        return out
    if valid is not None:
        valid = valid.to(device=xyz.device, dtype=torch.bool).contiguous()
    n_ws = _fps_fn("furthest_point_sample_workspace")(B, N)
    ws = torch.empty(n_ws, dtype=torch.float32, device=xyz.device) if n_ws else None
    with torch.cuda.device(xyz.device):
        stream = torch.cuda.current_stream(xyz.device).cuda_stream
        rc = _fps_fn("furthest_point_sample")(
            xyz.data_ptr(), None if valid is None else valid.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), B, N, npoint, stream)
    if rc != 0:
        raise RuntimeError(f"furthest_point_sample launch failed: cudaError {rc}")
    FPS_LAUNCHES += 1
    return out


def furthest_point_sample(xyz: torch.Tensor, npoint: int,
                          valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Iterative farthest-point sampling, [B, N, 3] -> [B, npoint] int32
    indices (see ``furthest_point_sample_plain``): the FPS kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if xyz.is_cuda:
        if xyz.shape[1] < 1:
            raise ValueError("furthest_point_sample needs at least one point")
        return _launch_fps(xyz, npoint, valid)
    return furthest_point_sample_plain(xyz, npoint, valid)


def three_nn(unknown: torch.Tensor, known: torch.Tensor,
             valid: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """3 nearest known points per unknown point (ops/interpolate three_nn)."""
    return knn(3, known, unknown, valid)


def three_interpolate(feats: torch.Tensor, idx: torch.Tensor,
                      weight: torch.Tensor) -> torch.Tensor:
    """Inverse-distance weighted interpolation: [B, M, C], [B, N, 3], [B, N, 3]
    -> [B, N, C]."""
    g = group_points(feats, idx) * weight[..., None]  # [B, N, 3, C]
    return (g[:, :, 0] + g[:, :, 1]) + g[:, :, 2]


# ---------------------------------------------------------------------------
# boxes (ops/{roiaware_pool3d, iou3d})
# ---------------------------------------------------------------------------

def _box_frame(points, boxes):
    """Points [..., N, 3] in the frames of boxes [..., M, 7]: (lx, ly, lz)
    [..., N, M] each."""
    ctr, yaw = boxes[..., :3], boxes[..., 6]
    rel = points[..., :, None, :] - ctr[..., None, :, :]
    c, s = torch.cos(-yaw)[..., None, :], torch.sin(-yaw)[..., None, :]
    lx = rel[..., 0] * c - rel[..., 1] * s
    ly = rel[..., 0] * s + rel[..., 1] * c
    return lx, ly, rel[..., 2]


def points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[B, N, 3] x [B, M, 7] (x, y, z, dx, dy, dz, yaw; z = bottom centre) ->
    [B, N, M] bool membership (roiaware_pool3d points_in_boxes semantics)."""
    lx, ly, lz = _box_frame(points, boxes)
    dims = boxes[..., None, :, 3:6]
    return ((lx.abs() <= dims[..., 0] / 2) & (ly.abs() <= dims[..., 1] / 2)
            & (lz >= 0) & (lz <= dims[..., 2]))


def roiaware_pool3d(points: torch.Tensor, feats: torch.Tensor, boxes: torch.Tensor,
                    out_size: int = 7, mode: str = "max",
                    valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RoI-aware pooling: per box, pool the features of its points into a
    T^3 grid.  points [N, 3], feats [N, C], boxes [M, 7] (z bottom), valid
    [N].  The points go into each box's frame and to a cell, and each
    (box, cell) takes the max or mean of its points' features.  Returns
    [M, T, T, T, C] (empty cells 0)."""
    M, T, C = boxes.shape[0], out_size, feats.shape[-1]
    lx, ly, lz = _box_frame(points, boxes)  # [N, M]
    dims = boxes[:, 3:6]
    u = (lx / dims[:, 0] + 0.5) * T
    v = (ly / dims[:, 1] + 0.5) * T
    w = (lz / dims[:, 2]) * T
    inside = (u >= 0) & (u < T) & (v >= 0) & (v < T) & (w >= 0) & (w < T)
    if valid is not None:
        inside = inside & valid[:, None]
    cell = (u.to(torch.int64) * T + v.to(torch.int64)) * T + w.to(torch.int64)
    pt, box = inside.nonzero(as_tuple=True)
    seg = box * T ** 3 + cell[pt, box]
    f = feats[pt]
    n_seg = M * T ** 3
    if mode == "max":
        out = torch.full((n_seg, C), float("-inf"), dtype=feats.dtype, device=feats.device)
        out.scatter_reduce_(0, seg[:, None].expand(-1, C), f, "amax")
        out = torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    else:
        sums = torch.zeros((n_seg, C), dtype=feats.dtype, device=feats.device)
        sums.index_add_(0, seg, f)
        cnt = torch.bincount(seg, minlength=n_seg).to(feats.dtype)
        out = sums / cnt.clamp(min=1.0)[:, None]
    return out.reshape(M, T, T, T, C)


def _box_corners_bev(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 5] (x, y, dx, dy, yaw) -> [..., 4, 2] corners (ccw)."""
    x, y, dx, dy, yaw = (boxes[..., i] for i in range(5))
    cx = torch.stack([dx, dx, -dx, -dx], -1) / 2
    cy = torch.stack([-dy, dy, dy, -dy], -1) / 2
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    rx = cx * c - cy * s + x[..., None]
    ry = cx * s + cy * c + y[..., None]
    return torch.stack([rx, ry], -1)


def _polygon_area(poly: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Shoelace area of a padded convex polygon [..., V, 2] with mask."""
    p = torch.where(valid[..., None], poly, poly[..., :1, :])
    nxt = torch.roll(p, -1, dims=-2)
    cross = p[..., 0] * nxt[..., 1] - nxt[..., 0] * p[..., 1]
    return 0.5 * cross.sum(-1).abs()


def rotated_box_intersection_area(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Exact intersection area of two BEV boxes [..., 5] by
    Sutherland-Hodgman clipping of b1's corners by each edge of b2's (a
    polygon of at most 8 vertices, kept as 8 slots and a mask)."""
    subject = _box_corners_bev(b1)  # [..., 4, 2]
    clip = _box_corners_bev(b2)
    V = 8
    poly = torch.cat([subject, torch.zeros_like(subject)], -2)
    valid = torch.zeros(poly.shape[:-1], dtype=torch.bool, device=poly.device)
    valid[..., :4] = True
    slots = torch.arange(V, device=poly.device)
    for i in range(4):
        a, b = clip[..., i, :], clip[..., (i + 1) % 4, :]
        edge = b - a  # inside = left of a -> b (ccw)

        def inside(p):
            return (edge[..., 0] * (p[..., 1] - a[..., 1])
                    - edge[..., 1] * (p[..., 0] - a[..., 0])) >= 0

        out_poly = torch.zeros_like(poly)
        out_valid = torch.zeros_like(valid)
        count = torch.zeros(poly.shape[:-2], dtype=torch.int64, device=poly.device)
        n_valid = valid.sum(-1)

        def emit(out_poly, out_valid, count, pt, do):
            onehot = (slots == count.clamp(0, V - 1)[..., None]) & do[..., None]
            out_poly = out_poly + onehot[..., None].to(poly.dtype) * pt[..., None, :]
            return out_poly, out_valid | onehot, count + do.long()

        for j in range(V):
            cur = poly[..., j, :]
            # the ring over the valid prefix: vertex j + 1 past it wraps to 0
            wrap = (j + 1) >= n_valid
            nxt = torch.where(wrap[..., None], poly[..., 0, :], poly[..., (j + 1) % V, :])
            cur_in, nxt_in = inside(cur), inside(nxt)
            denom = (edge[..., 0] * (nxt[..., 1] - cur[..., 1])
                     - edge[..., 1] * (nxt[..., 0] - cur[..., 0]))
            t_num = (edge[..., 0] * (a[..., 1] - cur[..., 1])
                     - edge[..., 1] * (a[..., 0] - cur[..., 0]))
            t = t_num / torch.where(denom.abs() < 1e-12, torch.full_like(denom, 1e-12), denom)
            inter = cur + t[..., None] * (nxt - cur)
            seg_valid = valid[..., j]
            out_poly, out_valid, count = emit(out_poly, out_valid, count, cur,
                                              seg_valid & cur_in)
            out_poly, out_valid, count = emit(out_poly, out_valid, count, inter,
                                              seg_valid & (cur_in != nxt_in))
        poly, valid = out_poly, out_valid
    return _polygon_area(poly, valid)


# pairs a chunk of boxes_iou_bev clips at once (its transients scale with it)
IOU_CHUNK_PAIRS = 1 << 21


def boxes_iou_bev(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU: [N, 5] x [M, 5] -> [N, M] (ops/iou3d), in
    chunks of rows of at most ``IOU_CHUNK_PAIRS`` pairs."""
    N, M = b1.shape[0], b2.shape[0]
    rows = max(1, IOU_CHUNK_PAIRS // max(M, 1))
    inter = torch.cat([
        rotated_box_intersection_area(b1[r:r + rows, None].expand(-1, M, 5),
                                      b2[None].expand(min(rows, N - r), M, 5))
        for r in range(0, N, rows)]) if N else b1.new_zeros((0, M))
    a1 = b1[:, 2] * b1[:, 3]
    a2 = b2[:, 2] * b2[:, 3]
    union = a1[:, None] + a2[None, :] - inter
    return inter / union.clamp(min=1e-7)


def boxes_iou_3d(b1: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    """Rotated 3D IoU: [N, 7] x [M, 7], z = bottom centre."""
    cols = [0, 1, 3, 4, 6]
    bev = boxes_iou_bev(b1[:, cols], b2[:, cols])
    inter_bev = bev * ((b1[:, 3] * b1[:, 4])[:, None]
                       + (b2[:, 3] * b2[:, 4])[None, :]) / (1.0 + bev)
    z1_lo, z1_hi = b1[:, 2], b1[:, 2] + b1[:, 5]
    z2_lo, z2_hi = b2[:, 2], b2[:, 2] + b2[:, 5]
    zi = (torch.minimum(z1_hi[:, None], z2_hi[None, :])
          - torch.maximum(z1_lo[:, None], z2_lo[None, :])).clamp(min=0.0)
    inter = inter_bev * zi
    v1 = b1[:, 3] * b1[:, 4] * b1[:, 5]
    v2 = b2[:, 3] * b2[:, 4] * b2[:, 5]
    return inter / (v1[:, None] + v2[None, :] - inter).clamp(min=1e-7)


def nms_bev(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float) -> torch.Tensor:
    """Rotated-BEV NMS: keep mask [N] bool (ops/iou3d nms_gpu): in order of
    descending score (a stable sort), each kept box suppresses the later
    boxes that overlap it by more than ``iou_threshold``.  One step a box,
    on the device, with no host synchronisation."""
    N = boxes.shape[0]
    order = torch.argsort(-scores, stable=True)
    iou = boxes_iou_bev(boxes[order], boxes[order])
    ar = torch.arange(N, device=boxes.device)
    keep = torch.ones(N, dtype=torch.bool, device=boxes.device)
    for i in range(N):
        keep = keep & ~((iou[i] > iou_threshold) & keep[i] & (ar > i))
    out = torch.zeros(N, dtype=torch.bool, device=boxes.device)
    out[order] = keep
    return out
