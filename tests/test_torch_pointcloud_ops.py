"""The port's point-cloud ops against the JAX package's, on the CPU.

The 11 cases of tests/test_pointcloud_ops.py, each run through the port's
op and the JAX op on the same seeded numpy inputs (and, where that file
checks an oracle, against the oracle too).  Indices, coordinates, masks and
voxel groupings must be equal; IoU, intersection areas, distances and
interpolations agree within rtol/atol 1e-5, pooled features within 1e-6
(both pool the same float32 values).  FPS's plain version is held to the
JAX op's indices on clouds with every point valid; with invalid points the
JAX op is at fault (it takes the first invalid point at every step), so the
port is held there to a numpy oracle of the greedy recursion instead.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from occformer_tpu.ops import pointcloud as J
from occformer_tpu_torch.ops import pointcloud as T


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _eq(got, ref):
    np.testing.assert_array_equal(got.numpy() if torch.is_tensor(got) else got, np.asarray(ref))


def _close(got, ref, tol=1e-5):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=tol, atol=tol)


def test_dynamic_voxelize(rng):
    pts = rng.uniform(-5, 5, (100, 4)).astype(np.float32)
    valid = np.ones(100, bool)
    valid[::7] = False
    args = ([0.5, 0.5, 0.5], [-4, -4, -4, 4, 4, 4])
    coords = T.dynamic_voxelize(_t(pts), _t(valid), *args)
    _eq(coords, J.dynamic_voxelize(jnp.asarray(pts), jnp.asarray(valid), *args))
    ref = np.floor((pts[:, :3] + 4) / 0.5).astype(np.int32)
    inr = np.all((ref >= 0) & (ref < 16), axis=1) & valid
    _eq(coords.numpy()[inr], ref[inr])
    assert (coords.numpy()[~inr] == -1).all()


@pytest.mark.parametrize("max_points,max_voxels", [(8, 64), (2, 5)])
def test_hard_voxelize_groups(rng, max_points, max_voxels):
    """Every output equal to JAX's, also when both capacities overflow."""
    pts = rng.uniform(-2, 2, (50, 4)).astype(np.float32)
    valid = np.ones(50, bool)
    args = ([1, 1, 1], [-2, -2, -2, 2, 2, 2], max_points, max_voxels)
    got = T.hard_voxelize(_t(pts), _t(valid), *args)
    ref = J.hard_voxelize(jnp.asarray(pts), jnp.asarray(valid), *args)
    for g, r in zip(got, ref):
        _eq(g, r)
    voxels, coords, nump = (g.numpy() for g in got)
    if max_points == 8:
        assert int(nump.sum()) == 50
    for v in range(max_voxels):
        for p in range(int(nump[v])):
            _eq(np.floor(voxels[v, p, :3] + 2).astype(np.int32), coords[v])


def test_ball_query_matches_bruteforce(rng):
    xyz = rng.uniform(-1, 1, (2, 40, 3)).astype(np.float32)
    new = rng.uniform(-1, 1, (2, 5, 3)).astype(np.float32)
    valid = rng.rand(2, 40) > 0.2
    r, k = 0.7, 6
    idx = T.ball_query(_t(xyz), _t(new), r, k)
    _eq(idx, J.ball_query(jnp.asarray(xyz), jnp.asarray(new), r, k))
    _eq(T.ball_query(_t(xyz), _t(new), r, k, _t(valid)),
        J.ball_query(jnp.asarray(xyz), jnp.asarray(new), r, k, jnp.asarray(valid)))
    idx = idx.numpy()
    for b in range(2):
        for s in range(5):
            inside = np.nonzero(np.linalg.norm(xyz[b] - new[b, s], axis=-1) <= r)[0]
            if len(inside) == 0:
                continue
            want = inside[:k]
            _eq(idx[b, s, :len(want)], want)
            assert (idx[b, s, len(want):] == want[0]).all()


def test_knn_matches_bruteforce(rng):
    xyz = rng.uniform(-1, 1, (1, 30, 3)).astype(np.float32)
    new = rng.uniform(-1, 1, (1, 7, 3)).astype(np.float32)
    valid = rng.rand(1, 30) > 0.2
    for v in (None, valid):
        dist, idx = T.knn(4, _t(xyz), _t(new), None if v is None else _t(v))
        rdist, ridx = J.knn(4, jnp.asarray(xyz), jnp.asarray(new),
                            None if v is None else jnp.asarray(v))
        _eq(idx, ridx)
        _close(dist, rdist)
    for s in range(7):
        d = np.linalg.norm(xyz[0] - new[0, s], axis=-1)
        np.testing.assert_allclose(np.sort(dist.numpy()[0, s]), np.sort(d[valid[0]])[:4],
                                   rtol=1e-4)


def _fps_oracle(xyz, npoint, valid):
    """The greedy recursion in numpy float32, invalid points never taken
    while a valid one is left."""
    B, N, _ = xyz.shape
    out = np.zeros((B, npoint), np.int32)
    for b in range(B):
        dist = np.where(valid[b], np.float32(1e10), np.float32(-1.0)).astype(np.float32)
        last = 0
        for i in range(1, npoint):
            d = xyz[b] - xyz[b, last]
            d = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2]
            dist = np.minimum(dist, d)
            last = int(np.argmax(dist))
            out[b, i] = last
    return out


def test_fps_covers_space(rng):
    xyz = rng.uniform(-1, 1, (2, 100, 3)).astype(np.float32)
    idx = T.furthest_point_sample(_t(xyz), 10)
    assert idx.shape == (2, 10) and idx.dtype == torch.int32
    _eq(idx, J.furthest_point_sample(jnp.asarray(xyz), 10))
    idx = idx.numpy()
    assert idx[0, 0] == 0
    assert len(set(idx[0].tolist())) == 10  # distinct
    d0 = np.linalg.norm(xyz[0] - xyz[0, 0], axis=-1)
    assert idx[0, 1] == d0.argmax()
    # invalid points: never taken while a valid one is left (the oracle)
    valid = rng.rand(2, 100) > 0.3
    got = T.furthest_point_sample(_t(xyz), 40, _t(valid)).numpy()
    _eq(got, _fps_oracle(xyz, 40, valid))
    assert valid[np.arange(2)[:, None], got[:, 1:]].all()
    # ties (a grid of points at equal distances) go to the lowest index
    grid = np.stack(np.meshgrid(*[np.arange(3.0)] * 3, indexing="ij"), -1).reshape(1, -1, 3)
    grid = grid.astype(np.float32)
    _eq(T.furthest_point_sample(_t(grid), 27), _fps_oracle(grid, 27, np.ones((1, 27), bool)))
    _eq(T.furthest_point_sample(_t(grid), 27), J.furthest_point_sample(jnp.asarray(grid), 27))


def test_gather_group_three_interpolate(rng):
    feats = rng.randn(2, 20, 5).astype(np.float32)
    idx = rng.randint(0, 20, (2, 6)).astype(np.int32)
    g = T.gather_points(_t(feats), _t(idx))
    _eq(g, J.gather_points(jnp.asarray(feats), jnp.asarray(idx)))
    for b in range(2):
        _eq(g[b], feats[b, idx[b]])
    gidx = rng.randint(0, 20, (2, 4, 3)).astype(np.int32)
    gg = T.group_points(_t(feats), _t(gidx))
    _eq(gg, J.group_points(jnp.asarray(feats), jnp.asarray(gidx)))
    _eq(gg[1, 2], feats[1, gidx[1, 2]])

    known = rng.uniform(-1, 1, (1, 10, 3)).astype(np.float32)
    unknown = rng.uniform(-1, 1, (1, 4, 3)).astype(np.float32)
    kf = rng.randn(1, 10, 2).astype(np.float32)
    dist, nidx = T.three_nn(_t(unknown), _t(known))
    rdist, ridx = J.three_nn(jnp.asarray(unknown), jnp.asarray(known))
    _eq(nidx, ridx)
    _close(dist, rdist)
    w = 1.0 / (np.asarray(rdist) ** 2 + 1e-8)
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)
    out = T.three_interpolate(_t(kf), nidx, _t(w))
    assert out.shape == (1, 4, 2)
    _close(out, J.three_interpolate(jnp.asarray(kf), ridx, jnp.asarray(w)))


def test_points_in_boxes_axis_aligned_and_rotated(rng):
    boxes = np.array([[[0, 0, 0, 2, 4, 2, 0.0],
                       [5, 5, 0, 2, 2, 2, np.pi / 4]]], np.float32)
    pts = np.array([[[0.9, 1.9, 1.0], [1.1, 0.0, 1.0], [5.0, 5.0, 0.5],
                     [5.95, 5.95, 0.5], [0.0, 0.0, 2.5]]], np.float32)
    m = T.points_in_boxes(_t(pts), _t(boxes)).numpy()
    _eq(m[0, :, 0], [True, False, False, False, False])
    _eq(m[0, :, 1], [False, False, True, False, False])
    # random clouds and boxes
    pts = rng.uniform(-4, 4, (2, 200, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-3, 3, (2, 6, 3)), rng.uniform(0.5, 3, (2, 6, 3)),
                            rng.uniform(-np.pi, np.pi, (2, 6, 1))], -1).astype(np.float32)
    _eq(T.points_in_boxes(_t(pts), _t(boxes)),
        J.points_in_boxes(jnp.asarray(pts), jnp.asarray(boxes)))


def test_rotated_intersection_known_cases(rng):
    cases = [([[0.0, 0.0, 2.0, 3.0, 0.3]], [[0.0, 0.0, 2.0, 3.0, 0.3]], 6.0),
             ([[0.0, 0.0, 2.0, 3.0, 0.3]], [[10.0, 0.0, 2.0, 3.0, 0.0]], 0.0),
             ([[1.0, 0.0, 2.0, 3.0, 0.0]], [[0.0, 0.0, 2.0, 3.0, 0.0]], 3.0),
             ([[0.0, 0.0, 1.0, 1.0, 0.0]], [[0.0, 0.0, 1.0, 1.0, np.pi / 4]],
              2 * (np.sqrt(2) - 1))]
    for a, b, area in cases:
        got = T.rotated_box_intersection_area(torch.tensor(a), torch.tensor(b))
        np.testing.assert_allclose(got.numpy(), [area], rtol=1e-4, atol=1e-6)
    b1 = np.concatenate([rng.uniform(-2, 2, (40, 2)), rng.uniform(0.5, 3, (40, 2)),
                         rng.uniform(-np.pi, np.pi, (40, 1))], -1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(-2, 2, (40, 2)), rng.uniform(0.5, 3, (40, 2)),
                         rng.uniform(-np.pi, np.pi, (40, 1))], -1).astype(np.float32)
    _close(T.rotated_box_intersection_area(_t(b1), _t(b2)),
           J.rotated_box_intersection_area(jnp.asarray(b1), jnp.asarray(b2)), 1e-4)


def test_iou_bev_and_3d(rng, monkeypatch):
    iou = T.boxes_iou_bev(torch.tensor([[0.0, 0, 2, 2, 0]]), torch.tensor([[1.0, 0, 2, 2, 0]]))
    np.testing.assert_allclose(iou.numpy(), [[2.0 / 6.0]], rtol=1e-5)
    iou3 = T.boxes_iou_3d(torch.tensor([[0.0, 0, 0, 2, 2, 2, 0]]),
                          torch.tensor([[1.0, 0, 1, 2, 2, 2, 0]]))
    np.testing.assert_allclose(iou3.numpy(), [[2.0 / 14.0]], rtol=1e-4)
    b1 = np.concatenate([rng.uniform(-3, 3, (30, 3)), rng.uniform(0.5, 3, (30, 3)),
                         rng.uniform(-np.pi, np.pi, (30, 1))], -1).astype(np.float32)
    b2 = np.concatenate([rng.uniform(-3, 3, (20, 3)), rng.uniform(0.5, 3, (20, 3)),
                         rng.uniform(-np.pi, np.pi, (20, 1))], -1).astype(np.float32)
    bev = b1[:, [0, 1, 3, 4, 6]], b2[:, [0, 1, 3, 4, 6]]
    ref = J.boxes_iou_bev(jnp.asarray(bev[0]), jnp.asarray(bev[1]))
    _close(T.boxes_iou_bev(_t(bev[0]), _t(bev[1])), ref, 1e-4)
    monkeypatch.setattr(T, "IOU_CHUNK_PAIRS", 64)  # several chunks: the same IoUs
    _close(T.boxes_iou_bev(_t(bev[0]), _t(bev[1])), ref, 1e-4)
    _close(T.boxes_iou_3d(_t(b1), _t(b2)),
           J.boxes_iou_3d(jnp.asarray(b1), jnp.asarray(b2)), 1e-4)


def test_nms_bev_suppression(rng):
    boxes = torch.tensor([[0.0, 0, 2, 2, 0], [0.1, 0, 2, 2, 0], [5.0, 5, 2, 2, 0]])
    keep = T.nms_bev(boxes, torch.tensor([0.9, 0.8, 0.7]), 0.5)
    _eq(keep, [True, False, True])
    b = np.concatenate([rng.uniform(-4, 4, (60, 2)), rng.uniform(0.5, 3, (60, 2)),
                        rng.uniform(-np.pi, np.pi, (60, 1))], -1).astype(np.float32)
    scores = rng.rand(60).astype(np.float32)
    for thr in (0.1, 0.3):
        _eq(T.nms_bev(_t(b), _t(scores), thr),
            J.nms_bev(jnp.asarray(b), jnp.asarray(scores), thr))


def test_roiaware_pool3d(rng):
    boxes = torch.tensor([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]])
    pts = torch.tensor([[-0.9, -0.9, 0.1], [0.9, 0.9, 1.9], [0.9, 0.9, 1.95], [5.0, 5.0, 0.5]])
    feats = torch.tensor([[1.0], [2.0], [5.0], [9.0]])
    out = T.roiaware_pool3d(pts, feats, boxes, out_size=2, mode="max").numpy()
    assert out.shape == (1, 2, 2, 2, 1)
    assert out[0, 0, 0, 0, 0] == 1.0 and out[0, 1, 1, 1, 0] == 5.0 and out[0, 0, 1, 0, 0] == 0.0
    out_avg = T.roiaware_pool3d(pts, feats, boxes, out_size=2, mode="avg").numpy()
    assert abs(out_avg[0, 1, 1, 1, 0] - 3.5) < 1e-6
    # random clouds, boxes and validity, both modes
    pts = rng.uniform(-3, 3, (400, 3)).astype(np.float32)
    feats = rng.randn(400, 4).astype(np.float32)
    valid = rng.rand(400) > 0.2
    boxes = np.concatenate([rng.uniform(-2, 2, (5, 3)), rng.uniform(1, 3, (5, 3)),
                            rng.uniform(-np.pi, np.pi, (5, 1))], -1).astype(np.float32)
    for mode in ("max", "avg"):
        got = T.roiaware_pool3d(_t(pts), _t(feats), _t(boxes), 3, mode, _t(valid))
        ref = J.roiaware_pool3d(jnp.asarray(pts), jnp.asarray(feats), jnp.asarray(boxes), 3,
                                mode, jnp.asarray(valid))
        _close(got, ref, 1e-6)
