"""Time the redesigned gather kernels of a checkout of the port on the card.

    python3 occformer_tpu_torch/tools/time_backwards.py [--root DIR] [--label NAME] [--sweep]

K1 (``ops/trilerp_fused.py:_launch_fwd``) at the flagship's deformable
attention shapes in bf16 and float32 and K1-bwd (``_launch_bwd``) in bf16,
each at uniform and at local locations (``flagship_gather_inputs``, which
``chip_smoke.py`` draws its K1 inputs from too); K2-bwd (``ops/trilerp.py:_launch_bwd``) at the per-layer loss
route's candidate (150528 points) and random-fill (17 x 12544 points)
readouts of the bf16 feature ``[1, 128, 128, 16, 192]``, border,
align_corners=False; K2 (``ops/trilerp.py:_launch_fwd``) at that candidate
readout, at the per-layer route's GT masks (bool ``[17, 256, 256, 32, 1]``,
17 x 12544 points) and GT table (bool ``[1, 256, 256, 32, 17]`` at the
150528 candidates), and at the batched route's match (bf16 ``[10, 128,
128, 16, 100]``, 10 x 50176 points) and per-slot (float32 C = 17 at 10 x
150528 points, C = 1 at 170 x 12544) volumes; and K4
(``ops/trilerp_fused.py:_launch_multi_fwd``) at the deformable attention's
pyramid (``k4_inputs``, bf16 and float32), and at bench.py's parity-gate
shapes by the profiler's device time.  Each is the median ms of 30
CUDA-event timed launches, on the path the checkout picks; K1 and K2 also
by the profiler's device time.  ``--root`` names the checkout whose
``occformer_tpu_torch`` is imported (this one by default), so that two
versions can be timed in turns on one card:

    for r in parent . . parent; do python3 .../time_backwards.py --root $r; done

``--sweep`` also times both of K2-bwd's paths, and both of K2's forward
paths, at the candidate readout's shape over row widths C = 8 ... 192, in
turns (the measurements behind ``ops/trilerp.py:SEGMENTED_MIN_C`` and
``fwd_path``), K2's row-wide path at C = 192 over its lane-group sizes
1 ... 32, K2's narrow path at the batched route's C = 17 and C = 100 over
and the GT table's C = 17 over its lane-group sizes and at C = 1 (the GT
masks, the random fill) over its
points per lane (``NARROW_CHUNKS_PER_LANE``, ``NARROW_POINTS_PER_LANE``),
and K1's row-wide path over its lanes per row and samples per lane at the
uniform and local locations in bf16 and float32 (``ROW_LANES``,
``ROW_SAMPLES_PER_LANE``; it needs a checkout with those paths).  It prints
one JSON line and exits 2 without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

SWEEP_WIDTHS = (8, 16, 32, 40, 48, 56, 64, 128, 192)
LANE_SWEEP = (1, 2, 4, 8, 16, 32)
POINTS_SWEEP = (1, 2, 4)
SAMPLES_SWEEP = (1, 2, 3)
# the pyramid of the deformable attention, largest level first, as bench.py
K4_PYRAMID = [(64, 64, 8), (32, 32, 4), (16, 16, 2)]


def flagship_gather_inputs(dtype, local, seed=0):
    """K1's inputs at the flagship's shapes on the card: B=1, H=8, hd=24,
    P=4, levels (16,16,2), (32,32,4), (64,64,8), Nq = 37376.  ``local=False``:
    locations uniform over [-a, 1+a]^3 with a = 0.018, so that about 10% of
    samples have a coordinate outside [0, 1]; ``local=True``: each query's own
    grid center plus up to +-2 voxels, the spread of the model's radial
    offset init.  Returns (value, shapes, locs, weights)."""
    import numpy as np
    import torch

    from occformer_tpu_torch.models.pixel_decoder import reference_points

    shapes = [(16, 16, 2), (32, 32, 4), (64, 64, 8)]
    B, H, hd, L, P = 1, 8, 24, 3, 4
    Nq = sum(x * y * z for x, y, z in shapes)
    rng = np.random.RandomState(seed)
    value = rng.randn(B, Nq, H, hd).astype(np.float32)
    if local:
        ref = reference_points(shapes)[None, :, None, None, None, :]
        norm = np.asarray(shapes, np.float32)[None, None, None, :, None, :]
        locs = ref + rng.uniform(-2, 2, (B, Nq, H, L, P, 3)) / norm
    else:
        locs = rng.uniform(-0.018, 1.018, (B, Nq, H, L, P, 3))
    w = rng.rand(B, Nq, H, L * P)
    w = (w / w.sum(-1, keepdims=True)).reshape(B, Nq, H, L, P)
    dev = torch.device("cuda")
    return (torch.from_numpy(value).to(dev, dtype), shapes,
            torch.from_numpy(locs.astype(np.float32)).to(dev),
            torch.from_numpy(w.astype(np.float32)).to(dev, dtype))


def k4_inputs(case, dtype=None, seed=6):
    """K4's inputs on the card: (a) "gate", bench.py's _kernel_parity shapes:
    G = 8, C = 24, S = 512 per level, coords uniform in [-1.1, 1.1], float32;
    (b) "flagship", the deformable attention's: G = B * H = 8, C = hd = 24,
    S_l = Nq * P = 37376 * 4, bf16 tables (or ``dtype``), locations uniform
    over [-0.018, 1.018] as ``flagship_gather_inputs`` draws them (2 * loc - 1
    in [-1, 1] terms).  Returns (tables [G, X*Y, Z*C], coords, C)."""
    import numpy as np
    import torch

    rng = np.random.RandomState(seed)
    G, C = 8, 24
    if case == "gate":
        S, dtype = 512, dtype or torch.float32
        draw = [rng.uniform(-1.1, 1.1, (G, S, 3)) for _ in K4_PYRAMID]
    else:
        S, dtype = 37376 * 4, dtype or torch.bfloat16
        draw = [2.0 * rng.uniform(-0.018, 1.018, (G, S, 3)) - 1.0 for _ in K4_PYRAMID]
    dev = torch.device("cuda")
    tables = [torch.from_numpy(rng.randn(G, X * Y, Z * C).astype(np.float32)).to(dev, dtype)
              for X, Y, Z in K4_PYRAMID]
    coords = [torch.from_numpy(c.astype(np.float32)).to(dev) for c in draw]
    return tables, coords, C


def k2_fwd_cases(seed=2):
    """K2's readouts on the card, by name: (table, coords) of the per-layer
    route's candidates, its per-slot GT masks at the random fill and its GT
    table (17 class slots as channels) at the candidates, and the batched
    route's three volumes."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    shapes = (("candidates", (1, 128, 128, 16, 192), torch.bfloat16, (1, 150528)),
              ("gt_masks", (17, 256, 256, 32, 1), torch.bool, (17, 12544)),
              ("gt_table_candidates", (1, 256, 256, 32, 17), torch.bool, (1, 150528)),
              ("batched_matching", (10, 128, 128, 16, 100), torch.bfloat16, (10, 50176)),
              ("batched_candidates", (10, 128, 128, 16, 17), torch.float32, (10, 150528)),
              ("batched_random_fill", (170, 128, 128, 16, 1), torch.float32, (170, 12544)))
    for name, tshape, dtype, cshape in shapes:
        if dtype == torch.bool:
            table = (torch.rand(tshape, device="cuda", generator=g) < 0.06).view(torch.uint8)
        else:
            table = torch.randn(tshape, device="cuda", generator=g).to(dtype)
        coords = torch.rand((*cshape, 3), device="cuda", generator=g) * 2 - 1
        yield name, table, coords
        del table, coords


def k2_fwd_path_sweep(widths=SWEEP_WIDTHS, lanes=LANE_SWEEP, seed=10):
    """Both K2 forward paths at the candidate readout's shape (bf16 table [1,
    128, 128, 16, C], 150528 points, border) for each row width C, in turns
    (scalar, row, row, scalar), with the path ``fwd_path`` picks; and the
    row-wide path at C = 192 for each lane-group size."""
    import torch

    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.utils.timing import time_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    coords = torch.rand((1, 150528, 3), device="cuda", generator=g) * 2 - 1
    recs = {}
    for C in widths:
        table = torch.randn((1, 128, 128, 16, C), device="cuda", generator=g).to(torch.bfloat16)
        ms = {"scalar": [], "row": []}
        for path in ("scalar", "row", "row", "scalar"):
            ms[path].append(time_cuda(lambda: k2._launch_fwd(
                table, coords, False, "border", path=path)))
        recs[str(C)] = {"scalar_ms": ms["scalar"], "row_ms": ms["row"],
                        "chosen": k2.fwd_path(table.shape, table.dtype, table.data_ptr()),
                        "lanes": k2.row_lanes(C, table.dtype)}
        if C == widths[-1]:
            recs[f"{C}_by_lanes"] = {str(n): [time_cuda(lambda: k2._launch_fwd(
                table, coords, False, "border", path="row", lanes=n)) for _ in range(2)]
                for n in lanes}
        del table
    return recs


def k2_narrow_sweep(lanes=LANE_SWEEP, points=POINTS_SWEEP):
    """K2's narrow forward at the GT and the batched route's readouts
    (``k2_fwd_cases``): over lane-group sizes at C = 17 and C = 100, over
    points per lane at C = 1; ms twice each, in turns over the settings."""
    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.utils.timing import time_cuda

    recs = {}
    for name, table, coords in k2_fwd_cases():
        C = table.shape[-1]
        if name == "candidates":
            continue
        if C == 1:
            key, opts = "points", [{"points": n} for n in points]
        else:
            key, opts = "lanes", [{"lanes": n} for n in lanes]
        ms = {str(o[key]): [] for o in opts}
        for o in opts + opts[::-1]:
            ms[str(o[key])].append(time_cuda(lambda: k2._launch_fwd(
                table, coords, False, "border", path="scalar", **o)))
        vec = k2.narrow_vec(C, table.dtype, table.data_ptr())
        recs[name] = {"C": C, "vec": vec, f"ms_by_{key}": ms,
                      "default_lanes": k2.narrow_lanes(C, vec),
                      "default_points": k2.NARROW_POINTS_PER_LANE}
    return recs


def k1_row_sweep(lanes=LANE_SWEEP, samples=SAMPLES_SWEEP):
    """K1's row-wide path at the flagship's shapes over lanes per row and
    samples a lane loads at a time, at uniform and local locations, bf16
    and float32: ms twice each, in turns; and the scalar path once each."""
    import torch

    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.utils.timing import time_cuda

    recs = {}
    for dtype in (torch.bfloat16, torch.float32):
        for where, local in (("uniform", False), ("local", True)):
            value, shapes, locs, w = flagship_gather_inputs(dtype, local)
            opts = [(n, k) for n in lanes for k in samples]
            ms = {f"{n}x{k}": [] for n, k in opts}
            for n, k in opts + opts[::-1]:
                ms[f"{n}x{k}"].append(time_cuda(lambda: k1._launch_fwd(
                    value, shapes, locs, w, path="row", lanes=n, samples=k)))
            recs[f"{str(dtype)[6:]}_{where}"] = {
                "ms_by_lanes_x_samples": ms,
                "scalar_ms": time_cuda(lambda: k1._launch_fwd(value, shapes, locs, w,
                                                              path="scalar"))}
            del value, locs, w
    recs["default"] = f"{k1.ROW_LANES}x{k1.ROW_SAMPLES_PER_LANE}"
    return recs


def k2_bwd_path_sweep(widths=SWEEP_WIDTHS, seed=9):
    """Both K2-bwd paths at the candidate readout's shape (bf16 table [1,
    128, 128, 16, C], 150528 points, border) for each row width C: ms lists
    per path and the path ``bwd_path`` picks."""
    import torch

    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.utils.timing import time_cuda

    g = torch.Generator(device="cuda").manual_seed(seed)
    coords = torch.rand((1, 150528, 3), device="cuda", generator=g) * 2 - 1
    recs = {}
    for C in widths:
        table = torch.randn((1, 128, 128, 16, C), device="cuda", generator=g).to(torch.bfloat16)
        gout = torch.randn((1, coords.shape[1], C), device="cuda", generator=g).to(torch.bfloat16)
        ms = {"narrow": [], "segmented": []}
        for path in ("narrow", "segmented", "segmented", "narrow"):
            ms[path].append(time_cuda(lambda: k2._launch_bwd(
                table, coords, gout, False, "border", want_coords=False, path=path)))
        recs[str(C)] = {"narrow_ms": ms["narrow"], "segmented_ms": ms["segmented"],
                        "chosen": k2.bwd_path(table.shape, coords.shape[1])}
        del table, gout
    return recs


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), help="the checkout whose port is timed")
    p.add_argument("--label", default=None, help="a name for the run in the output")
    p.add_argument("--sweep", action="store_true",
                   help="also time both paths of K2-bwd and of K2 over row widths 8-192, "
                        "and the lane groups of K2's and K1's redesigned paths")
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_backwards: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from occformer_tpu_torch.ops import trilerp as k2
    from occformer_tpu_torch.ops import trilerp_fused as k1
    from occformer_tpu_torch.utils.timing import device_ms, time_cuda

    rec = {"label": args.label or args.root, "root": os.path.abspath(args.root),
           "package": os.path.dirname(k1.__file__), "device": torch.cuda.get_device_name(0)}
    for dtype in (torch.bfloat16, torch.float32):
        for where, local in (("uniform", False), ("local", True)):
            value, shapes, locs, w = flagship_gather_inputs(dtype, local)
            rec[f"K1_{str(dtype)[6:]}_{where}_ms"] = time_cuda(
                lambda: k1._launch_fwd(value, shapes, locs, w))
            rec[f"K1_{str(dtype)[6:]}_{where}_device_ms"] = device_ms(
                lambda: k1._launch_fwd(value, shapes, locs, w))
            del value, locs, w
    gen = torch.Generator(device="cuda").manual_seed(1)
    for where, local in (("uniform", False), ("local", True)):
        value, shapes, locs, w = flagship_gather_inputs(torch.bfloat16, local)
        gout = torch.randn((1, locs.shape[1], 8, 24), device="cuda",
                           generator=gen).to(torch.bfloat16)
        rec[f"K1-bwd_{where}_ms"] = time_cuda(
            lambda: k1._launch_bwd(value, shapes, locs, w, gout))
        del value, locs, w, gout
    g = torch.Generator(device="cuda").manual_seed(2)
    table = torch.randn((1, 128, 128, 16, 192), device="cuda", generator=g).to(torch.bfloat16)
    for where, S in (("candidates", 150528), ("random_fill", 17 * 12544)):
        coords = torch.rand((1, S, 3), device="cuda", generator=g) * 2 - 1
        gout = torch.randn((1, S, 192), device="cuda", generator=g).to(torch.bfloat16)
        rec[f"K2-bwd_{where}_ms"] = time_cuda(
            lambda: k2._launch_bwd(table, coords, gout, False, "border", want_coords=False))
    del table, coords, gout
    for name, table, coords in k2_fwd_cases():
        rec[f"K2_{name}_ms"] = time_cuda(lambda: k2._launch_fwd(table, coords, False, "border"))
        # the events also time the wrapper's host work, most of a short launch
        rec[f"K2_{name}_device_ms"] = device_ms(
            lambda: k2._launch_fwd(table, coords, False, "border"))
    del table, coords
    for dtype in (torch.bfloat16, torch.float32):
        tables, coords, C = k4_inputs("flagship", dtype)
        rec[f"K4_{str(dtype)[6:]}_ms"] = time_cuda(
            lambda: k1._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False))
    tables, coords, C = k4_inputs("gate")
    rec["K4_gate_f32_device_ms"] = device_ms(
        lambda: k1._launch_multi_fwd(tables, K4_PYRAMID, C, coords, False))
    if args.sweep:
        rec["K2-bwd_path_sweep"] = k2_bwd_path_sweep()
        rec["K2_path_sweep"] = k2_fwd_path_sweep()
        rec["K2_narrow_sweep"] = k2_narrow_sweep()
        rec["K1_row_sweep"] = k1_row_sweep()
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
