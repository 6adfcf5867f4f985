"""Ops of the port; the hand-written CUDA kernels sit behind the wrappers in
``trilerp_fused`` (K1, K1-bwd, K4, K4-bwd), ``trilerp`` (K2, K2-bwd),
``loss_gather`` (K3) and ``probe`` (P1, P2), the ports of the JAX package's
Pallas kernels, ``scatter`` (S1, the LSS splat, and S1-rows, the splat of
given rows, which the JAX package leaves to XLA, and their backwards S1-bwd
and S1-rows-bwd) and ``pointcloud`` (FPS,
furthest-point sampling, a ``fori_loop`` in the JAX package).

Every kernel is a ``torch.library`` custom op in the ``occformer``
namespace (``library.OPS``), registered when this package is imported: a
process that loads an exported program imports ``occformer_tpu_torch.ops``
and nothing else of the port.

Each op's CUDA implementation counts its kernel's launches in a
module-level integer
("K2" and "K2-bwd" count both paths of their kernel, "K2.row" and
"K2-bwd.narrow" one path alone; "K1.row" and "K4.row" count the row-wide
kernel, which every launch of K1 and K4 takes);
``launch_counts`` reads them all by kernel name and ``reset_launch_counts``
sets them to 0.
"""

from . import library, loss_gather, pointcloud, probe, scatter, trilerp, trilerp_fused

# kernel name -> (module, counter) of its op's CUDA implementation
_COUNTERS = {"K1": ("trilerp_fused", "LAUNCHES"), "K1.row": ("trilerp_fused", "ROW_LAUNCHES"),
             "K1-bwd": ("trilerp_fused", "BWD_LAUNCHES"),
             "K2": ("trilerp", "LAUNCHES"), "K2.row": ("trilerp", "ROW_LAUNCHES"),
             "K2-bwd": ("trilerp", "BWD_LAUNCHES"),
             "K2-bwd.narrow": ("trilerp", "BWD_NARROW_LAUNCHES"),
             "K3": ("loss_gather", "LAUNCHES"),
             "K4": ("trilerp_fused", "MULTI_LAUNCHES"),
             "K4.row": ("trilerp_fused", "MULTI_ROW_LAUNCHES"),
             "K4-bwd": ("trilerp_fused", "MULTI_BWD_LAUNCHES"),
             "P1": ("probe", "ADD_ONE_LAUNCHES"), "P2": ("probe", "ROW_GATHER_LAUNCHES"),
             "S1": ("scatter", "LAUNCHES"), "S1-bwd": ("scatter", "BWD_LAUNCHES"),
             "S1-rows": ("scatter", "ROWS_LAUNCHES"),
             "S1-rows-bwd": ("scatter", "ROWS_BWD_LAUNCHES"),
             "FPS": ("pointcloud", "FPS_LAUNCHES")}

_MODULES = {"trilerp_fused": trilerp_fused, "trilerp": trilerp, "loss_gather": loss_gather,
            "probe": probe, "scatter": scatter, "pointcloud": pointcloud}


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    return {k: getattr(_MODULES[mod], var) for k, (mod, var) in _COUNTERS.items()}


def reset_launch_counts():
    for mod, var in _COUNTERS.values():
        setattr(_MODULES[mod], var, 0)
