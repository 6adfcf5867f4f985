"""Ops of the port; the hand-written CUDA kernels sit behind the wrappers in
``trilerp_fused`` (K1, K1-bwd, K4, K4-bwd), ``trilerp`` (K2, K2-bwd),
``loss_gather`` (K3) and ``probe`` (P1, P2), the ports of the JAX package's
Pallas kernels, and ``scatter`` (S1, the LSS splat, which the JAX package
leaves to XLA).

Each wrapper counts its kernel's launches in a module-level integer
("K1", "K2" and "K2-bwd" count both paths of their kernel, "K1.row",
"K2.row", "K2-bwd.narrow" and "K4.row" one path alone);
``launch_counts`` reads them all by kernel name and ``reset_launch_counts``
sets them to 0.
"""

# kernel name -> (module, counter) of its wrapper
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
             "S1": ("scatter", "LAUNCHES")}


def _module(name):
    import importlib

    return importlib.import_module(f"{__name__}.{name}")


def launch_counts() -> dict:
    """Launches of every kernel of the port since the last reset."""
    return {k: getattr(_module(mod), var) for k, (mod, var) in _COUNTERS.items()}


def reset_launch_counts():
    for mod, var in _COUNTERS.values():
        setattr(_module(mod), var, 0)
