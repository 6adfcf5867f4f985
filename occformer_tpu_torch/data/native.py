"""ctypes bindings of the port's native data kernels (``csrc/occ_data.cpp``).

The port's copy of ``occformer_tpu/data/native.py``: majority-vote
voxelization, the z-buffered LiDAR depth and bit unpacking, compiled with
``g++`` at first use into ``occformer_tpu_torch/_build/`` (named by a hash
of the source and the flags) and loaded with ``ctypes``.  Unlike the JAX
package's loader, a failed build or load raises: the pipeline never falls
back to numpy quietly.  The numpy versions (``data/voxelize.py:
majority_vote_plain``, ``data/transforms.py:zbuffer_depth_plain``,
``np.unpackbits``) are the plain versions the tests hold these against.
The build is serialised by a lock, since the loader's producer thread is
usually the first caller.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "occ_data.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libocc_data-{h.hexdigest()[:16]}.so")


def build_native(cxx: str = "g++", force: bool = False) -> str:
    """Compile ``csrc/occ_data.cpp`` with ``cxx`` (unless already built) and
    return the library's path; raises ``RuntimeError`` with the compiler's
    output when the compiler cannot run or fails."""
    out = library_path()
    if os.path.exists(out) and not force:
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    try:
        r = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp], capture_output=True,
                           text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"the native data library cannot be built: {cxx}: {e}") from e
    if r.returncode != 0:
        raise RuntimeError(f"the native data library failed to build ({cxx} exited "
                           f"{r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built first if needed; raises when it cannot be."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            path = build_native()
            try:
                lib = ctypes.CDLL(path)
            except OSError as e:
                raise RuntimeError(f"the native data library {path} does not load: {e}") from e
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            lib.majority_vote.argtypes = [i64p, i64p, ctypes.c_int64, ctypes.c_int64,
                                          ctypes.c_int32, i64p]
            lib.zbuffer_depth.argtypes = [i32p, i32p, f32p, u8p, ctypes.c_int64,
                                          ctypes.c_int64, ctypes.c_int64, f32p]
            lib.unpack_bits.argtypes = [u8p, ctypes.c_int64, u8p]
            lib.pack_bits.argtypes = [u8p, ctypes.c_int64, u8p]
            for fn in (lib.majority_vote, lib.zbuffer_depth, lib.unpack_bits, lib.pack_bits):
                fn.restype = None
            _LIB = lib
        return _LIB


def majority_vote_native(flat_idx: np.ndarray, labels: np.ndarray, n_voxels: int,
                         empty_id: int, suppress_zero: bool = False) -> np.ndarray:
    """[n_voxels] int64: each voxel's most frequent label (ties: the
    smallest; ``suppress_zero``: label 0 only when alone), ``empty_id``
    where no point falls.  ``flat_idx`` must lie in [0, n_voxels)."""
    flat_idx = np.ascontiguousarray(flat_idx, np.int64)
    labels = np.ascontiguousarray(labels, np.int64).reshape(-1)
    if flat_idx.shape != labels.shape:
        raise ValueError(f"{flat_idx.shape} voxel indices, {labels.shape} labels")
    out = np.full(n_voxels, empty_id, np.int64)
    get_lib().majority_vote(flat_idx, labels, len(flat_idx), n_voxels, int(suppress_zero), out)
    return out


def zbuffer_depth_native(u: np.ndarray, v: np.ndarray, d: np.ndarray, valid: np.ndarray,
                         h: int, w: int) -> np.ndarray:
    """[h, w] float32 sparse depth: per pixel the nearest valid return, 0
    where none falls."""
    n = len(u)
    if not (len(v) == len(d) == len(valid) == n):
        raise ValueError("u, v, d and valid must have one length")
    depth = np.zeros(h * w, np.float32)
    get_lib().zbuffer_depth(np.ascontiguousarray(u, np.int32), np.ascontiguousarray(v, np.int32),
                            np.ascontiguousarray(d, np.float32),
                            np.ascontiguousarray(valid, np.uint8), n, h, w, depth)
    return depth.reshape(h, w)


def unpack_bits_native(data: np.ndarray) -> np.ndarray:
    """MSB-first bit unpack, as ``np.unpackbits``."""
    data = np.ascontiguousarray(data, np.uint8).reshape(-1)
    out = np.empty(len(data) * 8, np.uint8)
    get_lib().unpack_bits(data, len(data), out)
    return out
