"""The native C++ BVH builder.

Counterpart of ``rust_pathtracer_tpu/native.py``'s ``build_bvh``.
``csrc/bvh_builder.cpp`` (a copy of the JAX package's) is compiled with
``g++`` at first use into ``csrc/build/libptnative-<hash>.so``
(git-ignored; the hash covers the source and the flags, so an edited
source builds anew) and loaded with ctypes.  This is host code, not a
device kernel: where ``g++`` cannot build the library, ``build_bvh``
returns None after a warning and ``bvh.build_bvh`` takes the numpy
builder, as the JAX package does.

The flags are the JAX package's (``rust_pathtracer_tpu/csrc/Makefile``),
so both libraries order the primitives alike on one machine: the split
is ``std::nth_element``, which leaves each half in the standard
library's order, not ``np.argpartition``'s.  The JAX package's OBJ
parser is not copied: it gives the same arrays as the Python parser
(``scene/obj_loader.py``), which the port keeps as its only one.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import warnings
from pathlib import Path
from typing import Optional

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC / "build"
SOURCES = ("bvh_builder.cpp",)
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_f32p = ctypes.POINTER(ctypes.c_float)
_i32p = ctypes.POINTER(ctypes.c_int)

SIGNATURES = {
    # bbox_min, bbox_max (n, 3), n, leaf_size, node_min, node_max (2n, 3),
    # miss, leaf_first, leaf_count (2n), prim_order (n) -> nodes
    "pt_build_bvh": ([_f32p, _f32p, ctypes.c_int, ctypes.c_int, _f32p, _f32p,
                      _i32p, _i32p, _i32p, _i32p], ctypes.c_int),
}


def library_path() -> Path:
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    for name in SOURCES:
        digest.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libptnative-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless it is already built; raises on failure."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [cxx, *CXXFLAGS, "-o", str(tmp), *[str(CSRC / n) for n in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    return out


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None (with a warning) where it cannot be
    built or loaded."""
    try:
        lib = ctypes.CDLL(str(build()))
    except (OSError, RuntimeError, subprocess.SubprocessError) as err:
        warnings.warn(f"the native BVH builder is unavailable "
                      f"({err}); using the numpy builder, whose BVH order differs from the JAX package's default",
                      RuntimeWarning, stacklevel=2)
        return None
    for fn, (argtypes, restype) in SIGNATURES.items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib


def available() -> bool:
    return load() is not None


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def build_bvh(bbox_min: np.ndarray, bbox_max: np.ndarray, leaf_size: int = 4):
    """The native threaded-BVH build, the layout of ``bvh.build_bvh_numpy``;
    None where the library is unavailable or refuses the arguments."""
    from rust_pathtracer_tpu_torch.bvh import FlatBvh

    lib = load()
    if lib is None:
        return None
    n = int(bbox_min.shape[0])
    if n == 0:
        raise ValueError("cannot build BVH over zero primitives")
    bmin = np.ascontiguousarray(bbox_min, np.float32)
    bmax = np.ascontiguousarray(bbox_max, np.float32)
    cap = 2 * n
    nmin = np.empty((cap, 3), np.float32)
    nmax = np.empty((cap, 3), np.float32)
    miss, leaf_first, leaf_count = (np.empty(cap, np.int32) for _ in range(3))
    order = np.empty(n, np.int32)
    nodes = lib.pt_build_bvh(
        _ptr(bmin, _f32p), _ptr(bmax, _f32p), n, int(leaf_size),
        _ptr(nmin, _f32p), _ptr(nmax, _f32p), _ptr(miss, _i32p),
        _ptr(leaf_first, _i32p), _ptr(leaf_count, _i32p), _ptr(order, _i32p))
    if nodes <= 0:  # leaf_size <= 0: the caller takes the numpy builder
        return None
    return FlatBvh(bbox_min=nmin[:nodes].copy(), bbox_max=nmax[:nodes].copy(),
                   miss=miss[:nodes].copy(), leaf_first=leaf_first[:nodes].copy(),
                   leaf_count=leaf_count[:nodes].copy(), prim_order=order)

