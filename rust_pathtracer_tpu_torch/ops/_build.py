"""Build the CUDA kernels at first use and load them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface.  ``nvcc`` compiles
it for Hopper (``sm_90a``) into ``build/<name>-<hash>.so`` beside this
file, keyed by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source builds anew and an unchanged one
loads at once.  The library is then
loaded with ctypes; every pointer, and the stream, is passed as
``ctypes.c_void_p``.

Floats are IEEE on purpose: no ``--use_fast_math`` (IEEE division and
sqrt, no flush to zero, precise sin/cos) and ``--fmad=false`` (no
contraction into fused multiply-adds), so a kernel rounds op for op
like its plain PyTorch twin.

No fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_c_void_p, _c_int, _c_uint = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint

# C signature of each library's entry points: name -> (argtypes, restype)
SIGNATURES: Dict[str, Dict[str, Tuple[List, object]]] = {
    "fused_bounce": {
        # table, n_prims, bg, seed, t_min, mat_flags, tex_flags, in (13
        # rows), keys (2 rows), bounce, roulette, depth (a per-lane bounce,
        # or NULL), rr_start, out (13 rows), res (9 or 10 rows, or NULL),
        # flags, winner (or NULL), n_lanes, stream
        "fused_bounce_launch": (
            [_c_void_p, _c_int, _c_void_p, _c_uint, ctypes.c_float, _c_int,
             _c_int, _c_void_p, _c_void_p, _c_uint, _c_int, _c_void_p, _c_int,
             _c_void_p, _c_void_p, _c_void_p, _c_void_p, ctypes.c_longlong,
             _c_void_p],
            _c_int,
        ),
        "error_string": ([_c_int], ctypes.c_char_p),
    },
    "fused_bounce_bwd": {
        # n_lanes, n_prims -> blocks of the launch on the current device
        # (columns of the partials scratch)
        "fused_bounce_bwd_blocks": ([ctypes.c_longlong, _c_int], _c_int),
        # in_ptrs[28], out_ptrs[9], bg, mat_flags, n_prims, partials,
        # reduced, n_lanes, stream
        "fused_bounce_bwd_launch": (
            [_c_void_p, _c_void_p, _c_void_p, _c_int, _c_int, _c_void_p,
             _c_void_p, ctypes.c_longlong, _c_void_p],
            _c_int,
        ),
        "error_string": ([_c_int], ctypes.c_char_p),
    },
    "draws": {
        # keys (2 rows), depth (a per-lane bounce, or NULL), bounce,
        # roulette, out (6 or 7 rows), n_lanes, stream
        "bounce_draws_launch": (
            [_c_void_p, _c_void_p, _c_uint, _c_int, _c_void_p, ctypes.c_longlong,
             _c_void_p],
            _c_int,
        ),
        "error_string": ([_c_int], ctypes.c_char_p),
    },
    "closest_hit": {
        # table, n_prims, o, d, t_min, record (0: K4, 1: K3), out (one
        # buffer, planes at multiples of 16 bytes), n_lanes, stream
        "closest_hit_launch": (
            [_c_void_p, _c_int, _c_void_p, _c_void_p, ctypes.c_float, _c_int,
             _c_void_p, ctypes.c_longlong, _c_void_p],
            _c_int,
        ),
        "error_string": ([_c_int], ctypes.c_char_p),
    },
    "projected": {
        # mode (0: K5, 1: K6, 2: K7), tab_ptrs[5], C, G, words, kcap, rb,
        # W, o, d, t_min, t_out, c_out, pay_out, n_lanes, stream
        "projected_launch": (
            [_c_int, _c_void_p, _c_int, _c_int, _c_void_p, _c_int, _c_int,
             ctypes.c_longlong, _c_void_p, _c_void_p, ctypes.c_float,
             _c_void_p, _c_void_p, _c_void_p, ctypes.c_longlong, _c_void_p],
            _c_int,
        ),
        "error_string": ([_c_int], ctypes.c_char_p),
    },
}

# name -> {"seconds": build seconds (0.0 when loaded from the cache),
#          "command": the nvcc command, "log": nvcc's output}
build_info: Dict[str, dict] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of rust_pathtracer_tpu_torch build at first use and need "
        "the CUDA toolkit")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):  # what a source may include
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    src = CSRC / f"{name}.cu"
    out = _library_path(name)
    if out.exists():
        build_info[name] = {"seconds": 0.0, "command": None, "log": ""}
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) building {src}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: concurrent builders never see half a file
    build_info[name] = {"seconds": seconds, "command": " ".join(cmd),
                        "log": proc.stdout + proc.stderr}
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, with its C
    signatures declared."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, (argtypes, restype) in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = restype
    return lib
