"""Build and load the lattice CUDA kernels (csrc/) with nvcc and ctypes.

The shared library is built at first use, from the package's own sources,
into `fem_simulation_tpu_torch/build/` under a name keyed by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. A missing nvcc, a failed build or a failed load raises: there is no
fallback to the plain torch versions for CUDA tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")
_SOURCES = ("lattice_chain.cuh", "lattice_kernels.cu")
# IEEE division and square root stay on: never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# what the last build printed (ptxas registers, spills) and how long it took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): cannot build the lattice "
                       "CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _build(so_path: str) -> None:
    global build_log, build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           os.path.join(_CSRC, "lattice_kernels.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{build_log}")
    os.replace(tmp, so_path)


def _declare(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    chain = [I, I, I, P, F, F, F, P]          # X, Y, Z, g, det, mu, la, stream
    lib.lat_force.argtypes = [P, P, P, P] + chain
    lib.lat_hvp.argtypes = [P, P, P, P, P] + chain
    lib.lat_diag.argtypes = [P, P, P, P] + chain
    lib.lat_energy.argtypes = [P, P, P, P] + chain
    lib.lat_energy_partials.argtypes = [I, I, I]
    lib.lat_newton_grid.argtypes = [I, I, I, ctypes.POINTER(I)]
    lib.lat_fused_newton.argtypes = (
        [F] + [P] * 17 + [I, I, I, I, P, F, F, F, I, P])
    lib.lat_error_string.argtypes = [I]
    lib.lat_error_string.restype = ctypes.c_char_p
    for name in ("lat_force", "lat_hvp", "lat_diag", "lat_energy",
                 "lat_energy_partials", "lat_newton_grid",
                 "lat_fused_newton"):
        getattr(lib, name).restype = I


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        so_path = os.path.join(_BUILD, f"liblattice_{_digest()}.so")
        if not os.path.exists(so_path):
            _build(so_path)
        lib = ctypes.CDLL(so_path)
        _declare(lib)
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        msg = _lib.lat_error_string(err).decode() if _lib is not None else ""
        raise RuntimeError(f"{what}: CUDA error {err} {msg}")
