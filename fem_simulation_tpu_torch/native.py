"""Build and load the host topology builder (csrc/topology.cpp) with g++.

Port of `fem_simulation_tpu/native/__init__.py`. The library is built at
first use, from the package's own source, into `fem_simulation_tpu_torch/
build/` under a name keyed by a hash of the source and flags, so an edited
source is rebuilt and an unchanged one reused. A missing g++, a failed
build or a failed load raises: there is no silent fallback. The numpy
paths of hierarchy.py and mesh.py are the plain versions (`use_native=
False` there), and every entry here returns their bits.

No `-march=native` and no contraction of products into FMAs: the outputs
must not depend on the host the library was built on.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_BUILD = os.path.join(_PKG, "build")
# the source built; tests point it at another to see a failed build raise
SOURCE = os.path.join(_PKG, "csrc", "topology.cpp")
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-ffp-contract=off")

_libs: dict = {}
# host seconds of this process's last build (0.0: none built here)
build_seconds = 0.0


def _so_path(source: str) -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(source, "rb") as fh:
        h.update(fh.read())
    return os.path.join(_BUILD, f"libfemtopo_{h.hexdigest()[:16]}.so")


def _build(source: str, so_path: str) -> None:
    global build_seconds
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found on PATH: cannot build the native "
                           "topology builder (use_native=False takes the "
                           "numpy path)")
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, source, "-o", tmp]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"building the native topology builder failed "
                           f"({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, so_path)     # atomic: concurrent builds agree


def load():
    """The loaded library of SOURCE, building it first if needed."""
    source = SOURCE
    if source in _libs:
        return _libs[source]
    so_path = _so_path(source)
    if not os.path.exists(so_path):
        _build(source, so_path)
    lib = ctypes.CDLL(so_path)
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.galerkin_plan.restype = i64
    lib.galerkin_plan.argtypes = [i32p, i32p, i32p, i64, i32p, f32p, i32p,
                                  i32p, i64, i32p, i32p, f32p, i64]
    lib.hex_pairs_unique.restype = i64
    lib.hex_pairs_unique.argtypes = [i32p, i64, i64, i32p]
    lib.hex_slot_map.restype = i64
    lib.hex_slot_map.argtypes = [i32p, i64, i32p, i32p, i64, i32p]
    lib.points_inside_parity.restype = i64
    lib.points_inside_parity.argtypes = [f64p, i64, f64p, i32p, i64, u8p]
    _libs[source] = lib
    return lib


def hex_pairs_unique(hexes: np.ndarray) -> np.ndarray:
    """The sorted unique (row, col) vertex pairs of every hex's 8 x 8
    couplings, (P, 2) int32: np.unique of the pairs."""
    lib = load()
    flat = np.ascontiguousarray(hexes.reshape(-1), np.int32)
    H = hexes.shape[0]
    out = np.empty((H * 64, 2), np.int32)
    n = lib.hex_pairs_unique(flat, H, H * 64, out)
    if n < 0:
        raise RuntimeError(f"hex_pairs_unique failed: {n}")
    return out[:n].copy()


def hex_slot_map(hexes: np.ndarray, nbr: np.ndarray,
                 deg: np.ndarray) -> np.ndarray:
    """(H, 8, 8) int32: the flat block-ELL slot row * K + slot of each
    hex's coupling (a, b), row = hexes[h, a], found in the row's ascending
    real prefix of `deg` entries."""
    lib = load()
    flat = np.ascontiguousarray(hexes.reshape(-1), np.int32)
    nbr_f = np.ascontiguousarray(nbr.reshape(-1), np.int32)
    deg = np.ascontiguousarray(deg, np.int32)
    H = hexes.shape[0]
    out = np.empty(H * 64, np.int32)
    if lib.hex_slot_map(flat, H, nbr_f, deg, nbr.shape[1], out) < 0:
        raise RuntimeError("hex_slot_map: a coupling is missing from the "
                           "stencil")
    return out.reshape(H, 8, 8)


def galerkin_plan(fi, fj, src_flat, p_idx, p_w, cnbr, cdeg, Kc):
    """The Galerkin plan A_c[I, J] += wI wJ A[i, j] over the fine entries
    (fi, fj) at flat slots src_flat: (g_src, g_dst, g_w) in entry, then
    contributor-pair order, the zero-weight pairs left out."""
    lib = load()
    fi = np.ascontiguousarray(fi, np.int32)
    fj = np.ascontiguousarray(fj, np.int32)
    src_flat = np.ascontiguousarray(src_flat, np.int32)
    p_idx_f = np.ascontiguousarray(p_idx.reshape(-1), np.int32)
    p_w_f = np.ascontiguousarray(p_w.reshape(-1), np.float32)
    cnbr_f = np.ascontiguousarray(cnbr.reshape(-1), np.int32)
    cdeg = np.ascontiguousarray(cdeg, np.int32)
    cap = fi.size * 64
    g_src = np.empty(cap, np.int32)
    g_dst = np.empty(cap, np.int32)
    g_w = np.empty(cap, np.float32)
    n = lib.galerkin_plan(fi, fj, src_flat, fi.size, p_idx_f, p_w_f, cnbr_f,
                          cdeg, Kc, g_src, g_dst, g_w, cap)
    if n < 0:
        raise RuntimeError(f"galerkin_plan failed: {n}")
    return g_src[:n].copy(), g_dst[:n].copy(), g_w[:n].copy()


def points_inside(points: np.ndarray, verts: np.ndarray,
                  tris: np.ndarray) -> np.ndarray:
    """The ray-parity inside test of mesh._points_inside: (P,) bool."""
    lib = load()
    points = np.ascontiguousarray(points, np.float64)
    verts = np.ascontiguousarray(verts, np.float64)
    tris = np.ascontiguousarray(tris.reshape(-1), np.int32)
    out = np.empty(points.shape[0], np.uint8)
    n = lib.points_inside_parity(points, points.shape[0], verts, tris,
                                 tris.size // 3, out)
    if n != points.shape[0]:
        raise RuntimeError(f"points_inside_parity failed: {n}")
    return out.astype(bool)
