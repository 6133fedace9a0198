"""Build and load the port's CUDA kernels (csrc/) with nvcc and ctypes.

One shared library holds every kernel: lattice_kernels.cu (with
lattice_chain.cuh) and ell_kernels.cu (the SpMV, the fused smoothers and
their backward kernels). It
is built at first use, from the package's own sources, into `fem_simulation_tpu_torch/build/` under a name
keyed by a hash of the sources and flags, so an edited source is rebuilt
and an unchanged one is reused. Each translation unit gets its own nvcc,
all started together, and one more nvcc links them. A missing nvcc, a
failed build or a failed load raises: there is no fallback to the plain
torch versions for CUDA tensors.

Also the wrappers' shared dispatch and argument checks (`on_cpu`,
`require`, `records_grad`, `refuse_grad`).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(_PKG, "build")
_SOURCES = ("lattice_chain.cuh", "cluster.cuh", "lattice_kernels.cu",
            "ell_kernels.cu")
_UNITS = ("lattice_kernels.cu", "ell_kernels.cu")     # one nvcc -c each
# IEEE division and square root stay on: never --use_fast_math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lib = None
# what the last build printed (ptxas registers, spills) and how long it took
build_log = ""
build_seconds = 0.0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       "/usr/local/cuda/bin): cannot build the CUDA kernels")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in _SOURCES:
        with open(os.path.join(_CSRC, name), "rb") as fh:
            h.update(name.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def _build(so_path: str) -> None:
    global build_log, build_seconds
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    tmp = f"{so_path}.{os.getpid()}.tmp"
    objs = [f"{tmp}.{unit}.o" for unit in _UNITS]
    t0 = time.perf_counter()
    jobs = []
    for unit, obj in zip(_UNITS, objs):
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, os.path.join(_CSRC, unit)]
        jobs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT,
                                           text=True)))
    logs, failed = [], None
    for cmd, proc in jobs:                  # wait for every compile
        out, _ = proc.communicate()
        logs.append(out)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, out)
    if failed is None:
        cmd = [nvcc, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        logs.append(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed = (cmd, proc.returncode, logs[-1])
    for obj in objs:
        if os.path.exists(obj):
            os.remove(obj)
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    if failed is not None:
        cmd, rc, out = failed
        raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(cmd)}\n{out}")
    os.replace(tmp, so_path)


def _declare(lib) -> None:
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    chain = [I, I, I, P, F, F, F, P]          # X, Y, Z, g, det, mu, la, stream
    lib.lat_force.argtypes = [P, P, P, P, P, I] + [I] * 5 + chain
    lib.lat_hvp.argtypes = [P] * 7 + [I] * 5 + chain
    lib.lat_diag.argtypes = [P] * 6 + [I] * 7 + chain
    lib.lat_energy.argtypes = [P, P, P, P, P, P, I, I, I] + chain
    lib.lat_newton_plan.argtypes = [I, I, I, I, I, ctypes.POINTER(I)]
    lib.lat_fused_newton.argtypes = (
        [F] + [P] * 19 + [I] * 11 + [P, F, F, F, I, P])
    lib.lat_fused_pcg.argtypes = (
        [F] + [P] * 15 + [I] * 10 + [P, F, F, F, I, P])
    lib.lat_level_plan.argtypes = [I] * 7 + [ctypes.POINTER(I)]
    lib.lat_cheby.argtypes = [P] * 12 + [I] * 5 + chain
    lib.lat_power.argtypes = [P] * 10 + [I] * 5 + chain
    lib.ell_spmv.argtypes = [P, P, P, P, P, I, I, I, P]
    lib.ell_gs.argtypes = ([P, P, P, P, ctypes.POINTER(I), I, P, P]
                           + [I] * 5 + [P])
    lib.ell_gs_plan.argtypes = [I, I, ctypes.POINTER(I), I, I,
                                ctypes.POINTER(I)]
    lib.ell_jacobi.argtypes = [P] * 7 + [I] * 4 + [P]
    lib.ell_spmv_t.argtypes = [P] * 6 + [F, I, I, I, P]
    lib.ell_spmv_t_plan.argtypes = [I, I, ctypes.POINTER(I)]
    lib.ell_outer.argtypes = [P] * 5 + [F, I, P, I, I, P]
    lib.ell_jacobi_bwd.argtypes = [P] * 10 + [I, I, I, P]
    lib.lat_error_string.argtypes = [I]
    lib.lat_error_string.restype = ctypes.c_char_p
    for name in ("lat_force", "lat_hvp", "lat_diag", "lat_energy",
                 "lat_newton_plan", "lat_level_plan", "lat_cheby",
                 "lat_power", "lat_fused_newton",
                 "lat_fused_pcg",
                 "ell_spmv", "ell_gs", "ell_gs_plan", "ell_jacobi",
                 "ell_spmv_t", "ell_spmv_t_plan",
                 "ell_outer", "ell_jacobi_bwd"):
        getattr(lib, name).restype = I


def load():
    """The loaded kernel library, building it first if needed."""
    global _lib
    if _lib is None:
        so_path = os.path.join(_BUILD, f"libkernels_{_digest()}.so")
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


def on_cpu(*tensors) -> bool:
    """True for CPU tensors; False for CUDA tensors on one device; raises on
    anything else."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


def records_grad(*tensors) -> bool:
    """True when autograd records and one of the tensors (None: skipped)
    requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    """Raise when records_grad(*tensors): `what` is a kernel wrapper with no
    backward, whose output would carry no grad_fn (a silent detach)."""
    if records_grad(*tensors):
        raise RuntimeError(
            f"{what} has no backward: call it under torch.no_grad() or on "
            "tensors that do not require grad")


def require(t: torch.Tensor, shape, name: str, dtype=torch.float32) -> None:
    """Raise unless t has this dtype and shape and is contiguous."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
