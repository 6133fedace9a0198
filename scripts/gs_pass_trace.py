#!/usr/bin/env python3
"""Where a pass of ell_gs's staged forms spends its time, on one GPU.

    python3 scripts/gs_pass_trace.py

Builds a copy of csrc/ell_kernels.cu with clock64() stamps added to the
cluster and the cooperative staged kernels (thread 0 of block 0 adds, in
every pass, the SM cycles from the pass's start to: its first row's
relaxation starting, that relaxation done, its stores done (cluster form),
the block barrier passed, the wait for the other blocks' rows or the grid
barrier passed) into fem_simulation_tpu_torch/build/gs_trace/, runs 3
iterations from zero in several forms at every multigrid level of the 2k
and 19k beams (chip_smoke.py's phase 4 systems) and prints the mean cycles
a pass of each mark. The stamps' own atomics add a little to each mark.
"""
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch import require_cuda  # noqa: E402
from fem_simulation_tpu_torch.config import SolverConfig  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import ell_kernels as ek  # noqa: E402
from fem_simulation_tpu_torch.sim import quasistatic as qs  # noqa: E402
from fem_simulation_tpu_torch.sim.scene import Scene  # noqa: E402

MARKS = ("relaxation starts", "relaxation done", "stores done",
         "block barrier", "wait / grid barrier")


def instrumented(src: str) -> str:
    """The kernels' source with the stamps (gs_trace[0] counts passes,
    gs_trace[1..5] the marks' cycles; gs_trace_read copies and zeroes)."""
    s = src.replace("namespace cg = cooperative_groups;", """\
namespace cg = cooperative_groups;
__device__ unsigned long long gs_trace[8];
__device__ __forceinline__ void tr_add(int k, long long t0) {
    atomicAdd(&gs_trace[k], (unsigned long long)(clock64() - t0));
}
extern "C" int gs_trace_read(unsigned long long* out) {
    cudaDeviceSynchronize();
    int e = cudaMemcpyFromSymbol(out, gs_trace, sizeof(gs_trace));
    unsigned long long z[8] = {};
    cudaMemcpyToSymbol(gs_trace, z, sizeof(z));
    return e;
}""", 1)
    start = ("\n        const bool TR = blockIdx.x == 0 && threadIdx.x == 0;"
             " long long t0 = clock64();"
             " if (TR) atomicAdd(&gs_trace[0], 1ull);")
    key = "        pos = pos + 1 == B.period ? 0 : pos + 1;"
    at = 0
    for _ in range(2):                       # the cluster and grid kernels
        at = s.index(key, at) + len(key)
        s = s[:at] + start + s[at:]
    for call in ("relax_staged(T, l, live ? l : l0",
                 "relax_staged(T, base + i,"):
        at = s.index(call)
        s = s[:at] + "if (TR && (group >> 2) == 0) tr_add(1, t0);\n" + s[at:]
        end = s.index("o0, o1, o2);", at) + len("o0, o1, o2);")
        s = s[:end] + "\n            if (TR) tr_add(2, t0);" + s[end:]
    wait = ("        __syncthreads();  // this block's rows of color c seen "
            "by its warps\n        mbar_wait(bar, (p >> 1) & 1);  // and "
            "the other blocks' rows")
    s = s.replace(wait, "        if (TR) tr_add(3, t0);\n        "
                  "__syncthreads();\n        if (TR) tr_add(4, t0);\n"
                  "        mbar_wait(bar, (p >> 1) & 1);\n"
                  "        if (TR) tr_add(5, t0);")
    sync = "        if (p + 1 < P.passes) grid.sync();"
    at = s.rindex(sync)
    s = (s[:at] + "        if (TR) tr_add(4, t0);\n" + sync
         + "\n        if (TR) tr_add(5, t0);" + s[at + len(sync):])
    if s.count("tr_add(") < 10:
        raise RuntimeError("the kernels' source no longer has the marks' "
                           "anchors")
    return s


def build():
    out = os.path.join(ROOT, "fem_simulation_tpu_torch", "build", "gs_trace")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(_cuda._CSRC, "ell_kernels.cu")) as fh:
        src = instrumented(fh.read())
    cu, so = os.path.join(out, "ell_trace.cu"), os.path.join(out, "ell_trace.so")
    with open(cu, "w") as fh:
        fh.write(src)
    flags = [f for f in _cuda.NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_cuda._nvcc(), *flags, "-shared", "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    P, I = ctypes.c_void_p, ctypes.c_int
    lib.ell_gs.argtypes = [P, P, P, P, ctypes.POINTER(I), I, P, P] + [I] * 5 + [P]
    lib.gs_trace_read.argtypes = [P]
    return lib


def main() -> int:
    dev = require_cuda()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    lib = build()
    buf = (ctypes.c_ulonglong * 8)()
    lib.gs_trace_read(buf)
    for label, beam, levels in (("2k", (8, 8, 24), 2), ("19k", (16, 16, 64), 3)):
        sc = Scene(meshlib.beam(*beam, dx=0.05),
                   solver=SolverConfig(n_levels=levels), device=dev)
        rng = np.random.default_rng(11)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(dev)
        chain = qs.galerkin_chain(sc, sc.params,
                                  qs.assemble_fine(sc, sc.params, x))
        for li, vals in enumerate(chain):
            op = sc.make_op(li)
            n, k = vals.shape[0], vals.shape[1]
            offs = [int(c) for c in op.color_offsets]
            b = torch.from_numpy(rng.standard_normal((n, 3)).astype(
                np.float32)).to(dev)
            for form, blocks in ((ek.GS_CLUSTER, 4), (ek.GS_CLUSTER, 16),
                                 (ek.GS_RESIDENT, 33), (ek.GS_RESIDENT, 132),
                                 (ek.GS_STREAM, 132)):
                rows = ek.gs_layout_rows(offs, form, blocks)
                if ek.gs_smem_bytes(form, n, k, rows) > ek.GS_SMEM_CAP:
                    continue
                xo = torch.zeros_like(b)

                def call():
                    return lib.ell_gs(
                        vals.data_ptr(), op.nbr.data_ptr(),
                        op.mask.data_ptr(), op.diag_slot.data_ptr(),
                        (ctypes.c_int * len(offs))(*offs), len(offs) - 1,
                        b.data_ptr(), xo.data_ptr(), n, k, 3, form, blocks,
                        torch.cuda.current_stream().cuda_stream)
                err = call()
                lib.gs_trace_read(buf)           # the first call warms up
                for _ in range(5):
                    err = err or call()
                lib.gs_trace_read(buf)
                passes = max(buf[0], 1)
                marks = "  ".join(f"{m} {buf[i + 1] / passes:.0f}"
                                  for i, m in enumerate(MARKS))
                print(f"{label} level {li} N {n} {ek.GS_FORMS[form]} {blocks}"
                      f" (error {err}): cycles from a pass's start: {marks}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
