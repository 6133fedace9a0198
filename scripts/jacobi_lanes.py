#!/usr/bin/env python3
"""Time ell_jacobi at 8, 16 and 32 lanes a row at the paths' shapes, on one GPU.

    python3 scripts/jacobi_lanes.py [--out DIR]

ell_jacobi's C entry picks its lanes a row itself (`jacobi_lanes` in
`csrc/ell_kernels.cu`: the most of 32 / 16 / 8 whose grid fits one wave).
To time the other counts, the script builds three more copies of the
kernel library under DIR (default `.scratch/jacobi_lanes` in this
checkout), each from this tree's `csrc/` with `jacobi_lanes` made to
return one G, and calls each copy's `ell_jacobi` in this process on the
paths' inputs: one iteration from zero and from x0 on level 1 of the 2k,
19k and 74k beams' Galerkin chains (325 / 2,673 / 10,449 rows) and on
exp2's coarse matrix (21k level 1, 2,997 rows), seeded as
`scripts/ell_tilings.py` seeds them. Every copy's output must be
bit-equal to the package wrapper's, and its kernel must be the one of G
lanes. The script prints the device us of a launch (torch.profiler) for
the wrapper and each G, and exits 1 where a check fails.
"""
import argparse
import concurrent.futures
import importlib.util
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch import require_cuda  # noqa: E402
from fem_simulation_tpu_torch.config import SolverConfig  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import ell_kernels as ek  # noqa: E402
from fem_simulation_tpu_torch.sim import quasistatic as qs  # noqa: E402
from fem_simulation_tpu_torch.sim.scene import Scene  # noqa: E402

LANES = (8, 16, 32)
RULE = re.compile(r"int jacobi_lanes\(int N, int sms\) \{.*?\n\}", re.S)


def forced_library(out, lanes):
    """Load a copy of this tree's kernel library whose jacobi_lanes always
    returns `lanes`, built under out/g<lanes> by a copy of ops/_cuda.py."""
    pkg = os.path.join(out, f"g{lanes}", "fem_simulation_tpu_torch")
    shutil.rmtree(os.path.join(pkg, "csrc"), ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "fem_simulation_tpu_torch", "csrc"),
                    os.path.join(pkg, "csrc"))
    os.makedirs(os.path.join(pkg, "ops"), exist_ok=True)
    shutil.copy(os.path.join(ROOT, "fem_simulation_tpu_torch", "ops",
                             "_cuda.py"), os.path.join(pkg, "ops"))
    src = os.path.join(pkg, "csrc", "ell_kernels.cu")
    with open(src) as fh:
        text, n = RULE.subn(
            f"int jacobi_lanes(int, int) {{ return {lanes}; }}", fh.read())
    if n != 1:
        raise RuntimeError(f"jacobi_lanes not found once in {src}")
    with open(src, "w") as fh:
        fh.write(text)
    spec = importlib.util.spec_from_file_location(
        f"jacobi_lanes_{lanes}", os.path.join(pkg, "ops", "_cuda.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.load()


def systems(dev):
    """[(label, op, values, b, x0)]: level 1 of each beam's chain (rng 11
    for the state, then each level's b and x0 in turn) and exp2's coarse
    matrix at 21k (rng 19 for the state, rng 23 for b and x0)."""
    out = []
    for label, beam in cs.BEAMS.items():
        solver = SolverConfig(n_levels=2) if label == "2k" else SolverConfig()
        sc = Scene(meshlib.beam(*beam, dx=cs.DX), solver=solver, device=dev)
        rng = np.random.default_rng(11)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(dev)
        chain = qs.galerkin_chain(sc, sc.params,
                                  qs.assemble_fine(sc, sc.params, x))
        for li, vals in enumerate(chain):
            n = vals.shape[0]
            b, x0 = (torch.from_numpy(s * rng.standard_normal((n, 3)).astype(
                np.float32)).to(dev) for s in (1.0, 0.1))
            if li == 1:
                out.append((f"{label} level 1 N {n}", sc.make_op(1), vals, b,
                            x0))
    sc21 = Scene(meshlib.beam(*cs.EXP_BEAM, dx=cs.DX),
                 solver=SolverConfig(n_levels=2), device=dev)
    rng = np.random.default_rng(19)
    x = sc21.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(sc21.x0.shape)).astype(np.float32)).to(dev)
    vals = cs.exp2_coarse_values(sc21, x)
    n = vals.shape[0]
    rng = np.random.default_rng(23)
    b, x0 = (torch.from_numpy(s * rng.standard_normal((n, 3)).astype(
        np.float32)).to(dev) for s in (1.0, 0.1))
    out.append((f"21k level 1 N {n}", sc21.make_op(1), vals, b, x0))
    return out


def call_library(lib, vals, op, b, start):
    """One ell_jacobi iteration through `lib`'s C entry into a new tensor."""
    n, k = vals.shape[:2]
    xa = torch.zeros_like(b) if start is None else start.clone()
    xb = torch.empty_like(b)
    _cuda.check(lib.ell_jacobi(
        vals.data_ptr(), op.nbr.data_ptr(), op.mask.data_ptr(),
        op.diag_slot.data_ptr(), b.data_ptr(), xa.data_ptr(), xb.data_ptr(),
        n, k, 1, int(start is None), torch.cuda.current_stream().cuda_stream),
        "ell_jacobi")
    return xb


def launch_us(fn):
    """(device us of ell_jacobi_kernel in one call, its kernel names)."""
    for _ in range(3):              # a short trace can lose its last events
        sel = {k: v for k, v in cs.device_ops(fn, 20).items()
               if "ell_jacobi_kernel" in k}
        if sel:
            return (round(sum(max(1, round(c)) * t for c, t in sel.values()),
                          2), sorted(sel))
    return None, []


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, ".scratch",
                                                  "jacobi_lanes"))
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    with concurrent.futures.ThreadPoolExecutor(len(LANES) + 1) as pool:
        own = pool.submit(_cuda.load)
        libs = dict(zip(LANES, pool.map(
            lambda g: forced_library(args.out, g), LANES)))
        own.result()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    failures = []
    for label, op, vals, b, x0 in systems(dev):
        n = vals.shape[0]
        for start, what in ((None, "1 it from 0"), (x0, "1 it from x0")):
            def wrapper(start=start):
                return ek.jacobi(vals, op.nbr, op.mask, op.diag_slot, b,
                                 start, 1)
            got = wrapper()
            us, _ = launch_us(wrapper)
            parts = []
            for lanes, lib in libs.items():
                def forced(lib=lib, start=start):
                    return call_library(lib, vals, op, b, start)
                same = torch.equal(forced() + 0.0, got + 0.0)
                t, names = launch_us(forced)
                right = bool(names) and all(
                    f"ell_jacobi_kernel<{lanes}," in name for name in names)
                if not (same and right):
                    failures.append(f"{label} {what} {lanes} lanes: bit-equal "
                                    f"{same}, kernels {names}")
                parts.append(f"{lanes} lanes {t} us (bit-equal {same})")
            print(f"jacobi_lanes {label} {what}: the wrapper's "
                  f"{ek.jacobi_lanes(n, sms)} lanes {us} us; "
                  + ", ".join(parts), flush=True)
    print(card)
    for f in failures:
        print("FAILED", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
