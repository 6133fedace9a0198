#!/usr/bin/env python3
"""Time the fused Newton / PCG kernels under explicit vertex tilings, on one GPU.

    python3 scripts/fused_newton_tilings.py [--beams 2k,19k,74k]

For each beam (dx 0.05, the Newton inputs of chip_smoke.py phase 1) it
times, with torch.profiler, the kernel under the tiling `lat_newton_plan`
picks and under a list of explicit ones (mode, tiles along x, y, z; halo
mode computes a block's halo cells itself, exchange mode computes each cell
once and exchanges partial vertex sums): device us per launch of
fused_newton at the phase-1 tolerance (k = 3) and at a tight one (more PCG
iterations, so the difference over the extra iterations is the cost of one),
interpolated to --mean-k (what a frame's Newton iterations run on average),
and of fused_pcg. A tiling whose tile does not fit the kernel's shared
memory fails to launch and is reported so. The plan's cost model in
csrc/lattice_kernels.cu was fitted to this script's output; the rows of the
best halo and the best exchange tiling of a beam say what keeping only one
of the two modes would cost there.
"""
import argparse
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch import require_cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import lattice_kernels as lk  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice as tlat  # noqa: E402

# (halo, ntx, nty, ntz) per beam; None is the plan's own choice
TILINGS = {
    "2k": [None, (1, 2, 2, 13), (1, 2, 2, 25), (1, 3, 3, 13), (1, 3, 3, 9),
           (1, 2, 2, 7), (0, 2, 2, 13)],
    "19k": [None, (1, 4, 4, 8), (1, 4, 4, 4), (1, 3, 3, 13), (1, 4, 4, 6),
            (1, 4, 4, 16), (0, 4, 4, 8), (0, 4, 4, 4), (0, 3, 3, 13)],
    "74k": [None, (0, 4, 4, 8), (0, 3, 3, 14), (0, 4, 4, 16), (0, 3, 3, 29),
            (1, 4, 4, 16), (1, 3, 3, 29), (1, 3, 3, 22)],
}


def tile_sizes(shape, tiles, halo):
    """(cells, box vertices) of the largest tile of a balanced partition."""
    cells, box = 1, 1
    for n, nt in zip(shape, tiles):
        d = min(-(-n // nt) + halo, n - 1)
        cells *= d
        box *= d + 1
    return cells, box


def device_us(fn, kernel):
    us = cs.device_us(fn, 20, kernel)
    return float("nan") if us is None else us


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", default="2k,19k,74k")
    ap.add_argument("--mean-k", type=float, default=8.0)
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    lib = _cuda.load()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label in args.beams.split(","):
        sc = tlat.LatticeScene(meshlib.beam(*cs.BEAMS[label], dx=cs.DX),
                               device=dev)
        inputs = cs.newton_inputs(sc, np.random.default_rng(1))
        tight = inputs[:-1] + (1e-6,)
        dxp, fp, _, kp = lk.fused_newton_plain(*inputs)
        pcg = (inputs[0], fp, inputs[2], inputs[3], inputs[5], cs.DX, cs.MU,
               cs.LA, 60, 1e-2)
        X, Y, Z = sc.shape
        dev = inputs[0].device              # the wrappers' cache key
        # asking for both plans also lets both kernels take their shared
        # memory
        own = lk._newton_plan(lib, X, Y, Z, dev)
        lk._newton_plan(lib, X, Y, Z, dev, pcg=True)
        for tiling in TILINGS[label]:
            if tiling is None:
                plan = own
            else:
                halo, ntx, nty, ntz = tiling
                cells, box = tile_sizes((X, Y, Z), (ntx, nty, ntz), halo)
                plan = (min(ntx * nty * ntz, sms), ntx, nty, ntz, cells | 1,
                        box, halo)
            for is_pcg in (False, True):
                lk._newton_plans[(str(dev), X, Y, Z, is_pcg)] = plan
            lk._workspaces.clear()          # frees the last tiling's scratch
            try:
                dxk, _, _, kk = lk.fused_newton(*inputs)
                torch.cuda.synchronize()
                assert lk._newton_plan(lib, X, Y, Z, dev) == plan
            except RuntimeError as e:
                print(f"{label} {tiling}: {plan[4]} cells a tile: {e}")
                continue
            err = float((dxk - dxp).abs().max()) / float(dxp.abs().max())
            k_tight = int(lk.fused_newton(*tight)[3])
            us = device_us(lambda: lk.fused_newton(*inputs),
                           "fused_newton_kernel<false>")
            us_tight = device_us(lambda: lk.fused_newton(*tight),
                                 "fused_newton_kernel<false>")
            us_pcg = device_us(lambda: lk.fused_pcg(*pcg),
                               "fused_newton_kernel<true>")
            per_it = (us_tight - us) / max(k_tight - int(kk), 1)
            at_mean = us + per_it * (args.mean_k - int(kk))
            print(f"{label} {'plan' if tiling is None else '    '} "
                  f"{'halo' if plan[6] else 'exchange'} tiles "
                  f"{plan[1]}x{plan[2]}x{plan[3]} grid {plan[0]} cells/tile "
                  f"{plan[4]} k {int(kk)} (plain {int(kp)}) rel|d dx| "
                  f"{err:.1e}  fused_newton {us:.1f} us, at k {k_tight} "
                  f"{us_tight:.1f} us ({per_it:.2f} us per PCG iteration, "
                  f"{at_mean:.1f} us at k {args.mean_k:g})  "
                  f"fused_pcg {us_pcg:.1f} us", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
