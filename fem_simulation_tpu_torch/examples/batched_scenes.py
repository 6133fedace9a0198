"""Batched multi-scene throughput: the dp (data-parallel) axis.

Port of `examples/batched_scenes.py`. The physics of independent scenes
never communicates, so a batch of B scenes is split over the grid's dp
axis (the placement of parallel/dist.make_batched_step); each scene takes
one matrix-free step_to_tol a frame. Times two run lengths and reports
their difference per frame (the fixed per-run cost cancels), each the best
of 3 runs.

    python -m fem_simulation_tpu_torch.examples.batched_scenes [--batch 8]

The reference vmaps the batch into one program; here a dp row's scenes run
one after another. --device and --n-devices (grid entries; default: the
visible GPUs, or 1 on the CPU) are added here.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import mesh as meshlib
from ..config import SolverConfig
from ..parallel import dist
from ..sim import Scene, dynamic
from ._common import beam_shape


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--beam", default="8,8,24")
    ap.add_argument("--dx", type=float, default=0.05)
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU)")
    ap.add_argument("--n-devices", type=int, default=None)
    args = ap.parse_args(argv)

    grid = dist.make_device_mesh(args.n_devices, device=args.device)
    m = meshlib.beam(*beam_shape(args.beam), dx=args.dx)
    scene = Scene(m, solver=SolverConfig(n_levels=2), device=grid.device)
    # the batch split over dp; each scene steps by step_to_tol here
    _, params, state0 = dist.make_batched_step(scene, grid, args.batch)
    fns = []

    def one(p, s):
        s2, k, fn = dynamic.step_to_tol(scene, p, s, tol=1e-4,
                                        matrix_free=True)
        fns.append(fn)
        return s2

    def step_row(p, s):
        done = [one(p, dynamic.DynState(*(a[b] for a in s)))
                for b in range(s.x.shape[0])]
        return dynamic.DynState(*(torch.stack(list(f)) for f in zip(*done)))

    def run(n):
        s = state0
        for _ in range(n):
            s = [step_row(p, r) for p, r in zip(params, s)]
        return s

    def sync():
        if grid.device.type == "cuda":
            torch.cuda.synchronize()

    def timed(n):
        run(n)
        best = np.inf
        for _ in range(3):
            fns.clear()
            sync()
            t0 = time.perf_counter()
            run(n)
            sync()
            best = min(best, time.perf_counter() - t0)
        return best, np.asarray(fns)

    n_small = max(args.frames // 5, 2)
    t_small, _ = timed(n_small)
    t_big, fn_all = timed(args.frames)
    if not fn_all.max() <= 1.01e-4:
        raise RuntimeError(f"a frame missed tol: {fn_all.max():.3e}")
    ms = (t_big - t_small) / (args.frames - n_small) * 1000.0
    B = args.batch
    print(f"batch={B} on {grid}: {ms:.2f} ms per batched frame "
          f"-> {ms / B:.3f} ms per scene-step "
          f"({B * 1000.0 / ms:.0f} scene-steps/sec)")
    return ms, fn_all


if __name__ == "__main__":
    main()
