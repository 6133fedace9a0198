#!/usr/bin/env python3
"""Where the time goes in the port's lattice multigrid solves, on one GPU.

    python3 scripts/profile_torch_lattice_mg.py [--beams 19k,74k]

For each beam (dx 0.05, top slab pinned, LatticeMG(n_levels=3, dt=None),
the quasi-static configuration of `bench.py --quasistatic --solver latmg`)
it runs one quasistatic_to_tol_mg solve from rest to ||f||_inf <= 1e-4 as a
warm-up, then traces with torch.profiler:
  * the same solve again, reported per Newton step (the first step of a
    solve also estimates the Chebyshev bounds: 6 power iterations a level);
  * 3 linearizations at the solve's end state with its cached bounds, what
    every later Newton step runs;
  * spd_project alone on every level's diagonal blocks, 3 times (as one
    linearization runs it);
  * 10 V-cycles on the residual at rest;
  * 10 restriction and prolongation chains (the transfers of one V-cycle);
  * lat_hvp and lat_diag alone, 20 calls each at every level's shape.
Per window it prints the wall and device-busy time, the idle share, the
device ops, the launches and device time of lat_hvp (hvp_cells) and
lat_diag (diag_cells), and the top kernels, one JSON object per line; then
the shares of a Newton step's device ops and device time that spd_project
and the transfers take, with the V-cycles a step runs counted in the solve.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch import require_cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda, ell  # noqa: E402
from fem_simulation_tpu_torch.ops import lattice_kernels as lk  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice as tlat  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice_mg as tmg  # noqa: E402
from profile_torch_unstructured import (device_events,  # noqa: E402
                                        summarize)

BEAMS = {"2k": (8, 8, 24), "19k": (16, 16, 64), "74k": (16, 16, 256)}
DX = 0.05
TOL = 1e-4


def traced(fn, n):
    """summarize() of n calls of fn, with the launches and device time of
    lat_diag's cell pass added (lat_hvp's is summarize's kernel)."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    out = summarize(prof, wall, n, kernel="hvp_cells")
    diag = [e - s for name, s, e in device_events(prof)
            if "diag_cells" in name]
    out["diag_events"] = len(diag)
    out["diag_device_us_per_launch"] = (float(np.mean(diag)) if diag
                                        else None)
    out["device_us_per_unit"] = out["device_busy_ms_per_unit"] * 1e3
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", default="19k,74k")
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    _cuda.load()
    for label in args.beams.split(","):
        sc = tlat.LatticeScene(meshlib.beam(*BEAMS[label], dx=DX),
                               device=dev)
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
        mat = sc.material

        def solve():
            return tmg.quasistatic_to_tol_mg(sc, mg, sc.x0, tol=TOL,
                                             max_newton=100, return_cg=True)
        x, k, fn, cg = solve()                       # warm-up
        vcycles = [0]
        plain_vcycle = mg.vcycle

        def counted(ops, b, level=0):
            vcycles[0] += level == 0
            return plain_vcycle(ops, b, level)
        mg.vcycle = counted
        res = {"newton": k, "pcg": cg, "fn": fn}
        res["solve_per_newton_step"] = traced(solve, 1)
        mg.vcycle = plain_vcycle
        res["solve_per_newton_step"] = {
            key: (v / k if key.endswith("per_unit") else v)
            for key, v in res["solve_per_newton_step"].items()}
        vc_per_step = vcycles[0] / k
        res["vcycles_per_newton_step"] = vc_per_step
        _, lmaxes = mg.newton_ops(mg.pad(x))
        res["linearize_cached"] = traced(
            lambda: mg.linearize(mg.pad(x), lmax_cache=lmaxes), 3)
        ops = mg.linearize(mg.pad(x), lmax_cache=lmaxes)
        eye = torch.eye(3, device=dev)
        raw = []
        xl = mg.pad(x)
        for li, lvl in enumerate(mg.levels):
            _, d = mg._level_matvec_diag(li, xl)
            raw.append(d + (lvl.ctrl + 1.0 - lvl.vert_mask)[..., None, None]
                       * eye)
            if li < mg.n_levels - 1:
                u = (xl - mg.x0_levels[li]) * lvl.vert_mask[..., None]
                ur = mg._restrict(li, u) / mg._restrict_w[li]
                nxt = mg.levels[li + 1]
                xl = mg.x0_levels[li + 1] + ur * nxt.vert_mask[..., None]
        res["spd_project_per_linearize"] = traced(
            lambda: [ell.spd_project(d, eps=1e-6, rel_floor=1e-3)
                     for d in raw], 3)
        b = mg.pad(sc.dyn_force(sc.x0, sc.x0, 0.0))
        res["vcycle"] = traced(lambda: mg.vcycle(ops, b), 10)

        def transfers():
            r = b
            for li in range(mg.n_levels - 1):
                r = mg._restrict(li, r)
            for li in range(mg.n_levels - 2, -1, -1):
                r = mg._prolong(li, r)
        res["transfers_per_vcycle"] = traced(transfers, 10)
        for li, lvl in enumerate(mg.levels):
            shape = (3,) + tuple(lvl.vert_mask.shape)
            u = 0.03 * torch.randn(shape, device=dev) * lvl.vert_mask
            p = torch.randn(shape, device=dev)
            a = (lvl.cell_mask, lvl.dx, mat.lame_mu, mat.lame_la)
            res[f"hvp_level{li}"] = traced(lambda: lk.hvp_cf(u, p, *a), 20)
            res[f"diag_level{li}"] = traced(lambda: lk.hess_diag_cf(u, *a),
                                            20)
        step = res["solve_per_newton_step"]
        spd = res["spd_project_per_linearize"]
        tr = res["transfers_per_vcycle"]
        res["shares_of_a_newton_step"] = {
            "spd_project_ops": spd["device_ops_per_unit"]
            / step["device_ops_per_unit"],
            "spd_project_device_time": spd["device_us_per_unit"]
            / step["device_us_per_unit"],
            "transfers_ops": tr["device_ops_per_unit"] * vc_per_step
            / step["device_ops_per_unit"],
            "transfers_device_time": tr["device_us_per_unit"] * vc_per_step
            / step["device_us_per_unit"],
        }
        for name, r in res.items():
            print(f"{label:4s} {name:26s} " + json.dumps(r), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
