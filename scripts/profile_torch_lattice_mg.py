#!/usr/bin/env python3
"""Where the time goes in the port's lattice multigrid solves, on one GPU.

    python3 scripts/profile_torch_lattice_mg.py [--beams 19k,74k]
        [--frame-beams 2k,19k] [--root TREE]

For each beam (dx 0.05, top slab pinned, LatticeMG(n_levels=3, dt=None), the
quasi-static configuration of `bench.py --quasistatic --solver latmg`) it
runs one quasistatic_to_tol_mg solve from rest to ||f||_inf <= 1e-4 as a
warm-up, then:
  * times 3 more solves (CUDA events and the host clock) and counts their
    Newton steps, PCG iterations, V-cycles, lattice kernel launches and
    host syncs (torch.cuda sync debug mode: every synchronizing op);
  * traces one solve with torch.profiler, reported per Newton step: host
    ms, device busy ms (union of the kernel and memory-op intervals), the
    idle share, device ops, and each lattice kernel's launches and mean
    device us;
  * traces 3 first linearizations of a solve at its end state (the
    Chebyshev bounds estimated by power iteration) and 3 later ones (the
    bounds cached): device ops, host ms and host syncs per linearization;
  * traces 10 V-cycles on the residual at rest: device ops and host ms per
    V-cycle.
For each frame beam (LatticeMG(n_levels=3) with the inertia term baked, the
excited protocol of chip_smoke.py phase 7: gravity x cos(2 pi t / 16), tol
1e-4) it runs one step_to_tol_mg frame as a warm-up, times 16 frames
(events and host clock), counts their Newton steps and host syncs, and
traces 4 more: device ops, idle share and host ms per frame.
One JSON object per line, then the card's name and power limit.

`--root` names the checkout whose `fem_simulation_tpu_torch` is measured
(default: this one), so that one call on the card can alternate two trees,
each in its own process. It reads either layout of the multigrid: fields
channel-last around the two-pass lat_hvp / lat_diag, or channel-first
around lat_cheby / lat_diag_shift (`LevelOps`).
"""
import argparse
import json
import os
import subprocess
import sys
import time
import warnings

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

HERE = os.path.dirname(os.path.abspath(__file__))
BEAMS = {"2k": (8, 8, 24), "19k": (16, 16, 64), "74k": (16, 16, 256)}
DX = 0.05
TOL = 1e-4
# device kernels of the lattice operators, by a substring of their names
# (level_kernel: lat_cheby and lat_power; cheby_kernel and power_kernel:
# their first forms, in a tree given by --root)
KERNELS = ("level_kernel", "cheby_kernel", "diag_tiles_kernel",
           "power_kernel", "hvp_serial_kernel", "hvp_tiles_kernel", "hvp_cells",
           "diag_cells", "gather", "force", "energy_kernel")


def host_syncs(fn):
    """(fn(), the synchronizing CUDA operations it ran): torch.cuda's sync
    debug mode warns at each, and the warnings are counted."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def gravity_scale(frame: int) -> float:
    return float(np.cos(np.float32(2.0 * np.pi) * np.float32(frame)
                        / np.float32(16.0)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", default="19k,74k")
    ap.add_argument("--frame-beams", default="2k,19k")
    ap.add_argument("--root", default=os.path.dirname(HERE))
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    from fem_simulation_tpu_torch import mesh as meshlib
    from fem_simulation_tpu_torch import require_cuda
    from fem_simulation_tpu_torch.ops import _cuda
    from fem_simulation_tpu_torch.ops import lattice_kernels as lk
    from fem_simulation_tpu_torch.sim import lattice as tlat
    from fem_simulation_tpu_torch.sim import lattice_mg as tmg
    sys.path.insert(1, HERE)
    from profile_torch_unstructured import device_events, summarize

    channel_first = hasattr(tmg, "LevelOps")
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    _cuda.load()

    def traced(fn, n):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        out = summarize(prof, wall, n, kernel=KERNELS[0])
        by = {}
        for name, s, e in device_events(prof):
            for k in KERNELS:
                if k in name:
                    t, c = by.get(k, (0.0, 0))
                    by[k] = (t + (e - s), c + 1)
        out["lattice_kernels"] = {k: {"launches_per_unit": c / n,
                                      "device_us_per_launch": t / c}
                                  for k, (t, c) in by.items()}
        return out

    print(json.dumps({"root": os.path.abspath(args.root),
                      "layout": ("channel-first, lat_cheby / lat_diag_shift"
                                 if channel_first else
                                 "channel-last, lat_hvp / lat_diag")}),
          flush=True)
    for label in args.beams.split(","):
        sc = tlat.LatticeScene(meshlib.beam(*BEAMS[label], dx=DX),
                               device=dev)
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)

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
        res = {"newton": k, "pcg": cg, "fn": fn, "solves": []}
        for _ in range(3):
            vcycles[0] = 0
            before = dict(lk.launches)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            _, k, fn, cg = solve()
            end.record()
            torch.cuda.synchronize()
            res["solves"].append({
                "ms": start.elapsed_time(end),
                "host_ms": (time.perf_counter() - t0) * 1e3,
                "newton": k, "pcg": cg, "fn": fn, "vcycles": vcycles[0],
                "launches": {n: lk.launches[n] - before[n]
                             for n in lk.launches
                             if lk.launches[n] != before[n]}})
            # one more solve, counting its host syncs
            res["solves"][-1]["host_syncs"] = host_syncs(solve)[1]
        mg.vcycle = plain_vcycle
        step = traced(solve, 1)
        res["solve_per_newton_step"] = {
            key: (v / k if key.endswith("per_unit") else v)
            for key, v in step.items() if key != "lattice_kernels"}
        res["solve_per_newton_step"]["lattice_kernels"] = {
            name: {"launches_per_step": v["launches_per_unit"] / k,
                   "device_us_per_launch": v["device_us_per_launch"]}
            for name, v in step["lattice_kernels"].items()}
        res["vcycles_per_newton_step"] = res["solves"][-1]["vcycles"] / k
        _, lmaxes = mg.newton_ops(mg.pad(x))
        res["linearize_first"] = traced(lambda: mg.newton_ops(mg.pad(x)), 3)
        res["linearize_first"]["host_syncs"] = host_syncs(
            lambda: mg.newton_ops(mg.pad(x)))[1]
        res["linearize_cached"] = traced(
            lambda: mg.linearize(mg.pad(x), lmax_cache=lmaxes), 3)
        res["linearize_cached"]["host_syncs"] = host_syncs(
            lambda: mg.linearize(mg.pad(x), lmax_cache=lmaxes))[1]
        ops = mg.linearize(mg.pad(x), lmax_cache=lmaxes)
        b = sc.dyn_force(sc.x0, sc.x0, 0.0)
        b = mg.pad_cf(b) if channel_first else mg.pad(b)
        res["vcycle"] = traced(lambda: mg.vcycle(ops, b), 10)
        for name, r in res.items():
            print(f"{label:4s} {name:24s} " + json.dumps(r), flush=True)
        print(f"{label:4s} summary " + json.dumps({
            "ms_per_solve": [s["ms"] for s in res["solves"]],
            "host_ms_per_solve": [s["host_ms"] for s in res["solves"]],
            "newton": k, "pcg": cg,
            "ops_per_newton_step":
                res["solve_per_newton_step"]["device_ops_per_unit"],
            "idle_share": res["solve_per_newton_step"]["idle_share"],
            "ops_per_linearization":
                res["linearize_cached"]["device_ops_per_unit"],
            "ops_per_first_linearization":
                res["linearize_first"]["device_ops_per_unit"],
            "host_ms_per_first_linearization":
                res["linearize_first"]["wall_ms_per_unit"],
            "host_syncs_per_linearization": {
                "first": res["linearize_first"]["host_syncs"],
                "cached": res["linearize_cached"]["host_syncs"]},
            "host_syncs_per_solve": res["solves"][-1]["host_syncs"],
            "ops_per_vcycle": res["vcycle"]["device_ops_per_unit"],
            "launches_per_solve": res["solves"][-1]["launches"]}),
            flush=True)
    for label in [b for b in args.frame_beams.split(",") if b]:
        sc = tlat.LatticeScene(meshlib.beam(*BEAMS[label], dx=DX),
                               device=dev)
        mg = tmg.LatticeMG(sc, n_levels=3)
        st = [sc.init_state()]
        frame_no = [0]

        def frame():
            s_new, k, fn = tmg.step_to_tol_mg(
                sc, mg, st[0], tol=TOL,
                gravity_scale=gravity_scale(frame_no[0]))
            st[0] = s_new
            frame_no[0] += 1
            return k, fn

        frame()                                      # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        ks = [frame()[0] for _ in range(16)]
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 16
        host = (time.perf_counter() - t0) * 1e3 / 16
        syncs = [host_syncs(frame)[1] for _ in range(2)]
        tr = traced(frame, 4)
        print(f"{label:4s} frames summary " + json.dumps({
            "ms_per_frame": ms, "host_ms_per_frame": host,
            "newton": ks, "newton_mean": float(np.mean(ks)),
            "host_syncs_per_frame": syncs,
            "ops_per_frame": tr["device_ops_per_unit"],
            "idle_share": tr["idle_share"],
            "traced_host_ms_per_frame": tr["wall_ms_per_unit"],
            "device_busy_ms_per_frame": tr["device_busy_ms_per_unit"],
            "lattice_kernels": tr["lattice_kernels"]}), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
