#!/usr/bin/env python3
"""Where the time goes on the PyTorch port's unstructured path, on one GPU.

    python3 scripts/profile_torch_unstructured.py [--beams 2k,19k,74k]

For each beam (dx 0.05; the 8x8x24 beam with SolverConfig(n_levels=2), the
others with the default SolverConfig) it traces, with torch.profiler after
one warm-up of each:
  * 3 Newton-MG steps and 3 FAS v3 cycles of QuasiStaticSim;
  * 8 DynamicSim.frame_to_tol frames (8x8x24 beam only);
  * 50 back-to-back block-ELL SpMV calls on the fine-level Hessian;
and, on the dense lattice of the same beam, 10 fused_pcg calls (tol 1e-2).
It prints per window the wall time, the device busy time (union of the
kernel and memory-op intervals), the idle share, the device-op count, the
SpMV (or fused PCG) kernel's traced launches and mean device time, and the
kernels that take the most device time, one JSON object per line.
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
from fem_simulation_tpu_torch.config import SolverConfig  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import ell_kernels as ek  # noqa: E402
from fem_simulation_tpu_torch.ops import lattice_kernels as lk  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice as tlat  # noqa: E402
from fem_simulation_tpu_torch.sim import quasistatic as qs  # noqa: E402
from fem_simulation_tpu_torch.sim.dynamic import DynamicSim  # noqa: E402
from fem_simulation_tpu_torch.sim.scene import Scene  # noqa: E402

BEAMS = {"2k": (8, 8, 24), "19k": (16, 16, 64), "74k": (16, 16, 256)}
DX = 0.05


def device_events(prof):
    """(name, start_us, end_us) of every kernel / memory op on the device."""
    out = []
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out.append((e.name, e.time_range.start, e.time_range.end))
    return out


def summarize(prof, wall_ms, n, kernel="ell_spmv_kernel"):
    """Busy time (merged intervals), idle share, the launches and mean
    device time of `kernel` (over the events the trace captured: a short
    window can lose its last few), and the top kernels, per unit."""
    evs = device_events(prof)
    spans = sorted((s, e) for _, s, e in evs)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    by_name = {}
    for name, s, e in evs:
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + (e - s), c + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
    hits = [(t, c) for name, (t, c) in by_name.items() if kernel in name]
    k_us, k_n = (sum(t for t, _ in hits), sum(c for _, c in hits))
    return {
        "wall_ms_per_unit": wall_ms / n,
        "device_busy_ms_per_unit": busy / 1e3 / n,
        "idle_share": 1.0 - (busy / 1e3) / wall_ms,
        "device_ops_per_unit": len(evs) / n,
        "kernel": kernel,
        "kernel_events": k_n,
        "kernel_device_us_per_launch": k_us / k_n if k_n else None,
        "top": [(name[:60], round(t / 1e3 / n, 4), round(c / n, 2))
                for name, (t, c) in top],
    }


def traced(fn, n, kernel="ell_spmv_kernel"):
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    return summarize(prof, wall, n, kernel)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", default="2k,19k,74k")
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    _cuda.load()
    for label in args.beams.split(","):
        m = meshlib.beam(*BEAMS[label], dx=DX)
        solver = SolverConfig(n_levels=2) if label == "2k" else SolverConfig()
        sc = Scene(m, solver=solver, device=dev)
        res = {"levels": sc.n_levels}
        for name, method in (("newton_mg_step", "newton_multigrid"),
                             ("fas_v3_cycle", "fas")):
            sim = qs.QuasiStaticSim(sc)
            getattr(sim, method)(1)                      # warm-up
            res[name] = traced(lambda: getattr(sim, method)(1), 3)
        if label == "2k":
            dsim = DynamicSim(sc)
            dsim.frame_to_tol()
            res["dynamic_frame"] = traced(dsim.frame_to_tol, 8)
        rng = np.random.default_rng(4)
        op = sc.make_op(0)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(dev)
        full = (qs.assemble_fine(sc, sc.params, x)
                * op.mask[..., None, None]).contiguous()
        v = torch.randn(tuple(sc.x0.shape), device=dev)
        ek.spmv(full, op.nbr, op.mask, v)
        res["spmv_alone"] = traced(
            lambda: ek.spmv(full, op.nbr, op.mask, v), 50)
        ls = tlat.LatticeScene(m, device=dev)
        u = 0.01 * torch.randn(tuple(ls.x0.shape), device=dev) \
            * ls.vert_mask[..., None]
        inv_dt = 1.0 / 0.033
        mat = ls.material
        ctrl = (mat.control_mag * ls.pin_mask + ls.mass * inv_dt * inv_dt
                + (1.0 - ls.vert_mask))
        f_cf = ls.dyn_force(ls.x0 + u, ls.x0 + u, inv_dt).permute(
            3, 0, 1, 2).contiguous()
        u_cf = u.permute(3, 0, 1, 2).contiguous()
        pcg_args = (u_cf, f_cf, ls.cell_mask, ctrl, ls.vert_mask, DX,
                    mat.lame_mu, mat.lame_la, 60, 1e-2)
        _, k = lk.fused_pcg(*pcg_args)
        res["fused_pcg_alone"] = traced(lambda: lk.fused_pcg(*pcg_args), 10,
                                        kernel="fused_newton_kernel<true>")
        res["fused_pcg_alone"]["k"] = int(k)
        for name, r in res.items():
            if isinstance(r, dict):
                print(f"{label:4s} {name:16s} " + json.dumps(r), flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
