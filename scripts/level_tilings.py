#!/usr/bin/env python3
"""Time the standalone HVP and the multigrid's power iteration under explicit launch plans, on one GPU.

    python3 scripts/level_tilings.py [--beams 2k,19k,74k]

For every level shape of each beam's 3-level hierarchy (dx 0.05, LatticeMG
(n_levels=3, dt=None), a seeded displacement and direction) it runs
`lat_hvp` under the plan `hvp_plan` picks, under the two passes and under
up to 10 other halo tilings (for every (waves, rounds) pair some tiling
gives, the one that computes the fewest cells), and checks each against
the plain version (max|d| <= 1e-4 max|ref|, two runs bit-identical). It
prints the device us of a call (every device op, torch.profiler), the
events ms of a call, the tiles, their rounds and waves, the cells computed
per cell of the level and the model's us (`force_cost` under HVP_MODEL,
which was fitted to this output). Then `level_matvec_cf` and
`power_lmax_cf` under their plans, against their plain versions, with the
plain versions' events ms.
"""
import argparse
import itertools
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
from fem_simulation_tpu_torch.sim import lattice_mg as tmg  # noqa: E402


def cells_computed(shape, plan):
    """Cells the halo tiles of plan compute, all tiles together."""
    return int(np.prod([sum(lk.tile_axis(n, nt, it)[3] for it in range(nt))
                        for n, nt in zip(shape, plan[1:4])]))


def device_total(fn, n_ops):
    """Device us of one call: every op's mean span times its launches a
    call; None when the traces lost an op."""
    ops = cs.whole_trace(fn, 20, n_ops)
    if len(ops) < n_ops:
        return None
    return round(sum(max(1, round(n)) * t for n, t in ops.values()), 2)


def serial_tilings(shape, sms, own):
    """Halo tilings of lat_hvp worth timing besides its plan: for every
    (waves, rounds) pair that some fitting tiling gives, the one that
    computes the fewest cells, ordered by the model's cost."""
    by = {}
    for tiles in itertools.product(*(lk._tile_counts(n) for n in shape)):
        plan = lk.force_tiling(shape, tiles, lk.HVP_MODEL.box_floats)
        if plan is None or plan == own:
            continue
        per_sm = -(-plan[0] // sms)
        waves = -(-per_sm // lk.FORCE_RESIDENT)
        rounds = -(-plan[4] // lk.FORCE_THREADS)
        key = (waves, rounds)
        cells = cells_computed(shape, (0,) + plan[1:])
        if key not in by or cells < by[key][0]:
            by[key] = (cells, plan)
    plans = sorted((p for _, p in by.values()),
                   key=lambda p: lk.force_cost(p, shape, sms, lk.HVP_MODEL))
    return plans[:10]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", default="2k,19k,74k")
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    lib = _cuda.load()
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas", line.strip(), flush=True)
    sms = lk._sms(dev.index)
    for label in args.beams.split(","):
        sc = tlat.LatticeScene(meshlib.beam(*cs.BEAMS[label], dx=cs.DX),
                               device=dev)
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
        rng = np.random.default_rng(7)
        for li, lvl in enumerate(mg.levels):
            shape = tuple(lvl.vert_mask.shape)
            vm = lvl.vert_mask

            def field(scale):
                return torch.from_numpy((scale * rng.standard_normal(
                    (3,) + shape)).astype(np.float32)).to(dev)
            u, p = field(0.03) * vm, field(1.0)
            cargs = (lvl.cell_mask, lvl.dx, cs.MU, cs.LA)
            ref = lk.hvp_cf_plain(u, p, *cargs)
            scale = float(ref.abs().max())
            cells = lvl.cell_mask.numel()
            runs = []
            own = lk._hvp_plan(*shape, u.device)
            key = (str(u.device), *shape)
            plans = [("plan", own), ("two-pass", lk.FORCE_TWO_PASS)]
            plans += [(f"{t[1]}x{t[2]}x{t[3]}", t)
                      for t in serial_tilings(shape, sms, own)]
            for name, plan in plans:
                lk._hvp_plans[key] = plan
                try:
                    def call():
                        return lk.hvp_cf(u, p, *cargs)
                    got, again = call(), call()
                    torch.cuda.synchronize()
                    err = float((got - ref).abs().max())
                    cs.check(torch.equal(got, again),
                             f"hvp {name}: two runs differ")
                    cs.check(err <= 1e-4 * scale, f"hvp {name}: max|d| "
                             f"{err:.3e} > 1e-4 * {scale:.3e}")
                    two = plan == lk.FORCE_TWO_PASS
                    us = device_total(call, 2 if two else 1)
                    ms = cs.cuda_ms(call, 50)
                finally:
                    lk._hvp_plans[key] = own
                if two:
                    extra = "every cell once, a scratch round trip"
                else:
                    per_sm = -(-plan[0] // sms)
                    extra = (f"tiles {plan[1]}x{plan[2]}x{plan[3]} "
                             f"({plan[0]}) cells/tile <= {plan[4]} rounds "
                             f"{-(-plan[4] // lk.FORCE_THREADS)} waves "
                             f"{-(-per_sm // lk.FORCE_RESIDENT)} "
                             f"computed/cells "
                             f"{cells_computed(shape, plan) / cells:.3f}")
                model = lk.force_cost(plan, shape, sms, lk.HVP_MODEL)
                runs.append((us, name))
                print(f"hvp {label:4s} level {li} {shape} {name:9s} device "
                      f"{us} us  events {ms:.4f} ms  max|d| {err:.2e} "
                      f"(max|ref| {scale:.2e})  {extra} model {model:.2f} us",
                      flush=True)
            best = min((r for r in runs if r[0] is not None), default=None)
            print(f"hvp {label:4s} level {li} {shape} fastest {best}",
                  flush=True)
            ctrl = lvl.ctrl + lvl.mass * 900.0
            margs = (lvl.cell_mask, ctrl, vm, lvl.dx, cs.MU, cs.LA)
            d6 = lk.hess_diag_shift_cf(u, lvl.cell_mask, ctrl, vm, lvl.dx,
                                       cs.MU, cs.LA)
            cases = {
                "level_matvec": (
                    lambda: lk.level_matvec_cf(u, p, *margs),
                    lambda: lk.level_matvec_cf_plain(u, p, *margs)),
                "power": (
                    lambda: lk.power_lmax_cf(u, d6, ctrl, vm, *cargs),
                    lambda: lk.power_lmax_cf_plain(u, d6, ctrl, vm,
                                                   *cargs)),
            }
            for name, (kern, plain) in cases.items():
                got, again, want = kern(), kern(), plain()
                torch.cuda.synchronize()
                cs.check(torch.equal(got, again), f"{name}: two runs differ")
                err = float((got - want).abs().max())
                s = float(want.abs().max())
                cs.check(err <= 1e-4 * s, f"{name} {label} level {li}: "
                         f"max|d| {err:.3e} > 1e-4 * {s:.3e}")
                plan = (lk._level_plan(lib, *shape, u.device, lk.POWER)
                        if name == "power" else own)
                two = plan == lk.FORCE_TWO_PASS
                us = device_total(kern, 2 if two else 1)
                print(f"{name} {label:4s} level {li} {shape} plan {plan} "
                      f"device {us} us  events {cs.cuda_ms(kern, 50):.4f} ms"
                      f"  plain {cs.cuda_ms(plain, 5, warmup=1):.4f} ms  "
                      f"max|d| {err:.2e} (max|ref| {s:.2e})", flush=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
