#!/usr/bin/env python3
"""Time the standalone force and energy kernels under explicit launch shapes, on one GPU.

    python3 scripts/force_tilings.py [--beams 2k,19k,74k]

For each beam (dx 0.05, the seeded displacement of chip_smoke.py phase 1)
it runs `lat_force` under the plan `force_plan` picks and under a list of
others (halo tilings, one launch: the cells between two tiles are computed
twice; the two passes), checks each against the plain version (max|d| <=
1e-4 max|ref|, two runs bit-identical), and prints its device us per call
(every device op of a call, torch.profiler), its events ms per call, the
cells it computes per cell of the lattice, and the plan's modelled us. Then
the energy kernel under the launch shape `energy_plan` picks and a few
others (eight lanes or a thread a cell). The plan's cost model
(ops/lattice_kernels.py) was fitted to this output.
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

# Halo tilings (ntx, nty, ntz) per beam besides the plan's own, and the
# two passes ("two-pass"); energy launch shapes (blocks, lanes) besides the
# plan's.
TILINGS = {
    "2k": [(2, 5, 13), (2, 2, 13), (3, 3, 13), (1, 1, 25), (2, 9, 13),
           (3, 3, 25), "two-pass"],
    "19k": [(4, 4, 8), (2, 4, 16), (2, 2, 33), (4, 4, 16), (3, 3, 13),
            (2, 4, 17), "two-pass"],
    "74k": [(1, 4, 65), (4, 4, 32), (2, 2, 129), (4, 4, 16), (3, 3, 43),
            "two-pass"],
}
ENERGY = {
    "2k": [(48, 1), (132, 1), (6, 0), (12, 0)],
    "19k": [(64, 0), (132, 0), (512, 1), (264, 1)],
    "74k": [(256, 0), (132, 0), (528, 0), (528, 1)],
}


def timed(fn, kernel):
    us = cs.device_us(fn, 20, kernel)
    return (float("nan") if us is None else us), cs.cuda_ms(fn, 50)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", default="2k,19k,74k")
    args = ap.parse_args()
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    _cuda.load()
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas", line.strip())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    energy_plan = lk.energy_plan
    for label in args.beams.split(","):
        sc = tlat.LatticeScene(meshlib.beam(*cs.BEAMS[label], dx=cs.DX),
                               device=dev)
        rng = np.random.default_rng(1)
        u = torch.from_numpy(0.03 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(sc.device) \
            * sc.vert_mask[..., None]
        u_cf = u.permute(3, 0, 1, 2).contiguous()
        cm = sc.cell_mask
        X, Y, Z = sc.shape
        key = (str(u.device), X, Y, Z)
        ref = lk.force_cf_plain(u_cf, cm, cs.DX, cs.MU, cs.LA)
        scale = float(ref.abs().max())
        own = lk.force_plan(X, Y, Z, sms)
        for tiling in [None] + TILINGS[label]:
            if tiling is None:
                plan = own
            elif tiling == "two-pass":
                plan = lk.FORCE_TWO_PASS
            else:
                plan = lk.force_tiling((X, Y, Z), tiling)
                if plan is None:
                    print(f"{label} {tiling}: does not fit the shared memory")
                    continue
            lk._force_plans[key] = plan
            got = lk.force_cf(u_cf, cm, cs.DX, cs.MU, cs.LA)
            again = lk.force_cf(u_cf, cm, cs.DX, cs.MU, cs.LA)
            torch.cuda.synchronize()
            err = float((got - ref).abs().max()) / scale
            same = bool(torch.equal(got, again))
            ops = cs.device_ops(
                lambda: lk.force_cf(u_cf, cm, cs.DX, cs.MU, cs.LA), 20)
            us = sum(n * t for n, t in ops.values())
            ms = cs.cuda_ms(lambda: lk.force_cf(u_cf, cm, cs.DX, cs.MU, cs.LA),
                            50)
            if plan == lk.FORCE_TWO_PASS:
                shape = "two passes"
            else:
                computed = plan[0] * plan[4] / ((X - 1) * (Y - 1) * (Z - 1))
                shape = (f"halo tiles {plan[1]}x{plan[2]}x{plan[3]} blocks "
                         f"{plan[0]} cells/tile {plan[4]} (x{computed:.2f} "
                         f"the lattice's)")
            print(f"{label} force {'plan' if tiling is None else '    '} "
                  f"{shape} rel|d| {err:.1e} "
                  f"{'same bits' if same else 'BITS DIFFER'} device {us:.1f} "
                  f"us in {sum(n for n, _ in ops.values()):.0f} ops, events "
                  f"{ms:.4f} ms, model {lk.force_cost(plan, (X, Y, Z), sms):.1f}"
                  f" us", flush=True)
            if err > 1e-4 or not same:
                return 1
        lk._force_plans[key] = own
        eref = lk.elastic_energy_lattice_plain(u, cm, cs.DX, cs.MU, cs.LA)
        own_e = energy_plan(X, Y, Z, sms)
        for shape in [own_e] + [e for e in ENERGY[label] if e != own_e]:
            lk.energy_plan = lambda *a, p=shape: p
            e = lk.elastic_energy_lattice(u, cm, cs.DX, cs.MU, cs.LA)
            e2 = lk.elastic_energy_lattice(u, cm, cs.DX, cs.MU, cs.LA)
            torch.cuda.synchronize()
            rel = abs(float(e) - float(eref)) / abs(float(eref))
            us, ms = timed(lambda: lk.elastic_energy_lattice(
                u, cm, cs.DX, cs.MU, cs.LA), "energy_kernel")
            print(f"{label} energy {'plan' if shape == own_e else '    '} "
                  f"blocks {shape[0]} {'lanes' if shape[1] else 'a thread a cell'}"
                  f" rel|d| {rel:.1e} "
                  f"{'same bits' if torch.equal(e, e2) else 'BITS DIFFER'} "
                  f"device {us:.1f} us events {ms:.4f} ms", flush=True)
            if rel > 1e-4 or not torch.equal(e, e2):
                return 1
        lk.energy_plan = energy_plan
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
