#!/usr/bin/env python3
"""Time lat_diag and lat_diag_shift under their plans and under every launch form, on one GPU.

    python3 scripts/diag_tilings.py [--beams 2k,19k,74k] [--root TREE]
                                    [--save OUT.pt]
    python3 scripts/diag_tilings.py --bits A.pt B.pt

The shapes are every shape a main path launches the two kernels at: each
level of the beams' 3-level multigrid hierarchies (dx 0.05, LatticeMG
(n_levels=3, dt=None); level 0 is the beam itself), the 17x17x67 slab of
the 74k halo step (4 slabs), the sharded-level slabs of the distributed
multigrid (4 slabs) at 19k and 74k, and its replicated coarsest level at
19k (8 planes a slab). On a seeded displacement (and the level's ctrl and
vertex mask, or on a slab ones and a seeded positive ctrl) it runs
`hess_diag6_cf` (lat_diag) and `hess_diag_shift_cf` (lat_diag_shift,
projected) under the plan `diag_plan` picks and under each form forced:
the best halo tiling (one launch), the two passes, and up to 6 more halo
tilings (for every (waves, rounds) pair some tiling gives, the one that
computes the fewest cells); lat_diag_shift's best tiling also with eight
lanes a cell on every tile and on none (DIAG_LANE_CELLS). Each run is checked against the plain version
(max|d| <= 1e-4 max|ref|; the projected blocks outside the blocks where a
Jacobi rotation of either chain meets an exact tie), two runs bit-identical,
and the tiles' output against the two passes' bits. It prints the device us
of a call (the kernels' ops in a torch.profiler trace, kernel by kernel),
the events ms of a call, the tiles, their cells, rounds and waves, and the
model's us (`force_cost` under DIAG_MODEL or DIAG_SHIFT_MODEL, which were
fitted to this output).

--root TREE imports the package of another checkout and times only what its
wrappers run under its own plans (hess_diag_cf, hess_diag_shift_cf): run it
on the parent and on this tree in turns in one call to compare the two.
--save writes those two wrappers' outputs at every shape; --bits says
whether two such files are bit-equal, shape by shape.
"""
import argparse
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--beams", default="2k,19k,74k")
ap.add_argument("--root", default=None,
                help="another checkout: time its wrappers under its plans")
ap.add_argument("--save", default=None,
                help="write the wrappers' outputs at every shape here")
ap.add_argument("--bits", nargs=2, default=None,
                help="two --save files: bit-equal shape by shape?")
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root or os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import itertools  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch import require_cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda, ell  # noqa: E402
from fem_simulation_tpu_torch.ops import lattice_kernels as lk  # noqa: E402
from fem_simulation_tpu_torch.parallel import dist as pdist  # noqa: E402
from fem_simulation_tpu_torch.parallel import lattice_halo as plh  # noqa: E402
from fem_simulation_tpu_torch.parallel import \
    lattice_mg_dist as pmgd  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice as tlat  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice_mg as tmg  # noqa: E402

KERNELS = ("diag", "gather")      # the kernels' names hold one of these


def kernel_us(fn, n_ops):
    """(device us of one call: the mean span of each kernel op times its
    launches a call, "name us" of each kernel): traced again while fewer
    than n_ops kernels show (a short trace can lose its last events)."""
    sel = {}
    for _ in range(3):
        ops = cs.device_ops(fn, 20)
        got = {k: v for k, v in ops.items() if any(n in k for n in KERNELS)}
        if len(got) > len(sel):
            sel = got
        if len(sel) >= n_ops:
            break
    if not sel:
        return None, "none traced"
    parts = " + ".join(f"{_short(k)} {t:.2f}" for k, (_, t) in sel.items())
    return round(sum(max(1, round(n)) * t for n, t in sel.values()), 2), \
        parts


def _short(name):
    """A kernel's name without its namespace and signature."""
    for k in ("diag_tiles_kernel", "gather_diag", "diag_cells",
              "gather_vertices"):
        if k in name:
            return k
    return name[:40]


def shapes(dev, beams):
    """[(label, cell_mask, vert_mask, ctrl, dx)] at every launched shape."""
    out = []
    scenes = {}
    rng = np.random.default_rng(5)
    for label in beams:
        sc = tlat.LatticeScene(meshlib.beam(*cs.BEAMS[label], dx=cs.DX),
                               device=dev)
        scenes[label] = sc
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
        for li, lvl in enumerate(mg.levels):
            out.append((f"{label} level {li}", lvl.cell_mask, lvl.vert_mask,
                        lvl.ctrl + lvl.mass * 900.0, lvl.dx))

    def slab(label, cm, dx):
        X, Y, Z = (n + 1 for n in cm.shape)
        vm = torch.ones((X, Y, Z), device=dev)
        ctrl = torch.from_numpy((1.0 + rng.random((X, Y, Z))).astype(
            np.float32)).to(dev)
        out.append((label, cm, vm, ctrl, dx))
    if "74k" in scenes:
        slabs = plh.LatticeSlabs(scenes["74k"], cs.SLABS10)
        slab("74k halo-step slab", slabs.scatter_cells()[1], cs.DX)
    grid = pdist.make_device_mesh(cs.SLABS10, dp=1)
    for label in ("19k", "74k"):
        if label not in scenes:
            continue
        mg = pmgd.DistLatticeMG(scenes[label], grid, n_levels=3, dt=None)
        for li, lvl in enumerate(mg.levels):
            if mg.sharded(li):
                slab(f"{label} dist-mg slab level {li}", mg._cells[li][1],
                     lvl.dx)
        if label == "19k":
            mg8 = pmgd.DistLatticeMG(scenes[label], grid, n_levels=3,
                                     dt=None, min_planes_per_dev=8)
            for li, lvl in enumerate(mg8.levels):
                if not mg8.sharded(li):
                    out.append((f"19k dist-mg replicated level {li}",
                                lvl.cell_mask, lvl.vert_mask,
                                lvl.ctrl + lvl.mass * 900.0, lvl.dx))
    return out


def cells_computed(shape, plan):
    """Cells the halo tiles of plan compute, all tiles together."""
    return int(np.prod([sum(lk.tile_axis(n, nt, it)[3] for it in range(nt))
                        for n, nt in zip(shape, plan[1:4])]))


def other_tilings(shape, sms, model, skip):
    """Up to 6 halo tilings besides `skip`: for every (waves, rounds) pair
    some fitting tiling gives, the one that computes the fewest cells, the
    model's cheapest first."""
    by = {}
    for tiles in itertools.product(*(lk._tile_counts(n) for n in shape)):
        plan = lk.force_tiling(shape, tiles, model.box_floats, model.rows,
                               model.smem_floats, model.fixed_stride)
        if plan is None or plan in skip:
            continue
        per_sm = -(-plan[0] // sms)
        key = (-(-per_sm // lk.FORCE_RESIDENT),
               -(-plan[4] // lk.FORCE_THREADS))
        cells = cells_computed(shape, plan)
        if key not in by or cells < by[key][0]:
            by[key] = (cells, plan)
    plans = sorted((p for _, p in by.values()),
                   key=lambda p: lk.force_cost(p, shape, sms, model))
    return plans[:6]


def describe(plan, shape, sms):
    if plan == lk.FORCE_TWO_PASS:
        return "two passes: every cell once, a 48-float cell scratch"
    per_sm = -(-plan[0] // sms)
    cells = int(np.prod([n - 1 for n in shape]))
    return (f"halo tiles {plan[1]}x{plan[2]}x{plan[3]} ({plan[0]}) "
            f"cells/tile <= {plan[4]} rounds "
            f"{-(-plan[4] // lk.FORCE_THREADS)} per_sm {per_sm} waves "
            f"{-(-per_sm // lk.FORCE_RESIDENT)} computed/cells "
            f"{cells_computed(shape, plan) / cells:.3f}")


def check_shift(u, dargs, got, ref):
    """max|d| of the projected blocks outside the exact-tie blocks."""
    raw_k = lk.sym_blocks(lk.hess_diag_shift_cf(u, *dargs, False))
    raw_p = lk.shifted_diag_blocks_plain(u, *dargs)
    tie = ell.jacobi_ties(raw_k) | ell.jacobi_ties(raw_p)
    d = (got - ref).abs().amax(0)
    return float(d[~tie].max()), int(tie.sum())


def bits(a_path, b_path) -> int:
    """Whether two --save files hold bit-equal outputs, shape by shape."""
    a, b = torch.load(a_path), torch.load(b_path)
    equal = True
    for key in a:
        same = key in b and torch.equal(a[key], b[key])
        diff = (float((a[key] - b[key]).abs().max()) if key in b
                else float("nan"))
        print(f"bits {key}: {'bit-equal' if same else 'differ'} (max|d| "
              f"{diff:.3e})", flush=True)
        equal &= same
    print(f"bits {a_path} vs {b_path}: "
          f"{'bit-equal' if equal else 'differ'}", flush=True)
    return 0


def main() -> int:
    if ARGS.bits:
        return bits(*ARGS.bits)
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    _cuda.load()
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas", line.strip(), flush=True)
    sms = lk._sms(dev.index)
    tree = "root " + ARGS.root if ARGS.root else "this tree"
    failures = []
    saved = {}
    for label, cm, vm, ctrl, dx in shapes(dev, ARGS.beams.split(",")):
        shape = tuple(vm.shape)
        rng = np.random.default_rng(7)
        u = torch.from_numpy((0.03 * rng.standard_normal((3,) + shape))
                             .astype(np.float32)).to(dev) * vm
        args = (cm, dx, cs.MU, cs.LA)
        dargs = (cm, ctrl, vm, dx, cs.MU, cs.LA)
        ref6 = lk.sym_channels(lk.hess_diag_lattice_plain(
            u.permute(1, 2, 3, 0), *args))
        ref_s = lk.hess_diag_shift_cf_plain(u, *dargs)
        # what both trees' wrappers give (the slabs' diagonal as the parent
        # called it, and the multigrid's), under each tree's own plans
        cases = {"diag": (lambda: lk.hess_diag_cf(u, *args), ref6),
                 "diag_shift": (lambda: lk.hess_diag_shift_cf(u, *dargs),
                                ref_s)}
        for name, (call, ref) in cases.items():
            got, again = call(), call()
            torch.cuda.synchronize()
            saved[f"{name} {label}"] = got.cpu()
            if ARGS.root is None:
                continue
            ok = torch.equal(got, again)
            err = (check_shift(u, dargs, got, ref)[0] if name == "diag_shift"
                   else float((lk.sym_channels(got) - ref).abs().max()))
            # the two passes launch two kernels
            us, n = kernel_us(call, 2 if name == "diag" else 1)
            ms = cs.cuda_ms(call, 50)
            print(f"{name:10s} {tree} {label:28s} {shape} plan device {us} "
                  f"us ({n})  events {ms:.4f} ms  max|d| {err:.2e} same "
                  f"bits {ok}", flush=True)
        if ARGS.root:
            continue
        for shift, model in ((False, lk.DIAG_MODEL),
                             (True, lk.DIAG_SHIFT_MODEL)):
            name = "diag_shift" if shift else "diag"
            key = (str(u.device), *shape, shift)
            own = lk._diag_plan(*shape, dev, shift)
            lanes = lk.DIAG_LANE_CELLS
            forms = [("plan", own, lanes),
                     ("halo", lk.best_force_tiling(*shape, sms, model), lanes),
                     ("two-pass", lk.FORCE_TWO_PASS, lanes)]
            seen = {p for _, p, _ in forms}
            forms += [("other", p, lanes)
                      for p in other_tilings(shape, sms, model, seen)]
            if shift:
                # lat_diag_shift's tiles with eight lanes a cell for every
                # tile, and for none
                forms += [(f"lanes<={n}", forms[1][1], n)
                          for n in (0, lk.FORCE_THREADS)]
            ref = ref_s if shift else ref6
            scale = float(ref.abs().max())
            outs, lane_outs = {}, []
            runs = []
            for form, plan, n_lanes in forms:
                lk._diag_plans[key] = plan
                lk.DIAG_LANE_CELLS = n_lanes
                try:
                    def call():
                        return (lk.hess_diag_shift_cf(u, *dargs) if shift
                                else lk.hess_diag6_cf(u, *args))
                    got, again = call(), call()
                    torch.cuda.synchronize()
                    if form.startswith("lanes"):
                        lane_outs.append(got)
                    else:
                        outs[plan] = got
                    same = torch.equal(got, again)
                    if shift:
                        err, ties = check_shift(u, dargs, got, ref)
                    else:
                        err, ties = float((got - ref).abs().max()), 0
                    two = plan == lk.FORCE_TWO_PASS
                    us, n = kernel_us(call, 2 if two else 1)
                    ms = cs.cuda_ms(call, 50)
                finally:
                    lk._diag_plans[key] = own
                    lk.DIAG_LANE_CELLS = lanes
                if not (same and err <= 1e-4 * scale):
                    failures.append(f"{name} {label} {form} {plan}: same "
                                    f"bits {same}, max|d| {err:.3e}")
                model_us = lk.force_cost(plan, shape, sms, model)
                runs.append((us if us is not None else float("inf"), form,
                             plan))
                print(f"{name:10s} {label:28s} {shape} {form:8s} device "
                      f"{us} us ({n})  events {ms:.4f} ms  max|d| "
                      f"{err:.2e} (max|ref| {scale:.2e}, {ties} tied)  "
                      f"{describe(plan, shape, sms)}  model "
                      f"{model_us:.2f} us", flush=True)
            two = outs[lk.FORCE_TWO_PASS]
            eq = all(torch.equal(o, two) for o in outs.values())
            eq = eq and all(torch.equal(o, two) for o in lane_outs)
            if not eq:
                failures.append(f"{name} {label}: tiles and two passes "
                                "differ")
            best = min(runs)
            print(f"{name:10s} {label:28s} {shape} fastest {best[1]} "
                  f"{best[2]} {best[0]} us; plan {own}; every form "
                  f"bit-equal to the two passes {eq}", flush=True)
    if ARGS.save:
        torch.save(saved, ARGS.save)
    print(card)
    for f in failures:
        print("FAILED", f)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
