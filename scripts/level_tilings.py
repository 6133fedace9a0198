#!/usr/bin/env python3
"""Time the multigrid's level kernels and the standalone HVP under their launch plans, on one GPU.

    python3 scripts/level_tilings.py [--beams 2k,19k,74k] [--only levels]
                                     [--root TREE] [--save OUT.pt]
    python3 scripts/level_tilings.py --sweep OUT.json
    python3 scripts/level_tilings.py --fit A.json [B.json ...]
    python3 scripts/level_tilings.py --bits A.pt B.pt

For every level shape of each beam's 3-level hierarchy (dx 0.05, LatticeMG
(n_levels=3, dt=None); a seeded displacement, right-hand side and start as
`chip_smoke.py`'s phase 7 makes them, d6 from lat_diag_shift, the
Chebyshev bound from the plain power iteration times 1.2, so that two
trees get the same inputs) it runs lat_cheby in the V-cycle's three calls
(a pre-smooth of 2 sweeps from zero with its residual and a post-smooth of
2 sweeps from a start on the levels above the coarsest, 12 sweeps from
zero on the coarsest) and lat_power (6 iterations), each under the tree's
plan: checked against the plain version (max|d| <= 1e-4 max|ref|) and for
two runs bit-identical, and timed (device us of a call from a
torch.profiler trace, events ms), with its share of the least the card
must do (`chip_smoke.cheby_bound` / `level_bounds`) and the form and tiles
the plan picked. lat_power prints its lambda in full.

Without --only levels it first times `lat_hvp` under the plan `hvp_plan`
picks, under the two passes and under up to 10 other halo tilings (the
data HVP_MODEL was fitted to), and `level_matvec_cf`.

--root TREE imports the package (and `chip_smoke.py`) of another checkout
and times only what its wrappers run: run it on the parent and on this tree
in turns in one call to compare the two. --save writes a digest of every
output here (SHA-256 after +0.0, sum, max |.|); --bits says whether two
such files are bit-equal key by key (exit 1 where a key differs or is
missing) and prints lat_power's two lambdas and their difference in ulps.

--path then runs the tree's own `chip_smoke.phase7_path` (the verify
recipe, the full-size quasi-static solves, 16 multigrid frames at 2k and
19k, the kicks, the cantilever's FMG) and saves its counts (Newton, PCG,
launches of every solve, the frames' mean Newton, the substeps, FMG's
Newton per level and tip, the path's launches) with the digests, so that
--bits compares them too, and the states that the 19k and 74k
quasi-static multigrid solves and three frames of the kick under
frame_adaptive_mg end in (--bits: their largest difference).

--sweep OUT.json runs every call at every shape in a sample of the launches
the plan weighs (`lattice_kernels.level_candidates`: clusters of 1-16
z-slabs, the tiles form's tilings), each forced through
`lattice_kernels._level_plans`, checks each against the plan's own output
(bit-equal) and the plain version, and writes its device us beside the
model's features. --fit fits LEVEL_MODEL (lat_level_plan's kLevelModel) to
such files by non-negative least squares, form by form, and prints the
table and, at each shape and call, the fitted plan's pick against the
fastest launch measured.
"""
import argparse
import hashlib
import itertools
import json
import os
import subprocess
import sys

ap = argparse.ArgumentParser()
ap.add_argument("--beams", default="2k,19k,74k")
ap.add_argument("--only", choices=("all", "levels"), default="all",
                help="levels: lat_cheby and lat_power alone")
ap.add_argument("--root", default=None,
                help="another checkout: time its wrappers as they are")
ap.add_argument("--save", default=None,
                help="write the level kernels' output digests here")
ap.add_argument("--bits", nargs=2, default=None,
                help="two --save files: bit-equal key by key?")
ap.add_argument("--sweep", default=None,
                help="time every sampled level launch; write the times here")
ap.add_argument("--fit", nargs="+", default=None,
                help="--sweep files: fit LEVEL_MODEL to them (no GPU needed)")
ap.add_argument("--path", action="store_true",
                help="also run chip_smoke.py's phase 7 path; save its counts")
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root or os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import lattice_kernels as lk  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice as tlat  # noqa: E402
from fem_simulation_tpu_torch.sim import lattice_mg as tmg  # noqa: E402

TREE = "root " + ARGS.root if ARGS.root else "this tree"
FAILURES = []
LEVEL_KERNELS = ("level_kernel", "cheby_kernel", "power_kernel")
SMS = 132


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


def level_us(fn):
    """Device us of one call of a level kernel (the spans of the kernels
    named in LEVEL_KERNELS), traced again while none shows."""
    for _ in range(3):
        ops = cs.device_ops(fn, 20)
        sel = [(n, t) for k, (n, t) in ops.items()
               if any(name in k for name in LEVEL_KERNELS)]
        if sel:
            return round(sum(max(1, round(n)) * t for n, t in sel), 2)
    return None


def digest(t):
    """(SHA-256 of t + 0.0, sum, max |t|): equal digests, equal bits up to
    the sign of a zero."""
    t = (t.detach() + 0.0).cpu().contiguous()
    return (hashlib.sha256(t.numpy().tobytes()).hexdigest(),
            float(t.double().sum()), float(t.double().abs().max()))


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


def hvp_tilings(label, li, lvl, u, p, sms):
    """lat_hvp under its plan, the two passes and other halo tilings; the
    level matvec under its plan."""
    shape = tuple(lvl.vert_mask.shape)
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
            cs.check(torch.equal(got, again), f"hvp {name}: two runs differ")
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
            extra = (f"tiles {plan[1]}x{plan[2]}x{plan[3]} ({plan[0]}) "
                     f"cells/tile <= {plan[4]} rounds "
                     f"{-(-plan[4] // lk.FORCE_THREADS)} waves "
                     f"{-(-per_sm // lk.FORCE_RESIDENT)} computed/cells "
                     f"{cells_computed(shape, plan) / cells:.3f}")
        model = lk.force_cost(plan, shape, sms, lk.HVP_MODEL)
        runs.append((us, name))
        print(f"hvp {label:4s} level {li} {shape} {name:9s} device {us} us  "
              f"events {ms:.4f} ms  max|d| {err:.2e} (max|ref| {scale:.2e})"
              f"  {extra} model {model:.2f} us", flush=True)
    best = min((r for r in runs if r[0] is not None), default=None)
    print(f"hvp {label:4s} level {li} {shape} fastest {best}", flush=True)
    margs = (u, p, lvl.cell_mask, lvl.ctrl, lvl.vert_mask, lvl.dx, cs.MU,
             cs.LA)
    got = lk.level_matvec_cf(*margs)
    want = lk.level_matvec_cf_plain(*margs)
    torch.cuda.synchronize()
    err, s = float((got - want).abs().max()), float(want.abs().max())
    cs.check(err <= 1e-4 * s, f"level_matvec {label} level {li}")
    call = lambda: lk.level_matvec_cf(*margs)  # noqa: E731
    print(f"level_matvec {label:4s} level {li} {shape} device "
          f"{device_total(call, 2 if own == lk.FORCE_TWO_PASS else 1)} us  "
          f"events {cs.cuda_ms(call, 50):.4f} ms  max|d| {err:.2e}",
          flush=True)


def level_cases(dev):
    """[(label, li, lvl, cases)] at every level of each beam's hierarchy:
    cases {name: (kernel, sweeps, warm, residual, call, plain, bound_ms)}
    with the inputs chip_smoke.py's phase 7 makes (rng 7) and the bound
    from the plain power iteration."""
    out = []
    for label in ARGS.beams.split(","):
        sc = tlat.LatticeScene(meshlib.beam(*cs.BEAMS[label], dx=cs.DX),
                               device=dev)
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
        rng = np.random.default_rng(7)
        for li, lvl in enumerate(mg.levels):
            shape = (3,) + tuple(lvl.vert_mask.shape)
            vm = lvl.vert_mask

            def field(scale):
                return torch.from_numpy((scale * rng.standard_normal(
                    shape)).astype(np.float32)).to(dev)
            u, p, b, x0 = field(0.03) * vm, field(1.0), field(1.0) * vm, \
                field(0.1) * vm
            dargs = (lvl.cell_mask, lvl.ctrl, vm, lvl.dx, cs.MU, cs.LA)
            d6 = lk.hess_diag_shift_cf(u, *dargs)
            pargs = (u, d6, lvl.ctrl, vm, lvl.cell_mask, lvl.dx, cs.MU, cs.LA)
            lmax = np.float32(lk.power_lmax_cf_plain(*pargs).item()) \
                * np.float32(1.2)
            calls = ({"coarse": (None, 12, False)}
                     if li == mg.n_levels - 1 else
                     {"pre": (None, 2, True), "post": (x0, 2, False)})
            cases = {}
            for name, (x, sweeps, res) in calls.items():
                args = (u, b, x, d6, lvl.ctrl, vm, lvl.cell_mask, lvl.dx,
                        cs.MU, cs.LA, lk.cheby_coeffs(lmax, sweeps), res)
                cases[name] = (
                    lk.CHEBY, sweeps, x is not None, res,
                    lambda args=args: lk.cheby_smooth_cf(*args),
                    lambda args=args: lk.cheby_smooth_cf_plain(*args),
                    cs.cheby_bound(lvl, sweeps, x is not None, res)[0])
            cases["power"] = (lk.POWER, 6, False, False,
                              lambda pargs=pargs: lk.power_lmax_cf(*pargs),
                              lambda pargs=pargs: lk.power_lmax_cf_plain(
                                  *pargs),
                              cs.level_bounds(lvl)["power"][0])
            out.append((label, li, lvl, u, p, cases))
    return out


def flat(out):
    """One tensor of a call's output (x, or x and r)."""
    return torch.cat([t.reshape(-1) for t in out]) if isinstance(
        out, tuple) else out.reshape(-1)


def plan_key(lvl, kernel, sweeps, warm, res):
    return (str(lvl.vert_mask.device), *lvl.vert_mask.shape, kernel, sweeps,
            bool(warm), bool(res))


def plan_text(lvl, kernel, sweeps, warm, res):
    """The form and tiles the tree's plan gave a call, as it cached them."""
    if not hasattr(lk, "level_plan"):
        return "parent's plan"
    form, *tiles = lk._level_plans[plan_key(lvl, kernel, sweeps, warm, res)]
    return f"{lk.LEVEL_FORMS[form]} {'x'.join(map(str, tiles))}"


def check_call(name, call, plain):
    """(output, max|d| / max|ref|, two runs bit-identical); the failure
    noted where either check fails."""
    got, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    got, again, ref = flat(got), flat(again), flat(ref)
    same = torch.equal(got, again)
    rel = float((got - ref).abs().max()) / float(ref.abs().max())
    if not (same and rel <= 1e-4):
        FAILURES.append(f"{name}: same bits {same}, max|d| {rel:.3e} of "
                        f"max|ref|")
    return got, rel, same


def levels(dev, saved):
    """lat_cheby's three calls and lat_power at every level shape."""
    for label, li, lvl, u, p, cases in level_cases(dev):
        shape = tuple(lvl.vert_mask.shape)
        if ARGS.only == "all":
            hvp_tilings(label, li, lvl, u, p, SMS)
        for name, (kernel, sweeps, warm, res, call, plain, b_ms) in \
                cases.items():
            where = f"{label} level {li} {name}"
            got, rel, same = check_call(where, call, plain)
            us = level_us(call)
            ms = cs.cuda_ms(call, 50)
            share = "" if us is None else f" ({b_ms * 1e3 / us:.1%})"
            lam = (f"  lambda*1.1 {float(got[0])!r}" if kernel == lk.POWER
                   else "")
            print(f"level {TREE:16s} {where:22s} {shape} "
                  f"{plan_text(lvl, kernel, sweeps, warm, res):18s} device "
                  f"{us} us  events {ms:.4f} ms  bound {b_ms * 1e3:.2f} us"
                  f"{share}  max|d|/max|ref| {rel:.2e} same bits {same}{lam}",
                  flush=True)
            saved[where] = digest(got)


def path(dev, saved):
    """chip_smoke.phase7_path on the tree's beams: its counts, printed and
    saved (their JSON as the digest) for --bits."""
    scenes = {label: tlat.LatticeScene(meshlib.beam(*b, dx=cs.DX),
                                       device=dev)
              for label, b in cs.BEAMS.items()}
    results, counts = cs.phase7_path(scenes)
    keep = {"launches": {k: v for k, v in counts.items() if v}}
    for name, r in results["solves"].items():
        keep[name] = {k: r[k] for k in ("newton", "pcg", "launches")}
    for name, r in results.items():
        if name == "solves":
            continue
        keep[name] = {k: v for k, v in r.items()
                      if k not in ("ms_per_frame", "wall_ms_per_frame")}
    for name, v in keep.items():
        text = json.dumps(v, sort_keys=True, default=repr)
        print(f"path {TREE:16s} {name}: {text}", flush=True)
        saved[f"path {name}"] = (hashlib.sha256(text.encode()).hexdigest(),
                                 0.0, 0.0)
    # the states these runs end in, for --bits to hold them to each other
    for label in ("19k", "74k"):
        sc = scenes[label]
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
        x, k, fn = tmg.quasistatic_to_tol_mg(sc, mg, sc.x0, tol=cs.TOL,
                                             max_newton=100)
        saved[f"x {label} quasistatic_to_tol_mg"] = x.cpu()
    kick = tlat.LatticeScene(meshlib.beam(3, 3, 12, dx=cs.DX), device=dev)
    kick_mg = tmg.LatticeMG(kick, n_levels=2, dt=None)
    st = cs.kicked(kick, kick.init_state())
    for _ in range(3):
        st = tmg.frame_adaptive_mg(kick, kick_mg, st, tol=cs.TOL,
                                   max_newton=6, max_halvings=4)[0]
    saved["x kick frame_adaptive_mg"] = st.x.cpu()


def _sampled(cands):
    """The sweep's launches among the plan's candidates: clusters of 1, 2,
    4, 8, 12 and 16 blocks; of each cooperative form, for (ntx, nty) in
    (1, 1), (2, 1), (4, 1), (2, 2) and (4, 4), the z counts whose blocks
    come nearest 8, 33, 66, 132 and 264."""
    keep = []
    groups = {}
    for cost, form, t in cands:
        if form == lk.LEVEL_CLUSTER:
            if t[2] in (1, 2, 4, 8, 12, 16):
                keep.append((cost, form, t))
        elif t[:2] in ((1, 1), (2, 1), (4, 1), (2, 2), (4, 4)):
            groups.setdefault((form, t[:2]), []).append((cost, form, t))
    for group in groups.values():
        pick = {min(group, key=lambda c: abs(c[2][0] * c[2][1] * c[2][2]
                                              - want))[2]
                for want in (8, 33, 66, 132, 264)}
        keep += [c for c in group if c[2] in pick]
    return keep


def sweep(dev) -> int:
    """--sweep: every sampled launch of every call at every shape, forced
    through the plan cache, checked and timed; the times to ARGS.sweep."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label, li, lvl, u, p, cases in level_cases(dev):
        shape = tuple(lvl.vert_mask.shape)
        for name, (kernel, sweeps, warm, res, call, plain, b_ms) in \
                cases.items():
            key = plan_key(lvl, kernel, sweeps, warm, res)
            lk._level_plans.pop(key, None)
            mine = flat(call())
            plan = lk._level_plans[key]
            ref = flat(plain())
            scale = float(ref.abs().max())
            for cost, form, tiles in _sampled(lk.level_candidates(
                    shape, sms, kernel, sweeps, warm, res)):
                lk._level_plans[key] = (form,) + tiles
                what = (f"{label} level {li} {name} {lk.LEVEL_FORMS[form]} "
                        f"{'x'.join(map(str, tiles))}")
                try:
                    got, again = flat(call()), flat(call())
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    FAILURES.append(f"sweep {what}: {e}")
                    print(f"sweep {what}: {e}", flush=True)
                    continue
                same, eq = torch.equal(got, again), torch.equal(got, mine)
                err = float((got - ref).abs().max()) / scale
                if not (same and eq and err <= 1e-4):
                    FAILURES.append(f"sweep {what}: same bits {same}, equal "
                                    f"to the plan's {eq}, max rel |d| "
                                    f"{err:.3e}")
                us = level_us(call)
                rows.append(dict(label=label, level=li, call=name,
                                 shape=shape, kernel=kernel, sweeps=sweeps,
                                 warm=warm, residual=res,
                                 form=lk.LEVEL_FORMS[form], tiles=tiles,
                                 us=us, model_us=cost, same=same,
                                 equal_to_plan=eq, rel_err=err))
                print(f"sweep {what}: device {us} us (model {cost:.1f}) "
                      f"same bits {same} equal to the plan's "
                      f"({lk.LEVEL_FORMS[plan[0]]} "
                      f"{'x'.join(map(str, plan[1:]))}) {eq} max rel |d| "
                      f"{err:.2e}", flush=True)
            lk._level_plans[key] = plan
    with open(ARGS.sweep, "w") as fh:
        json.dump(rows, fh, indent=0)
    for f in FAILURES:
        print("FAILED", f)
    return 1 if FAILURES else 0


def fit(paths) -> int:
    """--fit: LEVEL_MODEL fitted to sweep files (see the module
    docstring)."""
    from scipy.optimize import nnls
    rows = [r for path in paths for r in json.load(open(path))
            if r["us"] is not None]

    def features(r, form):
        hvps, waits = lk.level_calls(r["kernel"], r["sweeps"], r["warm"],
                                     r["residual"])
        return lk.level_features(tuple(r["shape"]), form, tuple(r["tiles"]),
                                 r["sweeps"], hvps, waits,
                                 r["kernel"] == lk.POWER)
    model = []
    for form in (lk.LEVEL_CLUSTER, lk.LEVEL_TILES):   # the modelled forms
        name = lk.LEVEL_FORMS[form]
        sel = [r for r in rows if r["form"] == name]
        X = np.array([features(r, form) for r in sel])
        y = np.array([r["us"] for r in sel])
        live = np.abs(X).max(axis=0) > 0
        coef = np.zeros(X.shape[1])
        coef[live] = nnls(X[:, live], y)[0]
        err = X @ coef - y
        print(f"fit {name:8s} {len(sel)} launches: rms "
              f"{np.sqrt(np.mean(err ** 2)):.2f} us, max |err| "
              f"{np.abs(err).max():.2f} us", flush=True)
        model.append(tuple(float(f"{c:.4g}") for c in coef))
    print("LEVEL_MODEL = (")
    for name, m in zip(lk.LEVEL_FORMS, model):  # cluster, tiles
        print(f"    {m},  # {name}")
    print(")")
    lk.LEVEL_MODEL = tuple(model)
    worst = 0.0
    calls = {(r["label"], r["level"], r["call"]): r for r in rows}
    for (label, li, name), r in calls.items():
        got = {(x["form"], tuple(x["tiles"])): x["us"] for x in rows
               if (x["label"], x["level"], x["call"]) == (label, li, name)}
        best = min(got.items(), key=lambda kv: kv[1])
        form, *tiles = lk.level_plan(tuple(r["shape"]), SMS, r["kernel"],
                                     r["sweeps"], r["warm"], r["residual"])
        key = (lk.LEVEL_FORMS[form], tuple(tiles))
        same = [kv for kv in got.items() if kv[0][0] == key[0]]
        if not same:
            print(f"fit {label} level {li} {name}: plan {key[0]} "
                  f"{'x'.join(map(str, tiles))}, a form the sweep did not "
                  f"measure here", flush=True)
            continue
        near = min(same, key=lambda kv: (kv[0][1] != key[1],
                                         kv[0][1][:2] != key[1][:2],
                                         abs(np.prod(kv[0][1])
                                             - np.prod(tiles))))
        worst = max(worst, near[1] / best[1])
        print(f"fit {label} level {li} {name}: plan {key[0]} "
              f"{'x'.join(map(str, tiles))} (measured "
              f"{'x'.join(map(str, near[0][1]))}: {near[1]:.1f} us); "
              f"fastest measured {best[0][0]} "
              f"{'x'.join(map(str, best[0][1]))} {best[1]:.1f} us",
              flush=True)
    print(f"fit: the plan's picks within {worst - 1:.1%} of the fastest",
          flush=True)
    return 0


def bits(a_path, b_path) -> int:
    """Whether two --save files hold bit-equal outputs, key by key: 0 where
    every key of either is in both and equal, else 1. lat_power's lambdas
    and their difference in float32 ulps."""
    a, b = torch.load(a_path), torch.load(b_path)
    equal = True
    for key in [k for k in a if k.startswith("x ")]:
        if key in b:   # a state: its largest difference
            d = float((a[key] - b[key]).abs().max())
            word = ("bit-equal" if d == 0 else "within 1e-4" if d <= 1e-4
                    else "beyond 1e-4")
            print(f"bits {key}: max|d x| {d:.3e} ({word})", flush=True)
    a = {k: v for k, v in a.items() if not k.startswith("x ")}
    b = {k: v for k, v in b.items() if not k.startswith("x ")}
    for key in list(a) + [k for k in b if k not in a]:
        same = key in a and key in b and a[key][0] == b[key][0]
        if key in a and key in b:
            sums = (f"sum {a[key][1]:.9e} / {b[key][1]:.9e}, max|.| "
                    f"{a[key][2]:.6e} / {b[key][2]:.6e}")
            if key.endswith("power"):
                la, lb = np.float32(a[key][1]), np.float32(b[key][1])
                ulps = abs(int(la.view(np.int32)) - int(lb.view(np.int32)))
                sums += f", lambda*1.1 {la!r} / {lb!r}: {ulps} ulps"
        else:
            sums = ("missing in the " + ("second" if key in a else "first")
                    + " file")
        print(f"bits {key}: {'bit-equal' if same else 'differ'} ({sums})",
              flush=True)
        equal &= same
    print(f"bits {a_path} vs {b_path}: "
          f"{'bit-equal' if equal else 'differ'}", flush=True)
    return 0 if equal else 1


def main() -> int:
    if ARGS.bits:
        return bits(*ARGS.bits)
    if ARGS.fit:
        return fit(ARGS.fit)
    if not torch.cuda.is_available():
        raise SystemExit("level_tilings.py needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    _cuda.load()
    for line in _cuda.build_log.splitlines():
        if "level_kernel" in line or "registers" in line or "spill" in line:
            print("ptxas", line.strip(), flush=True)
    if ARGS.sweep:
        code = sweep(dev)
        print(card)
        return code
    saved = {}
    levels(dev, saved)
    if ARGS.path:
        path(dev, saved)
    if ARGS.save:
        torch.save(saved, ARGS.save)
    print(card)
    for f in FAILURES:
        print("FAILED", f)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
