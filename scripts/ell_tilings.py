#!/usr/bin/env python3
"""Time ell_spmv, the smoothers, ell_outer, the Jacobi adjoint and ell_spmv_t at every shape the paths launch them at, on one GPU.

    python3 scripts/ell_tilings.py [--root TREE] [--save OUT.pt] [--only smoothers|backward]
    python3 scripts/ell_tilings.py --sweep OUT.json
    python3 scripts/ell_tilings.py --bits A.pt B.pt

The shapes (dx 0.05, seeded inputs as `chip_smoke.py` makes them):
- ell_spmv: the cloth's frame Hessian at 64x64 and 128x128 (K 7, phase 8's
  inputs); the fine Hessian (K 27) of the 2k, 19k and 74k beams (phase 4)
  and of the 21k exp2 beam with its exp2 coarse matrix (phase 9); and the
  owned-row ranges of the unstructured halo SpMV (`parallel/halo.py`) on
  the 19k beam's 4 slabs (phase 10);
- ell_outer alone at the phase 9 shapes (the 19k and 21k fine Hessians,
  the 21k coarse matrix, both 2k levels);
- ell_gs and ell_jacobi on every multigrid level of the 2k (2 levels),
  19k and 74k (3 levels) beams' Galerkin chains (phase 4's systems): ell_gs
  in the V-cycle's call (3 iterations from zero) and in the harness's and
  FAS's (1 iteration from x0) under the tree's own launch, with its share
  of the least the card must do (every row's values, nbr, mask, diag_slot
  and b read once, x read and written once); ell_jacobi 2 iterations from
  zero (phase 4's call), and in the paths' call, 1 iteration from zero
  (FAS v1-v3's and exp2's coarse solve) and from x0, at the level-1
  shapes (325, 2,673 and 10,449 rows) and exp2's coarse matrix (21k level
  1, 2,997 rows), each with its share of the bound (`jacobi_bound_us`)
  and, on a tree that has `ell_kernels.jacobi_lanes`, the lanes a row its
  C entry picks (`scripts/jacobi_lanes.py` times the other counts);
- ell_jacobi_bwd in its three forms (no values' gradient, from x_t, the
  zero start; storing, as the paths call it) at exp2's coarse matrix and
  the phase 9 shapes (the 19k and 21k fine Hessians, both 2k levels),
  beside `chip_smoke.jacobi_bwd_bound`;
- ell_spmv_t (`--only backward`) in both its calls, A^T g and, as the
  Jacobi adjoint calls it, -A^T g with each row's diagonal slot left out,
  at every shape a user's gradient gives it: the cloth's frame Hessians
  (K 7, phase 8's inputs), the fine Hessian of the 2k, 19k and 74k beams and the 2k beam's
  level 1, the 21k exp2 beam's fine Hessian and its exp2 coarse matrix
  (phase 9's state), beside `chip_smoke.spmv_t_bound`, the form and lanes
  its plan picks (on a tree that has `ell_kernels.spmv_t_plan`) and the
  device us of the library call BSR(A^T) @ g on the same matrix (each
  form and lane count at these shapes: `scripts/spmv_t_forms.py`);
- then the paths that launch them from rest (Newton-MG, FAS v1, v2 and v3
  on the 2k and 19k beams, 16 dynamic frames on the 2k beam) and exp2's
  first 10 clamped-SGD steps at 21k (P, l2, unroll 4, torch's
  deterministic algorithms on: run twice, the loss and gradient series must
  repeat their bits). These series do not repeat their bits from process
  to process at 19k and 21k (in either tree: the assembly's and the
  gradient's library calls), so --against TREE holds them to another
  tree's kernels in the same process instead: every ell_jacobi and
  ell_jacobi_bwd launch they make is run again through TREE's C entries on
  the same inputs, and must give the same bits (up to the sign of a zero).

Each output is checked against the plain version (max|d| <= 1e-5 max|ref|)
and for two runs bit-identical; the script prints the device us of a call
(the kernels' spans in a torch.profiler trace, summed over the kernels a
call launches) and the events ms of a call. Then 48 cloth frames
(`cloth.step_to_tol`, tol 2.5e-4) at both grids, their Newton list, max
||f|| and ms a frame, and exp2 (p_hat, l2, unroll 4, Adam, 10 steps) at
21k, its ms a step.

--only smoothers times ell_gs, ell_jacobi and ell_jacobi_bwd alone and
runs the series (no cloth, no SpMV, no ell_outer); --only backward times
ell_spmv_t alone.
--sweep OUT.json runs, at each smoother shape and call, ell_gs in every
form the tree's plan weighs (ops/ell_kernels.gs_candidates) at a sample of
block counts, each forced through `ell_kernels._gs_plans`, checks each
against the plan's own output (bit-equal) and the plain version, and
writes every device time with the plan model's estimate (the data
GS_MODEL is fitted to).

--fit A.json [B.json ...] fits GS_MODEL (ell_gs_plan's kGsModel) to such
sweeps by non-negative least squares, form by form, and prints the table,
each form's error and, at each shape and call, what the fitted plan picks
against the fastest launch the sweep measured.

--root TREE imports the package (and `chip_smoke.py`) of another checkout
and times only what its wrappers run: run it on the parent and on this
tree in turns in one call to compare the two. --save writes a digest of
every output (and of the cloth frames' Newton lists, ||f|| and final x)
here: its SHA-256 after +0.0 (so a zero's sign does not count), its sum
and its largest magnitude; --bits says whether two such files are
bit-equal, key by key, and exits 1 where a key differs or is missing
from either.
"""
import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

# cuBLAS repeats its bits under torch's deterministic algorithms only with
# a fixed workspace (the exp2 series); set before CUDA starts
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

ap = argparse.ArgumentParser()
ap.add_argument("--root", default=None,
                help="another checkout: time its wrappers as they are")
ap.add_argument("--save", default=None,
                help="write the outputs at every shape here")
ap.add_argument("--bits", nargs=2, default=None,
                help="two --save files: bit-equal key by key?")
ap.add_argument("--only", choices=("all", "smoothers", "backward"),
                default="all",
                help="smoothers: time ell_gs and ell_jacobi alone; "
                     "backward: ell_spmv_t alone")
ap.add_argument("--sweep", default=None,
                help="time every ell_gs form; write the times here (JSON)")
ap.add_argument("--fit", nargs="+", default=None,
                help="--sweep files: fit GS_MODEL to them (no GPU needed)")
ap.add_argument("--against", default=None,
                help="another checkout: hold the series' Jacobi launches "
                     "to its kernels in this process")
ARGS = ap.parse_args()
ROOT = os.path.abspath(ARGS.root or os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from fem_simulation_tpu_torch import mesh as meshlib  # noqa: E402
from fem_simulation_tpu_torch import require_cuda  # noqa: E402
from fem_simulation_tpu_torch.config import (SolverConfig,  # noqa: E402
                                             TrainInterpConfig)
from fem_simulation_tpu_torch.models import train_interp as ti  # noqa: E402
from fem_simulation_tpu_torch.ops import _cuda  # noqa: E402
from fem_simulation_tpu_torch.ops import ell_kernels as ek  # noqa: E402
from fem_simulation_tpu_torch.parallel import halo as phalo  # noqa: E402
from fem_simulation_tpu_torch.sim import cloth  # noqa: E402
from fem_simulation_tpu_torch.sim import quasistatic as qs  # noqa: E402
from fem_simulation_tpu_torch.sim.dynamic import DynamicSim  # noqa: E402
from fem_simulation_tpu_torch.sim.scene import Scene  # noqa: E402

TREE = "root " + ARGS.root if ARGS.root else "this tree"
FAILURES = []


def kernel_us(fn, names):
    """(device us of one call: the mean span of each kernel whose name holds
    one of `names`, times its launches a call; "name us" of each), traced
    again while none shows (a short trace can lose its last events)."""
    for _ in range(3):
        ops = cs.device_ops(fn, 20)
        sel = {k: v for k, v in ops.items() if any(n in k for n in names)}
        if sel:
            break
    if not sel:
        return None, "none traced"
    parts = " + ".join(f"{_short(k)} {t:.2f}" for k, (_, t) in sel.items())
    return round(sum(max(1, round(n)) * t for n, t in sel.values()), 2), \
        parts


def _short(name):
    for k in ("ell_spmv_kernel", "ell_spmv_t_kernel", "ell_outer_kernel",
              "ell_jacobi_bwd_kernel",
              "ell_gs_coop_kernel", "ell_gs_cluster_kernel",
              "ell_gs_grid_kernel", "ell_relax_rows_kernel",
              "ell_jacobi_kernel"):
        if k in name:
            return k + (name[name.index("<"):name.index(">") + 1]
                        if "<" in name else "")
    return name[:40]


def report(kind, label, call, plain, names, saved, bound_us=None):
    """Check call() against plain() and itself, time it, save its output;
    with bound_us, print the device time's share of it. Returns the device
    us of a call."""
    got, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not (same and err <= 1e-5 * scale):
        FAILURES.append(f"{kind} {label}: same bits {same}, max|d| "
                        f"{err:.3e} of {scale:.3e}")
    us, parts = kernel_us(call, names)
    ms = cs.cuda_ms(call, 50)
    share = ("" if bound_us is None or us is None
             else f"  bound {bound_us:.2f} us ({bound_us / us:.1%})")
    print(f"{kind:8s} {TREE:16s} {label:28s} "
          f"device {us} us ({parts})  events {ms:.4f} ms  max|d| {err:.2e} "
          f"(max|ref| {scale:.2e}) same bits {same}{share}", flush=True)
    saved[f"{kind} {label}"] = digest(got)
    return us


def digest(t):
    """(SHA-256 of t + 0.0, sum, max |t|): equal digests, equal bits up to
    the sign of a zero."""
    t = (t.detach().double() if not t.is_floating_point()
         else t.detach() + 0.0).cpu().contiguous()
    return (hashlib.sha256(t.numpy().tobytes()).hexdigest(),
            float(t.double().sum()), float(t.double().abs().max()))


def spmv_systems(dev):
    """[(label, values masked, nbr, mask, x, r0, r1)] at every launched
    shape; also the 21k Scene and its coarse matrix for the backward."""
    out = []
    for label, res in cs.CLOTHS.items():
        sc = cs.cloth_scene(res, dev)
        rng = np.random.default_rng(8)
        p = sc.params
        x = p["x0"] + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(p["x0"].shape)).astype(np.float32)).to(dev)
        vals = cloth._frame_hessian(sc, p, x, cloth._frame_diag(
            sc, p, cloth.init_state(sc), 1.0 / sc.cfg.dt))
        full = (vals * p["mask"][..., None, None]).contiguous()
        v = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
            np.float32)).to(dev)
        out.append((f"cloth {label}", full, p["nbr"], p["mask"], v, 0,
                    full.shape[0]))
    scenes = {}
    for label, b in cs.BEAMS.items():
        solver = SolverConfig(n_levels=2) if label == "2k" else SolverConfig()
        sc = Scene(meshlib.beam(*b, dx=cs.DX), solver=solver, device=dev)
        scenes[label] = sc
        rng = np.random.default_rng(4)
        op = sc.make_op(0)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(dev)
        full = (qs.assemble_fine(sc, sc.params, x)
                * op.mask[..., None, None]).contiguous()
        v = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
            np.float32)).to(dev)
        out.append((f"{label} fine", full, op.nbr, op.mask, v, 0,
                    full.shape[0]))
    sc21 = Scene(meshlib.beam(*cs.EXP_BEAM, dx=cs.DX),
                 solver=SolverConfig(n_levels=2), device=dev)
    rng = np.random.default_rng(19)
    x = sc21.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(sc21.x0.shape)).astype(np.float32)).to(dev)
    chain21 = [qs.assemble_fine(sc21, sc21.params, x),
               cs.exp2_coarse_values(sc21, x)]
    for li, vals in enumerate(chain21):
        op = sc21.make_op(li)
        full = (vals * op.mask[..., None, None]).contiguous()
        v = torch.from_numpy(rng.standard_normal((full.shape[0], 3)).astype(
            np.float32)).to(dev)
        out.append((f"21k level {li}", full, op.nbr, op.mask, v, 0,
                    full.shape[0]))
    # the unstructured halo SpMV's owned rows of each of 4 slabs at 19k
    sc = scenes["19k"]
    part = phalo.partition_slabs(sc.hier.levels[0], cs.SLABS10)
    vals = qs.assemble_fine(sc, sc.params, sc.x0)
    R = part.n_own + part.n_halo + 1
    for d in range(cs.SLABS10):
        nb = torch.zeros((R, part.local_nbr.shape[2]), dtype=torch.int32)
        nb[:part.n_own] = torch.from_numpy(part.local_nbr[d])
        mk = torch.zeros(tuple(nb.shape))
        mk[:part.n_own] = torch.from_numpy(part.local_mask[d])
        nb, mk = nb.to(dev), mk.to(dev)
        vp = vals.new_zeros((R,) + tuple(vals.shape[1:]))
        vp[:part.n_own] = vals[torch.from_numpy(part.own_global[d]).long()
                               .to(dev)] * mk[:part.n_own, :, None, None]
        v = torch.from_numpy(rng.standard_normal((R, 3)).astype(
            np.float32)).to(dev)
        out.append((f"19k halo slab {d}", vp, nb, mk, v, 0, part.n_own))
    return out, scenes, sc21, chain21


def smoother_systems(dev, scenes):
    """[(label, op, values, b, x0)] on every level of the Galerkin chain of
    each beam's unstructured Scene, made as chip_smoke.py's phase 4 makes
    them."""
    out = []
    for label, sc in scenes.items():
        rng = np.random.default_rng(11)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(dev)
        chain = qs.galerkin_chain(sc, sc.params,
                                  qs.assemble_fine(sc, sc.params, x))
        for li, vals in enumerate(chain):
            op = sc.make_op(li)
            n = vals.shape[0]
            b, x0 = (torch.from_numpy(scale * rng.standard_normal(
                (n, 3)).astype(np.float32)).to(dev) for scale in (1.0, 0.1))
            out.append((f"{label} level {li} N {n}", op, vals, b, x0))
    return out


def gs_pass_colors(offs, iterations):
    """The colors a Gauss-Seidel call must relax: per iteration the
    non-empty colors last to first, then first to last, never one twice in
    a row (a second pass in a row would write what the first wrote)."""
    seq = [c for c in range(len(offs) - 1) if offs[c + 1] > offs[c]]
    m = len(seq)
    if m == 1:
        return seq
    return [seq[abs(m - 1 - p % (2 * m - 2))]
            for p in range(iterations * (2 * m - 2) + 1)]


def gs_bound_us(offs, k, iterations, from_x0):
    """The least an H100 can take for a Gauss-Seidel call, in us: every
    row's values, nbr, mask, diag_slot and b read once, x read (from x0)
    and written once; 18 K + 60 FLOPs a row relaxed (chip_smoke.bound)."""
    n = offs[-1]
    rows = sum(offs[c + 1] - offs[c] for c in gs_pass_colors(offs,
                                                              iterations))
    return cs.bound(n * (44 * k + 16) + 12 * n * (2 if from_x0 else 1),
                    rows * (18.0 * k + 60.0))[0] * 1e3


def gs_plan_text(op, n, k, iterations, device):
    """The form and blocks the tree's plan gave a call, as it cached them."""
    plans = getattr(ek, "_gs_plans", None)
    if plans is None:
        return "coop (one form)"
    form, blocks = plans[(str(device), n, k, tuple(op.color_offsets),
                          iterations)]
    return f"{ek.GS_FORMS[form]} {blocks} blocks"


# the kernels of ell_jacobi in either tree: the first form's warp a row,
# the lane groups
JACOBI_NAMES = ("ell_relax_rows_kernel", "ell_jacobi_kernel")


def jacobi_bound_us(n, k, zero_start):
    """The least an H100 can take for one ell_jacobi iteration, in us:
    every row's values, diag_slot and b read and x written; from x also nbr
    and mask and x read (chip_smoke.jacobi_bound)."""
    n_bytes = n * (36 * k + 28) + (0 if zero_start else n * (8 * k + 12))
    return cs.bound(n_bytes, n * (18.0 * k + 60.0))[0] * 1e3


def jacobi_path_calls(dev, saved, systems):
    """ell_jacobi's paths' call (1 iteration from zero and from x0) at each
    (label, op, values, b, x0): checked and timed beside its bound."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, op, vals, b, x0 in systems:
        n, k = vals.shape[:2]
        for start, what in ((None, "1 it from 0"), (x0, "1 it from x0")):
            jargs = (vals, op.nbr, op.mask, op.diag_slot, b, start, 1)
            report("jacobi", f"{label} {what}", lambda: ek.jacobi(*jargs),
                   lambda: ek.jacobi_plain(*jargs), JACOBI_NAMES, saved,
                   jacobi_bound_us(n, k, start is None))
        if hasattr(ek, "jacobi_lanes"):
            print(f"jacobi   {TREE:16s} {label}: "
                  f"{ek.jacobi_lanes(n, sms)} lanes a row", flush=True)


def jacobi_bwd_calls(dev, saved, cases):
    """ell_jacobi_bwd's three forms, storing, at each (label, op, values):
    lam, gb and gv against jacobi_bwd_plain, timed beside the bound."""
    for label, op, vals in cases:
        n, k = vals.shape[:2]
        rng = np.random.default_rng(24)
        g, b, xt = (torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).to(dev) for _ in range(3))
        for form, gv_on, x in (("no gv", False, xt), ("from x_t", True, xt),
                               ("zero start", True, None)):
            def run(fn, gv_on=gv_on, x=x):
                gb = torch.zeros_like(g)
                gv = torch.zeros_like(vals) if gv_on else None
                lam = fn(vals, op.nbr, op.mask, op.diag_slot, b, x, g, gb, gv)
                return torch.cat([t.reshape(-1) for t in (lam, gb, gv)
                                  if t is not None])
            report("jacobi_bwd", f"{label} {form}",
                   lambda run=run: run(ek.jacobi_bwd),
                   lambda run=run: run(ek.jacobi_bwd_plain),
                   ("ell_jacobi_bwd_kernel",), saved,
                   cs.jacobi_bwd_bound(n, k, gv_on, x is not None)[0] * 1e3)


def exp21_system(dev):
    """The 21k exp2 Scene and its chain at a seeded state (phase 9's): the
    fine Hessian and the exp2 cycle's coarse matrix."""
    sc21 = Scene(meshlib.beam(*cs.EXP_BEAM, dx=cs.DX),
                 solver=SolverConfig(n_levels=2), device=dev)
    rng = np.random.default_rng(19)
    x = sc21.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(sc21.x0.shape)).astype(np.float32)).to(dev)
    return sc21, [qs.assemble_fine(sc21, sc21.params, x),
                  cs.exp2_coarse_values(sc21, x)]


def smoother_scenes(dev):
    """The beams' unstructured Scenes: 2 levels on the 2k beam, 3 on the
    others (chip_smoke.py's phase 4 and 5)."""
    return {label: Scene(meshlib.beam(*beam, dx=cs.DX), solver=(
        SolverConfig(n_levels=2) if label == "2k" else SolverConfig()),
        device=dev) for label, beam in cs.BEAMS.items()}


def smoothers(dev, saved, scenes, sc21, chain21):
    """ell_gs in both calls and ell_jacobi on every level of each beam,
    ell_jacobi's paths' call at the level-1 shapes and exp2's coarse
    matrix, ell_jacobi_bwd's forms, then the paths' series."""
    systems = smoother_systems(dev, scenes)
    for label, op, vals, b, x0 in systems:
        n, k = vals.shape[0], vals.shape[1]
        offs = [int(c) for c in op.color_offsets]
        args = (vals, op.nbr, op.mask, op.diag_slot, op.color_offsets, b)
        for iters, start, what in ((3, None, "3 it from 0"),
                                   (1, x0, "1 it from x0")):
            def call(start=start, iters=iters):
                return ek.gs(*args, start, iters)

            def plain(start=start, iters=iters):
                return ek.gs_plain(*args, start, iters)
            b_us = gs_bound_us(offs, k, iters, start is not None)
            report("gs", f"{label} {what}", call, plain, ("ell_gs_",),
                   saved, b_us)
            old = cs.smoother_bound(n, k, iters, 2, start is not None)[0]
            print(f"gs       {TREE:16s} {label} {what}: plan "
                  f"{gs_plan_text(op, n, k, iters, b.device)}; the first "
                  f"form's bytes a sweep {old * 1e3:.2f} us", flush=True)
        jargs = (vals, op.nbr, op.mask, op.diag_slot, b, None, 2)
        report("jacobi", f"{label} 2 it from 0", lambda: ek.jacobi(*jargs),
               lambda: ek.jacobi_plain(*jargs), JACOBI_NAMES, saved,
               jacobi_bound_us(n, k, True) + jacobi_bound_us(n, k, False))
    op21 = sc21.make_op(1)
    rng = np.random.default_rng(23)
    n21 = chain21[1].shape[0]
    b21, x21 = (torch.from_numpy(s * rng.standard_normal((n21, 3)).astype(
        np.float32)).to(dev) for s in (1.0, 0.1))
    coarse = [sys_ for sys_ in systems if " level 1 " in sys_[0]]
    jacobi_path_calls(dev, saved, coarse + [
        (f"21k level 1 N {n21}", op21, chain21[1], b21, x21)])
    bwd_cases = [(f"21k level 1 N {n21}", op21, chain21[1]),
                 ("19k level 0", scenes["19k"].make_op(0), None),
                 ("21k level 0", sc21.make_op(0), chain21[0]),
                 ("2k level 0", scenes["2k"].make_op(0), None),
                 ("2k level 1", scenes["2k"].make_op(1), None)]
    by_label = {label.rsplit(" N ", 1)[0]: vals
                for label, _, vals, _, _ in systems}
    jacobi_bwd_calls(dev, saved, [
        (label, op, vals if vals is not None else by_label[label])
        for label, op, vals in bwd_cases])
    against = Against(ARGS.against) if ARGS.against else None
    if against:
        against.install()
    series(scenes)
    if against:
        against.report("the series (Newton-MG, FAS v1-v3, dynamic frames)")
    exp2_series(sc21)
    if against:
        against.report("exp2's 10 steps, twice")
        against.restore()


def series(scenes):
    """The smoothers' paths from rest: Newton-MG and FAS v3, v1 and v2 on
    the 2k beam (30 steps, 60 cycles) and the 19k beam (20 and 20), 16
    dynamic frames to 1e-4 on the 2k beam; their ||f|| printed."""
    for label, steps in (("2k", (30, 60)), ("19k", (20, 20))):
        for method, n, kw in (("newton_multigrid", steps[0], {}),
                              ("fas", steps[1], {}),
                              ("fas", steps[1], {"variant": 1}),
                              ("fas", steps[1], {"variant": 2})):
            sim = qs.QuasiStaticSim(scenes[label])
            t0 = time.perf_counter()
            e, fn = getattr(sim, method)(n, **kw)
            ms = (time.perf_counter() - t0) * 1e3 / n
            name = method + "".join(f" v{v}" for v in kw.values())
            print(f"series   {TREE:16s} {label} {name} {n}: ||f|| "
                  f"{float(fn[0]):.6e} -> {float(fn[-1]):.6e}  host ms a "
                  f"step {ms:.2f}", flush=True)
    sim = DynamicSim(scenes["2k"])
    ks, fns = [], []
    for _ in range(16):
        state, k, fn = sim.frame_to_tol()
        ks.append(int(k))
        fns.append(float(fn))
    print(f"series   {TREE:16s} 2k dynamic 16 frames newton {ks} max ||f|| "
          f"{max(fns):.6e}", flush=True)


class Against:
    """While installed, every ell_jacobi and ell_jacobi_bwd launch of this
    process's wrappers is run again, on copies of the same inputs, through
    the C entries of another tree's kernel library, and the outputs are
    compared bit for bit (after + 0.0: a zero's sign does not count)."""

    def __init__(self, tree):
        spec = importlib.util.spec_from_file_location(
            "against_cuda", os.path.join(os.path.abspath(tree),
                                         "fem_simulation_tpu_torch", "ops",
                                         "_cuda.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        self.lib = mod.load()
        self.launches = {"jacobi": 0, "jacobi_bwd": 0}
        self.differ = []

    def _same(self, what, mine, theirs):
        if not torch.equal(mine + 0.0, theirs + 0.0):
            self.differ.append(what)

    def install(self):
        self.originals = launch, bwd = ek._jacobi_launch, ek.jacobi_bwd

        def jacobi_launch(values, nbr, mask, diag_slot, b, xa, xb,
                          iterations, zero_start):
            x0 = torch.zeros_like(b) if zero_start else xa.clone()
            launch(values, nbr, mask, diag_slot, b, xa, xb, iterations,
                   zero_start)
            n, k = values.shape[:2]
            ya, yb = x0, torch.empty_like(b)
            args = [t.data_ptr() for t in (values, nbr, mask, diag_slot, b,
                                           ya, yb)] + [n, k, iterations]
            if len(self.lib.ell_jacobi.argtypes) > 11:  # the zero-start flag
                args.append(int(zero_start))
            _cuda.check(self.lib.ell_jacobi(
                *args, torch.cuda.current_stream().cuda_stream), "against")
            odd = iterations % 2
            self.launches["jacobi"] += iterations
            self._same(f"jacobi N {n}", xb if odd else xa, yb if odd else ya)

        def jacobi_bwd(values, nbr, mask, diag_slot, b, xt, gbar, gb=None,
                       gv=None, accumulate=False):
            def start(t):
                if t is None:
                    return None
                return t.clone() if accumulate else torch.empty_like(t)
            gb2, gv2 = start(gb), start(gv)
            lam = bwd(values, nbr, mask, diag_slot, b, xt, gbar, gb, gv,
                      accumulate)
            lam2 = torch.empty_like(lam)
            ptr = [None if t is None else t.data_ptr()
                   for t in (values, nbr, mask, diag_slot, b, xt, gbar, lam2,
                             gb2, gv2)]
            _cuda.check(self.lib.ell_jacobi_bwd(
                *ptr, int(accumulate), values.shape[0], values.shape[1],
                torch.cuda.current_stream().cuda_stream), "against")
            self.launches["jacobi_bwd"] += 1
            what = f"jacobi_bwd N {values.shape[0]}"
            for mine, theirs in ((lam, lam2), (gb, gb2), (gv, gv2)):
                if mine is not None:
                    self._same(what, mine, theirs)
            return lam
        ek._jacobi_launch, ek.jacobi_bwd = jacobi_launch, jacobi_bwd

    def restore(self):
        ek._jacobi_launch, ek.jacobi_bwd = self.originals

    def report(self, what):
        torch.cuda.synchronize()
        print(f"against  {TREE:16s} {what}: {self.launches['jacobi']} "
              f"ell_jacobi and {self.launches['jacobi_bwd']} ell_jacobi_bwd "
              f"launches held to {ARGS.against}'s kernels on the same "
              f"inputs: {len(self.differ)} differ "
              f"{sorted(set(self.differ))[:5]}", flush=True)
        if self.differ:
            FAILURES.append(f"against {what}: {len(self.differ)} launches "
                            "differ")
        self.launches = {"jacobi": 0, "jacobi_bwd": 0}
        self.differ = []


def exp2_series(sc21, steps=10):
    """exp2's first `steps` clamped-SGD steps at 21k (P, l2, unroll 4, lr
    1e-4: chip_smoke.exp2_steps), each step's loss and gradient digested,
    under torch's deterministic algorithms (the gradient's index_add_ adds
    with atomics otherwise); run twice to show the series repeats."""
    cfg = TrainInterpConfig(mode="P", loss="l2", unroll=4, lr=1e-4)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        runs = [cs.exp2_steps(ti.InterpTrainer(sc21, cfg), steps)
                for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [torch.tensor([loss for loss, _ in r], dtype=torch.float64)
              for r in runs]
    grads = [torch.stack([g for _, g in r]) for r in runs]
    repeat = torch.equal(losses[0], losses[1]) and torch.equal(*grads)
    if not repeat:
        FAILURES.append("exp2 series: two runs differ")
    print(f"series   {TREE:16s} 21k exp2 P {steps} SGD steps: loss "
          f"{float(losses[0][0]):.9e} -> {float(losses[0][-1]):.9e}, max "
          f"|grad| {float(grads[0].abs().max()):.6e}; same bits twice "
          f"{repeat}", flush=True)


def spmv_t_systems(dev):
    """[(label, values, mask, tt, diag_slot)] at ell_spmv_t's shapes (see
    the module docstring), the beams' states seeded as chip_smoke.py's
    phase 9 seeds them."""
    out = []
    for label, res in cs.CLOTHS.items():
        sc = cs.cloth_scene(res, dev)
        rng = np.random.default_rng(8)
        p = sc.params
        x = p["x0"] + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(p["x0"].shape)).astype(np.float32)).to(dev)
        vals = cloth._frame_hessian(sc, p, x, cloth._frame_diag(
            sc, p, cloth.init_state(sc), 1.0 / sc.cfg.dt))
        out.append((f"cloth {label}", (vals * p["mask"][..., None, None])
                    .contiguous(), p["mask"], ek.transpose_table(p["nbr"]),
                    p["diag_slot"]))
    scenes = smoother_scenes(dev)
    for label, sc in scenes.items():
        rng = np.random.default_rng(19)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(dev)
        fine = qs.assemble_fine(sc, sc.params, x)
        chain = (qs.galerkin_chain(sc, sc.params, fine) if label == "2k"
                 else [fine])
        for li, vals in enumerate(chain):
            op = sc.make_op(li)
            out.append((f"{label} level {li}", vals, op.mask,
                        op.transpose_table(), op.diag_slot))
    sc21, chain21 = exp21_system(dev)
    for li, vals in enumerate(chain21):
        op = sc21.make_op(li)
        out.append((f"21k level {li}", vals, op.mask, op.transpose_table(),
                    op.diag_slot))
    return out


# ell_spmv_t's two calls: A^T g, and the Jacobi adjoint's -A^T g with each
# row's diagonal slot left out
SPMV_T_CALLS = (("plain", False, 1.0), ("diag out", True, -1.0))


def backward(dev, saved):
    """--only backward: ell_spmv_t in both calls at every shape, checked,
    timed beside its bound, its plan and BSR(A^T) @ g."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for label, vals, mask, tt, diag in spmv_t_systems(dev):
        n, k = vals.shape[:2]
        kt = int(tt.shape[1])
        g = torch.from_numpy(np.random.default_rng(23).standard_normal(
            (n, 3)).astype(np.float32)).to(dev)
        for call, with_skip, alpha in SPMV_T_CALLS:
            skip = diag if with_skip else None
            report("spmv_t", f"{label} N {n} Kt {kt} {call}",
                   lambda: ek.spmv_t(vals, mask, tt, g, skip, alpha),
                   lambda: ek.spmv_t_plain(vals, mask, tt, g, skip, alpha),
                   ("ell_spmv_t",), saved,
                   cs.spmv_t_bound(n, k, kt, with_skip)[0] * 1e3)
        plan = "one form"
        if hasattr(ek, "spmv_t_plan"):
            form, lanes = ek.spmv_t_plan(n, kt, sms)
            plan = f"{ek.SPMV_T_FORMS[form]} {lanes} lanes"
        At, gl = cs.bsr_t_of(vals, mask, tt), g.reshape(-1)
        lib = At @ gl
        ref = ek.spmv_t_plain(vals, mask, tt, g)
        err = float((lib.reshape(-1, 3) - ref).abs().max())
        print(f"spmv_t   {TREE:16s} {label} N {n} K {k} Kt {kt}: plan {plan}; "
              f"library BSR(A^T) @ g device {cs._ops_us(lambda: At @ gl, 1)[0]} us "
              f"events {cs.cuda_ms(lambda: At @ gl, 50):.4f} ms (max|d| "
              f"{err:.2e} of {float(ref.abs().max()):.2e})", flush=True)


def _sampled(cands):
    """The sweep's launches among the plan's candidates: every form's
    fewest blocks, clusters of 2-4, 8, 12 and 16 and 16, 33, 66, 99 and 132
    blocks of the cooperative staged forms."""
    keep, least = [], {}
    for cost, form, blocks in cands:
        least.setdefault(form, blocks)
    for cost, form, blocks in cands:
        cluster = form == ek.GS_CLUSTER
        if (form == ek.GS_COOP or blocks == least[form]
                or (cluster and (blocks <= 4 or blocks % 4 == 0))
                or (not cluster and blocks in (16, 33, 66, 99, 132))):
            keep.append((cost, form, blocks))
    return keep


def sweep(dev) -> int:
    """--sweep: every sampled form at every shape and call, forced through
    the plan cache, checked and timed; the times to ARGS.sweep."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    rows = []
    for label, op, vals, b, x0 in smoother_systems(dev,
                                                   smoother_scenes(dev)):
        n, k = vals.shape[0], vals.shape[1]
        offs = [int(c) for c in op.color_offsets]
        args = (vals, op.nbr, op.mask, op.diag_slot, op.color_offsets, b)
        for iters, start in ((3, None), (1, x0)):
            key = (str(b.device), n, k, tuple(offs), iters)
            ek._gs_plans.pop(key, None)
            mine = ek.gs(*args, start, iters)
            plan = ek._gs_plans[key]
            ref = ek.gs_plain(*args, start, iters)
            scale = float(ref.abs().max())
            for cost, form, blocks in _sampled(ek.gs_candidates(
                    n, k, offs, sms, iters)):
                ek._gs_plans[key] = (form, blocks)
                name = f"{label} {iters} it {ek.GS_FORMS[form]} {blocks}"
                try:
                    got = ek.gs(*args, start, iters)
                    again = ek.gs(*args, start, iters)
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    FAILURES.append(f"sweep {name}: {e}")
                    print(f"sweep {name}: {e}", flush=True)
                    continue
                same = torch.equal(got, again)
                eq = torch.equal(got, mine)
                err = float((got - ref).abs().max()) / scale
                if not (same and eq and err <= 1e-5):
                    FAILURES.append(f"sweep {name}: same bits {same}, "
                                    f"equal to the plan's {eq}, max rel "
                                    f"|d| {err:.3e}")
                us = kernel_us(lambda: ek.gs(*args, start, iters),
                               ("ell_gs_",))[0]
                rows.append(dict(label=label, n=n, k=k, offs=offs,
                                 iterations=iters,
                                 form=ek.GS_FORMS[form], blocks=blocks,
                                 us=us, model_us=cost, same=same,
                                 equal_to_plan=eq, rel_err=err))
                print(f"sweep {name}: device {us} us (model {cost:.1f}) "
                      f"same bits {same} equal to the plan's "
                      f"({ek.GS_FORMS[plan[0]]} {plan[1]}) {eq} max rel "
                      f"|d| {err:.2e}", flush=True)
            ek._gs_plans[key] = plan
    with open(ARGS.sweep, "w") as fh:
        json.dump(rows, fh, indent=0)
    for f in FAILURES:
        print("FAILED", f)
    return 1 if FAILURES else 0


def fit(paths) -> int:
    """--fit: GS_MODEL fitted to sweep files (see the module docstring)."""
    from scipy.optimize import nnls
    rows = [r for path in paths for r in json.load(open(path))
            if r["us"] is not None]
    model = []
    for form, name in enumerate(ek.GS_FORMS):
        sel = [r for r in rows if r["form"] == name]
        X = np.array([ek.gs_features(
            r["offs"], r["n"], r["k"],
            len(ek.gs_passes(r["offs"], r["iterations"])), form,
            r["blocks"] or ek.gs_coop_blocks(r["offs"], 132)) for r in sel])
        y = np.array([r["us"] for r in sel])
        live = np.abs(X).max(axis=0) > 0
        coef = np.zeros(X.shape[1])
        coef[live] = nnls(X[:, live], y)[0]
        err = X @ coef - y
        print(f"fit {name:9s} {len(sel)} launches: rms {np.sqrt(np.mean(err ** 2)):.2f} "
              f"us, max |err| {np.abs(err).max():.2f} us", flush=True)
        model.append(tuple(float(f"{c:.4g}") for c in coef))
    print("GS_MODEL = (")
    for name, m in zip(ek.GS_FORMS, model):
        print(f"    {m},  # {name}")
    print(")")
    ek.GS_MODEL = tuple(model)
    sms = 132
    shapes = {(r["label"], r["iterations"]): r for r in rows}
    worst = 0.0
    for (label, iters), r in shapes.items():
        got = {(x["form"], x["blocks"]): x["us"] for x in rows
               if (x["label"], x["iterations"]) == (label, iters)}
        best = min(got.items(), key=lambda kv: kv[1])
        form, blocks = ek.gs_plan(r["n"], r["k"], r["offs"], sms, iters)
        key = (ek.GS_FORMS[form], blocks)
        near = min((kv for kv in got.items() if kv[0][0] == key[0]),
                   key=lambda kv: abs(kv[0][1] - blocks))
        worst = max(worst, near[1] / best[1])
        print(f"fit {label} {iters} it: plan {key[0]} {blocks} (measured "
              f"{near[0][1]} blocks: {near[1]:.1f} us); fastest measured "
              f"{best[0][0]} {best[0][1]} {best[1]:.1f} us", flush=True)
    print(f"fit: the plan's picks within {worst - 1:.1%} of the fastest",
          flush=True)
    return 0


def bits(a_path, b_path) -> int:
    """Whether two --save files hold bit-equal outputs, key by key: 0 where
    every key of either is in both and equal, else 1."""
    a, b = torch.load(a_path), torch.load(b_path)
    equal = True
    for key in list(a) + [k for k in b if k not in a]:
        same = key in a and key in b and a[key][0] == b[key][0]
        sums = (f"sum {a[key][1]:.9e} / {b[key][1]:.9e}, max|.| "
                f"{a[key][2]:.6e} / {b[key][2]:.6e}" if key in a and key in b
                else "missing in the " + ("second" if key in a else "first")
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
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    _cuda.load()
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas", line.strip(), flush=True)
    if ARGS.sweep:
        return sweep(dev)
    saved = {}
    if ARGS.only == "backward":
        backward(dev, saved)
        return finish(saved, card)
    if ARGS.only == "smoothers":
        smoothers(dev, saved, smoother_scenes(dev), *exp21_system(dev))
        return finish(saved, card)
    systems, scenes, sc21, chain21 = spmv_systems(dev)
    names = ("ell_spmv",)
    for label, full, nbr, mask, v, r0, r1 in systems:
        k = full.shape[1]

        def call():
            return ek.spmv_rows(full, nbr, mask, v, r0, r1)
        report("spmv", f"{label} N {r1 - r0} K {k}", call,
               lambda: ek.spmv_rows_plain(full, nbr, mask, v, r0, r1), names,
               saved)
    # ell_outer alone
    cases = [("19k", scenes["19k"], 0), ("21k", sc21, 0), ("21k", sc21, 1),
             ("2k", scenes["2k"], 0), ("2k", scenes["2k"], 1)]
    for beam, sc, li in cases:
        op = sc.make_op(li)
        n, k = op.nbr.shape
        rng = np.random.default_rng(23 + li)
        g, v = (torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).to(dev) for _ in range(2))
        label = f"{beam} level {li} N {n}"

        def call():
            return ek.outer(g, op.nbr, op.mask, v)

        def plain():
            return ek.outer_plain(g, op.nbr, op.mask, v)
        report("outer", label, call, plain, ("ell_outer",), saved)
        b_ms = cs.outer_bound(n, k)[0]
        print(f"outer    bound {label}: {b_ms * 1e3:.2f} us", flush=True)
    smoothers(dev, saved, scenes, sc21, chain21)
    # end to end: 48 cloth frames at both grids, exp2 steps at 21k
    for label, res in cs.CLOTHS.items():
        sc = cs.cloth_scene(res, dev)
        cs.cloth_frames(sc, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, ks, fns = cs.cloth_frames(sc, 48)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / 48
        saved[f"cloth {label} newton"] = digest(torch.tensor(ks))
        saved[f"cloth {label} fn"] = digest(torch.tensor(
            fns, dtype=torch.float64))
        saved[f"cloth {label} x"] = digest(st.x)
        print(f"cloth    {TREE:16s} {label} 48 frames ms/frame {ms:.2f} "
              f"newton {ks} max||f|| {max(fns):.6e}", flush=True)
    cfg = TrainInterpConfig(mode="p_hat", loss="l2", unroll=4,
                            optimizer="adam", lr=1e-3)
    tr = ti.InterpTrainer(sc21, cfg)
    tr.train(2)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist = tr.train(10)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / 10
    print(f"exp2     {TREE:16s} 21k p_hat adam l2 unroll 4 ms/step {ms:.2f}"
          f" loss {hist[0]:.6e} -> {hist[-1]:.6e}", flush=True)
    return finish(saved, card)


def finish(saved, card) -> int:
    """Save the digests (--save), print the card and every failure."""
    if ARGS.save:
        torch.save(saved, ARGS.save)
    print(card)
    for f in FAILURES:
        print("FAILED", f)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
