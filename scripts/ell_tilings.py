#!/usr/bin/env python3
"""Time ell_spmv, ell_outer and the Jacobi adjoint at every shape the paths launch them at, on one GPU.

    python3 scripts/ell_tilings.py [--root TREE] [--save OUT.pt]
    python3 scripts/ell_tilings.py --bits A.pt B.pt

The shapes (dx 0.05, seeded inputs as `chip_smoke.py` makes them):
- ell_spmv: the cloth's frame Hessian at 64x64 and 128x128 (K 7, phase 8's
  inputs); the fine Hessian (K 27) of the 2k, 19k and 74k beams (phase 4)
  and of the 21k exp2 beam with its exp2 coarse matrix (phase 9); and the
  owned-row ranges of the unstructured halo SpMV (`parallel/halo.py`) on
  the 19k beam's 4 slabs (phase 10);
- the Jacobi adjoint of one iteration at the exp2 coarse matrix (21k level
  1, N 2,997), with the values' gradient, from the zero start (exp2's
  path) and from a seeded x_t: lam, gb and gv, as the tree's
  `EllJacobiFn` asks for them (one ell_jacobi_bwd launch where the tree
  can write the off-diagonal slots in it, else ell_jacobi_bwd and then
  ell_outer);
- ell_outer alone at the phase 9 shapes (the 19k and 21k fine Hessians,
  the 21k coarse matrix, both 2k levels).

Each output is checked against the plain version (max|d| <= 1e-5 max|ref|)
and for two runs bit-identical; the script prints the device us of a call
(the kernels' spans in a torch.profiler trace, summed over the kernels a
call launches) and the events ms of a call. Then 48 cloth frames
(`cloth.step_to_tol`, tol 2.5e-4) at both grids, their Newton list, max
||f|| and ms a frame, and exp2 (p_hat, l2, unroll 4, Adam, 10 steps) at
21k, its ms a step.

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
import os
import subprocess
import sys
import time

ap = argparse.ArgumentParser()
ap.add_argument("--root", default=None,
                help="another checkout: time its wrappers as they are")
ap.add_argument("--save", default=None,
                help="write the outputs at every shape here")
ap.add_argument("--bits", nargs=2, default=None,
                help="two --save files: bit-equal key by key?")
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
    for k in ("ell_spmv_kernel", "ell_outer_kernel", "ell_jacobi_bwd_kernel"):
        if k in name:
            return k + (name[name.index("<"):name.index(">") + 1]
                        if "<" in name else "")
    return name[:40]


def report(kind, label, call, plain, names, saved):
    """Check call() against plain() and itself, time it, save its output."""
    got, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    same = torch.equal(got, again)
    err, scale = float((got - ref).abs().max()), float(ref.abs().max())
    if not (same and err <= 1e-5 * scale):
        FAILURES.append(f"{kind} {label}: same bits {same}, max|d| "
                        f"{err:.3e} of {scale:.3e}")
    us, parts = kernel_us(call, names)
    ms = cs.cuda_ms(call, 50)
    print(f"{kind:8s} {TREE:16s} {label:28s} "
          f"device {us} us ({parts})  events {ms:.4f} ms  max|d| {err:.2e} "
          f"(max|ref| {scale:.2e}) same bits {same}", flush=True)
    saved[f"{kind} {label}"] = digest(got)


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


def _writes_whole_row():
    """Whether the tree's Jacobi adjoint writes the off-diagonal slots of
    the values' gradient itself (in ell_jacobi_bwd's launch), as its plain
    version shows on a one-row CPU system."""
    values = torch.eye(3).expand(1, 2, 3, 3).contiguous()
    nbr = torch.zeros((1, 2), dtype=torch.int32)
    one = torch.ones((1, 3))
    gv = torch.zeros_like(values)
    ek.jacobi_bwd_plain(values, nbr, torch.ones((1, 2)),
                        torch.zeros(1, dtype=torch.int32), one, one, one,
                        None, gv)
    return bool(gv[0, 1].abs().sum() > 0)


ONE_LAUNCH = _writes_whole_row()


def adjoint(values, op, b, xt, g):
    """(lam, gb, gv) of one Jacobi iteration's adjoint with the values'
    gradient, as the tree's EllJacobiFn runs it (xt None: the zero start)."""
    gb, gv = torch.zeros_like(g), torch.zeros_like(values)
    args = (values, op.nbr, op.mask, op.diag_slot, b)
    if ONE_LAUNCH:
        lam = ek.jacobi_bwd(*args, xt, g, gb, gv)
    else:
        x = torch.zeros_like(b) if xt is None else xt
        lam = ek.jacobi_bwd(*args, x, g, gb, gv)
        ek.outer(lam, op.nbr, op.mask, x, skip=op.diag_slot, alpha=-1.0,
                 out=gv)
    return torch.cat([lam.reshape(-1), gb.reshape(-1), gv.reshape(-1)])


def adjoint_plain(values, op, b, xt, g):
    gb, gv = torch.zeros_like(g), torch.zeros_like(values)
    x = torch.zeros_like(b) if xt is None else xt
    lam = ek.jacobi_bwd_plain(values, op.nbr, op.mask, op.diag_slot, b, x, g,
                              gb, gv)
    ek.outer_plain(lam, op.nbr, op.mask, x, skip=op.diag_slot, alpha=-1.0,
                   out=gv)
    return torch.cat([lam.reshape(-1), gb.reshape(-1), gv.reshape(-1)])


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
    dev = require_cuda()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    _cuda.load()
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print("ptxas", line.strip(), flush=True)
    print(f"{TREE}: one-launch adjoint {ONE_LAUNCH}", flush=True)
    saved = {}
    systems, scenes, sc21, chain21 = spmv_systems(dev)
    names = ("ell_spmv",)
    for label, full, nbr, mask, v, r0, r1 in systems:
        k = full.shape[1]

        def call():
            return ek.spmv_rows(full, nbr, mask, v, r0, r1)
        report("spmv", f"{label} N {r1 - r0} K {k}", call,
               lambda: ek.spmv_rows_plain(full, nbr, mask, v, r0, r1), names,
               saved)
    # the Jacobi adjoint at exp2's coarse matrix, and ell_outer alone
    bwd_names = ("ell_jacobi_bwd", "ell_outer")
    op21 = sc21.make_op(1)
    rng = np.random.default_rng(24)
    n = chain21[1].shape[0]
    g, b, xt = (torch.from_numpy(rng.standard_normal((n, 3)).astype(
        np.float32)).to(dev) for _ in range(3))
    for form, x in (("zero start", None), ("from x_t", xt)):
        label = f"21k level 1 {form}"

        def call(x=x):
            return adjoint(chain21[1], op21, b, x, g)

        def plain(x=x):
            return adjoint_plain(chain21[1], op21, b, x, g)
        report("adjoint", label, call, plain, bwd_names, saved)
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
    if ARGS.save:
        torch.save(saved, ARGS.save)
    print(card)
    for f in FAILURES:
        print("FAILED", f)
    return 1 if FAILURES else 0


if __name__ == "__main__":
    sys.exit(main())
