#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  requires CUDA, prints the card (nvidia-smi name and power limit)
         and the torch/CUDA versions, and builds the kernel library from
         csrc/ (one nvcc per source, started together, then one link).
Phase 1  runs every lattice kernel against its plain torch version on the
         same CUDA tensors (2k, 19k and 74k-vertex beams, seeded random
         displacement, mu=250, la=37) with stated tolerances, and times both.
Phase 2  the lattice main path: LatticeScene(mesh.beam(...), device="cuda")
         stepped 48 frames to ||f||_inf <= 1e-4 under the excited protocol
         (gravity scaled by cos(2 pi t / 16), dt 0.033, max_newton 20, cg
         60 / 1e-2) on the 8x8x24, 16x16x64 and 16x16x256 beams, then a
         violent kick on the 8x8x24 beam that takes the Armijo rescue.
Phase 3  reruns the first 8 frames of the 16x16x64 beam on the CPU with the
         plain versions and compares Newton counts and the final state.
Phase 4  the block-ELL SpMV against its plain version on the fine-level
         Hessian of the unstructured Scene of each beam (full range and every
         color range), and the fused PCG solve against its plain version on
         the lattice Newton inputs of phase 1; then the fused_pcg entry path
         (one solve per beam at two tolerances) with its launches counted.
Phase 5  the unstructured main path: QuasiStaticSim Newton-MG and FAS v3 on
         the three beams and DynamicSim.frame_to_tol for 16 frames on the
         8x8x24 beam, with every ell.spmv / spmv_rows call and every SpMV
         kernel launch counted.
Phase 6  reruns the first 5 Newton-MG steps of the 16x16x64 beam on the CPU
         with the plain versions and compares the ||f||_inf series and x.

Launch counters are zeroed just before each main path and read just after.
Every failure raises and exits non-zero. The last two lines are the kernel
table as JSON and the result line {"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch import require_cuda
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.ops import _cuda, ell
from fem_simulation_tpu_torch.ops import ell_kernels as ek
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import lattice as tlat
from fem_simulation_tpu_torch.sim import quasistatic as qs
from fem_simulation_tpu_torch.sim.dynamic import DynamicSim
from fem_simulation_tpu_torch.sim.scene import Scene

MU, LA = 250.0, 37.0
TOL = 1e-4
FRAMES = 48
BEAMS = {"2k": (8, 8, 24), "19k": (16, 16, 64), "74k": (16, 16, 256)}
DX = 0.05
LATTICE_SOURCE = "fem_simulation_tpu_torch/csrc/lattice_kernels.cu"
ELL_SOURCE = "fem_simulation_tpu_torch/csrc/ell_kernels.cu"
TPU_KERNELS = {   # the pallas_call each kernel replaces
    "fused_newton": "fem_simulation_tpu/ops/pallas_lattice.py:638",
    "force": "fem_simulation_tpu/ops/pallas_lattice.py:306",
    "hvp": "fem_simulation_tpu/ops/pallas_lattice.py:306",
    "diag": "fem_simulation_tpu/ops/pallas_lattice.py:251",
    "energy": "fem_simulation_tpu/ops/pallas_lattice.py:200",
    "fused_pcg": "fem_simulation_tpu/ops/pallas_lattice.py:608",
    "spmv": "fem_simulation_tpu/ops/pallas_kernels.py:68",
}
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores. Every kernel here computes in float32.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# f32 FLOPs of the energy chain per cell (8 quad points: deformation 147,
# Green strain 56, ||E||^2 and the sum 22)
ENERGY_FLOPS_PER_CELL = 225 * 8


def log(*args):
    print(*args, flush=True)


def gravity_scale(frame: int) -> float:
    return float(np.cos(np.float32(2.0 * np.pi) * np.float32(frame)
                        / np.float32(16.0)))


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() in ms over reps calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def bound(n_bytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the HBM rate and
    float32 FLOPs over the card's float32 rate."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_err(a, b):
    return float((a - b).abs().max())


# -- phase 1 -----------------------------------------------------------------

def newton_inputs(sc, rng):
    """Inputs of one fused Newton call as step_to_tol builds them, with a
    drag constraint over the top three y layers of the first third of the
    beam: it overlaps the pinned slab (rc sums pin and drag, ctrl takes
    their max)."""
    mat = sc.material
    inv_dt = 1.0 / 0.033
    vm3 = sc.vert_mask[..., None]
    dev = sc.device

    def noise(scale):
        a = rng.standard_normal(sc.x0.shape).astype(np.float32)
        return torch.from_numpy(scale * a).to(dev)

    x = sc.x0 + noise(0.01) * vm3
    x_tilde = sc.x0 + noise(0.005) * vm3
    drag = torch.zeros_like(sc.pin_mask)
    Y, Z = sc.shape[1], sc.shape[2]
    drag[:, Y - 3:, : Z // 3] = 1.0
    drag_pos = sc.x0 + noise(0.02)
    check(bool(((drag * sc.pin_mask).sum() > 0)
               & ((drag * (1 - sc.pin_mask)).sum() > 0)),
          "drag must overlap the pins and reach past them")
    ctrl = (mat.control_mag * torch.maximum(sc.pin_mask, drag)
            + sc.mass * inv_dt * inv_dt + (1.0 - sc.vert_mask))
    rc = mat.control_mag * (sc.pin_mask + drag) + sc.mass * inv_dt * inv_dt
    s_aff = (mat.control_mag * (sc.pin_mask[..., None] * sc.pin_pos
                                + drag[..., None] * drag_pos)
             + (sc.mass * inv_dt * inv_dt)[..., None] * x_tilde)
    s_aff[..., 1] += sc.mass * mat.gravity
    s_cf = (s_aff - rc[..., None] * sc.x0).permute(3, 0, 1, 2).contiguous()
    u_cf = (x - sc.x0).permute(3, 0, 1, 2).contiguous()
    return (u_cf, s_cf, sc.cell_mask, ctrl, rc, sc.vert_mask, DX, MU, LA, 60,
            1e-2)


def lattice_bounds(sc, k_newton):
    """Per-kernel (bound_ms, bound_by) on this lattice: every input read and
    every output written once, FLOPs of the active cells; fused_newton's
    PCG runs k_newton - 1 HVPs."""
    n = sc.vert_mask.numel()
    c = sc.cell_mask.numel()
    active = float(sc.cell_mask.sum())
    field = 3 * n * 4
    return {
        "force": bound(2 * field + 4 * c, active * lk.FORCE_FLOPS_PER_CELL),
        "hvp": bound(3 * field + 4 * c, active * lk.HVP_FLOPS_PER_CELL),
        "diag": bound(field + 9 * n * 4 + 4 * c,
                      active * lk.DIAG_FLOPS_PER_CELL),
        "energy": bound(field + 4 * c + 4, active * ENERGY_FLOPS_PER_CELL),
        # u, s, ctrl, rc, vm, cm in; dx, f, fn, k out
        "fused_newton": bound(4 * field + 3 * n * 4 + 4 * c + 8, active * (
            2 * lk.FORCE_FLOPS_PER_CELL + lk.DIAG_FLOPS_PER_CELL
            + (k_newton - 1) * lk.HVP_FLOPS_PER_CELL)),
    }


def phase1(scenes, reps):
    """Kernel vs plain on the same CUDA tensors; returns per-kernel rows
    {name: {"max_abs_err", "by_beam": {label: {ms, plain_ms, bound_ms,
    bound_by}}}} and the Newton inputs of each beam."""
    names = ("force", "hvp", "diag", "energy", "fused_newton")
    rows = {name: {"max_abs_err": 0.0, "by_beam": {}} for name in names}
    inputs = {}
    for label, sc in scenes.items():
        rng = np.random.default_rng(1)
        vm3 = sc.vert_mask[..., None]
        u = torch.from_numpy(
            0.03 * rng.standard_normal(sc.x0.shape).astype(np.float32)
        ).to(sc.device) * vm3
        p = torch.from_numpy(
            rng.standard_normal(sc.x0.shape).astype(np.float32)).to(sc.device)
        u_cf = u.permute(3, 0, 1, 2).contiguous()
        p_cf = p.permute(3, 0, 1, 2).contiguous()
        cm = sc.cell_mask
        cases = {
            "force": (lambda: lk.force_cf(u_cf, cm, DX, MU, LA),
                      lambda: lk.force_cf_plain(u_cf, cm, DX, MU, LA)),
            "hvp": (lambda: lk.hvp_cf(u_cf, p_cf, cm, DX, MU, LA),
                    lambda: lk.hvp_cf_plain(u_cf, p_cf, cm, DX, MU, LA)),
            "diag": (lambda: lk.hess_diag_lattice(u, cm, DX, MU, LA),
                     lambda: lk.hess_diag_lattice_plain(u, cm, DX, MU, LA)),
            "energy": (lambda: lk.elastic_energy_lattice(u, cm, DX, MU, LA),
                       lambda: lk.elastic_energy_lattice_plain(u, cm, DX, MU,
                                                               LA)),
        }
        for name, (kern, plain) in cases.items():
            got, ref = kern(), plain()
            torch.cuda.synchronize()
            err = max_err(got, ref)
            scale = float(ref.abs().max())
            # fields: max|d| <= 1e-4 max|ref|, energy: relative 1e-4; the
            # kernel sums over q per cell, then over cells (or per-block
            # partials), in another order than torch
            check(err <= 1e-4 * scale, f"{name} {label}: max|d| {err:.3e}"
                  f" > 1e-4 * {scale:.3e}")
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            log(f"phase1 {name:12s} {label:4s} max|d| {err:.3e} "
                f"(max|ref| {scale:.3e})")
        # fused Newton iteration with drag over the pins
        args = newton_inputs(sc, rng)
        inputs[label] = args
        dxk, fk, fnk, kk = lk.fused_newton(*args)
        dxp, fp, fnp, kp = lk.fused_newton_plain(*args)
        torch.cuda.synchronize()
        kk, kp = int(kk), int(kp)
        fscale = float(fp.abs().max())
        dscale = float(dxp.abs().max())
        e_f, e_dx = max_err(fk, fp), max_err(dxk, dxp)
        e_fn = abs(float(fnk) - float(fnp))
        log(f"phase1 fused_newton {label:4s} k {kk} vs {kp}  max|d f| "
            f"{e_f:.3e} (max|f| {fscale:.3e})  max|d dx| {e_dx:.3e} "
            f"(max|dx| {dscale:.3e})  fn {float(fnk):.6e} vs {float(fnp):.6e}")
        # |dk| <= 1: the PCG dots are summed in another order, which can move
        # the stopping test by one iteration
        check(abs(kk - kp) <= 1, f"fused_newton {label}: k {kk} vs {kp}")
        check(kk > 2, f"fused_newton {label}: PCG ran only {kk - 1} matvecs")
        # f is the force chain plus the affine part: as the force
        check(e_f <= 1e-4 * fscale, f"fused_newton {label}: f max|d| {e_f:.3e}")
        # dx: f32 roundoff grows through the PCG recurrences (1e-3 of max|dx|
        # at equal k); one CG step more or less changes dx by up to 5e-2
        dtol = 1e-3 if kk == kp else 5e-2
        check(e_dx <= dtol * dscale,
              f"fused_newton {label}: dx max|d| {e_dx:.3e} > {dtol} * {dscale:.3e}")
        # fn: the trial residual inherits dx's difference through H
        ftol = 1e-3 if kk == kp else 5e-2
        check(e_fn <= ftol * fscale, f"fused_newton {label}: fn |d| {e_fn:.3e}")
        rows["fused_newton"]["max_abs_err"] = max(
            rows["fused_newton"]["max_abs_err"], e_dx)
        cases["fused_newton"] = (lambda: lk.fused_newton(*args),
                                 lambda: lk.fused_newton_plain(*args))
        bounds = lattice_bounds(sc, kk)
        for name, (kern, plain) in cases.items():
            n = reps if name != "fused_newton" else max(reps // 4, 3)
            ms = cuda_ms(kern, n)
            plain_ms = cuda_ms(plain, max(n // 2, 3), warmup=1)
            b_ms, b_by = bounds[name]
            rows[name]["by_beam"][label] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)
            log(f"phase1 time {name:12s} {label:4s} kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})")
    return rows, inputs


# -- phase 2 -----------------------------------------------------------------

def kicked(sc, st):
    """A violent rigid-rotation kick about the beam's centre."""
    x = st.x.cpu().numpy()
    r = x - x.reshape(-1, 3).mean(0)
    omega = np.array([18.0, 0.0, 6.0], np.float32)
    v = np.cross(np.broadcast_to(omega, r.shape), r).astype(np.float32)
    return st._replace(v=torch.from_numpy(v).to(sc.device)
                       * sc.vert_mask[..., None])


def run_frames(sc, st, n, **kw):
    ks, fns, cgs = [], [], []
    states = []
    for i in range(n):
        st, k, fn, cg = tlat.step_to_tol(sc, st, tol=TOL, max_newton=20,
                                         cg_iterations=60, cg_tol=1e-2,
                                         gravity_scale=gravity_scale(i),
                                         return_cg=True, **kw)
        ks.append(k)
        fns.append(fn)
        cgs.append(cg)
        states.append(st)
    return states, ks, fns, cgs


def phase2(scenes):
    for sc in scenes.values():       # warm-up before the counters start
        run_frames(sc, sc.init_state(), 2)
    kick_scene = scenes["2k"]
    torch.cuda.synchronize()
    lk.reset_launches()
    results = {}
    newton_total = 0
    frames_total = 0
    for label, sc in scenes.items():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        states, ks, fns, cgs = run_frames(sc, sc.init_state(), FRAMES)
        end.record()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / FRAMES
        ms = start.elapsed_time(end) / FRAMES
        fns = np.array(fns)
        ks = np.array(ks)
        check(bool(np.all(fns <= TOL * 1.01)),
              f"{label}: tolerance missed, max fn {fns.max():.3e}")
        check(ks.mean() >= 1.0, f"{label}: newton_mean {ks.mean():.2f} < 1")
        newton_total += int(ks.sum())
        frames_total += FRAMES
        results[label] = dict(ms_per_frame=ms, wall_ms_per_frame=wall,
                              newton_mean=float(ks.mean()),
                              newton_max=int(ks.max()), cg_total=int(sum(cgs)),
                              fn_max=float(fns.max()), ks=ks.tolist(),
                              state8=states[7])
        log(f"phase2 {label:4s} {sc.shape} ms/frame {ms:.3f} "
            f"(host clock {wall:.3f})  newton_mean {ks.mean():.3f} "
            f"newton_max {ks.max()}  cg_total {sum(cgs)}  "
            f"fn_max {fns.max():.3e}")
    info = {}
    st = kicked(kick_scene, kick_scene.init_state())
    kick_ks = []
    for i in range(6):
        st, k, fn = tlat.step_to_tol(kick_scene, st, tol=TOL, max_newton=25,
                                     info=info)
        check(bool(torch.isfinite(st.x).all() & torch.isfinite(st.v).all()),
              f"kick frame {i} not finite")
        kick_ks.append(k)
    torch.cuda.synchronize()
    counts = dict(lk.launches)
    newton_total += sum(kick_ks)
    frames_total += len(kick_ks)
    log(f"phase2 kick 2k newton {kick_ks} rescues {info.get('rescues', 0)}")
    log(f"phase2 launches {counts}")
    check(info.get("rescues", 0) >= 1, "the kick took no rescue step")
    check(counts["fused_newton"] == newton_total,
          f"fused_newton launches {counts['fused_newton']} != Newton "
          f"iterations {newton_total}")
    check(counts["force"] >= frames_total,
          f"force launches {counts['force']} < frames {frames_total}")
    check(counts["energy"] > 0, "the energy kernel never ran")
    return results, counts, info.get("rescues", 0)


# -- phase 3 -----------------------------------------------------------------

def phase3(gpu):
    """First 8 frames of the 19k beam again on the CPU (plain versions)."""
    sc = tlat.LatticeScene(meshlib.beam(*BEAMS["19k"], dx=DX), device="cpu")
    t0 = time.perf_counter()
    states, ks, fns, _ = run_frames(sc, sc.init_state(), 8)
    secs = time.perf_counter() - t0
    x_cpu = states[-1].x
    x_gpu = gpu["state8"].x.cpu()
    err = float((x_cpu - x_gpu).abs().max())
    log(f"phase3 19k cpu-plain newton {ks} vs gpu {gpu['ks'][:8]}  "
        f"max|dx| {err:.3e}  ({secs:.1f} s on CPU)")
    check(ks == gpu["ks"][:8], "Newton counts differ between CPU and GPU")
    # both frames stop below ||f||_inf 1e-4; at equal Newton counts the
    # states differ by f32 roundoff carried through 8 solves
    check(err <= 1e-4, f"final state max|d| {err:.3e} > 1e-4")
    return err


# -- phase 4 -----------------------------------------------------------------

def bsr_of(values, nbr, mask):
    """The block-ELL matrix as a torch BSR tensor (masked slots dropped), for
    timing one library SpMV call on the same matrix."""
    n, k = mask.shape
    keep = mask.reshape(-1) > 0
    cols = nbr.reshape(-1)[keep].long()
    blocks = values.reshape(n * k, 3, 3)[keep].contiguous()
    crow = torch.zeros(n + 1, dtype=torch.int64, device=values.device)
    crow[1:] = torch.cumsum(mask.sum(dim=1).long(), 0)
    return torch.sparse_bsr_tensor(crow, cols, blocks, size=(3 * n, 3 * n))


def spmv_bound(values, nbr, r0, r1, n):
    """Bytes of values, nbr and mask of rows [r0, r1), of x and of y."""
    k = nbr.shape[1]
    rows = r1 - r0
    return bound(rows * k * (36 + 4 + 4) + 12 * n + 12 * rows,
                 rows * k * 18.0)


def phase4_spmv(uscenes, reps):
    """SpMV kernel vs plain on each beam's fine-level Hessian."""
    row = {"max_abs_err": 0.0, "by_beam": {}}
    for label, sc in uscenes.items():
        rng = np.random.default_rng(4)
        p0 = sc.params["levels"][0]
        op = sc.make_op(0)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(sc.device)
        vals = qs.assemble_fine(sc, sc.params, x)
        full = (vals * op.mask[..., None, None]).contiguous()
        v = torch.from_numpy(rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(sc.device)
        nbr, mask = p0["nbr"], p0["mask"]
        n = full.shape[0]
        ranges = [(0, n)] + [(op.color_offsets[c], op.color_offsets[c + 1])
                             for c in range(op.n_colors)
                             if op.color_offsets[c + 1] > op.color_offsets[c]]
        worst = 0.0
        for r0, r1 in ranges:
            got = ek.spmv_rows(full, nbr, mask, v, r0, r1)
            ref = ek.spmv_rows_plain(full, nbr, mask, v, r0, r1)
            torch.cuda.synchronize()
            err, scale = max_err(got, ref), float(ref.abs().max())
            # the kernel sums the 27 slots' products by a fixed warp
            # butterfly, torch by its own contraction order; fp32 FMA
            # contraction is the other difference
            check(err <= 1e-5 * scale, f"spmv {label} rows [{r0}, {r1}): "
                  f"max|d| {err:.3e} > 1e-5 * {scale:.3e}")
            worst = max(worst, err / scale)
            row["max_abs_err"] = max(row["max_abs_err"], err)
        ms = cuda_ms(lambda: ek.spmv(full, nbr, mask, v), reps)
        plain_ms = cuda_ms(lambda: ek.spmv_plain(full, nbr, mask, v),
                           max(reps // 2, 3), warmup=1)
        lib_ms, lib_note = None, ""
        try:
            A = bsr_of(full, nbr, mask)
            xv = v.reshape(-1)
            yl = A @ xv
            torch.cuda.synchronize()
            lib_err = max_err(yl.reshape(-1, 3), ek.spmv_plain(full, nbr,
                                                               mask, v))
            lib_ms = cuda_ms(lambda: A @ xv, reps)
            lib_note = f"library (BSR @ x) {lib_ms:.4f} ms, max|d| {lib_err:.3e}"
        except (RuntimeError, NotImplementedError) as e:
            lib_note = f"library (BSR @ x) not supported: {str(e)[:120]}"
        b_ms, b_by = spmv_bound(full, nbr, 0, n, n)
        row["by_beam"][label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=lib_ms)
        log(f"phase4 spmv {label:4s} N {n} K {full.shape[1]} colors "
            f"{op.n_colors} max rel |d| {worst:.3e}  kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  "
            f"{lib_note}")
    return row


def phase4_pcg(scenes, inputs, reps):
    """fused_pcg kernel vs plain on the Newton inputs of phase 1, with the
    residual there as the right-hand side; the zero-RHS no-op."""
    row = {"max_abs_err": 0.0, "by_beam": {}}
    rhs = {}
    for label, sc in scenes.items():
        u_cf, s_cf, cm, ctrl, rc, vm = inputs[label][:6]
        _, f_cf, _, _ = lk.fused_newton_plain(*inputs[label])
        rhs[label] = f_cf
        args = (u_cf, f_cf, cm, ctrl, vm, DX, MU, LA, 60, 1e-2)
        dxk, kk = lk.fused_pcg(*args)
        dxp, kp = lk.fused_pcg_plain(*args)
        torch.cuda.synchronize()
        kk, kp = int(kk), int(kp)
        e_dx, dscale = max_err(dxk, dxp), float(dxp.abs().max())
        log(f"phase4 fused_pcg {label:4s} k {kk} vs {kp}  max|d dx| "
            f"{e_dx:.3e} (max|dx| {dscale:.3e})")
        # as fused_newton in phase 1: the dots' summation order can move the
        # stopping test by one iteration; dx 1e-3 at equal k, else 5e-2
        check(abs(kk - kp) <= 1, f"fused_pcg {label}: k {kk} vs {kp}")
        check(kk > 2, f"fused_pcg {label}: PCG ran only {kk - 1} matvecs")
        dtol = 1e-3 if kk == kp else 5e-2
        check(e_dx <= dtol * dscale,
              f"fused_pcg {label}: dx max|d| {e_dx:.3e} > {dtol} * {dscale:.3e}")
        row["max_abs_err"] = max(row["max_abs_err"], e_dx)
        dx0, k0 = lk.fused_pcg(u_cf, torch.zeros_like(f_cf), cm, ctrl, vm,
                               DX, MU, LA, 60, 1e-2)
        torch.cuda.synchronize()
        check(float(dx0.abs().max()) == 0.0 and int(k0) == 1,
              f"fused_pcg {label}: zero RHS gave k {int(k0)}, "
              f"max|dx| {float(dx0.abs().max()):.3e}")
        ms = cuda_ms(lambda: lk.fused_pcg(*args), max(reps // 4, 3))
        plain_ms = cuda_ms(lambda: lk.fused_pcg_plain(*args), 3, warmup=1)
        n, c = vm.numel(), cm.numel()
        active = float(cm.sum())
        b_ms, b_by = bound(3 * 3 * n * 4 + 2 * n * 4 + 4 * c + 4, active * (
            lk.DIAG_FLOPS_PER_CELL + (kk - 1) * lk.HVP_FLOPS_PER_CELL))
        row["by_beam"][label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None, k=kk)
        log(f"phase4 time fused_pcg {label:4s} kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})")
    return row, rhs


def phase4_pcg_path(scenes, inputs, rhs):
    """The fused_pcg entry path: one solve per beam at tol 1e-2 and 1e-5,
    counters zeroed just before and read just after."""
    torch.cuda.synchronize()
    lk.reset_launches()
    for label in scenes:
        u_cf, _, cm, ctrl, _, vm = inputs[label][:6]
        ks = []
        for tol in (1e-2, 1e-5):
            dx, k = lk.fused_pcg(u_cf, rhs[label], cm, ctrl, vm, DX, MU, LA,
                                 200, tol)
            ks.append(int(k))
            check(bool(torch.isfinite(dx).all()), f"fused_pcg {label} dx")
        log(f"phase4 fused_pcg path {label:4s} k at tol 1e-2 / 1e-5: {ks}")
        check(ks[1] > ks[0], f"fused_pcg {label}: tighter tol ran no more "
              f"iterations ({ks})")
    torch.cuda.synchronize()
    n = lk.launches["fused_pcg"]
    log(f"phase4 fused_pcg path launches {n}")
    check(n == 2 * len(scenes), f"fused_pcg launches {n}")
    return n


# -- phase 5 -----------------------------------------------------------------

def timed_run(run, n):
    """(result, ms per step by CUDA events, host ms per step)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start.record()
    out = run(n)
    end.record()
    torch.cuda.synchronize()
    return (out, start.elapsed_time(end) / n,
            (time.perf_counter() - t0) * 1e3 / n)


def quasi_runs(label, sc, runs):
    """Each (method, steps, tol or None) on a fresh QuasiStaticSim, after a
    one-step warm-up on another; returns {method: summary}."""
    out = {}
    for method, steps, tol in runs:
        warm = qs.QuasiStaticSim(sc)
        getattr(warm, method)(1)
        sim = qs.QuasiStaticSim(sc)
        calls0 = ell.cuda_calls["spmv"]
        torch.cuda.reset_peak_memory_stats()
        (e, fn), ms, wall = timed_run(getattr(sim, method), steps)
        calls = ell.cuda_calls["spmv"] - calls0
        fn = fn.numpy()
        peak = torch.cuda.max_memory_allocated() / 2**20
        check(bool(np.isfinite(fn).all() & np.isfinite(e.numpy()).all()),
              f"{label} {method}: non-finite series")
        if tol is not None:
            check(fn[-1] < tol, f"{label} {method}({steps}): ||f|| "
                  f"{fn[-1]:.3e} >= {tol}")
        else:
            check(fn[-1] < fn[0], f"{label} {method}({steps}): ||f|| "
                  f"{fn[0]:.3e} -> {fn[-1]:.3e} did not decrease")
        out[method] = dict(fn_first=float(fn[0]), fn_last=float(fn[-1]),
                           ms_per_step=ms, wall_ms_per_step=wall,
                           spmv_calls_per_step=calls / steps,
                           peak_mib=peak)
        log(f"phase5 {label:4s} {method:16s} levels {sc.n_levels} steps "
            f"{steps} ||f|| {fn[0]:.3e} -> {fn[-1]:.3e}  ms/step {ms:.2f} "
            f"(host clock {wall:.2f})  spmv calls/step {calls / steps:.0f}  "
            f"peak {peak:.0f} MiB")
    return out


def phase5(uscenes):
    """The unstructured path: Newton-MG, FAS v3 and the dynamic frames."""
    torch.cuda.synchronize()
    ek.reset_launches()
    ell.cuda_calls["spmv"] = 0
    results = {}
    for label, sc in uscenes.items():
        if label == "2k":
            runs = [("newton_multigrid", 30, TOL), ("fas", 60, TOL)]
        else:
            runs = [("newton_multigrid", 20, None), ("fas", 20, None)]
        results[label] = quasi_runs(label, sc, runs)
    sim = DynamicSim(uscenes["2k"])
    sim.frame_to_tol()                      # warm-up frame
    ks, fns = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(16):
        _, k, fn = sim.frame_to_tol()
        ks.append(k)
        fns.append(fn)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / 16
    wall = (time.perf_counter() - t0) * 1e3 / 16
    log(f"phase5 2k   dynamic frame_to_tol 16 frames newton {ks} "
        f"max ||f|| {max(fns):.3e}  ms/frame {ms:.2f} (host clock {wall:.2f})")
    check(all(f <= TOL for f in fns), f"dynamic frames missed tol: {fns}")
    results["2k"]["dynamic"] = dict(ms_per_frame=ms, wall_ms_per_frame=wall,
                                    newton_mean=float(np.mean(ks)),
                                    fn_max=float(max(fns)))
    torch.cuda.synchronize()
    launches, calls = ek.launches["spmv"], ell.cuda_calls["spmv"]
    log(f"phase5 spmv launches {launches}, ell.spmv + spmv_rows calls on "
        f"CUDA tensors {calls}")
    check(launches == calls > 0,
          f"spmv launches {launches} != CUDA calls {calls}")
    return results, launches


# -- phase 6 -----------------------------------------------------------------

def phase6(uscene_gpu, steps=5):
    """The first Newton-MG steps of the 19k beam on the GPU and again on the
    CPU with the plain versions."""
    sim = qs.QuasiStaticSim(uscene_gpu)
    _, fn_gpu = sim.newton_multigrid(steps)
    x_gpu = sim.x.cpu()
    cpu = Scene(uscene_gpu.mesh, solver=uscene_gpu.solver, device="cpu")
    t0 = time.perf_counter()
    sim_cpu = qs.QuasiStaticSim(cpu)
    _, fn_cpu = sim_cpu.newton_multigrid(steps)
    secs = time.perf_counter() - t0
    fg, fc = fn_gpu.numpy(), fn_cpu.numpy()
    rel = np.abs(fg - fc) / np.abs(fc)
    err = float((sim_cpu.x - x_gpu).abs().max())
    log(f"phase6 19k newton_multigrid({steps}) ||f|| gpu {fg.tolist()}")
    log(f"phase6 19k newton_multigrid({steps}) ||f|| cpu {fc.tolist()}")
    log(f"phase6 max rel |d ||f||| {rel.max():.3e}  max|d x| {err:.3e}  "
        f"({secs:.1f} s on CPU)")
    # 1e-3 relative: these five steps stay above 4e-3, where the f32 noise
    # of ||f|| (a few 1e-6 absolute) is under 1e-3 of it
    check(bool(np.all(rel <= 1e-3)), f"||f|| series differ: rel {rel}")
    check(err <= 1e-4, f"final x max|d| {err:.3e} > 1e-4")
    return float(rel.max()), err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    dev = require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    card = smi.strip().splitlines()[0]
    log(f"phase0 torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _cuda.load()
    log(f"phase0 kernel build+load {time.perf_counter() - t0:.1f} s (nvcc "
        f"{_cuda.build_seconds:.1f} s, one compile per source in parallel)")
    for line in _cuda.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log("phase0 ptxas", line.strip())

    meshes = {label: meshlib.beam(*b, dx=DX) for label, b in BEAMS.items()}
    scenes = {label: tlat.LatticeScene(m, device=dev)
              for label, m in meshes.items()}
    for label, sc in scenes.items():
        log(f"phase0 scene {label} lattice {sc.shape} vertices "
            f"{int(sc.vert_mask.sum())}")
    rows, inputs = phase1(scenes, reps=20)
    results, counts, rescues = phase2(scenes)
    err3 = phase3(results["19k"])

    t0 = time.perf_counter()
    uscenes = {}
    for label, m in meshes.items():
        solver = SolverConfig(n_levels=2) if label == "2k" else SolverConfig()
        uscenes[label] = Scene(m, solver=solver, device=dev)
        sc = uscenes[label]
        log(f"phase4 scene {label} levels {sc.n_levels} vertices "
            + " / ".join(str(lv.n_verts) for lv in sc.hier.levels)
            + f" K {sc.level(0).K}")
    log(f"phase4 unstructured scenes built in {time.perf_counter() - t0:.1f} s")
    rows["spmv"] = phase4_spmv(uscenes, reps=50)
    rows["fused_pcg"], rhs = phase4_pcg(scenes, inputs, reps=20)
    counts["fused_pcg"] = phase4_pcg_path(scenes, inputs, rhs)
    uresults, counts["spmv"] = phase5(uscenes)
    rel6, err6 = phase6(uscenes["19k"])

    summary = {label: {k: v for k, v in r.items() if k != "state8"}
               for label, r in results.items()}
    log("phase2 summary " + json.dumps(summary))
    log("phase5 summary " + json.dumps(uresults))
    log(f"phase3 max|dx| {err3:.3e}  phase6 max rel |d f| {rel6:.3e} "
        f"max|d x| {err6:.3e}")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    def row(name, launches):
        r = rows[name]
        at = r["by_beam"]["19k"]     # the line's numbers: the 19k beam
        return {"name": name, "route": "cuda",
                "source": ELL_SOURCE if name == "spmv" else LATTICE_SOURCE,
                "replaces": TPU_KERNELS[name], "launches": launches,
                "max_abs_err": r["max_abs_err"], "ms": at["ms"],
                "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
                "bound_by": at["bound_by"], "library_ms": at["library_ms"],
                "by_beam": r["by_beam"]}
    log(card)
    print(json.dumps({
        "kernels": [row(n, counts[n]) for n in ("fused_newton", "force",
                                                "energy", "fused_pcg",
                                                "spmv")],
        # built and checked above; the main path runs their chains inside
        # fused_newton and does not launch these two entry points
        "not_on_main_path": [row(n, counts[n]) for n in ("hvp", "diag")],
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
