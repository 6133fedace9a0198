#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phase 0  requires CUDA, prints the card (nvidia-smi name and power limit)
         and the torch/CUDA versions, and builds the kernel library from
         csrc/ (one nvcc per source, started together, then one link).
Phase 1  runs every lattice kernel against its plain torch version on the
         same CUDA tensors (2k, 19k and 74k-vertex beams, seeded random
         displacement, mu=250, la=37) with stated tolerances, and times both;
         force and energy must launch one device op a call (torch.profiler)
         and repeat their bits; prints the force tiling of each beam and
         the device us of force, energy and fused_newton. lat_diag and
         lat_diag_shift run under their plans and under each form forced
         (halo tiles, two passes), each checked and timed (diag_forms).
Phase 2  the lattice main path: LatticeScene(mesh.beam(...), device="cuda")
         stepped 48 frames to ||f||_inf <= 1e-4 under the excited protocol
         (gravity scaled by cos(2 pi t / 16), dt 0.033, max_newton 20, cg
         60 / 1e-2) on the 8x8x24, 16x16x64 and 16x16x256 beams, then a
         violent kick on the 8x8x24 beam that takes the Armijo rescue.
Phase 3  reruns the first 8 frames of the 16x16x64 beam on the CPU with the
         plain versions and compares Newton counts and the final state.
Phase 4  the block-ELL SpMV against its plain version on the fine-level
         Hessian of the unstructured Scene of each beam (full range and every
         color range); the fused Gauss-Seidel and Jacobi kernels against
         their plain versions on every multigrid level of each scene (1 and
         3 iterations, with and without x0, two runs bit-identical), ell_gs
         under its plan and in every form the plan can pick (coop, cluster,
         resident, stream; each forced through the plan cache, bit-equal to
         each other), each form's device us in the V-cycle's call and the
         harness's; ell_jacobi in the paths' call (1 iteration) in both its
         forms, from zero (which gathers nothing) and from x0, each against
         both plain versions, with NaNs at a live and at a padded slot
         propagated as theirs, timed beside its bound and (from zero) the
         library's gather and batched solve; the fused PCG solve
         against its plain version on the lattice Newton inputs of phase 1;
         then the fused_pcg entry path (one solve per beam at two
         tolerances) with its launches counted.
Phase 5  the unstructured main path: QuasiStaticSim Newton-MG and FAS v3 on
         the three beams and DynamicSim.frame_to_tol for 16 frames on the
         8x8x24 beam, with every SpMV and smoother call on CUDA tensors and
         every kernel launch counted, per Newton-MG step too.
Phase 6  reruns the first 5 Newton-MG steps of the 16x16x64 beam on the CPU
         with the plain versions and compares the ||f||_inf series and x.
Phase 7  lattice quasi-static solvers and multigrid: on every level of the
         3-level hierarchies of the three beams (dx doubling per level)
         lat_hvp (under its plan and in PR 1's two passes, and as the level
         matvec with the shift and mask in its vertex pass), the multigrid's
         power iteration lat_power, lat_diag and the multigrid's fused
         diagonal lat_diag_shift (under their plans and each form forced:
         halo tiles, two passes), and its Chebyshev smoother lat_cheby
         (pre-smooth with residual, post-smooth, coarse sweeps) against their
         plain versions (the projected diagonal outside the blocks where a
         Jacobi rotation of either chain meets an exact tie, which are
         counted and logged; at rest, against ell.spd_project of the
         kernel's own shifted blocks; two runs bit-identical), timed;
         lat_cheby's calls and lat_power also in every form their plan
         weighs at that shape (cluster, halo tiles, exchange tiles), the
         forms bit-equal, one device op a call;
         then the path, counters zeroed before it:
         the verify recipe on the 8x8x24 beam (quasistatic_to_tol with 2
         load steps; LatticeMG(n_levels=2, dt=None, coarse_cg=8) with
         quasistatic_to_tol_mg), full-size quasi-static solves from rest
         (top slab pinned, max_newton 100: quasistatic_to_tol at 19k and,
         with 2 load steps, 74k; quasistatic_to_tol_mg with 3 levels at 19k
         and 74k, one lat_power a level and one lat_hvp an outer PCG matvec),
         each timed after a warm-up solve; step_to_tol_mg for 16
         excited frames on the 2k and 19k beams; frame_adaptive and
         frame_adaptive_mg on the violent kick of the 3x3x12 beam; FMG with
         the "jacobi" corrector on the 4x4x32 cantilever; the path's Newton,
         PCG and V-cycle counts, substeps and FMG's Newton held equal to
         those of lat_cheby's and lat_power's first forms
         (PHASE7_FIRST_FORMS). Then the first 3 Newton iterations of
         quasistatic_to_tol_mg at 19k again on the CPU.
Phase 8  the rest of exp1: the SpMV against its plain version on the cloth
         Hessians (K = 7, 8 lanes a row, L on each line) of the 64x64 and
         128x128 grids (pins [0, res]),
         bit-repeat, timed beside its bound and BSR @ x; then, counters
         zeroed: ClothSim.frame (the reference 5-CG frame) for 48 frames at
         64x64, cloth.step_to_tol (tol 2.5e-4, max_newton 20) for 48 frames
         at both grids with every frame at tol, two runs of 8 frames
         bit-identical and the same 8 frames on the CPU (equal Newton, x
         within 1e-4); a Picker drag on the 64x64 cloth; the harness on the
         8x8x24 beam (drag_study: the V-cycle beats GS and CG at iterations
         1-3; compare and compare_fas); dynamic.frame_adaptive on the
         violent kick of the 3x3x12 beam (matrix-free, max_newton 10, and
         multigrid, max_newton 20) with n_sub equal to the CPU's; a
         HeadlessWindow loop of 8 DynamicSim frames.
Phase 9  the learning slice. The backward kernels (ell_spmv_t, ell_outer,
         ell_jacobi_bwd, which writes the whole values' gradient row in
         its launch, from x_t and from the zero start, the off-diagonal
         slots bit-equal to ell_outer's) against their plain versions,
         and the autograd Functions against torch.autograd through
         spmv_plain / jacobi_plain (Jacobi at 1 and 3 iterations, with and
         without x0), on the same CUDA tensors at the fine Hessian of the
         19k and 21k Scenes, the 21k Scene's exp2 coarse matrix and every
         level of the 2k one; two runs bit-identical; timed beside their
         bounds (ell_jacobi_bwd in each form: no values' gradient, from
         x_t, from the zero start). ell_spmv_t also at the cloth's frame
         Hessians (K 7, phase 8's inputs) and the 74k Scene's fine
         Hessian, each shape in both its calls (A^T g; -A^T g with the
         diagonal slot left out, as the Jacobi adjoint calls it) in the
         form and lanes its plan picks (held to the plan's mirror), each
         call's device us and share of the bound beside BSR(A^T) @ g's
         events ms and device us; and
         ell_jacobi's forms as in phase 4 at the exp2 coarse matrix. Then,
         counters zeroed (each exp2 run: jacobi_bwd = unroll launches a
         step and no ell_outer):
         exp2 (InterpTrainer on the 16x16x72 beam, 21,097 vertices: modes P
         and p_hat, l2, unroll 4, 10 SGD and 10 Adam steps each, compare(8);
         10 steps with two coarse Jacobi iterations) and exp3 on the same
         beam (generate_rollout 4 frames; 20 Adam steps of MDN3 with mse and
         with the residual loss, 5 of MultiLevel3; evaluate_residual,
         learned_step, warmstart_stats(4); train_energy_gcn 10 steps on the
         2k beam); then the first 2 exp2 steps again on the CPU.

Phase 10 distribution, on 4 z-slabs sharing the card (a DeviceGrid of 4
         entries). lat_force, lat_hvp and lat_diag on the slabs of the
         16x16x256 beam (74,273 vertices, n_own 65, 17x17x67-vertex slabs),
         exchanged and folded, against the same kernels on the whole
         lattice (max|d| <= 1e-5 max|ref|), one slab's bits against the
         whole lattice's, each kernel's time at the slab shape, the exchange
         of one matvec (4 planes a slab). Then, counters zeroed: the halo
         lattice step (make_dist_step's defaults: constant gravity, dt
         0.033, tol 1e-4, max_newton 20, PCG 60 / 1e-2) for 16 frames from
         rest at 74k against the same code on one slab; the distributed
         multigrid on the 16x16x64 beam (3 levels, z_multiple 4: a
         quasi-static solve from rest, max_newton 100, with every level
         sharded and again with the coarsest replicated, and 16 frames of
         make_dist_mg_step) against LatticeMG with the same z_multiple on
         the whole lattice, and a quasi-static solve of the 16x16x256 beam
         (every level sharded) against the same and phase 7's Newton count;
         each hierarchy's slab layout (every sharded level's fields slab
         fields on their devices) and whole-field crossings, a solve's and
         a V-cycle's (1 split + 1 join, plus 1 gather + 1 scatter at a
         sharded -> replicated boundary, at three nu / coarse_sweeps),
         device ops a V-cycle, one slab a device group bit-equal to one
         group of 4, and each solve and the frames timed again warm; the
         unstructured halo SpMV, CG and Newton step
         (8 frames) on the 16x16x64 Scene against the whole mesh; the dp
         batch of 8 scenes of the 8x8x24 beam (identical entries equal to
         one dynamic.step) and the batched_scenes driver (10 frames);
         entry.dryrun_multichip(4); and the Newton state placed in the
         fine level's slabs (DistLatticeMG.place, the reference's
         _state_sharding: the scene's vertex z extent divides the slabs)
         on the 16x16x63 and 16x16x255 beams (18,496 and 73,984
         vertices, z padded 64 -> 80 and 256 -> 272): a quasi-static
         solve from rest on each, one of the 16x16x63 beam from a
         perturbed start (its line search runs lat_energy on the slabs)
         and 16 frames of make_dist_mg_step, the residual, energy, outer
         PCG and V-cycles all on slab fields (no split, no join). While
         they run, the arguments of every
         kernel wrapper they call are copied once for each shape (every
         sharded level's slabs, the replicated coarsest level, the dry
         run's thin slabs, the halo rows of ell_spmv); after the counters
         are read, each kernel is held against its plain version on those
         copies, each float input followed by NaNs so that a read past its
         end shows (max|d| <= 1e-5 max|ref|; lat_cheby, lat_power and the
         energy 1e-4), and at each shape of lat_diag or lat_diag_shift both
         run under their plans and each form forced (diag_forms). The
         references hold each frame from the distributed run's own input
         (equal Newton, ||f|| within 1e-3 relative + 5e-6, x within 1e-4),
         and each path's trajectory from rest against the
         reference's own: x within 1e-4 at every frame, and every frame
         whose Newton count or ||f|| differs taken apart (the reference's
         code on the distributed run's input gives the distributed run's
         norms: one ulp of x can move ||f|| by as much as tol). The
         placed runs against the same code on the whole state from the
         same input and along the trajectory, a V-cycle's and an outer
         matvec's crossings (split 0, join 0 placed; 1 and 1 whole),
         device ops and ms a V-cycle, a warm solve and a frame placed and
         whole, lat_force and lat_energy at the placed slab shapes timed
         beside their plain versions, and the host seconds of
         build_hierarchy at 74k with the native topology builder and
         with numpy (bit-equal).

Phase 11 the low-fill path (ops/boxes.py) on the JAX tests' demo-scale shell,
         mesh.shell(64, 64, 64, thickness=2) at dx 0.05 (65^3 vertices,
         46,144 real cells of 262,144): LatticeScene engages the cover at
         the default box_threshold. lat_force (two passes over the real
         cells and one launch on the active tiles), lat_energy and
         lat_fused_newton in cover mode against their plain cover versions
         and against the dense kernels (the force equal up to the sign of
         zero), bits repeated, timed beside the dense kernels and the bounds
         on the real cells. Then, counters zeroed: 48 frames of phase 2's
         protocol and a quasi-static solve from rest (max_newton 100) on the
         covered scene, then the same on the dense scene (use_boxes=False).
         The covered run launches only the cover modes; it is held to the
         dense one frame by frame from one input (equal Newton, ||f||_inf
         within 1e-3 relative + 5e-6) and along the trajectory (x within
         1e-4; every frame at ||f||_inf <= 1.01e-4).

Launch counters are zeroed just before each main path and read just after
(ell_gs's and ell_jacobi's also by rows and form).
Every failure raises and exits non-zero. The last two lines are the kernel
table as JSON and the result line {"ok": true, "device": {...}}.
"""
import ctypes
import json
import os
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch import require_cuda
from fem_simulation_tpu_torch.config import (ClothConfig, SolverConfig,
                                             TrainInterpConfig,
                                             TrainSolverConfig)
from fem_simulation_tpu_torch.harness import compare as harness
from fem_simulation_tpu_torch.ops import _cuda, ell
from fem_simulation_tpu_torch.ops import transfer as tops
from fem_simulation_tpu_torch.ops import ell_kernels as ek
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import lattice as tlat
from fem_simulation_tpu_torch.sim import lattice_mg as tmg
from fem_simulation_tpu_torch.sim import quasistatic as qs
from fem_simulation_tpu_torch.render import HeadlessWindow
from fem_simulation_tpu_torch.models import train_interp as ti
from fem_simulation_tpu_torch.models import train_solver as tsolve
from fem_simulation_tpu_torch.sim import cloth, dynamic
from fem_simulation_tpu_torch.sim.cloth import ClothScene, ClothSim
from fem_simulation_tpu_torch.sim.dynamic import DynamicSim
from fem_simulation_tpu_torch.sim.picking import Picker
from fem_simulation_tpu_torch.sim.scene import Scene
from fem_simulation_tpu_torch.solvers import cg as cgmod
from fem_simulation_tpu_torch.solvers import smoothers
from fem_simulation_tpu_torch import entry
from fem_simulation_tpu_torch.examples import batched_scenes
from fem_simulation_tpu_torch.parallel import dist as pdist
from fem_simulation_tpu_torch.parallel import halo as phalo
from fem_simulation_tpu_torch.parallel import lattice_halo as plh
from fem_simulation_tpu_torch.parallel import lattice_mg_dist as pmgd
from fem_simulation_tpu_torch.parallel import slab_field as pslab

MU, LA = 250.0, 37.0
TOL = 1e-4
FRAMES = 48
BEAMS = {"2k": (8, 8, 24), "19k": (16, 16, 64), "74k": (16, 16, 256)}
DX = 0.05
CLOTHS = {"64x64": 64, "128x128": 128}
CLOTH_TOL = 2.5e-4            # bench.py's cloth tolerance
LATTICE_SOURCE = "fem_simulation_tpu_torch/csrc/lattice_kernels.cu"
ELL_SOURCE = "fem_simulation_tpu_torch/csrc/ell_kernels.cu"
TPU_KERNELS = {   # the pallas_call each kernel replaces
    "fused_newton": "fem_simulation_tpu/ops/pallas_lattice.py:638",
    "force": "fem_simulation_tpu/ops/pallas_lattice.py:306",
    "hvp": "fem_simulation_tpu/ops/pallas_lattice.py:306",
    "diag": "fem_simulation_tpu/ops/pallas_lattice.py:251",
    # the same diagonal with the multigrid's shift and SPD projection fused
    "diag_shift": "fem_simulation_tpu/ops/pallas_lattice.py:251",
    # the HVP as the multigrid's Chebyshev smoother applies it
    "cheby": "fem_simulation_tpu/ops/pallas_lattice.py:306",
    # the HVP as the JAX LatticeMG._est_lmax applies it
    # (fem_simulation_tpu/sim/lattice_mg.py:469)
    "power": "fem_simulation_tpu/ops/pallas_lattice.py:306",
    "energy": "fem_simulation_tpu/ops/pallas_lattice.py:200",
    "fused_pcg": "fem_simulation_tpu/ops/pallas_lattice.py:608",
    "spmv": "fem_simulation_tpu/ops/pallas_kernels.py:68",
    # the smoothers are fused around the SpMV's row pass
    "gs": "fem_simulation_tpu/ops/pallas_kernels.py:68",
    "jacobi": "fem_simulation_tpu/ops/pallas_kernels.py:68",
    # the backward kernels: no TPU kernel of their own; the JAX package
    # takes these gradients with jax.grad of the same SpMV and smoother
    # (models/train_interp.py:51-79 through ops/ell.py:29)
    "spmv_t": "fem_simulation_tpu/ops/pallas_kernels.py:68",
    "outer": "fem_simulation_tpu/ops/pallas_kernels.py:68",
    "jacobi_bwd": "fem_simulation_tpu/ops/pallas_kernels.py:68",
}
ELL_FORWARD = ("spmv", "gs", "jacobi")
ELL_BACKWARD = ("spmv_t", "outer", "jacobi_bwd")
EXP_BEAM = (16, 16, 72)       # the exp2 / exp3 drivers' beam: 21,097 vertices
# Published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and float32
# FLOP/s outside the tensor cores. Every kernel here computes in float32.
SLABS10 = 4                   # phase 10: z-slabs, all on the one card
FRAMES10 = 16
NEWTON_FRAMES10 = 8
# phase 10's placed state: beams whose vertex z extent divides SLABS10
# (18,496 and 73,984 vertices), and the perturbed start of a 16x16x63
# solve whose line search runs lat_energy on the slabs (seeded noise of
# this fraction of dx at every vertex: a first full step from it grows
# the residual)
PLACED10 = {"16x16x63": (16, 16, 63), "16x16x255": (16, 16, 255)}
PERTURB10 = (0.2,)
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


def device_ops(fn, reps: int):
    """{name: (launches per call, mean device us)} of every device op in a
    torch.profiler trace of reps calls of fn()."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            spans.setdefault(e.name, []).append(e.time_range.end
                                                - e.time_range.start)
    return {name: (len(v) / reps, float(np.mean(v)))
            for name, v in spans.items()}


def host_trace(fn, reps: int):
    """What one call of fn() costs the host and the card, from reps calls
    after a warm one: host ms (wall clock to a synchronize), with Python's
    garbage collector on and off; the collections it ran a call by
    generation, their ms, and the objects it tracks; the caching
    allocator's allocations, cudaMallocs (new segments) and retries a
    call; device busy ms (the kernels' spans summed) and device ops a call
    (torch.profiler); {kernel: device us}, {host op: self ms} (the
    profiler's CPU events) and {Python function: own ms} (cProfile), each
    a call, for largest_differences."""
    import cProfile
    import gc
    import pstats
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    seen = {"n": [0, 0, 0], "ms": 0.0, "t": 0.0}

    def on_gc(phase, info):
        if phase == "start":
            seen["t"] = time.perf_counter()
        else:
            seen["n"][info["generation"]] += 1
            seen["ms"] += (time.perf_counter() - seen["t"]) * 1e3

    def host_ms():
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / reps
    keys = {"allocations": "allocation.all.allocated",
            "cuda_mallocs": "segment.all.allocated",
            "alloc_retries": "num_alloc_retries"}
    m0 = torch.cuda.memory_stats()
    gc.callbacks.append(on_gc)
    try:
        out = {"host_ms": host_ms()}
    finally:
        gc.callbacks.remove(on_gc)
    m1 = torch.cuda.memory_stats()
    out.update(gc_collections=[n / reps for n in seen["n"]],
               gc_ms=seen["ms"] / reps, gc_tracked=len(gc.get_objects()))
    out.update({k: (m1.get(v, 0) - m0.get(v, 0)) / reps
                for k, v in keys.items()})
    out["reserved_mib"] = m1.get("reserved_bytes.all.current", 0) / 2 ** 20
    out["inactive_split_blocks"] = m1.get("inactive_split.all.current", 0)
    gc.disable()
    try:
        out["host_ms_gc_off"] = host_ms()
    finally:
        gc.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    kernels, n = {}, 0
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.name] = kernels.get(ev.name, 0.0) + (
                ev.time_range.end - ev.time_range.start) / reps
            n += 1
    host_ops = {e.key: e.self_cpu_time_total / reps / 1e3
                for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CPU
                and e.self_cpu_time_total > 0}
    out.update(busy_ms=sum(kernels.values()) / 1e3, device_ops=n / reps)
    pr = cProfile.Profile()
    pr.enable()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    pr.disable()
    funcs = {f"{os.path.basename(f)}:{line}({name})": tt / reps * 1e3
             for (f, line, name), (_, _, tt, _, _)
             in pstats.Stats(pr).stats.items()}
    return out, dict(kernels=kernels, host_ops=host_ops, python=funcs)


def largest_differences(a: dict, b: dict, n: int):
    """The n keys whose values differ most between a and b: [key, a - b,
    a, b], largest |a - b| first."""
    keys = sorted(set(a) | set(b), key=lambda k: -abs(a.get(k, 0.0)
                                                       - b.get(k, 0.0)))
    return [[k[:100], a.get(k, 0.0) - b.get(k, 0.0), a.get(k, 0.0),
             b.get(k, 0.0)] for k in keys[:n]]


def whole_trace(fn, reps: int, launches: int):
    """device_ops(fn, reps), traced again (up to twice) while it holds fewer
    than `launches` device ops a call: a short trace can lose its last
    events (PERF.md), and a call launches at least that many."""
    for _ in range(3):
        ops = device_ops(fn, reps)
        if sum(n for n, _ in ops.values()) >= launches:
            break
    return ops


def device_us(fn, reps: int, kernel: str, per_call: int = 1):
    """Device time in us of one call of fn(): the mean span of the launches
    of `kernel` (a substring of its name) in a torch.profiler trace of reps
    calls, times the launches a call makes (a short trace can lose its last
    events, so the spans are averaged, not summed). None when two traces
    in a row hold no such launch."""
    for _ in range(2):              # a trace can come back empty: once more
        means = [us for name, (_, us) in device_ops(fn, reps).items()
                 if kernel in name]
        if means:
            return round(float(np.mean(means)) * per_call, 1)
    return None


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
        "diag": bound(field + 6 * n * 4 + 4 * c,
                      active * lk.DIAG_FLOPS_PER_CELL),
        "energy": bound(field + 4 * c + 4, active * ENERGY_FLOPS_PER_CELL),
        # u, s, ctrl, rc, vm, cm in; dx, f, fn, k out
        "fused_newton": bound(4 * field + 3 * n * 4 + 4 * c + 8, active * (
            2 * lk.FORCE_FLOPS_PER_CELL + lk.DIAG_FLOPS_PER_CELL
            + (k_newton - 1) * lk.HVP_FLOPS_PER_CELL)),
    }


def diag_bounds(cm, vm):
    """(bound_ms, bound_by) of lat_diag (u and the cell mask in, 6 channels
    out) and of lat_diag_shift (u, ctrl, vm and the cell mask in, 6
    channels out; the projection's FLOPs at the real vertices) on a lattice
    of this cell and vertex mask."""
    n, c = vm.numel(), cm.numel()
    active, verts = float(cm.sum()), float(vm.sum())
    field = 3 * n * 4
    return {"diag": bound(field + 4 * c + 6 * n * 4,
                          active * lk.DIAG_FLOPS_PER_CELL),
            "diag_shift": bound(field + 4 * c + 2 * n * 4 + 6 * n * 4,
                                active * lk.DIAG_FLOPS_PER_CELL
                                + verts * lk.SPD_PROJECT_FLOPS)}


def diag_forms(phase, where, u, cm, ctrl, vm, dx, rows, reps=10):
    """lat_diag (hess_diag6_cf) and lat_diag_shift (hess_diag_shift_cf,
    projected) on one lattice under the plan diag_plan gives each and under
    each form forced: the best halo tiling (one launch) and the two passes.
    Each against its plain version (max|d| <= 1e-4 max|ref|; the projected
    blocks outside the blocks where a rotation of either chain meets an
    exact tie, diag_shift_err), two runs bit-identical, one device op a call
    on tiles and two in two passes, the tiles bit-equal to the two passes
    (one order of the same sums); timed: device us (torch.profiler)
    and events ms, beside the plain version and the bound. Returns {kernel:
    the plan's numbers, with "plan" and every form's under "forms"}; the
    rows' max_abs_err updated."""
    shape = tuple(vm.shape)
    dev = u.device
    sms = lk._sms(dev.index)
    args = (cm, dx, MU, LA)
    dargs = (cm, ctrl, vm, dx, MU, LA)
    bounds = diag_bounds(cm, vm)
    out = {}
    for name in ("diag", "diag_shift"):
        shift = name == "diag_shift"
        model = lk.DIAG_SHIFT_MODEL if shift else lk.DIAG_MODEL
        key = (str(dev), *shape, shift)
        own = lk._diag_plan(*shape, dev, shift)
        forms = {"halo tiles": lk.best_force_tiling(*shape, sms, model),
                 "two passes": lk.FORCE_TWO_PASS}
        if shift:
            def call():
                return lk.hess_diag_shift_cf(u, *dargs)

            def plain():
                return lk.hess_diag_shift_cf_plain(u, *dargs)
        else:
            def call():
                return lk.hess_diag6_cf(u, *args)

            def plain():
                return lk.sym_channels(lk.hess_diag_lattice_plain(
                    u.permute(1, 2, 3, 0), *args))
        ref = plain()
        plain_ms = cuda_ms(plain, 3, warmup=1)
        b_ms, b_by = bounds[name]
        res, outs = {}, {}
        for form, plan in forms.items():
            lk._diag_plans[key] = plan
            try:
                got, again = call(), call()
                torch.cuda.synchronize()
                check(bool(torch.equal(got, again)),
                      f"{phase} {name} {where} {form}: two runs differ")
                ties = None
                if shift:
                    err, scale, ties = diag_shift_err(
                        f"{where} {form}", u, dargs, got, ref, phase=phase)
                else:
                    err, scale = max_err(got, ref), float(ref.abs().max())
                check(err <= 1e-4 * scale, f"{phase} {name} {where} {form}:"
                      f" max|d| {err:.3e} > 1e-4 * {scale:.3e}")
                n_ops = 2 if plan == lk.FORCE_TWO_PASS else 1
                ops = whole_trace(call, reps, n_ops)
                n_got = sum(n for n, _ in ops.values())
                check(len(ops) <= n_ops and n_got <= n_ops, f"{phase} {name}"
                      f" {where} {form}: device ops per call {ops}")
                us = (round(sum(max(1, round(n)) * t
                                for n, t in ops.values()), 2)
                      if len(ops) == n_ops else None)
                ms = cuda_ms(call, reps)
            finally:
                lk._diag_plans[key] = own
            outs[form] = got
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            res[form] = dict(tiling=_plan_text(plan, shift), max_abs_err=err,
                             device_us=us, ms=ms, share_of_bound=(
                                 None if us is None else b_ms * 1e3 / us),
                             ties=ties)
            log(f"{phase} {name:10s} {where} {shape} {form:10s} max|d| "
                f"{err:.3e} (max|ref| {scale:.3e}) same bits twice  device "
                f"{'not captured' if us is None else f'{us} us'}  events "
                f"{ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})"
                + ("" if us is None else
                   f", {100 * b_ms * 1e3 / us:.1f}% of it"))
        # the same sums in the same order (each kernel's own point order,
        # the same corner order)
        check(bool(torch.equal(outs["halo tiles"], outs["two passes"])),
              f"{phase} {name} {where}: halo tiles and two passes differ")
        pick = "two passes" if own == lk.FORCE_TWO_PASS else "halo tiles"
        check(own == forms[pick], f"{phase} {name} {where}: plan {own}")
        out[name] = dict(res[pick], plan=pick, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None,
                         forms=res)
        log(f"{phase} {name:10s} {where} {shape} plan {pick} "
            f"({_plan_text(own, shift)}); tiles bit-equal to the two passes")
    return out


def phase1(scenes, reps):
    """Kernel vs plain on the same CUDA tensors; returns per-kernel rows
    {name: {"max_abs_err", "by_beam": {label: {ms, plain_ms, bound_ms,
    bound_by}}}} and the Newton inputs of each beam."""
    names = ("force", "hvp", "diag", "diag_shift", "energy", "fused_newton")
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
        device = {}
        for name, (kern, plain) in cases.items():
            got, ref = kern(), plain()
            again = kern()
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
            if name in ("force", "energy", "hvp"):
                # deterministic; one launch a call (force, hvp: two where
                # their plans take the two passes)
                check(bool(torch.equal(got, again)),
                      f"{name} {label}: two runs differ")
                two = ((lk._force_plan(*sc.shape, sc.device) if name
                        == "force" else lk._hvp_plan(*sc.shape, sc.device)
                        if name == "hvp" else None) == lk.FORCE_TWO_PASS)
                want = 2 if two else 1
                ops = whole_trace(kern, 20, want)
                check(round(sum(n for n, _ in ops.values())) == want,
                      f"{name} {label}: device ops per call {ops}")
                device[name] = round(sum(n * t for n, t in ops.values()), 2)
        plan = lk._force_plan(*sc.shape, sc.device)
        grid, lanes = lk.energy_plan(*sc.shape, lk._sms(0))
        log(f"phase1 force        {label:4s} "
            + ("two passes" if plan == lk.FORCE_TWO_PASS else
               f"one launch, halo tiles {plan[1]}x{plan[2]}x{plan[3]}")
            + f"; energy {grid} blocks, {'8 lanes' if lanes else 'a thread'}"
            f" a cell; same bits twice; device us force {device['force']} "
            f"energy {device['energy']}")
        # fused Newton iteration with drag over the pins
        args = newton_inputs(sc, rng)
        inputs[label] = args
        # lat_diag and lat_diag_shift under their plans and each form, at
        # the Newton iteration's displacement and ctrl
        forms = diag_forms("phase1", label, args[0], cm, args[3],
                           sc.vert_mask, DX, rows)
        for name in ("diag", "diag_shift"):
            rows[name]["by_beam"][label] = forms[name]
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
        plan = lk._newton_plan(_cuda.load(), *sc.shape, sc.device)
        us = device_us(lambda: lk.fused_newton(*args), 10,
                       "fused_newton_kernel<false>")
        device["fused_newton"] = us
        log(f"phase1 fused_newton {label:4s} grid {plan[0]} tiles "
            f"{plan[1]}x{plan[2]}x{plan[3]} "
            f"{'halo' if plan[6] else 'exchange'}  device us {us}")
        for name, (kern, plain) in cases.items():
            if name == "diag":          # timed by diag_forms
                continue
            n = reps if name != "fused_newton" else max(reps // 4, 3)
            ms = cuda_ms(kern, n)
            plain_ms = cuda_ms(plain, max(n // 2, 3), warmup=1)
            b_ms, b_by = bounds[name]
            rows[name]["by_beam"][label] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, device_us=device.get(name))
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


def smoother_bound(n, k, iterations, sweeps, with_x0):
    """The first ell_gs form's traffic, kept for comparison (it is not a
    floor): every row's values, nbr and mask once per sweep, b and x0 in, x
    out; 18 K + 60 FLOPs a row and sweep (the row product and the 3x3
    solve)."""
    return bound(iterations * sweeps * n * k * 44
                 + 12 * n * (3 if with_x0 else 2),
                 iterations * sweeps * n * (18.0 * k + 60.0))


def jacobi_bound(n, k, iterations=1, zero_start=True):
    """What `iterations` ell_jacobi launches must move, launch by launch
    (each reads its input iterate, which the one before wrote): every row's
    values (36 K B: the propagation of non-finite values needs them all),
    diag_slot and b in and x out; from x (every iteration but a zero
    start's first) also nbr and mask and x read once. 18 K + 60 FLOPs a row
    and iteration."""
    gathers = iterations - (1 if zero_start and iterations else 0)
    return bound(iterations * n * (36 * k + 28) + gathers * n * (8 * k + 12),
                 iterations * n * (18.0 * k + 60.0))


def with_nans(op, vals):
    """vals with a NaN at one live off-diagonal slot of one row and at one
    padded slot of another (a padded slot's values are read and multiply a
    masked zero, so the NaN propagates, as in the JAX smoother)."""
    mask, ds = op.mask.cpu().numpy(), op.diag_slot.cpu().numpy()
    slots = np.arange(mask.shape[1])[None, :]
    live = np.argwhere((mask > 0) & (slots != ds[:, None]))
    padded = np.argwhere(mask == 0)
    r1, k1 = live[len(live) // 3]
    r2, k2 = next(p for p in padded if p[0] != r1)
    out = vals.clone()
    out[int(r1), int(k1), 2, 1] = float("nan")
    out[int(r2), int(k2), 1, 1] = float("nan")
    return out


# ell_jacobi's forms of the paths' calls: one iteration from x0 = None (FAS
# v1-v3's and exp2's coarse solve) and from a given x0
JACOBI_CALLS = (("zero start", False), ("from x", True))


def jacobi_forms(phase, label, li, op, vals, b, x0, reps):
    """ell_jacobi's two forms in the paths' call (1 iteration) at one level:
    each against ek.jacobi_plain and smoothers.jacobi_plain (max|d| <= 1e-5
    max|ref|), with NaNs at a live and at a padded slot propagated to the
    plain versions' NaN entries and no others, two runs bit-identical;
    device us a launch, events ms, plain ms, the bound and, for the zero
    start, the library's two calls (the diagonal blocks gathered, then
    torch.linalg.solve_ex: the same x = D^-1 b). Returns ({form: entry},
    the largest max|d| against a plain version)."""
    n, k = vals.shape[:2]
    rows_i = torch.arange(n, device=b.device)
    ds = op.diag_slot.long()
    sms = torch.cuda.get_device_properties(b.device).multi_processor_count
    out, rel, abs_err = {}, {}, 0.0
    for form, from_x in JACOBI_CALLS:
        start = x0 if from_x else None
        worst = 0.0
        for v in (vals, with_nans(op, vals)):
            a = (v, op.nbr, op.mask, op.diag_slot, b)
            got, again = ek.jacobi(*a, start, 1), ek.jacobi(*a, start, 1)
            refs = (ek.jacobi_plain(*a, start, 1),
                    smoothers.jacobi_plain(op, v, b, 1, x0=start))
            torch.cuda.synchronize()
            nan = torch.isnan(refs[0])
            check(bool(nan.any()) == (v is not vals), f"jacobi {form} "
                  f"{label} level {li}: NaN rows {int(nan.any(1).sum())}")
            check(torch.equal(torch.isnan(again), torch.isnan(got))
                  and torch.equal(got[~nan], again[~nan]),
                  f"jacobi {form} {label} level {li}: two runs differ")
            for ref in refs:
                check(torch.equal(torch.isnan(got), torch.isnan(ref)),
                      f"jacobi {form} {label} level {li}: NaN entries "
                      "differ from the plain version's")
                scale = float(ref[~nan].abs().max())
                err = float((got - ref)[~nan].abs().max())
                check(err <= 1e-5 * scale, f"jacobi {form} {label} level "
                      f"{li}: max|d| {err:.3e} > 1e-5 * {scale:.3e}")
                worst = max(worst, err / scale)
                abs_err = max(abs_err, err)
        args = (vals, op.nbr, op.mask, op.diag_slot, b, start, 1)
        us = device_us(lambda: ek.jacobi(*args), 10, "ell_jacobi_kernel")
        ms = cuda_ms(lambda: ek.jacobi(*args), reps)
        plain_ms = cuda_ms(lambda: ek.jacobi_plain(*args), 3, warmup=1)
        b_ms, b_by = jacobi_bound(n, k, 1, not from_x)
        lib_ms = None
        if not from_x:
            def library():
                return torch.linalg.solve_ex(vals[rows_i, ds],
                                             b.unsqueeze(-1))[0]
            ref = ek.jacobi_plain(*args)
            lib_err = max_err(library().squeeze(-1), ref)
            check(lib_err <= 1e-4 * float(ref.abs().max()), f"library "
                  f"solve {label} level {li}: max|d| {lib_err:.3e}")
            lib_ms = cuda_ms(library, reps)
        out[form] = dict(ms=ms, device_us=us, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)
        rel[form] = worst
    log(f"{phase} jacobi {label:4s} level {li} N {n} 1 iteration (the "
        f"paths' call; lanes {ek.jacobi_lanes(n, sms)}): " + "  ".join(
            f"{form} device {e['device_us']} us (bound "
            f"{e['bound_ms'] * 1e3:.2f} us, {e['bound_by']}"
            + (f"; library gather + solve_ex {e['library_ms'] * 1e3:.2f} us"
               if e["library_ms"] is not None else "")
            + f"), events {e['ms']:.4f} ms, plain {e['plain_ms']:.3f} ms, "
            f"max rel |d| {rel[form]:.2e}"
            for form, e in out.items())
        + "; NaN at a live and a padded slot propagated; same bits twice")
    return out, abs_err


# ell_jacobi's launches on the main paths by (rows, form), added up by
# log_jacobi_shapes where phases 5, 8 and 9 read their counters
JACOBI_PATH_SHAPES = {}


def log_jacobi_shapes(phase):
    """Log ell_jacobi's launches by (rows, form) since the counts were
    zeroed (they must add up to launches["jacobi"]) and add them to
    JACOBI_PATH_SHAPES."""
    log(f"{phase} jacobi launches by (rows, form): "
        + ", ".join(f"{n} {form} {c}"
                    for (n, form), c in sorted(ek.jacobi_launches.items())))
    check(sum(ek.jacobi_launches.values()) == ek.launches["jacobi"],
          f"{phase}: jacobi launches by shape {ek.jacobi_launches} do not "
          f"add up to {ek.launches['jacobi']}")
    for key, c in ek.jacobi_launches.items():
        JACOBI_PATH_SHAPES[key] = JACOBI_PATH_SHAPES.get(key, 0) + c


def gs_bound(offs, k, iterations, with_x0):
    """The least the card must do for an ell_gs call: every row's values,
    nbr, mask, diag_slot and b read once, x read (from x0) and written
    once; 18 K + 60 FLOPs a row for each pass that relaxes it (the passes
    of ek.gs_passes)."""
    n = offs[-1]
    rows = sum(offs[c + 1] - offs[c] for c in ek.gs_passes(offs, iterations))
    return bound(n * (44 * k + 16) + 12 * n * (2 if with_x0 else 1),
                 rows * (18.0 * k + 60.0))


def gs_forms(n, k, offs, iterations):
    """{form: blocks}: every ell_gs form the plan weighs at this level, each
    at the blocks its model likes best (ek.gs_candidates)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    best = {}
    for cost, form, blocks in ek.gs_candidates(n, k, offs, sms, iterations):
        if form not in best or cost < best[form][0]:
            best[form] = (cost, blocks)
    return {form: blocks for form, (_, blocks) in sorted(best.items())}


def phase4_smoothers(uscenes, reps):
    """The fused Gauss-Seidel and Jacobi kernels against their plain versions
    on every level of each scene's Galerkin chain; ell_gs under its plan and
    in every form the plan can pick (each forced through ek._gs_plans): two
    runs bit-identical, the forms bit-equal to each other, each timed."""
    rows = {name: {"max_abs_err": 0.0, "by_beam": {}, "by_level": []}
            for name in ("gs", "jacobi")}
    for label, sc in uscenes.items():
        rng = np.random.default_rng(11)
        x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).to(sc.device)
        chain = qs.galerkin_chain(sc, sc.params,
                                  qs.assemble_fine(sc, sc.params, x))
        for li, vals in enumerate(chain):
            op = sc.make_op(li)
            n, k = vals.shape[0], vals.shape[1]
            offs = [int(c) for c in op.color_offsets]
            b = torch.from_numpy(rng.standard_normal((n, 3)).astype(
                np.float32)).to(sc.device)
            x0 = torch.from_numpy(0.1 * rng.standard_normal((n, 3)).astype(
                np.float32)).to(sc.device)
            gs_args = (vals, op.nbr, op.mask, op.diag_slot, op.color_offsets,
                       b)
            worst = 0.0
            forms = {}
            for iters in (1, 3):
                key = (str(b.device), n, k, tuple(offs), iters)
                for start in (None, x0):
                    ref = ek.gs_plain(*gs_args, start, iters)
                    two = smoothers.gauss_seidel_plain(op, vals, b, iters,
                                                       x0=start)
                    scale = float(ref.abs().max())
                    got = ek.gs(*gs_args, start, iters)
                    plan = ek._gs_plans[key]
                    runs = {plan: got}
                    for form, blocks in gs_forms(n, k, offs, iters).items():
                        ek._gs_plans[key] = (form, blocks)
                        runs[(form, blocks)] = ek.gs(*gs_args, start, iters)
                        forms.setdefault(iters, {})[form] = blocks
                    ek._gs_plans[key] = plan
                    for (form, blocks), out in runs.items():
                        name = f"{ek.GS_FORMS[form]} {blocks}"
                        ek._gs_plans[key] = (form, blocks)
                        again = ek.gs(*gs_args, start, iters)
                        torch.cuda.synchronize()
                        check(bool(torch.equal(out, again)), f"gs {label} "
                              f"level {li} {name}: two runs differ")
                        check(bool(torch.equal(out, got)), f"gs {label} "
                              f"level {li} {name}: not bit-equal to the "
                              f"plan's form {ek.GS_FORMS[plan[0]]}")
                        # every form sums a row's 26 off-diagonal products in
                        # relax_row's butterfly order, the plain versions in
                        # torch's contraction order (the two-stage one the
                        # lower and upper parts apart)
                        for what, r in (("one-pass", ref),
                                        ("two-stage", two)):
                            err = max_err(out, r)
                            check(err <= 1e-5 * scale, f"gs {label} level "
                                  f"{li} {name} iters {iters} vs {what}: "
                                  f"max|d| {err:.3e} > 1e-5 * {scale:.3e}")
                            worst = max(worst, err / scale)
                            rows["gs"]["max_abs_err"] = max(
                                rows["gs"]["max_abs_err"], err)
                    ek._gs_plans[key] = plan
            jref = smoothers.jacobi_plain(op, vals, b, 2)
            for start in (None, x0):
                got = ek.jacobi(vals, op.nbr, op.mask, op.diag_slot, b, start,
                                2)
                again = ek.jacobi(vals, op.nbr, op.mask, op.diag_slot, b,
                                  start, 2)
                ref = smoothers.jacobi_plain(op, vals, b, 2, x0=start)
                torch.cuda.synchronize()
                check(bool(torch.equal(got, again)), f"jacobi {label} level "
                      f"{li}: two runs differ")
                err, scale = max_err(got, ref), float(ref.abs().max())
                check(err <= 1e-5 * scale, f"jacobi {label} level {li}: "
                      f"max|d| {err:.3e} > 1e-5 * {scale:.3e}")
                rows["jacobi"]["max_abs_err"] = max(
                    rows["jacobi"]["max_abs_err"], err)
            # the V-cycle's call (3 iterations from zero) and the harness's
            # and FAS's (1 iteration from x0), under the plan and in every
            # form
            calls = {3: None, 1: x0}
            plans = {it: ek._gs_plans[(str(b.device), n, k, tuple(offs), it)]
                     for it in calls}
            times = {}
            for iters, start in calls.items():
                key = (str(b.device), n, k, tuple(offs), iters)
                for form, blocks in forms[iters].items():
                    ek._gs_plans[key] = (form, blocks)
                    times[(iters, form)] = device_us(
                        lambda: ek.gs(*gs_args, start, iters), 10, "ell_gs_")
                ek._gs_plans[key] = plans[iters]
            ms = cuda_ms(lambda: ek.gs(*gs_args, None, 3), reps)
            plain_ms = cuda_ms(
                lambda: smoothers.gauss_seidel_plain(op, vals, b, 3), 3,
                warmup=1)
            b_ms, b_by = gs_bound(offs, k, 3, False)
            b1_ms = gs_bound(offs, k, 1, True)[0]
            old_ms = smoother_bound(n, k, 3, 2, False)[0]
            us3 = times[(3, plans[3][0])]
            us1 = times[(1, plans[1][0])]
            log(f"phase4 gs {label:4s} level {li} N {n} K {k} max rel |d| "
                f"{worst:.3e}  plan: 3 iterations from zero "
                f"{ek.GS_FORMS[plans[3][0]]} {plans[3][1]} device {us3} us "
                f"(bound {b_ms * 1e3:.2f} us, {b_by}; the first form's "
                f"traffic {old_ms * 1e3:.2f} us), events {ms:.4f} ms; 1 "
                f"iteration from x0 {ek.GS_FORMS[plans[1][0]]} "
                f"{plans[1][1]} device {us1} us (bound {b1_ms * 1e3:.2f} "
                f"us); plain {plain_ms:.3f} ms")
            log(f"phase4 gs {label:4s} level {li} forms (device us, 3 it "
                f"from 0 / 1 it from x0; all bit-equal): " + ", ".join(
                    f"{ek.GS_FORMS[f]} {forms[3][f]}/{forms[1][f]} "
                    f"{times[(3, f)]} / {times[(1, f)]}" for f in forms[3]))
            rows["gs"]["by_level"].append(dict(
                beam=label, level=li, n=n,
                form=ek.GS_FORMS[plans[3][0]], blocks=plans[3][1],
                device_us=us3, bound_ms=b_ms, bound_by=b_by,
                form_1=ek.GS_FORMS[plans[1][0]], blocks_1=plans[1][1],
                device_us_1=us1, bound_ms_1=b1_ms,
                forms={ek.GS_FORMS[f]: [times[(3, f)], times[(1, f)]]
                       for f in forms[3]}))
            jms = cuda_ms(lambda: ek.jacobi(vals, op.nbr, op.mask,
                                            op.diag_slot, b, None, 2), reps)
            jus = device_us(lambda: ek.jacobi(
                vals, op.nbr, op.mask, op.diag_slot, b, None, 2), 10,
                "ell_jacobi_kernel", per_call=2)
            jplain = cuda_ms(lambda: smoothers.jacobi_plain(op, vals, b, 2),
                             3, warmup=1)
            jb_ms, jb_by = jacobi_bound(n, k, 2, True)
            log(f"phase4 jacobi {label:4s} level {li} N {n} 2 iterations "
                f"from zero: kernel {jms:.4f} ms (device {jus} us)  plain "
                f"{jplain:.3f} ms  bound {jb_ms:.5f} ms ({jb_by})")
            forms1, err1 = jacobi_forms("phase4", label, li, op, vals, b, x0,
                                        reps)
            rows["jacobi"]["by_level"] += [
                dict(beam=label, level=li, n=n, form=form, **e)
                for form, e in forms1.items()]
            rows["jacobi"]["max_abs_err"] = max(
                rows["jacobi"]["max_abs_err"], err1)
            if li == 0:        # the table's numbers: the fine level
                rows["gs"]["by_beam"][label] = dict(
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, device_us=us3)
                rows["jacobi"]["by_beam"][label] = dict(
                    ms=jms, plain_ms=jplain, bound_ms=jb_ms, bound_by=jb_by,
                    library_ms=None, device_us=jus)
    return rows


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
        us = device_us(lambda: lk.fused_pcg(*args), 10,
                       "fused_newton_kernel<true>")
        plain_ms = cuda_ms(lambda: lk.fused_pcg_plain(*args), 3, warmup=1)
        n, c = vm.numel(), cm.numel()
        active = float(cm.sum())
        b_ms, b_by = bound(3 * 3 * n * 4 + 2 * n * 4 + 4 * c + 4, active * (
            lk.DIAG_FLOPS_PER_CELL + (kk - 1) * lk.HVP_FLOPS_PER_CELL))
        row["by_beam"][label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by, library_ms=None, k=kk)
        log(f"phase4 time fused_pcg {label:4s} kernel {ms:.4f} ms (device "
            f"{us} us)  plain "
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
        before = dict(ek.launches)
        torch.cuda.reset_peak_memory_stats()
        (e, fn), ms, wall = timed_run(getattr(sim, method), steps)
        per_step = {name: (ek.launches[name] - before[name]) / steps
                    for name in ek.launches}
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
        if method == "newton_multigrid":
            # a V-cycle: two residual SpMVs and two smoother calls per
            # level above the coarsest, one smoother call there
            want = dict(spmv=2 * (sc.n_levels - 1),
                        gs=2 * (sc.n_levels - 1) + 1, jacobi=0,
                        **{name: 0 for name in ELL_BACKWARD})
            check(per_step == want, f"{label} {method}: launches per step "
                  f"{per_step}, expected {want}")
        out[method] = dict(fn_first=float(fn[0]), fn_last=float(fn[-1]),
                           ms_per_step=ms, wall_ms_per_step=wall,
                           launches_per_step=per_step, peak_mib=peak)
        log(f"phase5 {label:4s} {method:16s} levels {sc.n_levels} steps "
            f"{steps} ||f|| {fn[0]:.3e} -> {fn[-1]:.3e}  ms/step {ms:.2f} "
            f"(host clock {wall:.2f})  launches/step "
            + " ".join(f"{k} {v:g}" for k, v in per_step.items())
            + f"  peak {peak:.0f} MiB")
    return out


def phase5(uscenes):
    """The unstructured path: Newton-MG, FAS v3 and the dynamic frames."""
    torch.cuda.synchronize()
    ek.reset_launches()
    for name in ell.cuda_calls:
        ell.cuda_calls[name] = 0
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
    launches, calls = dict(ek.launches), dict(ell.cuda_calls)
    log(f"phase5 kernel launches {launches}, asked for by the SpMV and "
        f"smoother calls on CUDA tensors {calls} (jacobi: one per iteration)")
    log_jacobi_shapes("phase5")
    check(launches == calls, f"launches {launches} != those the calls on "
          f"CUDA tensors ask for {calls}")
    check(all(launches[n] > 0 for n in ELL_FORWARD),
          f"a kernel of the path was never launched: {launches}")
    check(all(launches[n] == 0 for n in ELL_BACKWARD),
          f"a backward kernel ran on a path that takes no gradient: "
          f"{launches}")
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


# -- phase 7 -----------------------------------------------------------------

def level_bounds(lvl):
    """(bound_ms, bound_by) on one level of lat_hvp (u, p and the cell mask
    in, the product out; with ctrl and vm in, the level matvec), of
    lat_diag_shift unprojected (u, ctrl, vm and the cell mask in, 6 channels
    out; diag_bounds has lat_diag's and the projected one's) and of
    lat_power (u, the cell mask, ctrl, vm, d6 and the start in, one float
    out; the 6 iterations of LatticeMG.linearize, an HVP and the vertex
    update each): the chain FLOPs of the level's
    real cells, and the per-vertex work of its real vertices."""
    n = lvl.vert_mask.numel()
    c = lvl.cell_mask.numel()
    active = float(lvl.cell_mask.sum())
    verts = float(lvl.vert_mask.sum())
    field = 3 * n * 4
    hvp = bound(3 * field + 4 * c, active * lk.HVP_FLOPS_PER_CELL)
    return {"hvp": hvp, "hvp_two_pass": hvp,
            "level_matvec": bound(3 * field + 2 * n * 4 + 4 * c,
                                  active * lk.HVP_FLOPS_PER_CELL
                                  + verts * 3 * 3),
            "power": bound(field + 4 * c + (1 + 1 + 6 + 1) * n * 4 + 4,
                           6 * (active * lk.HVP_FLOPS_PER_CELL
                                + verts * lk.POWER_VERTEX_FLOPS)),
            "diag_shift_unprojected": bound(
                field + 4 * c + 2 * n * 4 + 6 * n * 4,
                active * lk.DIAG_FLOPS_PER_CELL)}


def cheby_bound(lvl, sweeps, warm, residual):
    """(bound_ms, bound_by) of one lat_cheby call: u, b, d6, ctrl, vm, the
    cell mask and (warm) the start read once, x and (residual) b - A x
    written once; the HVPs it runs on the real cells (none in a first sweep
    from zero, one more for the residual) and every sweep's vertex work on
    the real vertices."""
    n = lvl.vert_mask.numel()
    c = lvl.cell_mask.numel()
    active = float(lvl.cell_mask.sum())
    verts = float(lvl.vert_mask.sum())
    floats = (3 + 3 + 6 + 1 + 1 + 3 * warm + 3 + 3 * residual) * n + c
    hvps = sweeps - (not warm) + residual
    return bound(4 * floats, hvps * active * lk.HVP_FLOPS_PER_CELL
                 + sweeps * verts * lk.CHEBY_VERTEX_FLOPS)


def _plan_text(plan, lanes=False):
    """A plan in words; lanes: lat_diag_shift's, whose small tiles run
    eight lanes a cell."""
    if len(plan) == 4:                  # lat_cheby's and lat_power's
        return f"{lk.LEVEL_FORMS[plan[0]]} {plan[1]}x{plan[2]}x{plan[3]}"
    if len(plan) == 6:                  # lat_force's form
        if plan == lk.FORCE_TWO_PASS:
            return "two passes"
        per = ("eight lanes" if lanes and plan[4] <= lk.DIAG_LANE_CELLS
               else "a thread")
        return (f"{plan[0]} halo tiles {plan[1]}x{plan[2]}x{plan[3]}, {per} "
                f"a cell")
    grid, ntx, nty, ntz, _, _, halo = plan
    mode = ("one tile, one block" if ntx * nty * ntz == 1
            else "halo" if halo else "exchange")
    return f"grid {grid} tiles {ntx}x{nty}x{ntz} {mode}"


def two_passes(shape, device, fn):
    """fn() with lat_hvp's plan on this lattice replaced by PR 1's two
    passes while it runs."""
    own = lk._hvp_plan(*shape, device)
    key = (str(device), *shape)
    lk._hvp_plans[key] = lk.FORCE_TWO_PASS
    try:
        return fn()
    finally:
        lk._hvp_plans[key] = own


def diag_shift_err(where, u, dargs, got, ref, tol=1e-4, phase="phase7"):
    """lat_diag_shift's projected blocks against the plain chain's
    (hess_diag_shift_cf_plain): (max|d|, max|ref|, record), max|d| over the
    blocks where no rotation of either chain's projection meets an exact
    tie (ell.jacobi_ties: app == aqq, apq != 0; sign(0) = 0 skips the
    rotation, so an ulp of input moves such a block by up to |apq|). Logs
    how many blocks tie and, for the first block off by more than tol of
    max|ref|, its raw shifted blocks and projections in both chains."""
    raw_k = lk.sym_blocks(lk.hess_diag_shift_cf(u, *dargs, False))
    raw_p = lk.shifted_diag_blocks_plain(u, *dargs)
    tie = ell.jacobi_ties(raw_k) | ell.jacobi_ties(raw_p)
    d = (got - ref).abs().amax(0)
    scale = float(ref.abs().max())
    off = d > tol * scale
    n_tie, n_off = int(tie.sum()), int(off.sum())
    err = float(d[~tie].max()) if n_tie < tie.numel() else 0.0
    tie_err = float(d[tie].max()) if n_tie else 0.0
    log(f"{phase} diag_shift {where}: {n_tie} blocks tie in a rotation of "
        f"either chain, max|d| there {tie_err:.3e}; {n_off} blocks off by "
        f"more than {tol} * max|ref| ({int((off & tie).sum())} of them "
        f"tied)")
    if n_off:
        i = tuple(int(v) for v in torch.nonzero(off)[0])
        k = [float(v) for v in raw_k[i].flatten()]
        p = [float(v) for v in raw_p[i].flatten()]
        log(f"{phase} diag_shift {where} block {i} tied {bool(tie[i])}: raw "
            f"kernel {k}; raw plain {p}; projected kernel "
            f"{got[(slice(None),) + i].tolist()}; plain "
            f"{ref[(slice(None),) + i].tolist()}")
    return err, scale, dict(tie_blocks=n_tie, tie_max_abs_err=tie_err,
                            off_blocks=n_off)


def level_forms(label, li, shape, device, calls, cases, bounds):
    """lat_cheby's calls and lat_power at one level shape in every form the
    plan weighs, each at the tiles its model likes best for that form,
    forced through lk._level_plans: within 1e-4 of max|ref| of the plain
    version, two runs bit-identical, every form bit-equal to every other
    (one arithmetic; lat_power's dots summed by row and plane in one
    order), one device op a call; device us and share of bound. Returns
    {call: {form: record}}."""
    sms = lk._sms(device.index)
    out = {}
    for name, (kernel, sweeps, warm, res) in calls.items():
        kern, plain = cases[name]
        ref = plain()
        key = (str(device), *shape, kernel, sweeps, warm, res)
        own = lk._level_plans[key]
        best = {}
        for cost, form, tiles in lk.level_candidates(shape, sms, kernel,
                                                     sweeps, warm, res):
            if form not in best or cost < best[form][0]:
                best[form] = (cost, tiles)
        outs, rec = [], {}
        try:
            for form, (cost, tiles) in sorted(best.items()):
                lk._level_plans[key] = (form,) + tiles
                got, again = kern(), kern()
                torch.cuda.synchronize()
                g = [got] if not isinstance(got, tuple) else list(got)
                a = [again] if not isinstance(again, tuple) else list(again)
                r = [ref] if not isinstance(ref, tuple) else list(ref)
                what = f"{name} {label} level {li} {lk.LEVEL_FORMS[form]}"
                check(all(torch.equal(x, y) for x, y in zip(g, a)),
                      f"{what}: two runs differ")
                err = max(max_err(x, y) for x, y in zip(g, r))
                scale = max(float(y.abs().max()) for y in r)
                check(err <= 1e-4 * scale, f"{what}: max|d| {err:.3e} > "
                      f"1e-4 * {scale:.3e}")
                ops = whole_trace(kern, 20, 1)
                check(len(ops) <= 1 and sum(n for n, _ in ops.values()) <= 1,
                      f"{what}: device ops per call {ops}")
                us = (round(sum(t for _, t in ops.values()), 2) if ops
                      else None)
                b_us = bounds[name][0] * 1e3
                outs.append(g)
                rec[lk.LEVEL_FORMS[form]] = dict(
                    tiles=list(tiles), max_abs_err=err, device_us=us,
                    model_us=round(cost, 2),
                    share_of_bound=None if not us else b_us / us)
                log(f"phase7 form {name:12s} {label:4s} level {li} {shape} "
                    f"{lk.LEVEL_FORMS[form]:8s} {tiles}: max|d| {err:.3e} "
                    f"(max|ref| {scale:.3e}) same bits twice, device "
                    f"{us} us (model {cost:.1f}; bound {b_us:.2f} us)")
        finally:
            lk._level_plans[key] = own
        same = all(all(torch.equal(x, y) for x, y in zip(o, outs[0]))
                   for o in outs[1:])
        log(f"phase7 forms {name:12s} {label:4s} level {li} {shape}: "
            f"{len(outs)} forms bit-equal {same}")
        check(same, f"{name} {label} level {li}: the forms' bits differ")
        out[name] = rec
    return out


def phase7_kernels(scenes, rows, reps):
    """The multigrid's level operators at every level shape of each beam's
    3-level hierarchy, with the level's dx and ctrl, on a seeded perturbed
    displacement: lat_hvp; lat_diag and lat_diag_shift, the multigrid's
    diagonal (shift and SPD projection fused), under their plans and each
    form (diag_forms), and lat_diag_shift unprojected; lat_cheby as the
    V-cycle calls it (nu = 2:
    pre-smooth from zero with its residual and post-smooth from a start on
    every level but the coarsest; 12 sweeps on the coarsest), with the
    level's Chebyshev bound by power iteration times 1.2. Every result
    against its plain version (the projected diagonal outside the blocks
    where a projection meets an exact tie, diag_shift_err), two runs
    bit-identical, one device op a call for the new kernels, timed. At
    rest, the projection against ell.spd_project of the kernel's own
    shifted blocks where they tie (xx == yy, xy != 0: the sign(0) case).
    Also lat_hvp as its plan runs it and in PR 1's two passes, the level
    matvec (lat_hvp with the shift and mask) and lat_power against their
    plain versions. Returns {label: [per-level dict]}."""
    out = {}
    rows["cheby"] = {"max_abs_err": 0.0, "by_beam": {}}
    rows.setdefault("diag_shift", {"max_abs_err": 0.0, "by_beam": {}})
    rows["power"] = {"max_abs_err": 0.0, "by_beam": {}}
    lib = _cuda.load()
    for label, sc in scenes.items():
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
        rng = np.random.default_rng(7)
        out[label] = []
        for li, lvl in enumerate(mg.levels):
            shape = (3,) + tuple(lvl.vert_mask.shape)
            vm = lvl.vert_mask

            def field(scale):
                return torch.from_numpy((scale * rng.standard_normal(
                    shape)).astype(np.float32)).to(sc.device)
            u, p, b, x0 = field(0.03) * vm, field(1.0), field(1.0) * vm, \
                field(0.1) * vm
            args = (lvl.cell_mask, lvl.dx, MU, LA)
            dargs = (lvl.cell_mask, lvl.ctrl, vm, lvl.dx, MU, LA)
            d6 = lk.hess_diag_shift_cf(u, *dargs)
            pargs = (u, d6, lvl.ctrl, vm, *args)
            margs = (u, p, lvl.cell_mask, lvl.ctrl, vm, lvl.dx, MU, LA)
            lmax = np.float32(lk.power_lmax_cf(*pargs).item()) \
                * np.float32(1.2)
            bounds = level_bounds(lvl)
            cases = {
                "hvp": (lambda: lk.hvp_cf(u, p, *args),
                        lambda: lk.hvp_cf_plain(u, p, *args)),
                "hvp_two_pass": (
                    lambda: two_passes(shape[1:], u.device,
                                       lambda: lk.hvp_cf(u, p, *args)),
                    lambda: lk.hvp_cf_plain(u, p, *args)),
                "level_matvec": (lambda: lk.level_matvec_cf(*margs),
                                 lambda: lk.level_matvec_cf_plain(*margs)),
                "power": (lambda: lk.power_lmax_cf(*pargs),
                          lambda: lk.power_lmax_cf_plain(*pargs)),
                "diag_shift_unprojected": (
                    lambda: lk.hess_diag_shift_cf(u, *dargs, False),
                    lambda: lk.hess_diag_shift_cf_plain(u, *dargs, False)),
            }
            smooths = ({"cheby_coarse": (None, 12, False)}
                       if li == mg.n_levels - 1 else
                       {"cheby_pre": (None, 2, True),
                        "cheby_post": (x0, 2, False)})
            for name, (x, sweeps, res) in smooths.items():
                call = (u, b, x, d6, lvl.ctrl, vm, lvl.cell_mask, lvl.dx, MU,
                        LA, lk.cheby_coeffs(lmax, sweeps), res)
                cases[name] = (lambda call=call: lk.cheby_smooth_cf(*call),
                               lambda call=call: lk.cheby_smooth_cf_plain(
                                   *call))
                bounds[name] = cheby_bound(lvl, sweeps, x is not None, res)
            # lat_cheby's and lat_power's calls: (kernel, sweeps, warm,
            # residual), each with its own plan
            level_calls = {name: (lk.CHEBY, sweeps, x is not None, res)
                           for name, (x, sweeps, res) in smooths.items()}
            level_calls["power"] = (lk.POWER, 6, False, False)
            plans = {name: lk._level_plan(lib, *shape[1:], u.device, *call)
                     for name, call in level_calls.items()}
            plans["hvp"] = lk._hvp_plan(*shape[1:], u.device)
            for k in ("diag", "diag_shift"):
                plans[k] = lk._diag_plan(*shape[1:], u.device,
                                         k == "diag_shift")
            entry = {"level": li, "shape": shape[1:], "dx": lvl.dx,
                     "lmax": float(lmax),
                     "cheby_plan": {name: _plan_text(plans[name])
                                    for name in smooths},
                     "diag_plan": list(plans["diag"]),
                     "diag_shift_plan": list(plans["diag_shift"]),
                     "hvp_plan": list(plans["hvp"]),
                     "power_plan": _plan_text(plans["power"])}
            log(f"phase7 plan {label:4s} level {li} {shape[1:]} lat_cheby "
                + ", ".join(f"{name} {_plan_text(plans[name])}"
                            for name in smooths)
                + f"; lat_diag {_plan_text(plans['diag'])}; lat_diag_shift "
                f"{_plan_text(plans['diag_shift'], True)}; lat_hvp "
                f"{_plan_text(plans['hvp'])}; lat_power "
                f"{_plan_text(plans['power'])}; lmax {float(lmax):.4f}")
            forms = diag_forms("phase7", f"{label} level {li}", u,
                               lvl.cell_mask, lvl.ctrl, vm, lvl.dx, rows)
            entry["diag"] = forms["diag"]
            entry["diag_shift"] = forms["diag_shift"]
            entry["diag_shift_ties"] = forms["diag_shift"]["ties"]
            for name, (kern, plain) in cases.items():
                got, again = kern(), kern()
                ref = plain()
                torch.cuda.synchronize()
                pairs = (list(zip(got, again, ref)) if isinstance(got, tuple)
                         else [(got, again, ref)])
                err = scale = 0.0
                # another summation order (corner sums, the smoother's
                # recurrences): 1e-4 of the output's scale
                for g_, a_, r_ in pairs:
                    check(bool(torch.equal(g_, a_)),
                          f"{name} {label} level {li}: two runs differ")
                    e_, s_ = max_err(g_, r_), float(r_.abs().max())
                    check(e_ <= 1e-4 * s_, f"{name} {label} level {li}: "
                          f"max|d| {e_:.3e} > 1e-4 * {s_:.3e}")
                    err, scale = max(err, e_), max(scale, s_)
                kernel = ("cheby" if name.startswith("cheby")
                          else "diag_shift" if name.startswith("diag_shift")
                          else "hvp" if name in ("hvp_two_pass",
                                                 "level_matvec")
                          else name)
                rows[kernel]["max_abs_err"] = max(
                    rows[kernel]["max_abs_err"], err)
                ms = cuda_ms(kern, reps)
                # each op's mean span times its launches a call; None when
                # the traces lost an op altogether. The two passes (where
                # the plan or the case takes them): cell pass and gather;
                # the others: one launch a call
                two = plans["hvp"] == lk.FORCE_TWO_PASS
                n_ops = {"hvp": 1 + two, "level_matvec": 1 + two,
                         "hvp_two_pass": 2,
                         "diag_shift_unprojected": 1 + (
                             plans["diag_shift"] == lk.FORCE_TWO_PASS),
                         }.get(name, 1)
                ops = whole_trace(kern, 20, n_ops)
                n_got = sum(n for n, _ in ops.values())
                us = (round(sum(max(1, round(n)) * t
                                for n, t in ops.values()), 2)
                      if len(ops) >= n_ops else None)
                # at most n_ops device ops a call (a trace can lose its
                # last events, never add any)
                check(len(ops) <= n_ops and n_got <= n_ops, f"{name} {label} "
                      f"level {li}: device ops per call {ops}")
                plain_ms = cuda_ms(plain, 3, warmup=1)
                b_ms, b_by = bounds[name]
                entry[name] = dict(max_abs_err=err, ms=ms, device_us=us,
                                   plain_ms=plain_ms, bound_ms=b_ms,
                                   bound_by=b_by)
                log(f"phase7 {name:22s} {label:4s} level {li} {shape[1:]} dx "
                    f"{lvl.dx:g} max|d| {err:.3e} (max|ref| {scale:.3e}) "
                    f"same bits twice  kernel {ms:.4f} ms (device "
                    f"{'not captured' if us is None else f'{us} us'}, "
                    f"{n_got:g} ops)  plain {plain_ms:.3f} ms  bound "
                    f"{b_ms:.5f} ms ({b_by})")
            entry["level_forms"] = level_forms(
                label, li, shape[1:], u.device, level_calls,
                {name: cases[name] for name in level_calls}, bounds)
            # the projection where the kernel's own sums tie (at rest)
            u0 = torch.zeros_like(u)
            raw = lk.sym_blocks(lk.hess_diag_shift_cf(u0, *dargs, False))
            a = raw.reshape(-1, 3, 3)
            ties = int(((a[:, 0, 0] == a[:, 1, 1])
                        & (a[:, 0, 1].abs() > 1e-3)).sum())
            ref = lk.sym_channels(ell.spd_project(raw, eps=1e-6,
                                                  rel_floor=1e-3))
            got = lk.hess_diag_shift_cf(u0, *dargs)
            torch.cuda.synchronize()
            err, scale = max_err(got, ref), float(ref.abs().max())
            log(f"phase7 projection {label:4s} level {li} at rest: {ties} "
                f"tied blocks (xx == yy, |xy| > 1e-3); vs ell.spd_project "
                f"of the kernel's shifted blocks max|d| {err:.3e} (max|ref| "
                f"{scale:.3e}){'  bit-equal' if torch.equal(got, ref) else ''}")
            check(err <= 1e-6 * scale, f"projection {label} level {li}: "
                  f"max|d| {err:.3e} > 1e-6 * {scale:.3e}")
            entry["projection_at_rest"] = dict(ties=ties, max_abs_err=err,
                                               bit_equal=bool(torch.equal(
                                                   got, ref)))
            out[label].append(entry)
        rows["cheby"]["by_beam"][label] = out[label][0]["cheby_pre"]
        rows["diag_shift"]["by_beam"][label] = out[label][0]["diag_shift"]
        rows["power"]["by_beam"][label] = out[label][0]["power"]
    return out


def timed_solve(label, name, solve, cg_counted=True):
    """A warm-up solve, then one timed: CUDA events and the host clock, the
    Newton count, the PCG total and the lattice kernel launches of the
    timed solve. Fails unless it reaches ||f||_inf <= TOL."""
    solve()
    torch.cuda.synchronize()
    before = dict(lk.launches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    out = solve()
    end.record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    ms = start.elapsed_time(end)
    x, k, fn = out[:3]
    cg = out[3] if cg_counted else None
    launches = {n: lk.launches[n] - before[n]
                for n in ("cheby", "diag_shift", "power", "hvp", "diag",
                          "force", "energy", "fused_newton")}
    check(bool(torch.isfinite(x).all()) and fn <= TOL,
          f"phase7 {label} {name}: ||f|| {fn:.3e} > {TOL}")
    log(f"phase7 {label:4s} {name:28s} ms/solve {ms:.2f} (host clock "
        f"{wall:.2f})  newton {k}  pcg {cg if cg_counted else 'n/a'}  "
        f"||f|| {fn:.3e}  launches " + " ".join(
            f"{n} {v}" for n, v in launches.items()))
    return dict(ms=ms, wall_ms=wall, newton=k, pcg=cg, fn=fn,
                launches=launches)


def run_frames_mg(sc, mg, n):
    ks, fns = [], []
    st = sc.init_state()
    for i in range(n):
        st, k, fn = tmg.step_to_tol_mg(sc, mg, st, tol=TOL,
                                       gravity_scale=gravity_scale(i))
        ks.append(k)
        fns.append(fn)
    return ks, fns


def phase7_path(scenes):
    """The quasi-static, multigrid and substepping path on the card, lattice
    counters zeroed just before it and read just after."""
    results = {}
    sc2, sc19, sc74 = scenes["2k"], scenes["19k"], scenes["74k"]
    mg2 = tmg.LatticeMG(sc2, n_levels=2, dt=None, coarse_cg=8)
    mgs = {label: tmg.LatticeMG(scenes[label], n_levels=3, dt=None)
           for label in ("19k", "74k")}
    dyn_mgs = {label: tmg.LatticeMG(scenes[label], n_levels=3)
               for label in ("2k", "19k")}
    kick_mesh = meshlib.beam(3, 3, 12, dx=DX)
    kick_sc = tlat.LatticeScene(kick_mesh, device=sc2.device)
    kick_mg = tmg.LatticeMG(kick_sc, n_levels=2, dt=None)
    cant = meshlib.beam(4, 4, 32, dx=DX)
    pins = np.nonzero(cant.ijk[:, 2] == cant.ijk[:, 2].min())[0]
    cant_sc = tlat.LatticeScene(cant, pins=pins, device=sc2.device)
    cant_mg = tmg.LatticeMG(cant_sc, n_levels=3, dt=None, coarse_cg=16)
    torch.cuda.synchronize()
    lk.reset_launches()
    # the verify recipe on the 2k beam
    _, k, fn = tlat.quasistatic_to_tol(sc2, sc2.x0, tol=TOL, load_steps=2)
    log(f"phase7 2k   verify quasistatic_to_tol(load_steps=2) newton {k} "
        f"||f|| {fn:.3e}")
    check(fn <= TOL, f"verify quasistatic_to_tol: {fn:.3e}")
    _, k, fn = tmg.quasistatic_to_tol_mg(sc2, mg2, sc2.x0, tol=TOL)
    log(f"phase7 2k   verify quasistatic_to_tol_mg(2 levels, coarse_cg 8) "
        f"newton {k} ||f|| {fn:.3e}")
    check(fn <= TOL, f"verify quasistatic_to_tol_mg: {fn:.3e}")
    results["verify"] = dict(newton=k, fn=fn)
    # full-size quasi-static solves, as bench.py --quasistatic runs them
    solves = {}
    solves["19k quasistatic_to_tol"] = timed_solve(
        "19k", "quasistatic_to_tol", lambda: tlat.quasistatic_to_tol(
            sc19, sc19.x0, tol=TOL, max_newton=100, return_cg=True))
    solves["74k quasistatic_to_tol(load_steps=2)"] = timed_solve(
        "74k", "quasistatic_to_tol(load_steps=2)",
        lambda: tlat.quasistatic_to_tol(sc74, sc74.x0, tol=TOL,
                                        max_newton=100, load_steps=2),
        cg_counted=False)
    for label, mg in mgs.items():
        sc = scenes[label]
        r = solves[f"{label} quasistatic_to_tol_mg"] = timed_solve(
            label, "quasistatic_to_tol_mg(3 levels)",
            lambda sc=sc, mg=mg: tmg.quasistatic_to_tol_mg(
                sc, mg, sc.x0, tol=TOL, max_newton=100, return_cg=True))
        # one lat_power a level at the stage's first linearization, one
        # lat_hvp an outer PCG matvec
        n = r["launches"]
        check(n["power"] == mg.n_levels and n["hvp"] == r["pcg"],
              f"{label} quasistatic_to_tol_mg launches {n}, pcg {r['pcg']}")
    results["solves"] = solves
    # dynamic multigrid under the excited protocol
    for label, mg in dyn_mgs.items():
        sc = scenes[label]
        run_frames_mg(sc, mg, 1)                     # warm-up
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        ks, fns = run_frames_mg(sc, mg, 16)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / 16
        wall = (time.perf_counter() - t0) * 1e3 / 16
        log(f"phase7 {label:4s} step_to_tol_mg 16 frames ms/frame {ms:.2f} "
            f"(host clock {wall:.2f})  newton_mean {np.mean(ks):.3f} "
            f"newton {ks}  fn_max {max(fns):.3e}")
        check(max(fns) <= TOL * 1.01, f"{label} step_to_tol_mg: fn_max "
              f"{max(fns):.3e}")
        results[f"{label} step_to_tol_mg"] = dict(
            ms_per_frame=ms, wall_ms_per_frame=wall,
            newton_mean=float(np.mean(ks)), fn_max=float(max(fns)))
    # adaptive substepping on the violent kick
    for name, frame in (
            ("frame_adaptive", lambda s: tlat.frame_adaptive(
                kick_sc, s, tol=TOL, max_newton=25, max_halvings=4)),
            ("frame_adaptive_mg", lambda s: tmg.frame_adaptive_mg(
                kick_sc, kick_mg, s, tol=TOL, max_newton=6,
                max_halvings=4))):
        st = kicked(kick_sc, kick_sc.init_state())
        subs, ks, fns = [], [], []
        t0 = time.perf_counter()
        for _ in range(3):
            st, k, fn, n_sub = frame(st)
            subs.append(n_sub)
            ks.append(k)
            fns.append(fn)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"phase7 kick {name:18s} n_sub {subs} newton {ks} fn_max "
            f"{max(fns):.3e}  ({wall:.2f} s)")
        check(max(fns) <= TOL, f"{name}: a frame missed tol: {fns}")
        check(max(subs) > 1, f"{name}: the kick took no substeps")
        results[f"kick {name}"] = dict(n_sub=subs, newton=ks)
    # full multigrid on the deep-bend cantilever
    t0 = time.perf_counter()
    x, k, fn, ks = tmg.quasistatic_fmg(
        cant_sc, cant_mg, tol=TOL, max_newton=100, coarse_max_newton=100,
        load_steps="auto", fine_solver="jacobi", return_stats=True)
    torch.cuda.synchronize()
    tip = float(x[..., 1].min())
    log(f"phase7 4x4x32 cantilever quasistatic_fmg(jacobi, auto) newton per "
        f"level {ks} ||f|| {fn:.3e} tip y {tip:.4f} "
        f"({time.perf_counter() - t0:.2f} s)")
    check(fn <= TOL and tip < -1.3, f"fmg: ||f|| {fn:.3e}, tip {tip:.4f}")
    results["fmg"] = dict(newton=list(ks), fn=fn, tip=tip)
    torch.cuda.synchronize()
    counts = dict(lk.launches)
    log(f"phase7 launches {counts}")
    for name in ("cheby", "diag_shift", "power", "hvp", "force", "energy",
                 "fused_newton"):
        check(counts[name] > 0, f"phase7: {name} never launched")
    return results, counts


# phase 7's path under the first forms of lat_cheby and lat_power (the
# cooperative eight-lane kernels on the fused Newton kernel's tiles), as
# scripts/level_tilings.py --path counted it on an H100 (PERF.md):
# each solve's Newton and PCG counts and V-cycles (lat_cheby launches over
# the 2 (levels - 1) + 1 a V-cycle makes), the frames' mean Newton, the
# substeps and Newton of the kicks, FMG's Newton per level
PHASE7_FIRST_FORMS = {
    "19k quasistatic_to_tol": dict(newton=3, pcg=41),
    "74k quasistatic_to_tol(load_steps=2)": dict(newton=5),
    "19k quasistatic_to_tol_mg": dict(newton=3, pcg=7, vcycles=10),
    "74k quasistatic_to_tol_mg": dict(newton=3, pcg=7, vcycles=10),
    "verify": dict(newton=2),
    "2k step_to_tol_mg": dict(newton_mean=1.25),
    "19k step_to_tol_mg": dict(newton_mean=1.8125),
    "kick frame_adaptive": dict(n_sub=[2, 2, 1], newton=[12, 6, 6]),
    "kick frame_adaptive_mg": dict(n_sub=[4, 2, 1], newton=[4, 6, 6]),
    "fmg": dict(newton=[12, 10, 10]),
}


def phase7_against_first_forms(results):
    """The path's counts against PHASE7_FIRST_FORMS, each equal to them:
    the solves' Newton, PCG and V-cycles, the frames' mean Newton, the
    kicks' substeps and Newton, FMG's Newton per level."""
    got = {name: dict(r) for name, r in results["solves"].items()}
    for name in ("19k quasistatic_to_tol_mg", "74k quasistatic_to_tol_mg"):
        got[name]["vcycles"] = got[name]["launches"]["cheby"] // 5
    got.update({k: v for k, v in results.items() if k != "solves"})
    for name, want in PHASE7_FIRST_FORMS.items():
        have = {k: got[name][k] for k in want}
        same = have == want
        log(f"phase7 {name:36s} {have} against the first forms' {want}")
        check(same, f"phase7 {name}: {have}, first forms {want}")


def phase7_cpu(sc_gpu, newton=3):
    """The first Newton iterations of quasistatic_to_tol_mg (3 levels) at 19k
    on the card and on the CPU with the plain versions: ||f||_inf after 1,
    2, ... iterations (a solve capped at that count each)."""
    cpu = tlat.LatticeScene(sc_gpu.mesh, device="cpu")
    series = {}
    t0 = time.perf_counter()
    for sc in (sc_gpu, cpu):
        mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
        series[sc.device.type] = [tmg.quasistatic_to_tol_mg(
            sc, mg, sc.x0, tol=TOL, max_newton=m)[1:] for m in
            range(1, newton + 1)]
    secs = time.perf_counter() - t0
    ks = {d: [k for k, _ in v] for d, v in series.items()}
    fg = np.array([fn for _, fn in series["cuda"]])
    fc = np.array([fn for _, fn in series["cpu"]])
    d = np.abs(fg - fc)
    rel = d / np.abs(fc)
    log(f"phase7 19k quasistatic_to_tol_mg first {newton} Newton: gpu "
        f"newton {ks['cuda']} ||f|| {fg.tolist()}")
    log(f"phase7 19k quasistatic_to_tol_mg first {newton} Newton: cpu "
        f"newton {ks['cpu']} ||f|| {fc.tolist()}  max rel |d ||f||| "
        f"{rel.max():.3e}  max |d ||f||| {d.max():.3e}  ({secs:.1f} s)")
    check(ks["cuda"] == ks["cpu"], "Newton counts differ between CPU and GPU")
    # the float32 policy of the CPU parity tests: near tolerance the norm's
    # f32 noise (a few 1e-6) is most of it
    check(bool(np.all(d <= 1e-3 * np.abs(fc) + 5e-6)),
          f"||f|| series differ: {fg.tolist()} vs {fc.tolist()}")
    return float(rel.max())

# -- phase 8 -----------------------------------------------------------------

def cloth_scene(res, device):
    """The exp1 cloth protocol: a res x res ClothConfig grid, the two
    corners of the first row pinned."""
    return ClothScene(ClothConfig(res_x=res, res_y=res), pins=[0, res],
                      device=device)


def cloth_frames(sc, n):
    """n step_to_tol frames from rest: (state, Newton list, ||f|| list)."""
    st, ks, fns = cloth.init_state(sc), [], []
    for _ in range(n):
        st, k, fn = cloth.step_to_tol(sc, sc.params, st, tol=CLOTH_TOL,
                                      max_newton=20)
        ks.append(k)
        fns.append(fn)
    return st, ks, fns


def cloth_hessian(sc):
    """(the frame Hessian masked, a vector) of a cloth scene at a seeded
    perturbed state (rng 8): phase 8's and phase 9's K = 7 inputs."""
    rng = np.random.default_rng(8)
    p = sc.params
    x = p["x0"] + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(p["x0"].shape)).astype(np.float32)).to(sc.device)
    vals = cloth._frame_hessian(sc, p, x, cloth._frame_diag(
        sc, p, cloth.init_state(sc), 1.0 / sc.cfg.dt))
    v = torch.from_numpy(rng.standard_normal(
        tuple(x.shape)).astype(np.float32)).to(sc.device)
    return (vals * p["mask"][..., None, None]).contiguous(), v


def phase8_spmv(cloths, row, reps):
    """(a) ell_spmv against its plain version on the cloth Hessian (K = 7,
    8 lanes a row) at a seeded perturbed state: max|d| <= 1e-5 max|ref| as
    in phase 4, two runs bit-identical, timed beside its bound and
    BSR @ x."""
    row["by_cloth"] = {}
    for label, sc in cloths.items():
        full, v = cloth_hessian(sc)
        nbr, mask = sc.params["nbr"], sc.params["mask"]
        got = ek.spmv(full, nbr, mask, v)
        again = ek.spmv(full, nbr, mask, v)
        ref = ek.spmv_plain(full, nbr, mask, v)
        torch.cuda.synchronize()
        err, scale = max_err(got, ref), float(ref.abs().max())
        check(err <= 1e-5 * scale, f"spmv cloth {label}: max|d| {err:.3e} "
              f"> 1e-5 * {scale:.3e}")
        check(torch.equal(got, again), f"spmv cloth {label}: two runs differ")
        row["max_abs_err"] = max(row["max_abs_err"], err)
        ms = cuda_ms(lambda: ek.spmv(full, nbr, mask, v), reps)
        us = device_us(lambda: ek.spmv(full, nbr, mask, v), 10,
                       "ell_spmv_kernel")
        plain_ms = cuda_ms(lambda: ek.spmv_plain(full, nbr, mask, v),
                           max(reps // 2, 3), warmup=1)
        A = bsr_of(full, nbr, mask)
        xv = v.reshape(-1)
        lib_err = max_err((A @ xv).reshape(-1, 3), ref)
        lib_ms = cuda_ms(lambda: A @ xv, reps)
        n, k = full.shape[:2]
        b_ms, b_by = spmv_bound(full, nbr, 0, n, n)
        row["by_cloth"][label] = dict(ms=ms, device_us=us, plain_ms=plain_ms,
                                      bound_ms=b_ms, bound_by=b_by,
                                      library_ms=lib_ms, lanes=ek.lanes(k))
        log(f"phase8 spmv cloth {label} N {n} K {k} L {ek.lanes(k)} (lanes "
            f"a row, {256 // ek.lanes(k)} rows a block) max rel |d| "
            f"{err / scale:.3e} same bits twice  kernel {ms:.4f} ms (device "
            f"{us} us)  plain "
            f"{plain_ms:.4f} ms  bound {b_ms:.5f} ms ({b_by})  library "
            f"(BSR @ x) {lib_ms:.4f} ms, max|d| {lib_err:.3e}")


def kick_state(sc):
    """The violent kick of tests/test_dynamic.py on an unstructured scene."""
    x = sc.x0.cpu().numpy()
    r = x - x.mean(0)
    omega = np.array([18.0, 0.0, 6.0], np.float32)
    v = np.cross(np.broadcast_to(omega, r.shape), r).astype(np.float32)
    return dynamic.state_from_numpy(x, v, np.zeros(x.shape[0]), x,
                                    device=sc.device)


def adaptive_frames(sc, kw, n=3):
    st, subs, ks, fns = kick_state(sc), [], [], []
    for _ in range(n):
        st, k, fn, n_sub = dynamic.frame_adaptive(sc, sc.params, st, **kw)
        subs.append(n_sub)
        ks.append(k)
        fns.append(fn)
    return st, subs, ks, fns


def phase8(cloths, uscene2k):
    """(b)-(g): the cloth, picking, harness, substepping and viewer paths on
    the card, the block-ELL counters zeroed just before and read just after;
    (c) and (f) also run on the CPU with the plain versions."""
    dev = uscene2k.device
    kick = {name: Scene(meshlib.beam(3, 3, 12, dx=DX),
                        solver=SolverConfig(n_levels=nl), device=dev)
            for name, nl in (("matrix_free", 1), ("mg", 2))}
    sim = ClothSim(ClothConfig(res_x=64, res_y=64), pins=[0, 64], device=dev)
    sim.frame()
    cloth_frames(cloths["64x64"], 1)              # warm-up
    torch.cuda.synchronize()
    ek.reset_launches()
    for name in ell.cuda_calls:
        ell.cuda_calls[name] = 0
    results = {}
    # (b) the reference 5-CG frame, then step_to_tol at both grids
    before = ek.launches["spmv"]
    (_, ms, wall) = timed_run(lambda n: [sim.frame() for _ in range(n)],
                              FRAMES)
    check(bool(torch.isfinite(sim.state.x).all()), "ClothSim.frame: not finite")
    log(f"phase8 cloth 64x64 ClothSim.frame (5 CG) {FRAMES} frames ms/frame "
        f"{ms:.3f} (host clock {wall:.3f})  spmv launches "
        f"{ek.launches['spmv'] - before}")
    results["64x64 frame"] = dict(ms_per_frame=ms, wall_ms_per_frame=wall)
    for label, sc in cloths.items():
        before = ek.launches["spmv"]
        (st, ks, fns), ms, wall = timed_run(lambda n: cloth_frames(sc, n),
                                            FRAMES)
        spmv = ek.launches["spmv"] - before
        log(f"phase8 cloth {label} step_to_tol {FRAMES} frames ms/frame "
            f"{ms:.3f} (host clock {wall:.3f})  newton {ks}  max ||f|| "
            f"{max(fns):.3e}  spmv launches {spmv}")
        check(max(fns) <= CLOTH_TOL, f"cloth {label}: a frame ended above "
              f"tol: {max(fns):.3e}")
        check(max(ks) >= 1, f"cloth {label}: no frame took a Newton step")
        check(bool(torch.isfinite(st.x).all()), f"cloth {label}: not finite")
        results[f"{label} step_to_tol"] = dict(
            ms_per_frame=ms, wall_ms_per_frame=wall,
            newton_mean=float(np.mean(ks)), fn_max=float(max(fns)),
            spmv_launches=spmv)
    # the assembly and the solve repeat their bits
    runs = [cloth_frames(cloths["64x64"], 8) for _ in range(2)]
    # where a frame's time goes: device ops and busy time of the ninth frame
    for label, sc in cloths.items():
        st8 = runs[0][0] if label == "64x64" else cloth_frames(sc, 8)[0]
        frame = lambda: cloth.step_to_tol(sc, sc.params, st8, tol=CLOTH_TOL)
        _, k, _ = frame()
        (_, ms, _) = timed_run(lambda n: [frame() for _ in range(n)], 3)
        ops = whole_trace(frame, 3, 1)
        n_ops = sum(n for n, _ in ops.values())
        busy = sum(n * us for n, us in ops.values()) * 1e-3
        top = sorted(ops.items(), key=lambda e: -e[1][0] * e[1][1])[:4]
        log(f"phase8 cloth {label} frame 9 ({k} Newton) ms {ms:.3f}  device "
            f"ops {n_ops:.0f}  device busy {busy:.3f} ms  idle share "
            f"{1 - busy / ms:.3f}  most device time: " + ", ".join(
                f"{name[:40]} {n:.0f} x {us:.1f} us" for name, (n, us) in top))
        results[f"{label} frame 9"] = dict(newton=k, ms=ms, device_ops=n_ops,
                                          busy_ms=busy)
    check(runs[0][1] == runs[1][1] and torch.equal(runs[0][0].x, runs[1][0].x),
          "cloth 64x64: two runs of 8 frames differ")
    # (c) the first 8 frames again on the CPU with the plain versions
    t0 = time.perf_counter()
    st_cpu, ks_cpu, _ = cloth_frames(cloth_scene(64, "cpu"), 8)
    err = max_err(runs[0][0].x.cpu(), st_cpu.x)
    log(f"phase8 cloth 64x64 8 frames newton gpu {runs[0][1]} cpu {ks_cpu}  "
        f"max|d x| {err:.3e}  two gpu runs same bits  "
        f"({time.perf_counter() - t0:.1f} s on CPU)")
    check(ks_cpu == runs[0][1], "cloth: Newton counts differ between CPU "
          "and GPU")
    check(err <= 1e-4, f"cloth: x max|d| {err:.3e} > 1e-4")
    results["64x64 cpu"] = dict(newton=ks_cpu, max_dx=err)
    # (d) drag on the card
    pk = Picker(sim, sim.triangles(), grab_radius2=0.01)
    origin, down = np.array([0.5, 2.0, 0.5]), np.array([0.0, -1.0, 0.0])
    check(pk.select(origin, down), "picker: the ray missed the cloth")
    pk.move_select(origin + np.array([0.1, 0.0, 0.0]), down)
    grabbed = float(sim.state.drag_mask.sum())
    for _ in range(10):
        sim.frame()
    check(grabbed > 0, "picker: no vertex grabbed")
    check(bool(torch.isfinite(sim.state.x).all()), "dragged cloth not finite")
    log(f"phase8 picker vertex {pk.select_vertex} grabbed {grabbed:.0f} "
        f"vertices, 10 dragged frames finite")
    pk.clear()
    # (e) the harness on the card
    before = dict(ek.launches)
    factory = lambda: uscene2k
    drag = harness.drag_study(factory, iterations=6)
    gs, cg, mg = drag["gs"], drag["cg"], drag["mg"]
    log(f"phase8 drag_study 2k gs {gs.tolist()}")
    log(f"phase8 drag_study 2k cg {cg.tolist()}")
    log(f"phase8 drag_study 2k mg {mg.tolist()}")
    check(all(mg[i] < gs[i] and mg[i] < cg[i] for i in (1, 2, 3)),
          "drag_study: the V-cycle did not beat GS and CG at 1-3")
    studies = {**harness.compare(factory, iterations=10),
               **harness.compare_fas(factory, iterations=10)}
    for arm, ser in studies.items():
        fn = ser["f_inf"]
        check(bool(np.isfinite(fn).all()) and fn[-1] < fn[0],
              f"harness {arm}: ||f|| {fn[0]:.3e} -> {fn[-1]:.3e}")
    used = {k: ek.launches[k] - before[k] for k in ek.launches}
    log("phase8 harness 2k " + "  ".join(
        f"{arm} ||f|| {s['f_inf'][0]:.3e} -> {s['f_inf'][-1]:.3e}"
        for arm, s in studies.items()) + f"  launches {used}")
    results["drag_study"] = {k: v.tolist() for k, v in drag.items()}
    # (f) adaptive substepping on the violent kick, card and CPU
    for name, kw in (("matrix_free", dict(use_multigrid=False,
                                          matrix_free=True, max_newton=10)),
                     ("mg", dict(max_newton=20))):
        kw = dict(kw, tol=TOL, max_halvings=4)
        sc = kick[name]
        t0 = time.perf_counter()
        st, subs, ks, fns = adaptive_frames(sc, kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        cpu = Scene(sc.mesh, solver=sc.solver, device="cpu")
        st_c, subs_c, ks_c, _ = adaptive_frames(cpu, kw)
        err = max_err(st.x.cpu(), st_c.x)
        log(f"phase8 kick frame_adaptive {name:11s} n_sub {subs} (cpu "
            f"{subs_c})  newton {ks} (cpu {ks_c})  fn_max {max(fns):.3e}  "
            f"max|d x| {err:.3e}  ({wall:.2f} s on the card)")
        check(subs == subs_c, f"frame_adaptive {name}: n_sub {subs} != cpu "
              f"{subs_c}")
        check(max(fns) <= TOL, f"frame_adaptive {name}: missed tol {fns}")
        results[f"kick {name}"] = dict(n_sub=subs, newton=ks, cpu_newton=ks_c,
                                       max_dx=err)
    check(max(results["kick matrix_free"]["n_sub"]) > 1,
          "the kick took no substeps")
    # (g) a headless viewer loop over a DynamicSim
    dsim = DynamicSim(uscene2k)
    win = HeadlessWindow(320, 240)
    tris = meshlib.surface_triangles(uscene2k.mesh.hexes)
    win.set_frame_source(lambda: (uscene2k.to_mesh_order(dsim.state.x), tris))
    win.loop(lambda pause: pause or dsim.frame(), max_frames=8,
             capture_every=1)
    check(len(win.frames) == 8 and bool(np.isfinite(win.frames[-1]).all()),
          "headless window: frames missing or not finite")
    log(f"phase8 headless window 8 frames of DynamicSim, last max|x| "
        f"{np.abs(win.frames[-1]).max():.4f}")
    torch.cuda.synchronize()
    launches, calls = dict(ek.launches), dict(ell.cuda_calls)
    log(f"phase8 kernel launches {launches}, asked for by the calls on CUDA "
        f"tensors {calls}")
    log_jacobi_shapes("phase8")
    check(launches == calls, f"launches {launches} != those the calls on "
          f"CUDA tensors ask for {calls}")
    check(all(launches[n] > 0 for n in ELL_FORWARD),
          f"a block-ELL kernel of the path was never launched: {launches}")
    check(all(launches[n] == 0 for n in ELL_BACKWARD),
          f"a backward kernel ran on a path that takes no gradient: "
          f"{launches}")
    return results, launches


# -- phase 9 -----------------------------------------------------------------

def spmv_t_bound(n, k, kt, skip):
    """values and mask once (through the table), the table, g in and gx out
    (diag_slot where a slot is left out); 21 FLOPs an entry."""
    return bound(n * k * 40 + n * kt * 4 + 24 * n + (4 * n if skip else 0),
                 n * k * 21.0)


def outer_bound(n, k):
    """g, x, nbr and mask in, the (N, K, 3, 3) gradient out; 12 FLOPs an
    entry."""
    return bound(n * k * 44 + 24 * n, n * k * 12.0)


def jacobi_bwd_bound(n, k, gv=True, from_xt=True):
    """What one ell_jacobi_bwd launch must move: diag_slot, gbar and the
    diagonal blocks in, lam and gb out; with the values' gradient (gv) also
    b in and the whole rows' gradient out (N K 36 B: the diagonal blocks'
    derivative and the off-diagonal products), and, from x_t (not the zero
    start), the whole rows' values, nbr and mask and x_t in for the
    residual. ~60 FLOPs a row for lam, ~90 more for the diagonal
    derivative, 9 (K - 1) for the off-diagonal products, 18 K for the
    residual."""
    n_bytes = 4 * n + 12 * n + 36 * n + 24 * n
    flops = 60.0 * n
    if gv:
        n_bytes += 12 * n + n * k * 36
        flops += 90.0 * n + 9.0 * (k - 1) * n
        if from_xt:
            n_bytes += n * k * 44 - 36 * n + 12 * n
            flops += 18.0 * k * n
    return bound(n_bytes, flops)


# the forms of ell_jacobi_bwd phase 9 checks and times (values' gradient,
# from x_t), the exp2 path's last: one coarse iteration from zero
JACOBI_BWD_FORMS = {"no gv": (False, True),
                    "from x_t": (True, True),
                    "zero start": (True, False)}
JACOBI_BWD_PATH_FORM = "zero start"


def bsr_t_of(values, mask, tt):
    """A^T as a torch BSR tensor (row j: the blocks values[e]^T of its
    transpose-table entries, masked ones dropped), for timing one library
    call A^T @ g on the same matrix."""
    n, k = mask.shape
    e = tt.long().reshape(-1)
    rows = torch.arange(n, device=values.device).repeat_interleave(
        tt.shape[1])
    live = e >= 0
    e, rows = e[live], rows[live]
    keep = mask.reshape(-1)[e] > 0
    e, rows = e[keep], rows[keep]
    blocks = values.reshape(n * k, 3, 3)[e].transpose(1, 2).contiguous()
    crow = torch.zeros(n + 1, dtype=torch.int64, device=values.device)
    crow[1:] = torch.cumsum(torch.bincount(rows, minlength=n), 0)
    return torch.sparse_bsr_tensor(crow, e // k, blocks, size=(3 * n, 3 * n))


def _bwd_outputs(fn, vals, op, g, b, xt, with_gv):
    """(lam, gb, gv) of one jacobi_bwd call into zeros, flat (xt None: the
    zero start; gv all zeros without the values' gradient)."""
    gb, gv = torch.zeros_like(g), torch.zeros_like(vals)
    lam = fn(vals, op.nbr, op.mask, op.diag_slot, b, xt, g, gb,
             gv if with_gv else None)
    return torch.cat([lam.reshape(-1), gb.reshape(-1), gv.reshape(-1)])


def _outer_composition(out, vals, op, b, xt):
    """The (lam, gb, gv) of `_bwd_outputs` with the off-diagonal slots of gv
    formed as the second launch of the parent's adjoint formed them:
    ell_outer(lam, nbr, mask, x_t, skip=diag_slot, alpha=-1) (x_t zero for
    the zero start), the diagonal slots kept."""
    n = b.shape[0]
    lam = out[:3 * n].reshape(n, 3)
    gv = out[6 * n:].reshape(vals.shape)
    rows, ds = torch.arange(n, device=gv.device), op.diag_slot.long()
    two = torch.zeros_like(gv)
    two[rows, ds] = gv[rows, ds]
    ek.outer(lam, op.nbr, op.mask, torch.zeros_like(b) if xt is None else xt,
             skip=op.diag_slot, alpha=-1.0, out=two)
    return torch.cat([out[:6 * n], two.reshape(-1)])


def _grads(fn, leaves, w):
    """d (fn(*leaves) . w) / d leaves, leaves fresh copies."""
    leaves = [None if t is None else t.detach().clone().requires_grad_()
              for t in leaves]
    out = fn(*leaves)
    return torch.autograd.grad((out * w).sum(),
                               [t for t in leaves if t is not None])


def exp2_coarse_values(sc, x):
    """The exp2 cycle's coarse matrix at x (classic position restriction):
    the values its coarse Jacobi solve, and so the backward kernels, get."""
    t = sc.params["transfers"][0]
    xc = tops.restrict(t["r_idx"], t["r_w_norm"], x)
    return qs.assemble_coarse_rediscretized(sc, sc.params, 1, xc,
                                            with_fix_diag=True)


# ell_spmv_t's two calls: A^T g, and the Jacobi adjoint's -A^T g with each
# row's diagonal slot left out
SPMV_T_CALLS = (("plain", False, 1.0), ("diag out", True, -1.0))


def spmv_t_shape(rows, label, li, vals, mask, tt, diag, g, reps):
    """ell_spmv_t in both calls against spmv_t_plain on the same CUDA
    tensors, max|d| <= 1e-5 max|ref| (another summation order), two runs
    bit-identical, launched in the form and lanes its plan picks (the C
    plan equal to its mirror ek.spmv_t_plan); each call timed (events ms,
    device us by the profiler, its share of spmv_t_bound, the plain
    version) beside BSR(A^T) @ g (events ms and device us). Returns the
    max rel |d| by call and the log's parts."""
    n, k = vals.shape[:2]
    kt = tt.shape[1]
    sms = torch.cuda.get_device_properties(vals.device).multi_processor_count
    At, gl = bsr_t_of(vals, mask, tt), g.reshape(-1)
    lib_ref = ek.spmv_t_plain(vals, mask, tt, g)
    lib_err = max_err((At @ gl).reshape(-1, 3), lib_ref)
    check(lib_err <= 1e-4 * float(lib_ref.abs().max()),
          f"BSR(A^T) @ g {label} level {li}: max|d| {lib_err:.3e}")
    lib_ms = cuda_ms(lambda: At @ gl, reps)
    lib_us = _ops_us(lambda: At @ gl, 1)[0]
    errs, parts = {}, []
    for call, with_skip, alpha in SPMV_T_CALLS:
        skip = diag if with_skip else None

        def kf():
            return ek.spmv_t(vals, mask, tt, g, skip, alpha)

        def pf():
            return ek.spmv_t_plain(vals, mask, tt, g, skip, alpha)
        got, again, ref = kf(), kf(), pf()
        torch.cuda.synchronize()
        err, scale = max_err(got, ref), float(ref.abs().max())
        check(torch.equal(got, again), f"spmv_t {call} {label} level {li}: "
              "two runs differ")
        check(err <= 1e-5 * scale, f"spmv_t {call} {label} level {li}: "
              f"max|d| {err:.3e} > 1e-5 * {scale:.3e}")
        rows["spmv_t"]["max_abs_err"] = max(rows["spmv_t"]["max_abs_err"],
                                            err)
        errs[f"spmv_t {call}"] = err / scale
        c_plan = (ctypes.c_int * 2)()
        _cuda.check(_cuda.load().ell_spmv_t_plan(n, kt, c_plan),
                    "ell_spmv_t_plan")
        form, lanes = c_plan[0], c_plan[1]
        check((form, lanes) == ek.spmv_t_plan(n, kt, sms), f"spmv_t "
              f"{label} level {li}: ell_spmv_t_plan {(form, lanes)} is not "
              f"its mirror's {ek.spmv_t_plan(n, kt, sms)}")
        plan = f"{ek.SPMV_T_FORMS[form]} {lanes}"
        ms = cuda_ms(kf, reps)
        us = device_us(kf, 10, "ell_spmv_t_kernel")
        plain_ms = cuda_ms(pf, 3, warmup=1)
        b_ms, b_by = spmv_t_bound(n, k, kt, with_skip)
        entry = dict(ms=ms, device_us=us, plain_ms=plain_ms, bound_ms=b_ms,
                     bound_by=b_by, plan=plan, library_ms=lib_ms,
                     library_device_us=lib_us)
        rows["spmv_t"]["by_level"].append(dict(
            beam=label, level=li, n=n, form=None if call == "plain" else call,
            **entry))
        if li == 0 and call == "plain":
            rows["spmv_t"]["by_beam"][label] = entry
        share = f"{b_ms * 1e3 / us:.0%}" if us else "n.m."
        parts.append(f"spmv_t {call} ({plan} lanes) {ms:.4f} ms (device "
                     f"{us} us, {share} of bound {b_ms:.5f} {b_by}, plain "
                     f"{plain_ms:.3f})")
    parts.append(f"BSR(A^T) @ g {lib_ms:.4f} ms (device {lib_us} us)")
    return errs, parts


def phase9_kernels(uscenes, sc21, cloths, reps):
    """ell_spmv_t, ell_outer and ell_jacobi_bwd against their plain versions
    on the same CUDA tensors, and the Functions' gradients against
    torch.autograd through spmv_plain / jacobi_plain (1 and 3 iterations,
    with and without x0), at the fine Hessian of the 19k and 21k Scenes,
    the 21k Scene's exp2 coarse matrix (the learning path's shape) and every
    level of the 2k one: max|d| <= 1e-5 max|ref| (another summation order;
    fp32 FMA contraction), two runs bit-identical; timed. ell_spmv_t also
    at the cloth's frame Hessians (K 7, phase 8's inputs) and the 74k
    Scene's fine Hessian (spmv_t_shape)."""
    rows = {name: {"max_abs_err": 0.0, "by_beam": {}, "by_level": []}
            for name in ELL_BACKWARD}
    jacobi_rows, jacobi_err = [], 0.0
    for label, sc in cloths.items():   # ell_spmv_t alone at K 7
        full, _ = cloth_hessian(sc)
        g = torch.from_numpy(np.random.default_rng(23).standard_normal(
            (full.shape[0], 3)).astype(np.float32)).to(full.device)
        tt = ek.transpose_table(sc.params["nbr"])
        errs, parts = spmv_t_shape(rows, f"cloth {label}", 0, full,
                                   sc.params["mask"], tt,
                                   sc.params["diag_slot"], g, reps)
        log(f"phase9 backward cloth {label} N {full.shape[0]} K "
            f"{full.shape[1]} Kt {tt.shape[1]} max rel |d| "
            + " ".join(f"{c} {e:.2e}" for c, e in errs.items())
            + "; same bits twice")
        log(f"phase9 time     cloth {label}: " + "  ".join(parts))
    cases = [("19k", uscenes["19k"], 0), ("21k", sc21, 0), ("21k", sc21, 1)
             ] + [("2k", uscenes["2k"], li)
                  for li in range(uscenes["2k"].n_levels)] + [
        ("74k", uscenes["74k"], 0)]
    chains = {}
    for label, sc, li in cases:
        if label not in chains:
            rng = np.random.default_rng(19)
            x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
                tuple(sc.x0.shape)).astype(np.float32)).to(sc.device)
            fine = qs.assemble_fine(sc, sc.params, x)
            chains[label] = (qs.galerkin_chain(sc, sc.params, fine)
                             if label == "2k" else [fine] if label == "74k"
                             else [fine, exp2_coarse_values(sc, x)])
        vals = chains[label][li]
        op = sc.make_op(li)
        n, k = vals.shape[:2]
        tt = op.transpose_table()
        kt = tt.shape[1]
        rng = np.random.default_rng(23 + li)
        g, v, b, x0 = (torch.from_numpy(s * rng.standard_normal(
            (n, 3)).astype(np.float32)).to(sc.device)
            for s in (1.0, 1.0, 1.0, 0.1))
        errs, t_parts = spmv_t_shape(rows, label, li, vals, op.mask, tt,
                                     op.diag_slot, g, reps)
        if label == "74k":             # ell_spmv_t alone
            log(f"phase9 backward {label:4s} level {li} N {n} K {k} Kt {kt} "
                f"max rel |d| " + " ".join(f"{c} {e:.2e}"
                                           for c, e in errs.items())
                + "; same bits twice")
            log(f"phase9 time     {label:4s} level {li}: "
                + "  ".join(t_parts))
            continue
        if (label, li) == ("21k", 1):  # exp2's coarse solve: its forward
            forms1, jacobi_err = jacobi_forms("phase9", label, li, op, vals,
                                              b, x0, reps)
            jacobi_rows = [dict(beam=label, level=li, n=n, form=form, **e)
                           for form, e in forms1.items()]
        kern = {
            "outer": (lambda: ek.outer(g, op.nbr, op.mask, v),
                      lambda: ek.outer_plain(g, op.nbr, op.mask, v)),
        }
        # ell_jacobi_bwd in one launch: no values' gradient; the whole
        # values' gradient row from x_t and from the zero start (x_t not read)
        for form, (with_gv, from_xt) in JACOBI_BWD_FORMS.items():
            xt = v if from_xt else None
            kern[f"jacobi_bwd {form}"] = (
                lambda xt=xt, w=with_gv: _bwd_outputs(
                    ek.jacobi_bwd, vals, op, g, b, xt, w),
                lambda xt=xt, w=with_gv: _bwd_outputs(
                    ek.jacobi_bwd_plain, vals, op, g, b, xt, w))
        for case, (kf, pf) in kern.items():
            got, again, ref = kf(), kf(), pf()
            torch.cuda.synchronize()
            err, scale = max_err(got, ref), float(ref.abs().max())
            check(torch.equal(got, again), f"{case} {label} level {li}: two "
                  "runs differ")
            if case.startswith("jacobi_bwd") and "no gv" not in case:
                # the off-diagonal slots: the bits of the ell_outer launch
                # the parent's adjoint made after ell_jacobi_bwd
                two = _outer_composition(got, vals, op, b,
                                         None if "zero" in case else v)
                check(torch.equal(got, two), f"{case} {label} level {li}: "
                      "not the bits of ell_outer's off-diagonal slots")
            check(err <= 1e-5 * scale, f"{case} {label} level {li}: max|d| "
                  f"{err:.3e} > 1e-5 * {scale:.3e}")
            name = case.split()[0]
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            errs[case] = err / scale
        # the Functions (the kernels) against autograd of the plain forwards
        fn_err = 0.0
        spmv_k = lambda V, X: ek.spmv(V, op.nbr, op.mask, X)
        spmv_p = lambda V, X: ek.spmv_plain(V, op.nbr, op.mask, X)
        pairs = [(spmv_k, spmv_p, [vals, v])]
        for its in (1, 3):
            for start in (None, x0):
                pairs.append((
                    lambda V, B, X0, its=its: ek.jacobi(
                        V, op.nbr, op.mask, op.diag_slot, B, X0, its, tt),
                    lambda V, B, X0, its=its: ek.jacobi_plain(
                        V, op.nbr, op.mask, op.diag_slot, B, X0, its),
                    [vals, b, start]))
        for fk, fp, leaves in pairs:
            got, again = _grads(fk, leaves, g), _grads(fk, leaves, g)
            ref = _grads(fp, leaves, g)
            torch.cuda.synchronize()
            for a, a2, r in zip(got, again, ref):
                check(torch.equal(a, a2), f"backward {label} level {li}: "
                      "two runs differ")
                e = max_err(a, r) / float(r.abs().max())
                check(e <= 1e-5, f"backward {label} level {li}: max rel "
                      f"|d| {e:.3e} > 1e-5 against autograd of the plain "
                      "version")
                fn_err = max(fn_err, e)
        # times: the kernel (events; device us by the profiler), the plain
        # version and the bound (ell_spmv_t's: spmv_t_shape)
        timing = {
            "outer": (kern["outer"], "ell_outer_kernel", outer_bound(n, k)),
        }
        # the forms of the one-launch adjoint: no values' gradient, with it
        # from x_t, with it from the zero start (exp2's path)
        for form, (with_gv, from_xt) in JACOBI_BWD_FORMS.items():
            def bwd(fn, with_gv=with_gv, from_xt=from_xt):
                return fn(vals, op.nbr, op.mask, op.diag_slot, b,
                          v if from_xt else None, g, torch.empty_like(g),
                          torch.empty_like(vals) if with_gv else None)
            timing[f"jacobi_bwd {form}"] = (
                (lambda bwd=bwd: bwd(ek.jacobi_bwd),
                 lambda bwd=bwd: bwd(ek.jacobi_bwd_plain)),
                "ell_jacobi_bwd_kernel",
                jacobi_bwd_bound(n, k, with_gv, from_xt))
        parts = list(t_parts)
        for case, ((kf, pf), kname, (b_ms, b_by)) in timing.items():
            name, _, form = case.partition(" ")
            ms = cuda_ms(kf, reps)
            us = device_us(kf, 10, kname)
            plain_ms = cuda_ms(pf, 3, warmup=1)
            entry = dict(ms=ms, device_us=us, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None)
            rows[name]["by_level"].append(dict(beam=label, level=li, n=n,
                                               form=form or None, **entry))
            if li == 0 and form in ("", JACOBI_BWD_PATH_FORM):
                rows[name]["by_beam"][label] = entry
            parts.append(f"{case} {ms:.4f} ms (device {us} us, plain "
                         f"{plain_ms:.3f}, bound {b_ms:.5f} {b_by})")
        log(f"phase9 backward {label:4s} level {li} N {n} K {k} Kt {kt} max "
            f"rel |d| " + " ".join(f"{c} {e:.2e}" for c, e in errs.items())
            + f"; Functions vs autograd of plain {fn_err:.2e}; same bits "
            "twice")
        log(f"phase9 time     {label:4s} level {li}: " + "  ".join(parts))
    return rows, jacobi_rows, jacobi_err


def exp2_steps(tr, steps, seed=0):
    """The first `steps` clamped-SGD steps of tr.train(steps, seed) by hand:
    [(loss, d loss / d w)] (for the card / CPU comparison)."""
    _, vids, deltas = tr.schedule(steps, seed)
    w, out = tr.w.detach().clone(), []
    for vid, d in zip(vids, deltas):
        x = tr.scene.x0.clone()
        x[int(vid)] += torch.from_numpy(d).to(x.device)
        total, _, _, g = tr.loss_and_grad(w, x)
        out.append((float(total), g.cpu()))
        w = torch.clamp(w - tr.cfg.lr * g, 0.0, 1.0)
    return out


def trace_step(step, reps=2):
    """(ms a call by events, device ops a call, device busy ms a call) of
    step() after a warm-up."""
    step()
    ms = cuda_ms(step, reps, warmup=1)
    ops = whole_trace(step, reps, 1)
    return (ms, sum(n for n, _ in ops.values()),
            sum(n * us for n, us in ops.values()) * 1e-3)


def phase9(sc21, sc2k, sc21_cpu, steps=10):
    """The learning path on the card, the block-ELL counters zeroed just
    before and read just after: exp2 and exp3 at the drivers' width
    (16x16x72), train_energy_gcn on the 2k beam; then exp2's first two
    steps on the CPU. exp2's one coarse Jacobi iteration from zero sends no
    gradient through A^T: ell_spmv_t is not on this path."""
    check(not torch.backends.cuda.matmul.allow_tf32
          and not torch.backends.cudnn.allow_tf32, "TF32 is on")
    results = {}
    torch.cuda.synchronize()
    ek.reset_launches()
    for name in ell.cuda_calls:
        ell.cuda_calls[name] = 0
    # exp2: both modes, both optimizers, l2, unroll 4. SGD at lr 1e-4: at
    # the default 1e-3 p_hat's clamped SGD leaves the coarse positions
    # degenerate at this beam in both packages (the JAX package's loss
    # 3.75 -> 6.7e10 at its second step)
    for mode in ("P", "p_hat"):
        for opt in ("sgd", "adam"):
            cfg = TrainInterpConfig(mode=mode, loss="l2", unroll=4,
                                    optimizer=opt,
                                    lr=1e-4 if opt == "sgd" else 1e-3)
            tr = ti.InterpTrainer(sc21, cfg)
            before = dict(ek.launches)
            hist, ms, wall = timed_run(tr.train, steps)
            used = {k: (ek.launches[k] - before[k]) / steps
                    for k in ("jacobi", "jacobi_bwd", "outer", "spmv_t")}
            check(bool(np.isfinite(hist).all()), f"exp2 {mode} {opt}: loss "
                  "not finite")
            # one ell_jacobi_bwd launch a cycle writes the whole values'
            # gradient: no ell_outer on this path
            check(used["outer"] == 0 and used["jacobi_bwd"] == cfg.unroll,
                  f"exp2 {mode} {opt}: launches a step {used}, want "
                  f"jacobi_bwd {cfg.unroll} and outer 0")
            w = tr.w
            check(float(w.min()) >= 0.0 and float(w.max()) <= 1.0,
                  f"exp2 {mode} {opt}: weights left [0, 1]")
            cmp = tr.compare(iterations=8)
            log(f"phase9 exp2 21k {mode:5s} {opt:4s} l2 unroll 4 {steps} "
                f"steps ms/step {ms:.2f} (host clock {wall:.2f})  loss "
                f"{hist[0]:.4e} -> {hist[-1]:.4e}  probe "
                f"{tr.history['probe_resid'][0]:.3e} -> "
                f"{tr.history['probe_resid'][-1]:.3e}  launches/step {used}"
                f"  compare(8) classic {cmp['classic'][-1]:.3e} trained "
                f"{cmp['trained'][-1]:.3e}")
            results[f"exp2 {mode} {opt}"] = dict(
                ms_per_step=ms, wall_ms_per_step=wall,
                loss_first=float(hist[0]), loss_last=float(hist[-1]),
                classic_last=float(cmp["classic"][-1]),
                trained_last=float(cmp["trained"][-1]))
    # where an exp2 step's time goes
    pins = np.nonzero(sc21.params["levels"][0]["pin_mask"].cpu().numpy())[0]
    xs = sc21.x0.clone()
    xs[int(pins[0])] += 1e-3
    tr = ti.InterpTrainer(sc21, TrainInterpConfig(mode="p_hat", loss="l2",
                                                  unroll=4))
    ms, n_ops, busy = trace_step(lambda: tr.loss_and_grad(tr.w, xs))
    # run-to-run spread of a whole gradient: torch's own gather backward
    # (index_add_ in ops.take_rows) adds with atomics on the card
    g1, g2 = (tr.loss_and_grad(tr.w, xs)[3] for _ in range(2))
    spread = max_err(g1, g2) / float(g1.abs().max())
    log(f"phase9 exp2 21k loss_and_grad (unroll 4) ms {ms:.2f}  device ops "
        f"{n_ops:.0f}  device busy {busy:.2f} ms  idle share "
        f"{1 - busy / ms:.3f}  two runs max|d grad| / max|grad| {spread:.3e}")
    results["exp2 step"] = dict(ms=ms, device_ops=n_ops, busy_ms=busy,
                                grad_spread=spread)

    # exp3 on the same beam
    cfg3 = TrainSolverConfig(frames=4)
    (xt, xsol, res), ms, wall = timed_run(
        lambda n: tsolve.generate_rollout(sc21, cfg3, seed=0), 1)
    check(bool(torch.isfinite(xsol).all()), "exp3 rollout not finite")
    log(f"phase9 exp3 21k generate_rollout 4 frames {ms:.1f} ms  ||f|| "
        f"{res.cpu().numpy().tolist()}")
    results["exp3 rollout"] = dict(ms=ms, res_inf=res.cpu().numpy().tolist())
    trainers = {}
    for name, kw, n_steps in (("MDN3 mse", dict(loss="mse"), 20),
                              ("MDN3 residual", dict(loss="residual"), 20),
                              ("MultiLevel3 mse", dict(loss="mse"), 5)):
        tr3 = tsolve.SolverNetTrainer(
            sc21, TrainSolverConfig(frames=4, **kw),
            multilevel=name.startswith("Multi"), predict_delta=True)
        t0 = time.perf_counter()
        losses = tr3.train(n_steps, frames=4)
        wall = time.perf_counter() - t0
        check(bool(np.isfinite(losses).all()), f"exp3 {name}: not finite")
        log(f"phase9 exp3 21k {name:16s} {n_steps} Adam steps (with its "
            f"4-frame rollout) {wall:.2f} s  loss {losses[0]:.3e} -> "
            f"{losses[-1]:.3e}")
        results[f"exp3 {name}"] = dict(seconds=wall,
                                       loss_first=float(losses[0]),
                                       loss_last=float(losses[-1]))
        trainers[name] = tr3
    tr3 = trainers["MDN3 mse"]
    opt = torch.optim.Adam(tr3.model.parameters(), lr=1e-3)

    def mdn3_step():
        opt.zero_grad(set_to_none=True)
        tr3.loss_fn(xt[1], xsol[1]).backward()
        opt.step()
    ms, n_ops, busy = trace_step(mdn3_step)

    def mdn3_grads():
        tr3.model.zero_grad(set_to_none=True)
        tr3.loss_fn(xt[1], xsol[1]).backward()
        return torch.cat([p.grad.reshape(-1)
                          for p in tr3.model.parameters()])
    g1, g2 = mdn3_grads(), mdn3_grads()
    spread3 = max_err(g1, g2) / float(g1.abs().max())
    log(f"phase9 exp3 21k MDN3 Adam step ms {ms:.2f}  device ops {n_ops:.0f}"
        f"  device busy {busy:.2f} ms  idle share {1 - busy / ms:.3f}  two "
        f"runs max|d grad| / max|grad| {spread3:.3e}")
    results["exp3 step"] = dict(ms=ms, device_ops=n_ops, busy_ms=busy,
                                grad_spread=spread3)
    one_shot = tr3.evaluate_residual(xt[-1])
    st = tr3.learned_step(dynamic.init_state(sc21))
    check(np.isfinite(one_shot) and bool(torch.isfinite(st.x).all()),
          "exp3 evaluate_residual / learned_step not finite")
    stats = tr3.warmstart_stats(frames=4)
    check(bool((stats["fn_plain"] <= TOL).all()), "warmstart: plain solves "
          f"missed tol {stats['fn_plain']}")
    log(f"phase9 exp3 21k evaluate_residual {one_shot:.3e}  warmstart 4 "
        f"frames newton plain {stats['k_plain'].tolist()} warm "
        f"{stats['k_warm'].tolist()}  ms/frame plain {stats['ms_plain']:.2f}"
        f" warm {stats['ms_warm']:.2f}")
    results["exp3 warmstart"] = dict(
        k_plain=stats["k_plain"].tolist(), k_warm=stats["k_warm"].tolist(),
        ms_plain=stats["ms_plain"], ms_warm=stats["ms_warm"])
    _, energies = tsolve.train_energy_gcn(sc2k, iterations=10)
    check(bool(np.isfinite(energies).all()) and energies[-1] < energies[0],
          f"train_energy_gcn: energy {energies[0]:.4e} -> {energies[-1]:.4e}")
    log(f"phase9 train_energy_gcn 2k 10 steps energy {energies[0]:.6e} -> "
        f"{energies[-1]:.6e}")
    torch.cuda.synchronize()
    launches, calls = dict(ek.launches), dict(ell.cuda_calls)
    log(f"phase9 kernel launches {launches}, asked for by the calls on CUDA "
        f"tensors {calls}")
    log_jacobi_shapes("phase9")
    check(launches == calls, f"launches {launches} != those the calls on "
          f"CUDA tensors ask for {calls}")
    for name in ("jacobi_bwd", "jacobi", "spmv"):
        check(launches[name] > 0, f"{name} never launched on the learning "
              f"path: {launches}")
    check(launches["spmv_t"] == 0 and not ek.spmv_t_launches, "ell_spmv_t "
          "launched on the learning path, whose gradient needs no A^T: "
          f"{launches}, by (rows, form) {ek.spmv_t_launches}")
    check(launches["outer"] == 0, "ell_outer launched on the learning path, "
          f"whose Jacobi adjoint writes the values' gradient: {launches}")

    # exp2's first two SGD steps on the card and on the CPU
    cfg = TrainInterpConfig(mode="P", loss="l2", unroll=4, lr=1e-4)
    t0 = time.perf_counter()
    gpu = exp2_steps(ti.InterpTrainer(sc21, cfg), 2)
    cpu = exp2_steps(ti.InterpTrainer(sc21_cpu, cfg), 2)
    dl = max(abs(a[0] - c[0]) / abs(c[0]) for a, c in zip(gpu, cpu))
    dg = max(max_err(a[1], c[1]) / float(c[1].abs().max())
             for a, c in zip(gpu, cpu))
    log(f"phase9 exp2 21k P first 2 SGD steps card / CPU: loss "
        f"{[a[0] for a in gpu]} / {[c[0] for c in cpu]}  max rel |d loss| "
        f"{dl:.3e}  max|d grad| / max|grad| {dg:.3e}  "
        f"({time.perf_counter() - t0:.1f} s)")
    check(dl <= 1e-3, f"exp2 card vs CPU: loss differs by {dl:.3e} relative")
    check(dg <= 1e-3, f"exp2 card vs CPU: gradient differs by {dg:.3e} of "
          "its max")
    results["exp2 card vs cpu"] = dict(loss_rel=dl, grad_rel=dg)
    return results, launches


# -- phase 10 ----------------------------------------------------------------

def slab_frames(step, blockify, slabs, sc, n):
    """n frames of a distributed lattice step from rest: (Newton counts,
    exit norms, x after every frame, (x, v) before every frame), the fields
    whole."""
    xb = blockify(sc.x0)
    vb = blockify(torch.zeros_like(sc.x0))
    ks, fns, xs, ins = [], [], [], []
    for _ in range(n):
        ins.append((slabs.gather(xb), slabs.gather(vb)))
        xb, vb, k, fn = step(xb, vb)
        ks.append(k)
        fns.append(fn)
        xs.append(slabs.gather(xb))
    return ks, fns, xs, ins


def within_policy(a, b) -> bool:
    """||f||_inf a within 1e-3 relative + 5e-6 of b."""
    return abs(a - b) <= 1e-3 * abs(b) + 5e-6


def check_policy(label, ks, fns, xs, ks1, fns1, xs1):
    """The float32 policy of the port's parity tests, frame by frame: equal
    Newton counts, ||f||_inf within 1e-3 relative + 5e-6, x within 1e-4.
    Each reference frame starts from the state the checked run gave that
    frame (a float32 trajectory drifts, and near the tolerance a drifted
    state can take one Newton iteration more). Returns (max |d fn|,
    max |d x|)."""
    check(list(ks) == list(ks1), f"{label}: Newton {ks} vs {ks1}")
    dfn = max(abs(a - b) for a, b in zip(fns, fns1))
    for a, b in zip(fns, fns1):
        check(within_policy(a, b), f"{label}: ||f|| {a:.6e} vs {b:.6e}")
    dx = max(float((torch.as_tensor(a).cpu() - torch.as_tensor(b).cpu())
                   .abs().max()) for a, b in zip(xs, xs1))
    check(dx <= 1e-4, f"{label}: max|d x| {dx:.3e} > 1e-4")
    return dfn, dx


def reference_frames(step, ins):
    """(Newton counts, exit norms, x) of step(x, v) from each input."""
    out = ([], [], [])
    for x, v in ins:
        for lst, val in zip(out, step(x, v)):
            lst.append(val)
    return out


def _x_of(inputs):
    """x of a frame's inputs ((x, v) or a state), on the host."""
    x = inputs[0] if isinstance(inputs, tuple) else inputs.x
    return torch.as_tensor(x).cpu()


def trajectory_policy(label, got, ref, norm_at):
    """Two runs of the same frames from rest, each on its own trajectory:
    got and ref are (Newton counts, exit norms, x after every frame, the
    inputs of every frame). x within 1e-4 at every frame. A frame where the
    Newton counts differ or ||f||_inf is outside 1e-3 relative + 5e-6 is
    taken apart with norm_at(code, inputs, j): ||f||_inf after j Newton
    iterations of that frame run again from `inputs` by the checked code
    ("got") or the reference's ("ref"). With k the smaller count: the
    reference's code on the checked run's input gives the checked run's
    norms within the ||f|| policy after every iteration up to k (the two
    codes agree on one input, so the difference comes from the inputs),
    where the counts differ the run that stopped at k is at or under tol
    and the other above it, and the inputs are within 1e-4. Logs the norms
    and the inputs' distance in ulps of max |x|. Returns (max|d x|, the
    frames taken apart)."""
    ks, fns, xs, ins = got
    ks1, fns1, xs1, ins1 = ref
    check(len(ks) == len(ks1), f"{label}: {len(ks)} vs {len(ks1)} frames")
    tol32 = np.float32(TOL)
    apart = []
    for i in range(len(ks)):
        if ks[i] == ks1[i] and within_policy(fns[i], fns1[i]):
            continue
        k = min(ks[i], ks1[i])
        a = [norm_at("got", ins[i], j) for j in range(k + 1)]
        b = [norm_at("ref", ins1[i], j) for j in range(k + 1)]
        c = [norm_at("ref", ins[i], j) for j in range(k + 1)]
        stopped, went_on = (a[k], b[k]) if ks[i] == k else (b[k], a[k])
        converged = (ks[i] == ks1[i] or np.float32(stopped) <= tol32
                     < np.float32(went_on))
        same_code = all(within_policy(u, w) for u, w in zip(c, a))
        xa, xb = _x_of(ins[i]), _x_of(ins1[i])
        dx_in = max_err(xa, xb)
        ulp = float(np.spacing(np.float32(xa.abs().max())))
        log(f"{label} frame {i + 1}: Newton {ks[i]} vs {ks1[i]}; inputs "
            f"max|d x| {dx_in:.3e} ({dx_in / ulp:.2f} ulp of max|x|); "
            f"||f|| after 0..{k} iterations " + " ".join(
                f"{v:.9e}" for v in a) + " vs " + " ".join(
                f"{v:.9e}" for v in b) + " (tol "
            f"{float(tol32):.9e}); the reference's code on the checked "
            "input " + " ".join(f"{v:.9e}" for v in c))
        check(converged and same_code and dx_in <= 1e-4,
              f"{label} frame {i + 1}: Newton {ks[i]} vs {ks1[i]}: stopped "
              f"at tol {converged}, one code on one input {same_code}, "
              f"inputs max|d x| {dx_in:.3e}")
        apart.append(dict(frame=i + 1, newton=[ks[i], ks1[i]],
                          input_max_d_x=dx_in, input_ulps=dx_in / ulp,
                          fn=[a, b], ref_code_on_checked_input=c))
    dx = max(float((torch.as_tensor(a).cpu() - torch.as_tensor(b).cpu())
                   .abs().max()) for a, b in zip(xs, xs1))
    check(dx <= 1e-4, f"{label}: trajectory max|d x| {dx:.3e} > 1e-4")
    return dx, apart


# -- phase 11 ----------------------------------------------------------------

SHELL11 = (64, 64, 64)        # mesh.shell(64, 64, 64, thickness=2)
COVER_MODES = {"force": "force_cover", "energy": "energy_cover",
               "fused_newton": "fused_newton_cover"}


class FrameIn(NamedTuple):
    """A frame's input: its state (x first, as _x_of reads it) and index."""
    x: torch.Tensor
    st: object
    frame: int


def shell_bounds(sc, k_newton):
    """lattice_bounds on the real cells and vertices only: the same work for
    the covered and the dense kernels."""
    n = float(sc.vert_mask.sum())
    c = float(sc.cell_mask.sum())
    field = 3 * n * 4
    return {
        "force": bound(2 * field + 4 * c, c * lk.FORCE_FLOPS_PER_CELL),
        "energy": bound(field + 4 * c + 4, c * ENERGY_FLOPS_PER_CELL),
        "fused_newton": bound(4 * field + 3 * n * 4 + 4 * c + 8, c * (
            2 * lk.FORCE_FLOPS_PER_CELL + lk.DIAG_FLOPS_PER_CELL
            + (k_newton - 1) * lk.HVP_FLOPS_PER_CELL)),
    }


def _ops_us(fn, launches):
    """Device us of one call of fn (every device op of a call summed) and
    the ops a call launches."""
    ops = whole_trace(fn, 20, launches)
    return (round(sum(n * t for n, t in ops.values()), 2),
            round(sum(n for n, _ in ops.values())))


def phase11_kernels(sc, rows):
    """The three cover modes on the 64^3 shell against their plain cover
    versions and the dense kernels (the same wrappers without the cover);
    times and bounds. Returns an entry a mode for the rows'
    by_path_shape."""
    cov = sc.cover
    sms = lk._sms(sc.x0.device.index)
    rng = np.random.default_rng(11)
    vm3 = sc.vert_mask[..., None]
    u = torch.from_numpy(0.03 * rng.standard_normal(sc.x0.shape).astype(
        np.float32)).to(sc.x0.device) * vm3
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    cm = sc.cell_mask
    shape = list(sc.shape)
    out = {}
    # lat_force in both modes, each against the dense kernel in that mode
    dense_key = (str(u_cf.device),) + tuple(sc.shape)
    own = lk._cover_plan(cov, "force", sc.x0.device)
    tiles = lk.best_force_tiling(*sc.shape, sms, cover=cov)
    saved = lk._force_plans.get(dense_key)
    for mode, plan in (("two passes", lk.FORCE_TWO_PASS),
                       ("active tiles", tiles)):
        cov.plans[("force", sms)] = plan
        lk._force_plans[dense_key] = (plan if plan == lk.FORCE_TWO_PASS else
                                      lk.force_tiling(sc.shape, plan[1:4]))

        def kern():
            return lk.force_cf(u_cf, cm, DX, MU, LA, cover=cov)

        def whole():
            return lk.force_cf(u_cf, cm, DX, MU, LA)
        got, again, ref_d = kern(), kern(), whole()
        ref = lk.force_cf_plain(u_cf, cm, DX, MU, LA, cover=cov)
        torch.cuda.synchronize()
        err, scale = max_err(got, ref), float(ref.abs().max())
        check(err <= 1e-5 * scale, f"phase11 force cover ({mode}): max|d| "
              f"{err:.3e} > 1e-5 * {scale:.3e}")
        check(bool(torch.equal(got, again)), f"phase11 force cover ({mode}):"
              " two runs differ")
        check(bool(torch.equal(got, ref_d)), f"phase11 force cover ({mode}):"
              " differs from the dense kernel beyond the sign of zero")
        two = plan == lk.FORCE_TWO_PASS
        us, nops = _ops_us(kern, 2 if two else 1)
        us_d, _ = _ops_us(whole, 2 if two else 1)
        ms, ms_d = cuda_ms(kern, 20), cuda_ms(whole, 20)
        plain_ms = cuda_ms(lambda: lk.force_cf_plain(u_cf, cm, DX, MU, LA,
                                                     cover=cov), 3, warmup=1)
        b_ms, b_by = shell_bounds(sc, 1)["force"]
        n_active = (None if two else cov.tiles(*plan[1:4])[1])
        out[f"force {mode}"] = dict(
            wrapper="force_cf", cover_mode=mode, shape=shape,
            plan=_plan_text(plan), active_tiles=n_active,
            max_abs_err=err, max_ref=scale, equal_to_dense=True,
            device_us=us, dense_device_us=us_d, ops_per_call=nops, ms=ms,
            dense_ms=ms_d, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
            main_path=plan == own)
        rows["force"]["max_abs_err"] = max(rows["force"]["max_abs_err"], err)
        log(f"phase11 force cover {mode:12s} plan {_plan_text(plan)}"
            + ("" if two else f" ({n_active} active of {plan[0]})")
            + f"  max|d| {err:.3e} (max|ref| {scale:.3e}); same bits twice;"
            f" equal to the dense kernel up to the sign of zero; device us "
            f"{us} vs dense {us_d}; events ms {ms:.4f} vs {ms_d:.4f}; plain "
            f"{plain_ms:.3f}; bound {b_ms * 1e3:.2f} us ({b_by})")
    cov.plans[("force", sms)] = own
    if saved is None:
        lk._force_plans.pop(dense_key, None)
    else:
        lk._force_plans[dense_key] = saved

    # lat_energy over the real cells
    def ekern():
        return lk.elastic_energy_lattice(u, cm, DX, MU, LA, cover=cov)

    def ewhole():
        return lk.elastic_energy_lattice(u, cm, DX, MU, LA)
    got, again, ref_d = ekern(), ekern(), ewhole()
    ref = lk.elastic_energy_lattice_plain(u, cm, DX, MU, LA, cover=cov)
    torch.cuda.synchronize()
    err, scale = max_err(got, ref), float(ref.abs())
    check(err <= 1e-5 * scale and max_err(got, ref_d) <= 1e-5 * scale,
          f"phase11 energy cover: |d| {err:.3e} / {max_err(got, ref_d):.3e}"
          f" > 1e-5 * {scale:.3e}")
    check(bool(torch.equal(got, again)), "phase11 energy cover: two runs "
          "differ")
    us, _ = _ops_us(ekern, 1)
    us_d, _ = _ops_us(ewhole, 1)
    ms, ms_d = cuda_ms(ekern, 20), cuda_ms(ewhole, 20)
    plain_ms = cuda_ms(lambda: lk.elastic_energy_lattice_plain(
        u, cm, DX, MU, LA, cover=cov), 3, warmup=1)
    b_ms, b_by = shell_bounds(sc, 1)["energy"]
    grid, lanes = lk._cover_plan(cov, "energy", sc.x0.device)
    out["energy"] = dict(
        wrapper="elastic_energy_lattice", cover_mode="real cells",
        shape=shape, plan=f"grid {grid} lanes {lanes}",
        dense_plan="grid {} lanes {}".format(*lk.energy_plan(*sc.shape,
                                                             sms)),
        max_abs_err=err, max_ref=scale, dense_abs_d=max_err(got, ref_d),
        device_us=us, dense_device_us=us_d, ms=ms, dense_ms=ms_d,
        plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
    rows["energy"]["max_abs_err"] = max(rows["energy"]["max_abs_err"], err)
    log(f"phase11 energy cover   {grid} blocks over {cov.cells.size} real "
        f"cells: |d| {err:.3e} vs plain, {max_err(got, ref_d):.3e} vs the "
        f"dense kernel (|ref| {scale:.6e}); same bits twice; device us {us} "
        f"vs dense {us_d}; events ms {ms:.4f} vs {ms_d:.4f}; plain "
        f"{plain_ms:.3f}; bound {b_ms * 1e3:.2f} us ({b_by})")

    # lat_fused_newton over the active tiles
    args = newton_inputs(sc, rng)
    dxk, fk, fnk, kk = lk.fused_newton(*args, cover=cov)
    dx2, f2, fn2, k2 = lk.fused_newton(*args, cover=cov)
    dxd, fd, fnd, kd = lk.fused_newton(*args)
    dxp, fp, fnp, kp = lk.fused_newton_plain(*args, cover=cov)
    torch.cuda.synchronize()
    kk, kd, kp = int(kk), int(kd), int(kp)
    fscale = float(fp.abs().max())
    e_f, e_dx = max_err(fk, fp), max_err(dxk, dxp)
    check(bool(torch.equal(dxk, dx2) and torch.equal(fk, f2))
          and float(fnk) == float(fn2), "phase11 fused_newton cover: two "
          "runs differ")
    check(e_f <= 1e-5 * fscale, f"phase11 fused_newton cover: f max|d| "
          f"{e_f:.3e} > 1e-5 * {fscale:.3e}")
    check(bool(torch.equal(fk, fd)), "phase11 fused_newton cover: f differs"
          " from the dense kernel's beyond the sign of zero")
    check(abs(kk - kp) <= 1 and abs(kk - kd) <= 1 and kk > 2,
          f"phase11 fused_newton cover: k {kk} vs plain {kp}, dense {kd}")
    for name, dref, fnref, kref in (("plain", dxp, fnp, kp),
                                    ("dense", dxd, fnd, kd)):
        tol_ = 1e-3 if kk == kref else 5e-2
        check(max_err(dxk, dref) <= tol_ * float(dref.abs().max())
              and abs(float(fnk) - float(fnref)) <= tol_ * max(
                  fscale, abs(float(fnref))),
              f"phase11 fused_newton cover vs {name}: dx max|d| "
              f"{max_err(dxk, dref):.3e}, fn {float(fnk):.6e} vs "
              f"{float(fnref):.6e}")
    plan = lk._cover_plan(cov, "newton", sc.x0.device)
    dplan = lk._newton_plan(_cuda.load(), *sc.shape, sc.x0.device)
    # under the dense plan's tiles and grid the cover gives the dense bits:
    # the vertex-pass dots are summed a tile at a time
    same = bool(torch.equal(dxk, dxd)) and float(fnk) == float(fnd)
    check(same or plan != dplan, "phase11 fused_newton cover: the dense "
          "plan, but not the dense kernel's bits")
    n_active = cov.tiles(*plan[1:4])[1]
    us = device_us(lambda: lk.fused_newton(*args, cover=cov), 10,
                   "fused_newton_kernel<false>")
    us_d = device_us(lambda: lk.fused_newton(*args), 10,
                     "fused_newton_kernel<false>")
    ms = cuda_ms(lambda: lk.fused_newton(*args, cover=cov), 5)
    ms_d = cuda_ms(lambda: lk.fused_newton(*args), 5)
    plain_ms = cuda_ms(lambda: lk.fused_newton_plain(*args, cover=cov), 3,
                       warmup=1)
    b_ms, b_by = shell_bounds(sc, kk)["fused_newton"]
    out["fused_newton"] = dict(
        wrapper="fused_newton", cover_mode="active tiles", shape=shape,
        plan=_plan_text(plan), active_tiles=n_active,
        dense_plan=_plan_text(dplan), k=[kk, kp, kd], max_abs_err=e_dx,
        bit_equal_to_dense=same,
        f_max_abs_err=e_f, max_ref=float(dxp.abs().max()), device_us=us,
        dense_device_us=us_d, ms=ms, dense_ms=ms_d, plain_ms=plain_ms,
        bound_ms=b_ms, bound_by=b_by)
    rows["fused_newton"]["max_abs_err"] = max(
        rows["fused_newton"]["max_abs_err"], e_dx)
    log(f"phase11 fused_newton cover plan {_plan_text(plan)} ({n_active} "
        f"active of {plan[1] * plan[2] * plan[3]}; dense {_plan_text(dplan)})"
        f"  k {kk} vs plain {kp}, dense {kd}; max|d f| {e_f:.3e} (max|f| "
        f"{fscale:.3e}), f equal to the dense kernel's"
        + ("; dx, fn bit-equal to the dense kernel's" if same else "")
        + f"; max|d dx| {e_dx:.3e} vs plain;"
        f" same bits twice; device us {us} vs dense {us_d}; events ms "
        f"{ms:.4f} vs {ms_d:.4f}; plain {plain_ms:.3f}; bound "
        f"{b_ms * 1e3:.2f} us ({b_by})")
    return out


def shell_frames(sc, n):
    """n frames of phase 2's protocol from rest: (Newton counts, exit norms,
    x after each frame, each frame's input)."""
    st = sc.init_state()
    ks, fns, xs, ins = [], [], [], []
    for i in range(n):
        ins.append(FrameIn(st.x, st, i))
        st, k, fn = tlat.step_to_tol(sc, st, tol=TOL, max_newton=20,
                                     cg_iterations=60, cg_tol=1e-2,
                                     gravity_scale=gravity_scale(i))
        ks.append(k)
        fns.append(fn)
        xs.append(st.x)
    return ks, fns, xs, ins


def phase11(rows):
    """The low-fill path on the 64^3 shell: the cover, its kernels, then the
    covered frames and solve (counters zeroed) against the dense ones."""
    t0 = time.perf_counter()
    mesh = meshlib.shell(*SHELL11, thickness=2, dx=DX)
    sc = tlat.LatticeScene(mesh, device="cuda")
    dense = tlat.LatticeScene(mesh, device="cuda", use_boxes=False)
    cov = sc.cover
    check(cov is not None and dense.cover is None, "phase11: the cover did "
          f"not engage on the 64^3 shell (ratio {sc.box_cost_ratio:.3f})")
    sms = lk._sms(sc.x0.device.index)
    nplan = lk._cover_plan(cov, "newton", sc.x0.device)
    res = dict(shape=list(sc.shape), real_cells=int(cov.cells.size),
               cells=cov.grid_cells,
               real_vertices=int(sc.vert_mask.sum()),
               box_cost_ratio=sc.box_cost_ratio,
               newton_active_tiles=cov.tiles(*nplan[1:4])[1],
               newton_tiles=nplan[1] * nplan[2] * nplan[3],
               force_plan=_plan_text(lk._cover_plan(cov, "force",
                                                    sc.x0.device)),
               energy_plan=list(lk._cover_plan(cov, "energy", sc.x0.device)))
    log(f"phase11 shell {SHELL11} lattice {sc.shape}: {cov.cells.size} real "
        f"cells of {cov.grid_cells} "
        f"({cov.cells.size / cov.grid_cells:.3f}), "
        f"{res['real_vertices']} real vertices; box_cost_ratio "
        f"{sc.box_cost_ratio:.4f} (engaged below 0.5); fused_newton plan "
        f"{_plan_text(nplan)}: {res['newton_active_tiles']} active tiles of "
        f"{res['newton_tiles']}; force {res['force_plan']}; energy "
        f"{res['energy_plan']} on {sms} SMs (scenes built in "
        f"{time.perf_counter() - t0:.1f} s)")
    res["kernels"] = phase11_kernels(sc, rows)

    def solve(scene):
        return tlat.quasistatic_to_tol(scene, scene.x0, tol=TOL,
                                       max_newton=100)
    for scene in (sc, dense):         # warm-up before the counters start
        shell_frames(scene, 2)
        solve(scene)
    torch.cuda.synchronize()
    lk.reset_launches()
    runs = {}
    for label, scene in (("covered", sc), ("dense", dense)):
        if label == "dense":
            torch.cuda.synchronize()
            counts = dict(lk.launches)
        (got, ms, wall) = timed_run(lambda n: shell_frames(scene, n), FRAMES)
        (xq, kq, fq), ms_q, wall_q = timed_run(lambda n: solve(scene), 1)
        ks, fns = np.array(got[0]), np.array(got[1])
        check(bool(np.all(fns <= TOL * 1.01)), f"phase11 {label}: tolerance "
              f"missed, max fn {fns.max():.3e}")
        check(bool(torch.isfinite(xq).all()) and fq <= TOL,
              f"phase11 {label} quasistatic: ||f|| {fq:.3e}")
        runs[label] = dict(got=got, xq=xq)
        res[label] = dict(ms_per_frame=ms, wall_ms_per_frame=wall,
                          newton=ks.tolist(), newton_mean=float(ks.mean()),
                          fn_max=float(fns.max()), quasistatic=dict(
                              ms=ms_q, wall_ms=wall_q, newton=kq, fn=fq))
        log(f"phase11 {label:7s} 48 frames: ms/frame {ms:.3f} (host clock "
            f"{wall:.3f}) newton_mean {ks.mean():.3f} max {ks.max()} fn_max "
            f"{fns.max():.3e}; quasistatic_to_tol ms/solve {ms_q:.2f} (host "
            f"clock {wall_q:.2f}) newton {kq} ||f|| {fq:.3e}")
    log(f"phase11 launches (covered path) {counts}")
    got = runs["covered"]["got"]
    newton = sum(got[0]) + res["covered"]["quasistatic"]["newton"]
    check(counts["fused_newton_cover"] == newton, f"phase11: "
          f"fused_newton_cover {counts['fused_newton_cover']} != Newton "
          f"{newton}")
    check(counts["force_cover"] >= FRAMES, "phase11: force_cover launches "
          f"{counts['force_cover']} < {FRAMES}")
    for name in ("fused_newton", "force", "energy", "hvp", "diag"):
        check(counts[name] == 0, f"phase11: the covered path launched the "
              f"dense {name} {counts[name]} times")

    # the covered run against the dense code: frame by frame from its own
    # inputs, then the two trajectories from rest
    def dense_step(inp, _):
        st, k, fn = tlat.step_to_tol(dense, inp.st, tol=TOL, max_newton=20,
                                     cg_iterations=60, cg_tol=1e-2,
                                     gravity_scale=gravity_scale(inp.frame))
        return k, fn, st.x
    dfn, dxf = check_policy("phase11 covered vs dense, frame by frame",
                            *got[:3], *reference_frames(
                                dense_step, [(inp, None) for inp in got[3]]))

    def norm_at(code, inp, j):
        return tlat.step_to_tol(sc if code == "got" else dense, inp.st,
                                tol=TOL, max_newton=j, cg_iterations=60,
                                cg_tol=1e-2,
                                gravity_scale=gravity_scale(inp.frame))[2]
    tx, apart = trajectory_policy("phase11 covered vs dense trajectory", got,
                                  runs["dense"]["got"], norm_at)
    dq = max_err(runs["covered"]["xq"], runs["dense"]["xq"])
    check(dq <= 1e-4, f"phase11 quasistatic covered vs dense: max|d x| "
          f"{dq:.3e}")
    res.update(max_d_fn=dfn, max_d_x_frames=dxf, trajectory_max_d_x=tx,
               taken_apart=apart, quasistatic_max_d_x=dq,
               launches={k: v for k, v in counts.items() if v})
    log(f"phase11 covered vs dense: frame by frame Newton equal, max|d fn| "
        f"{dfn:.3e} max|d x| {dxf:.3e}; trajectory max|d x| {tx:.3e}, "
        f"{len(apart)} frames taken apart; quasistatic max|d x| {dq:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    for name, cname in COVER_MODES.items():
        for key, entry in res["kernels"].items():
            if key.split()[0] == name and entry.get("main_path", True):
                entry["launches"] = counts[cname]
            elif key.split()[0] == name:
                entry["launches"] = 0
            if key.split()[0] == name:
                rows[name].setdefault("by_path_shape", []).append(
                    dict(phase=11, **entry))
    return res, counts


def _diag6_plain(x_cf, cell_mask, dx, mu, la):
    return lk.sym_channels(lk.hess_diag_lattice_plain(
        x_cf.permute(1, 2, 3, 0), cell_mask, dx, mu, la))


def _power_plain(u_cf, d6, ctrl, vert_mask, cell_mask, dx, mu, la, out=None,
                 slot=0, iters=6):
    return lk.power_lmax_cf_plain(u_cf, d6, ctrl, vert_mask, cell_mask, dx,
                                  mu, la, iters=iters)


# the wrappers that phase 10's main path calls: (module, attribute, the
# kernel's row in the kernels line, its plain version on the same arguments,
# the tolerance on max|d| / max|ref|: 1e-5 for the field operators, 1e-4
# for lat_cheby's and lat_power's recurrences (as phase 7) and for the
# energy, a sum over every cell (as phase 1))
PATH_WRAPPERS = (
    (lk, "force_cf", "force", lk.force_cf_plain, 1e-5),
    (lk, "hvp_cf", "hvp", lk.hvp_cf_plain, 1e-5),
    (lk, "level_matvec_cf", "hvp", lk.level_matvec_cf_plain, 1e-5),
    (lk, "hess_diag6_cf", "diag", _diag6_plain, 1e-5),
    (lk, "hess_diag_shift_cf", "diag_shift", lk.hess_diag_shift_cf_plain,
     1e-5),
    (lk, "cheby_smooth_cf", "cheby", lk.cheby_smooth_cf_plain, 1e-4),
    (lk, "power_lmax_cf", "power", _power_plain, 1e-4),
    (lk, "elastic_energy_lattice", "energy", lk.elastic_energy_lattice_plain,
     1e-4),
    (ek, "_spmv_rows", "spmv", ek.spmv_rows_plain, 1e-5),
)
# floats after each float input in its copy: a read past the end shows
SENTINEL = 4096


def _describe(a):
    if torch.is_tensor(a):
        return ("t",) + tuple(a.shape)
    if isinstance(a, (list, tuple, np.ndarray)):
        return ("seq", len(a))
    return a


def _fenced(a):
    """A copy of a CUDA tensor; a float one in a buffer that goes on with
    SENTINEL NaNs."""
    if not torch.is_tensor(a):
        return a
    if not a.is_floating_point():
        return a.detach().clone()
    buf = torch.full((a.numel() + SENTINEL,), float("nan"), dtype=a.dtype,
                     device=a.device)
    out = buf[:a.numel()].view(a.shape)
    out.copy_(a)
    return out


class PathCapture:
    """While started, records the arguments of a call of each wrapper in
    PATH_WRAPPERS at each distinct signature (shapes, scalars, the length
    of a coefficient list) on CUDA tensors, as copies: the first call whose
    first argument (the displacement, or the SpMV's values) is not all zero,
    else the first call (at rest the force and the energy are zero on both
    sides). The call itself goes on unchanged (it launches and counts as
    before). check() then runs each wrapper's kernel and plain version on
    the copies."""

    def __init__(self):
        self.calls = {}
        self.saved = []

    def start(self):
        for mod, attr, row, plain, rtol in PATH_WRAPPERS:
            orig = getattr(mod, attr)
            self.saved.append((mod, attr, orig))
            setattr(mod, attr, self._wrap(orig, attr, row, plain, rtol))

    def stop(self):
        for mod, attr, orig in reversed(self.saved):
            setattr(mod, attr, orig)
        self.saved = []

    def _wrap(self, orig, attr, row, plain, rtol):
        def wrapper(*args, **kwargs):
            if any(torch.is_tensor(a) and a.is_cuda for a in args):
                key = ((attr,) + tuple(_describe(a) for a in args)
                       + tuple((k, _describe(v))
                               for k, v in sorted(kwargs.items())))
                if key not in self.calls or (
                        self.calls[key][7] and bool(args[0].any())):
                    self.calls[key] = (
                        attr, orig, row, plain, rtol,
                        tuple(_fenced(a) for a in args),
                        {k: _fenced(v) for k, v in kwargs.items()},
                        not bool(args[0].any()))
            return orig(*args, **kwargs)
        return wrapper

    def shapes(self, attr):
        """The vertex grids (or (N, K, r0, r1) of the SpMV) `attr` ran at."""
        return {_grid_of(attr, c[5]) for c in self.calls.values()
                if c[0] == attr}

    def check(self, rows):
        """Every recorded call's kernel against its plain version, with the
        plan each ran; lat_diag and lat_diag_shift at each of their shapes
        also under each form (diag_forms: on a lat_diag slab, ones for the
        vertex mask and a seeded positive ctrl); the rows' max_abs_err and
        by_path_shape updated. Returns the number of signatures checked."""
        lib = _cuda.load()
        level = {"cheby_smooth_cf": lk.CHEBY, "power_lmax_cf": lk.POWER}
        diags = ("hess_diag6_cf", "hess_diag_shift_cf")
        rng = np.random.default_rng(13)
        for attr, orig, row, plain, rtol, args, kwargs, rest in \
                self.calls.values():
            grid = _grid_of(attr, args)
            dev = args[0].device
            if attr == "force_cf":
                plan = _plan_text(lk._force_plan(*grid, dev))
            elif attr in ("hvp_cf", "level_matvec_cf"):
                plan = _plan_text(lk._hvp_plan(*grid, dev))
            elif attr in level:
                plan = _plan_text(lk._level_plan(
                    lib, *grid, dev, level[attr], *_level_call(attr, args,
                                                               kwargs)))
            elif attr in diags:
                shift = attr == "hess_diag_shift_cf"
                plan = _plan_text(lk._diag_plan(*grid, dev, shift), shift)
            elif attr == "elastic_energy_lattice":
                plan = "grid {} lanes {}".format(
                    *lk.energy_plan(*grid, lk._sms(dev.index)))
            else:
                plan = None
            got = orig(*args, **kwargs)
            ref = plain(*args, **kwargs)
            torch.cuda.synchronize()
            pairs = (list(zip(got, ref)) if isinstance(got, tuple)
                     else [(got, ref)])
            err = scale = 0.0
            for g_, r_ in pairs:
                check(bool(torch.isfinite(g_).all()),
                      f"phase10 {attr} at {grid}: non-finite output")
                if attr == "hess_diag_shift_cf" and kwargs.get(
                        "project", args[7] if len(args) > 7 else True):
                    e_, s_, _ = diag_shift_err(
                        f"phase10 path {grid}", args[0], args[1:7], g_, r_,
                        tol=rtol, phase="phase10")
                else:
                    e_, s_ = max_err(g_, r_), float(r_.abs().max())
                err, scale = max(err, e_), max(scale, s_)
            check(err <= rtol * scale, f"phase10 {attr} at {grid}: max|d| "
                  f"{err:.3e} > {rtol} * {scale:.3e}")
            rows[row]["max_abs_err"] = max(rows[row]["max_abs_err"], err)
            rows[row].setdefault("by_path_shape", []).append(dict(
                wrapper=attr, shape=list(grid), max_abs_err=err,
                max_ref=scale, plan=plan, at_rest=rest))
            log(f"phase10 path shape {attr:22s} {str(grid):18s} max|d| "
                f"{err:.3e} (max|ref| {scale:.3e}, tolerance {rtol:g})"
                + (" at rest, the only call" if rest else "")
                + ("" if plan is None else f"  plan {plan}"))
            if attr in diags:
                u, cm = args[0], args[1]
                if attr == "hess_diag_shift_cf":
                    ctrl, vm, dx = args[2], args[3], args[4]
                else:
                    dx = args[2]
                    vm = torch.ones(grid, device=dev)
                    ctrl = torch.from_numpy((1.0 + rng.random(grid)).astype(
                        np.float32)).to(dev)
                forms = diag_forms("phase10", f"path {attr}", u, cm, ctrl,
                                   vm, dx, rows)
                rows[row]["by_path_shape"][-1]["forms"] = {
                    k: {f: {m: e[m] for m in ("device_us", "ms",
                                              "share_of_bound")}
                        for f, e in v["forms"].items()}
                    for k, v in forms.items()}
        return len(self.calls)


def _level_call(attr, args, kwargs):
    """(sweeps, warm, residual) of a recorded lat_cheby call, or lat_power's
    (iterations, False, False)."""
    if attr == "power_lmax_cf":
        return (kwargs.get("iters", args[10] if len(args) > 10 else 6),
                False, False)
    coeffs = args[10] if len(args) > 10 else kwargs["coeffs"]
    res = kwargs.get("want_residual", args[11] if len(args) > 11 else False)
    return (len(coeffs) + 1) // 2, args[2] is not None, bool(res)


def _grid_of(attr, args):
    if attr == "_spmv_rows":
        return tuple(args[0].shape[:2]) + (int(args[4]), int(args[5]))
    if attr == "elastic_energy_lattice":
        return tuple(args[0].shape[:3])
    return tuple(args[0].shape[1:])


def phase10_operators(sc, rows, reps):
    """lat_force, lat_hvp and lat_diag on 4 z-slabs of the 74k beam (the
    slabs share the card), exchanged and folded, against the same kernels
    on the whole lattice (max|d| <= 1e-5 max|ref|); whether one slab gives
    the whole lattice's bits; each kernel's time at the slab shape beside
    its plain version and its bound; the exchange of one matvec."""
    rng = np.random.default_rng(10)
    vm3 = sc.vert_mask[..., None]
    u = torch.from_numpy(0.03 * rng.standard_normal(sc.x0.shape).astype(
        np.float32)).to(sc.device) * vm3
    p = torch.from_numpy(rng.standard_normal(sc.x0.shape).astype(
        np.float32)).to(sc.device)
    x = sc.x0 + u
    u_cf = (x - sc.x0).permute(3, 0, 1, 2).contiguous()
    p_cf = p.permute(3, 0, 1, 2).contiguous()
    cm = sc.cell_mask
    whole = {"force": lambda: lk.force_cf(u_cf, cm, DX, MU, LA),
             "hvp": lambda: lk.hvp_cf(u_cf, p_cf, cm, DX, MU, LA),
             "diag": lambda: lk.hess_diag_cf(u_cf, cm, DX, MU, LA)}
    ref = {"force": whole["force"]().permute(1, 2, 3, 0),
           "hvp": whole["hvp"]().permute(1, 2, 3, 0),
           "diag": whole["diag"]()}
    out = {}
    for D in (SLABS10, 1):
        grid = pdist.make_device_mesh(D, dp=1)
        slabs = plh.LatticeSlabs(sc, D, grid)
        xb, pb = slabs.scatter(x), slabs.scatter(p)
        ops = plh.SlabOps(slabs, grid, "sp", MU, LA)
        dist_ops = {"force": lambda: ops.force(ops.disp(xb)),
                    "hvp": lambda: ops.hvp(ops.disp(xb), pb),
                    "diag": lambda: ops.diag(ops.disp(xb))}
        got = {"force": slabs.gather(dist_ops["force"]()),
               "hvp": slabs.gather(dist_ops["hvp"]()),
               "diag": lk.sym_blocks(slabs.gather(dist_ops["diag"]())
                                     .permute(3, 0, 1, 2))}
        torch.cuda.synchronize()
        if D == 1:
            bits = {name: bool(torch.equal(got[name], ref[name]))
                    for name in ref}
            log(f"phase10 one slab: bit-equal to the whole lattice "
                + " ".join(f"{n} {b}" for n, b in bits.items()))
            out["one_slab_bits"] = bits
            continue
        blk = xb[0]
        log(f"phase10 grid {grid}: D {D} n_own {slabs.n_own} Zp {slabs.Zp} "
            f"slab {tuple(blk.shape)} ({blk.shape[1]}x{blk.shape[2]}x"
            f"{blk.shape[3]} vertices) cells {tuple(ops.cells[0].shape)}")
        for name in ref:
            err = max_err(got[name], ref[name])
            scale = float(ref[name].abs().max())
            check(err <= 1e-5 * scale, f"phase10 {name}: max|d| {err:.3e} > "
                  f"1e-5 * {scale:.3e}")
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            log(f"phase10 {name:5s} {D} slabs vs whole lattice max|d| "
                f"{err:.3e} (max|ref| {scale:.3e})")
        # one halo matvec: 4 plane shifts, one plane a slab each
        u_ext = ops.disp(xb)
        pdist.reset_counts()
        ops.hvp(u_ext, pb)
        c = dict(pdist.counts)
        check(c["planes"] == 4 * D, f"phase10 matvec planes {c}")
        log(f"phase10 exchange of one matvec: {c['shift']} shifts, "
            f"{c['planes'] // D} planes a slab, {c['bytes']} bytes between "
            "slabs")
        out["matvec_exchange"] = c
        # each kernel at the slab shape (the first slab's extended block)
        cm0 = ops.cells[0]
        u0 = u_ext[0]
        p0 = plh.refresh(pb)[0]
        slab_sc = type("Slab", (), {"vert_mask": blk[0], "cell_mask": cm0})
        bounds = lattice_bounds(slab_sc, 1)
        cases = {
            "force": (lambda: lk.force_cf(u0, cm0, DX, MU, LA),
                      lambda: lk.force_cf_plain(u0, cm0, DX, MU, LA)),
            "hvp": (lambda: lk.hvp_cf(u0, p0, cm0, DX, MU, LA),
                    lambda: lk.hvp_cf_plain(u0, p0, cm0, DX, MU, LA)),
            "diag": (lambda: lk.hess_diag6_cf(u0, cm0, DX, MU, LA),
                     lambda: _diag6_plain(u0, cm0, DX, MU, LA)),
        }
        for name, (kern, plain) in cases.items():
            err = max_err(kern(), plain())
            scale = float(plain().abs().max())
            check(err <= 1e-4 * scale, f"phase10 {name} slab: max|d| "
                  f"{err:.3e}")
            ms = cuda_ms(kern, reps)
            plain_ms = cuda_ms(plain, max(reps // 2, 3), warmup=1)
            dist_ms = cuda_ms(dist_ops[name], max(reps // 2, 3))
            whole_ms = cuda_ms(whole[name], max(reps // 2, 3))
            b_ms, b_by = bounds[name]
            plan = (lk._force_plan(*blk.shape[1:], blk.device)
                    if name == "force" else
                    lk._hvp_plan(*blk.shape[1:], blk.device) if name == "hvp"
                    else lk._diag_plan(*blk.shape[1:], blk.device, False))
            rows[name]["by_slab"] = dict(
                shape=list(blk.shape[1:]), slabs=D, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                dist_op_ms=dist_ms, whole_lattice_ms=whole_ms,
                plan=_plan_text(plan))
            log(f"phase10 time {name:5s} slab {tuple(blk.shape[1:])} kernel "
                f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {b_ms:.5f} ms "
                f"({b_by})  max|d| {err:.3e}; {D}-slab op with exchange "
                f"{dist_ms:.4f} ms vs whole lattice {whole_ms:.4f} ms; plan "
                f"{_plan_text(plan)}")
    return out


def placed_solve(solve, place, x0):
    """solve(place(x0)) timed by CUDA events, the DistLatticeMG's
    crossings and the lattice launches it made: (x whole, k, fn, ms,
    crossings, launches, the placed x)."""
    mg = solve.mg
    xp = place(x0)
    check(isinstance(xp, pslab.SlabField), "phase10 placed: the state was "
          "not placed")
    cross0, before = dict(mg.crossings), dict(lk.launches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    x, k, fn = solve(xp)
    end.record()
    torch.cuda.synchronize()
    check(isinstance(x, pslab.SlabField), "phase10 placed: the solve "
          "returned a whole x")
    cross = crossings_since(mg, cross0)
    launches = {n: lk.launches[n] - before[n] for n in lk.launches}
    return (solve.unplace(x), k, fn, start.elapsed_time(end), cross,
            launches, x)


def perturbed(sc, frac, seed):
    """The rest positions plus seeded noise of frac * dx at every vertex."""
    rng = np.random.default_rng(seed)
    return sc.x0 + torch.from_numpy((frac * DX * rng.standard_normal(
        sc.x0.shape)).astype(np.float32)).to(sc.device) * \
        sc.vert_mask[..., None]


def phase10_placed_path(pscenes, psolves, pstep):
    """The placed distributed multigrid's main path, inside phase 10's
    counted window: a quasi-static solve from rest on each PLACED10 beam,
    solves of the 16x16x63 beam from perturbed starts (their line search
    runs lat_energy on the slabs), and FRAMES10 frames of the placed
    dynamic step at 16x16x63; every field placed once and kept in slabs.
    Returns the runs (x whole) for the checks after the counters."""
    out = {"solves": {}, "perturbed": {}}
    for label, (solve, place) in psolves.items():
        r = placed_solve(solve, place, pscenes[label].x0)
        check(r[2] <= TOL, f"phase10 placed {label}: ||f|| {r[2]:.3e}")
        check(r[4]["split"] == r[4]["join"] == 0, f"phase10 placed {label}"
              f": crossings {r[4]}")
        check(r[5]["force"] > 0 and r[5]["hvp"] > 0 and r[5]["diag"] > 0,
              f"phase10 placed {label}: launches {r[5]}")
        out["solves"][label] = r[:6]
        log(f"phase10 placed quasistatic {label}: newton {r[1]} ||f|| "
            f"{r[2]:.3e} ms {r[3]:.1f} (CUDA events, under the path "
            "capture) crossings " + " ".join(f"{n} {v}" for n, v in
                                             r[4].items())
            + "; launches " + " ".join(
                f"{n} {r[5][n]}" for n in ("force", "hvp", "diag", "energy",
                                           "cheby", "power", "diag_shift")))
    sc63 = pscenes["16x16x63"]
    solve, place = psolves["16x16x63"]
    for i, frac in enumerate(PERTURB10):
        x0 = perturbed(sc63, frac, 100 + i)
        r = placed_solve(solve, place, x0)
        check(r[2] <= TOL, f"phase10 placed perturbed {frac}: ||f|| "
              f"{r[2]:.3e}")
        out["perturbed"][frac] = (x0,) + r[:6]
        log(f"phase10 placed quasistatic 16x16x63 from rest + {frac} dx "
            f"noise: newton {r[1]} ||f|| {r[2]:.3e} ms {r[3]:.1f}; "
            f"lat_energy launches {r[5]['energy']}, lat_force "
            f"{r[5]['force']}")
    energy = sum(r[6]["energy"] for r in out["perturbed"].values())
    check(energy > 0, "phase10 placed: no line search ran lat_energy on "
          "the slabs")
    step, place = pstep
    st = place(sc63.init_state())
    ks, fns, states = [], [], [st]
    mg = step.mg
    cross0, before = dict(mg.crossings), dict(lk.launches)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(FRAMES10):
        st, k, fn = step(st)
        ks.append(k)
        fns.append(fn)
        states.append(st)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / FRAMES10
    c = crossings_since(mg, cross0)
    check(all(isinstance(s_.x, pslab.SlabField) for s_ in states),
          "phase10 placed step: a state came back whole")
    check(c["split"] == c["join"] == c["place"] == c["unplace"] == 0,
          f"phase10 placed step crossings {c}")
    check(max(fns) <= TOL, "phase10 placed step missed tol")
    out["frames"] = dict(ms=ms, crossings=c, launches={
        n: lk.launches[n] - before[n] for n in lk.launches})
    # each frame's input and x brought back whole for the checks
    whole = [step.unplace(s_) for s_ in states]
    out["frames"]["runs"] = (ks, fns, [w.x for w in whole[1:]], whole[:-1])
    log(f"phase10 placed step 16x16x63 {FRAMES10} frames: newton {ks} "
        f"max||f|| {max(fns):.3e} ms/frame {ms:.2f} (CUDA events, under "
        "the path capture) crossings " + " ".join(f"{n} {v}"
                                                  for n, v in c.items()))
    by_beam = {label: dict(r[5]) for label, r in out["solves"].items()}
    for r in out["perturbed"].values():
        for n, v in r[6].items():
            by_beam["16x16x63"][n] += v
    for n, v in out["frames"]["launches"].items():
        by_beam["16x16x63"][n] += v
    out["launches_by_beam"] = by_beam
    return out


def placed_vcycle(mg, sc, placed: bool):
    """(ops, right-hand side) of one linearization at a seeded state of
    sc, placed in slabs or whole."""
    x = perturbed(sc, 0.1, 7)
    if placed:
        xp = mg.place(x)
        ops, _ = mg.newton_ops(xp)
        return ops, mg.state_ops(xp).dyn_force(xp, xp, 0.0, 1.0)
    ops, _ = mg.newton_ops(mg.pad(x))
    return ops, mg.pad_cf(sc.dyn_force(x, x, 0.0))


def phase10_placed_checks(pscenes, psolves, pstep, got, rows, card):
    """After the counters: each placed run against the whole-state
    DistLatticeMG from the same input (equal Newton, ||f|| within 1e-3
    relative + 5e-6, x within 1e-4; the frames one by one and along the
    trajectory from rest); a V-cycle's and an outer matvec's crossings,
    placed (split 0, join 0) and whole; device ops and CUDA-event ms of a
    V-cycle, a warm solve and a frame, placed and whole; lat_force and
    lat_energy at the slab shapes against their plain versions, timed."""
    res = {"card": card}
    for label, (solve, place) in psolves.items():
        sc = pscenes[label]
        x, k, fn, ms, cross, launches = got["solves"][label]
        xw, kw, fw = solve(sc.x0)
        check(torch.is_tensor(xw), "phase10 whole run came back placed")
        d = check_policy(f"phase10 placed quasistatic {label}", [k], [fn],
                         [x], [kw], [fw], [xw])
        res[label] = dict(newton=k, fn=fn, ms_path=ms, crossings=cross,
                          launches={n: v for n, v in launches.items() if v},
                          newton_whole=kw, fn_whole=fw, max_d_fn=d[0],
                          max_d_x=d[1])
        log(f"phase10 placed quasistatic {label} vs whole state: newton "
            f"{k} / {kw}, ||f|| {fn:.6e} / {fw:.6e}, max|d x| {d[1]:.3e}")
    solve, _ = psolves["16x16x63"]
    res["perturbed"] = {}
    for frac, (x0, x, k, fn, ms, cross, launches) in got["perturbed"].items():
        xw, kw, fw = solve(x0)
        d = check_policy(f"phase10 placed perturbed {frac}", [k], [fn], [x],
                         [kw], [fw], [xw])
        res["perturbed"][str(frac)] = dict(
            newton=k, newton_whole=kw, fn=fn, fn_whole=fw, max_d_x=d[1],
            energy_launches=launches["energy"])
        log(f"phase10 placed perturbed {frac} dx vs whole state: newton {k}"
            f" / {kw}, ||f|| {fn:.6e} / {fw:.6e}, max|d x| {d[1]:.3e}")

    # the frames: each from the placed run's own input, then the whole
    # state's trajectory from rest
    step, place_s = pstep
    sc63 = pscenes["16x16x63"]
    fr = got["frames"]["runs"]

    def whole_frame(st, _v):
        st1, k, fn = step(st)
        return k, fn, st1.x
    dmg = check_policy("phase10 placed step", *fr[:3], *reference_frames(
        whole_frame, [(st, None) for st in fr[3]]))
    ref = ([], [], [], [])
    st = sc63.init_state()
    for _ in range(FRAMES10):
        ref[3].append(st)
        st, k, fn = step(st)
        for lst, v in zip(ref, (k, fn, st.x)):
            lst.append(v)

    def norm_at(code, st, j):
        return tmg.step_to_tol_mg(sc63, step.mg, place_s(st) if code == "got"
                                  else st, tol=TOL, max_newton=j)[2]
    tx, apart = trajectory_policy("phase10 placed step trajectory vs whole "
                                  "state", fr, ref, norm_at)
    res["frames"] = dict(newton=fr[0], newton_whole=ref[0],
                         fn_max=max(fr[1]), ms_path=got["frames"]["ms"],
                         crossings=got["frames"]["crossings"],
                         max_d_fn=dmg[0], max_d_x=dmg[1],
                         trajectory=dict(max_d_x=tx, taken_apart=apart))
    log(f"phase10 placed step 16x16x63 vs whole state: frame by frame "
        f"max|d fn| {dmg[0]:.3e} max|d x| {dmg[1]:.3e}; trajectory from "
        f"rest newton {fr[0]} vs {ref[0]}, max|d x| {tx:.3e}, {len(apart)} "
        "frames taken apart")

    # a V-cycle and an outer matvec: crossings, device ops, ms; the times
    # placed, whole, whole, placed (the host sets them and drifts)
    res["vcycle"], res["warm_ms"] = {}, {}
    order = ("placed", "whole", "whole", "placed")
    for label, (solve, place) in psolves.items():
        mg, sc = solve.mg, pscenes[label]
        g = sum(1 for li in range(mg.n_levels - 1)
                if mg.sharded(li) and not mg.sharded(li + 1))
        entry_, calls = {}, {}
        for how in ("placed", "whole"):
            ops, b = placed_vcycle(mg, sc, how == "placed")
            calls[how] = (ops, b)
            before = dict(mg.crossings)
            mg.vcycle(ops, b)
            cv = crossings_since(mg, before)
            before = dict(mg.crossings)
            ops[0].matvec(b)
            cm = crossings_since(mg, before)
            n = 0 if how == "placed" else 1
            check(cv == dict(split=n, join=n, gather=g, scatter=g, place=0,
                             unplace=0) and cm == dict(
                      split=n, join=n, gather=0, scatter=0, place=0,
                      unplace=0),
                  f"phase10 {how} {label}: a V-cycle crossed {cv}, an outer"
                  f" matvec {cm}")
            n_ops = round(sum(v for v, _ in whole_trace(
                lambda: mg.vcycle(ops, b), 3, 1).values()))
            n_mv = round(sum(v for v, _ in whole_trace(
                lambda: ops[0].matvec(b), 3, 1).values()))
            entry_[how] = dict(vcycle_crossings=cv, matvec_crossings=cm,
                               vcycle_ops=n_ops, matvec_ops=n_mv,
                               vcycle_ms=[], matvec_ms=[])
        for how in order:
            ops, b = calls[how]
            entry_[how]["vcycle_ms"].append(
                cuda_ms(lambda: mg.vcycle(ops, b), 5))
            entry_[how]["matvec_ms"].append(
                cuda_ms(lambda: ops[0].matvec(b), 10))
        for how, e in entry_.items():
            cv, cm = e["vcycle_crossings"], e["matvec_crossings"]
            log(f"phase10 {how} {label} a V-cycle: crossings " + " ".join(
                f"{k_} {v}" for k_, v in cv.items()) + f"; "
                f"{e['vcycle_ops']} device ops, " + " / ".join(
                    f"{v:.3f}" for v in e["vcycle_ms"]) + " ms; an outer "
                f"matvec: split {cm['split']} join {cm['join']}, "
                f"{e['matvec_ops']} device ops, " + " / ".join(
                    f"{v:.3f}" for v in e["matvec_ms"]) + " ms (CUDA "
                f"events, placed / whole / whole / placed) [{card}]")
        # what differs between the two: one traced turn of each, after the
        # timed ones, on the host and the card
        tr, by = {}, {}
        for how in ("placed", "whole"):
            ops, b = calls[how]
            tr[how], by[how] = host_trace(lambda: mg.vcycle(ops, b), 5)
            entry_[how]["trace"] = tr[how]
            t = tr[how]
            log(f"phase10 {how} {label} a V-cycle traced: host "
                f"{t['host_ms']:.2f} ms ({t['host_ms_gc_off']:.2f} with the "
                f"garbage collector off; collections a call "
                + "/".join(f"{v:g}" for v in t["gc_collections"])
                + f", {t['gc_ms']:.2f} ms, {t['gc_tracked']} objects "
                f"tracked); device busy {t['busy_ms']:.3f} ms, "
                f"{t['device_ops']:g} device ops; allocator a call "
                f"{t['allocations']:g} allocations, {t['cuda_mallocs']:g} "
                f"cudaMallocs, {t['alloc_retries']:g} retries, "
                f"{t['reserved_mib']:.0f} MiB reserved, "
                f"{t['inactive_split_blocks']} inactive split blocks "
                f"[{card}]")
        entry_["differences"] = {
            what: largest_differences(by["placed"][what], by["whole"][what],
                                      6)
            for what in ("kernels", "host_ops", "python")}
        for what, unit in (("kernels", "us"), ("host_ops", "ms"),
                           ("python", "ms")):
            for k_, d_, a_, b_ in entry_["differences"][what]:
                log(f"phase10 {label} V-cycle placed - whole, {what}: "
                    f"{d_:+.3f} {unit} (placed {a_:.3f}, whole {b_:.3f}) "
                    f"{k_}")
        res["vcycle"][label] = entry_
        warm = {"placed": [], "whole": []}
        solve(place(sc.x0))
        solve(sc.x0)
        for how in order:
            warm[how].append(cuda_ms(
                (lambda: solve(place(sc.x0))) if how == "placed"
                else (lambda: solve(sc.x0)), 1, warmup=0))
        res["warm_ms"][label] = warm
        log(f"phase10 warm quasistatic {label}: placed " + " / ".join(
            f"{v:.1f}" for v in warm["placed"]) + " ms, whole state "
            + " / ".join(f"{v:.1f}" for v in warm["whole"]) + " ms (CUDA "
            f"events, place included; placed, whole, whole, placed) "
            f"[{card}]")

    def frames(placed):
        st = place_s(sc63.init_state()) if placed else sc63.init_state()
        for _ in range(FRAMES10):
            st, _, _ = step(st)
    ms_f = {"placed": [], "whole": []}
    for how in order:
        ms_f[how].append(cuda_ms(lambda: frames(how == "placed"), 1,
                                 warmup=0) / FRAMES10)
    st0 = place_s(sc63.init_state())
    ops_f = {"placed": round(sum(v for v, _ in whole_trace(
        lambda: step(st0), 1, 1).values())),
        "whole": round(sum(v for v, _ in whole_trace(
            lambda: step(sc63.init_state()), 1, 1).values()))}
    res["frame_ms"], res["frame_ops"] = ms_f, ops_f
    log("phase10 warm frames 16x16x63: placed " + " / ".join(
        f"{v:.2f}" for v in ms_f["placed"]) + " ms a frame, whole state "
        + " / ".join(f"{v:.2f}" for v in ms_f["whole"]) + f" (CUDA events, "
        f"{FRAMES10} frames from rest; placed, whole, whole, placed); the "
        f"first frame's device ops placed {ops_f['placed']}, whole "
        f"{ops_f['whole']} [{card}]")

    # lat_force and lat_energy at the slab shapes the placed path gave them
    res["slab_kernels"] = {}
    for label, (solve, place) in psolves.items():
        mg, sc = solve.mg, pscenes[label]
        so = mg.state_ops(mg.place(sc.x0))
        u = so._elastic(mg.place(perturbed(sc, 0.1, 9)))
        ub, cm = u.slabs()[0], so.cells[0]
        ul = ub.permute(1, 2, 3, 0).contiguous()
        slab_sc = type("Slab", (), {"vert_mask": ub[0], "cell_mask": cm})
        bounds = lattice_bounds(slab_sc, 1)
        cases = {"force": (lambda: lk.force_cf(ub, cm, DX, MU, LA),
                           lambda: lk.force_cf_plain(ub, cm, DX, MU, LA)),
                 "energy": (lambda: lk.elastic_energy_lattice(
                     ul, cm, DX, MU, LA),
                     lambda: lk.elastic_energy_lattice_plain(
                     ul, cm, DX, MU, LA))}
        launches = got["launches_by_beam"][label]
        for name, (kern, plain) in cases.items():
            a, b = kern(), plain()
            err, scale = max_err(a, b), float(b.abs().max())
            check(err <= (1e-5 if name == "force" else 1e-4) * scale,
                  f"phase10 placed {name} slab {label}: max|d| {err:.3e}")
            ms_k = cuda_ms(kern, 20)
            ms_p = cuda_ms(plain, 3, warmup=1)
            b_ms, b_by = bounds[name]
            n_l = launches[name]
            e = dict(beam=label, shape=list(ub.shape[1:]), ms=ms_k,
                     plain_ms=ms_p, bound_ms=b_ms, bound_by=b_by,
                     max_abs_err=err, launches=n_l)
            rows[name].setdefault("by_placed_slab", []).append(e)
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], err)
            res["slab_kernels"][f"{name} {label}"] = e
            log(f"phase10 placed {name} slab {label} {tuple(ub.shape[1:])}:"
                f" kernel {ms_k:.4f} ms plain {ms_p:.4f} ms bound "
                f"{b_ms:.5f} ms ({b_by}) max|d| {err:.3e}; launches on the "
                f"placed path {n_l} [{card}]")
    return res


def hierarchy_build_times():
    """Host seconds of build_hierarchy (3 levels) on the 74k beam with the
    native topology builder and with the numpy path, bit-equal; the
    machine named."""
    import platform
    from fem_simulation_tpu_torch import hierarchy as hl
    from fem_simulation_tpu_torch import native
    cpu = platform.processor() or platform.machine()
    try:
        with open("/proc/cpuinfo") as fh:
            cpu = next((ln.split(":", 1)[1].strip() for ln in fh
                        if ln.startswith("model name")), cpu)
    except OSError:
        pass
    native.load()
    m = meshlib.beam(*BEAMS["74k"], dx=DX)
    out = {"machine": f"{platform.node()}: {cpu}, {os.cpu_count()} logical "
                      "CPUs", "library_build_s": native.build_seconds}
    hs = {}
    for how, flag in (("native", True), ("numpy", False)):
        t0 = time.perf_counter()
        hs[how] = hl.build_hierarchy(m, 3, use_native=flag)
        out[how + "_s"] = time.perf_counter() - t0
    same = all(np.array_equal(getattr(a, f), getattr(b, f))
               for a, b in zip(hs["native"].levels, hs["numpy"].levels)
               for f in ("nbr", "nbr_mask", "hex_slot", "diag_slot",
                         "contrib_idx")) and all(
        np.array_equal(getattr(a, f), getattr(b, f))
        for a, b in zip(hs["native"].transfers, hs["numpy"].transfers)
        for f in ("g_src", "g_dst", "g_w", "p_w", "r_w"))
    check(same, "phase10 build_hierarchy: native and numpy differ")
    out["bit_equal"] = same
    log(f"phase10 build_hierarchy 74k (3 levels), host: native "
        f"{out['native_s']:.2f} s, numpy {out['numpy_s']:.2f} s, bit-equal "
        f"{same} (the library's g++ build at first use "
        f"{native.build_seconds:.2f} s) on {out['machine']}")
    return out


def crossings_since(mg, before):
    """A DistLatticeMG's whole-field crossings since `before`."""
    return {k: mg.crossings[k] - before[k] for k in before}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def mg_placement(mg, ops):
    """Where each level's linearized fields live: for a sharded level each
    of u_cf, ctrl, d6 and vmask must be a SlabField whose group tensors lie
    on their groups' devices, (slabs, C..., X, Y, Z / D), contiguous; a
    replicated level's are whole on the home device. One dict a level."""
    out = []
    for li, op in enumerate(ops):
        X, Y, Z = mg.levels[li].vert_mask.shape
        if not mg.sharded(li):
            check(all(torch.is_tensor(getattr(op, n)) and getattr(op, n)
                      .device == mg.home for n in ("u_cf", "d6", "vmask")),
                  f"phase10 level {li}: replicated fields not whole at home")
            out.append(dict(level=li, sharded=False, shape=[X, Y, Z],
                            u_cf=list(op.u_cf.shape),
                            device=str(op.u_cf.device)))
            continue
        groups = {}
        for name, chans in (("u_cf", (3,)), ("ctrl", ()), ("d6", (6,)),
                            ("vmask", ())):
            f = getattr(op, name)
            check(isinstance(f, pslab.SlabField),
                  f"phase10 level {li} {name}: not a slab field")
            for (a, b), part in zip(mg.layout.groups, f.parts):
                check(part.device == mg.devices[a] and part.is_contiguous()
                      and tuple(part.shape) == (b - a,) + chans
                      + (X, Y, Z // mg.n_sp),
                      f"phase10 level {li} {name}: group tensor "
                      f"{tuple(part.shape)} on {part.device}")
            groups[name] = [[list(p.shape), str(p.device)] for p in f.parts]
        out.append(dict(level=li, sharded=True, shape=[X, Y, Z],
                        groups=len(mg.layout.groups), fields=groups))
    return out


def phase10_mg_slabs(scenes, grid, solves, step_mg, place, ms_frame,
                     newton7):
    """The distributed multigrid's slab layout, after its path ran: each
    hierarchy's per-level placement; one V-cycle's whole-field crossings (1
    split + 1 join, plus 1 gather + 1 scatter a sharded -> replicated
    boundary) at three (nu, coarse_sweeps); device ops and ms a V-cycle;
    one slab a device group against the one group of 4 (bit-equal x, k,
    ||f||); the 74k solve against LatticeMG with the same z_multiple on
    the whole lattice (the ||f|| policy) and phase 7's Newton count; then
    each solve and the 19k frames timed again, warm, with no path capture.
    `solves`: label -> (solve, place, x, k, fn, ms of the path's solve)."""
    card = card_line()
    out = {"card": card, "layout": {}, "crossings_per_vcycle": {},
           "ops_per_vcycle": {}, "ms_per_vcycle": {}}
    for label, (solve, place_s, x, k, fn, _) in solves.items():
        mg = solve.mg
        sc = scenes[label.split()[0]]
        ops, _ = mg.newton_ops(mg.pad(sc.x0))
        out["layout"][label] = lay = mg_placement(mg, ops)
        for e in lay:
            if e["sharded"]:
                f = e["fields"]
                log(f"phase10 dist MG {label} level {e['level']} "
                    f"{tuple(e['shape'])}: sharded, {e['groups']} group(s); "
                    + "; ".join(f"{n} " + ", ".join(f"{tuple(sh)} on {d}"
                                                    for sh, d in f[n])
                                for n in ("u_cf", "ctrl", "d6", "vmask")))
            else:
                log(f"phase10 dist MG {label} level {e['level']} "
                    f"{tuple(e['shape'])}: replicated, whole "
                    f"{tuple(e['u_cf'])} on {e['device']}")
        b = mg.pad_cf(sc.dyn_force(sc.x0, sc.x0, 0.0))
        g = sum(1 for li in range(mg.n_levels - 1)
                if mg.sharded(li) and not mg.sharded(li + 1))
        want = dict(split=1, join=1, gather=g, scatter=g, place=0,
                    unplace=0)
        nu, sweeps = mg.nu, mg.coarse_sweeps
        got = {}
        for nu_, sw in ((nu, sweeps), (1, 12), (3, 6)):
            mg.nu, mg.coarse_sweeps = nu_, sw
            before = dict(mg.crossings)
            mg.vcycle(ops, b)
            got[f"nu {nu_} coarse_sweeps {sw}"] = c = crossings_since(
                mg, before)
            check(c == want, f"phase10 dist MG {label}: a V-cycle at nu "
                  f"{nu_}, coarse_sweeps {sw} crossed {c}, not {want}")
        mg.nu, mg.coarse_sweeps = nu, sweeps
        out["crossings_per_vcycle"][label] = got
        n_ops = round(sum(n for n, _ in whole_trace(
            lambda: mg.vcycle(ops, b), 3, 1).values()))
        ms_v = cuda_ms(lambda: mg.vcycle(ops, b), 5)
        out["ops_per_vcycle"][label] = n_ops
        out["ms_per_vcycle"][label] = ms_v
        log(f"phase10 dist MG {label} a V-cycle: crossings " + " ".join(
            f"{n} {v}" for n, v in want.items()) + f" at every (nu, "
            f"coarse_sweeps) of {list(got)}; {n_ops} device ops, "
            f"{ms_v:.2f} ms (CUDA events) [{card}]")

    # one slab a device group against the one group of 4
    solve, place_q, xq, kq, fq, _ = solves["19k"]
    saved = pslab.slab_groups
    pslab.slab_groups = lambda devices: [(i, i + 1)
                                         for i in range(len(devices))]
    try:
        solve1, _ = pmgd.make_dist_mg_quasistatic(
            scenes["19k"], grid, n_levels=3, tol=TOL, max_newton=100)
    finally:
        pslab.slab_groups = saved
    check(len(solve1.mg.layout.groups) == SLABS10,
          f"phase10 grouping: {solve1.mg.layout.groups}")
    x1, k1, f1 = solve1(place_q(scenes["19k"].x0))
    same = bool(torch.equal(x1, xq)) and k1 == kq and f1 == fq
    check(same, f"phase10 dist MG one slab a group: newton {k1} vs {kq}, "
          f"||f|| {f1:.6e} vs {fq:.6e}, max|d x| "
          f"{float((x1 - xq).abs().max()):.3e}")
    ops1, _ = solve1.mg.newton_ops(solve1.mg.pad(scenes["19k"].x0))
    b = solve1.mg.pad_cf(scenes["19k"].dyn_force(scenes["19k"].x0,
                                                 scenes["19k"].x0, 0.0))
    n_ops1 = round(sum(n for n, _ in whole_trace(
        lambda: solve1.mg.vcycle(ops1, b), 3, 1).values()))
    out["one_slab_a_group"] = dict(bit_equal=same, newton=k1,
                                   ops_per_vcycle=n_ops1)
    log(f"phase10 dist MG 19k, one slab a group ({SLABS10} groups) against "
        f"one group of {SLABS10}: x, newton and ||f|| bit-equal {same}; "
        f"{n_ops1} device ops a V-cycle against "
        f"{out['ops_per_vcycle']['19k']}")

    # the 74k solve against the whole lattice and phase 7's Newton count
    sc74 = scenes["74k"]
    _, _, x74, k74, f74, _ = solves["74k"]
    mg74 = tmg.LatticeMG(sc74, n_levels=3, dt=None, z_multiple=SLABS10)
    ref = tmg.quasistatic_to_tol_mg(sc74, mg74, sc74.x0, tol=TOL,
                                    max_newton=100)
    d74 = check_policy("phase10 dist MG quasistatic 74k", [k74], [f74],
                       [x74], [ref[1]], [ref[2]], [ref[0]])
    check(k74 == newton7, f"phase10 dist MG 74k: newton {k74}, phase 7's "
          f"quasistatic_to_tol_mg {newton7}")
    out["quasistatic_74k"] = dict(newton=k74, newton_whole=ref[1],
                                  newton_phase7=newton7, fn=f74,
                                  fn_whole=ref[2], max_d_fn=d74[0],
                                  max_d_x=d74[1])
    log(f"phase10 dist MG quasistatic 74k: newton {k74} (LatticeMG, "
        f"z_multiple {SLABS10}, whole lattice: {ref[1]}; phase 7's "
        f"quasistatic_to_tol_mg: {newton7}), ||f|| {f74:.3e} vs "
        f"{ref[2]:.3e}, max|d x| {d74[1]:.3e}")

    # warm, with no path capture
    warm = {}
    for label, (solve, place_s, *_rest) in solves.items():
        sc = scenes[label.split()[0]]
        warm[label] = cuda_ms(lambda: solve(place_s(sc.x0)), 2, warmup=1)
    sc19 = scenes["19k"]

    def frames():
        st = place(sc19.init_state())
        for _ in range(FRAMES10):
            st, _, _ = step_mg(st)
    warm["19k frame"] = cuda_ms(frames, 1, warmup=0) / FRAMES10
    out["warm_ms"] = warm
    log(f"phase10 dist MG times [{card}], CUDA events: a solve at 19k "
        f"{solves['19k'][5]:.1f} ms on the path (under its capture), "
        f"{warm['19k']:.1f} warm; coarsest replicated "
        f"{warm['19k replicated coarsest']:.1f} warm; 74k "
        f"{solves['74k'][5]:.1f} on the path, {warm['74k']:.1f} warm; a "
        f"frame at 19k {ms_frame:.2f} on the path, {warm['19k frame']:.2f} "
        "warm (PR 10, on an H100 80GB HBM3 at 700 W: 447-508 ms a solve, "
        "190.7-231.8 a frame); "
        "device ops a V-cycle " + " ".join(
            f"{k} {v}" for k, v in out["ops_per_vcycle"].items()))
    return out


def phase10_path(scenes, uscenes, rows, newton7):
    """The distributed paths on 4 z-slabs sharing the card, counters zeroed
    just before and read just after, the arguments of every kernel wrapper
    they call recorded at each shape (PathCapture); then every recorded
    call's kernel against its plain version, and the references (the same
    code on one slab, the whole-lattice and whole-mesh solvers): each frame
    from the state the distributed run gave it, and each run's trajectory
    from rest against the reference's own (trajectory_policy)."""
    sc74, sc19, usc19, usc2 = (scenes["74k"], scenes["19k"], uscenes["19k"],
                               uscenes["2k"])
    grid = pdist.make_device_mesh(SLABS10, dp=1)
    res = {"grid": repr(grid)}
    t0 = time.perf_counter()
    # the distributed objects: host tables built before the counters
    slabs = plh.LatticeSlabs(sc74, SLABS10, grid)
    step, blockify = plh.make_dist_step(slabs, grid)
    solve, place_q = pmgd.make_dist_mg_quasistatic(sc19, grid, n_levels=3,
                                                   tol=TOL, max_newton=100)
    solve8, _ = pmgd.make_dist_mg_quasistatic(sc19, grid, n_levels=3, tol=TOL,
                                              max_newton=100,
                                              min_planes_per_dev=8)
    solve74, place74 = pmgd.make_dist_mg_quasistatic(sc74, grid, n_levels=3,
                                                     tol=TOL, max_newton=100)
    step_mg, place = pmgd.make_dist_mg_step(sc19, grid, n_levels=3)
    # the placed state's beams (their vertex z extents divide the slabs)
    pscenes = {label: tlat.LatticeScene(meshlib.beam(*b, dx=DX),
                                        device=sc19.device)
               for label, b in PLACED10.items()}
    psolves = {label: pmgd.make_dist_mg_quasistatic(
        psc, grid, n_levels=3, tol=TOL, max_newton=100)
        for label, psc in pscenes.items()}
    pstep = pmgd.make_dist_mg_step(pscenes["16x16x63"], grid, n_levels=3)
    for label, (solve_p, _) in psolves.items():
        mg_p = solve_p.mg
        check(mg_p.placed and all(mg_p.sharded(li)
                                  for li in range(mg_p.n_levels)),
              f"phase10 placed {label}: placed {mg_p.placed}, levels "
              f"{mg_p.level_specs}")
        log(f"phase10 placed {label}: scene lattice {pscenes[label].shape} "
            f"({int(pscenes[label].vert_mask.sum())} vertices), levels "
            + " ".join(str(tuple(lv.vert_mask.shape)) for lv in mg_p.levels)
            + f", the state in {SLABS10} slabs of "
            f"{mg_p.pad_shape[2] // SLABS10} planes (the scene's "
            f"{pscenes[label].shape[2]} would split in "
            f"{pscenes[label].shape[2] // SLABS10})")
    part = phalo.partition_slabs(usc19.hier.levels[0], SLABS10)
    nstep = phalo.make_dist_newton_step(usc19, part, grid, tol=TOL)
    matvec, scatter, gather = phalo.make_dist_matvec(part, grid)
    grid_b = pdist.make_device_mesh(4)
    bstep, bparams, bstate = pdist.make_batched_step(usc2, grid_b, 8)
    vals = qs.assemble_elastic(usc19, usc19.params, 0, usc19.x0)
    p0 = usc19.params["levels"][0]
    eye2 = 2.0 * torch.eye(3, device=vals.device).expand(vals.shape[0], 3, 3)
    vals = ell.add_to_diag(vals, p0["diag_slot"], eye2)
    full = vals * p0["mask"][..., None, None]
    rng = np.random.default_rng(12)
    xr = torch.from_numpy(rng.standard_normal((vals.shape[0], 3)).astype(
        np.float32)).to(vals.device)
    log(f"phase10 tables built in {time.perf_counter() - t0:.1f} s; "
        "multigrid levels "
        + " ".join(f"{tuple(lv.vert_mask.shape)}{'*' if s else ''}"
                   for lv, s in zip(solve.mg.levels, solve.mg.level_specs))
        + " (* sharded); with 8 planes a slab: "
        + " ".join('sharded' if s else 'replicated'
                   for s in solve8.mg.level_specs))
    # one traced frame for the device ops (not counted)
    xb0, vb0 = blockify(sc74.x0), blockify(torch.zeros_like(sc74.x0))
    ops74 = whole_trace(lambda: step(xb0, vb0), 1, 1)
    torch.cuda.synchronize()

    cap = PathCapture()
    lk.reset_launches()
    ek.reset_launches()
    for name in ell.cuda_calls:
        ell.cuda_calls[name] = 0
    pdist.reset_counts()
    cap.start()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # 1. the lattice halo step at 74k
    before = dict(lk.launches)
    start.record()
    got74 = slab_frames(step, blockify, slabs, sc74, FRAMES10)
    end.record()
    torch.cuda.synchronize()
    ms74 = start.elapsed_time(end) / FRAMES10
    ex74 = dict(pdist.counts)
    ks, fns = got74[0], got74[1]
    check(max(fns) <= 1.01 * TOL, f"phase10 dist step: ||f|| {max(fns):.3e}")
    newton = sum(ks)
    per = {n: (lk.launches[n] - before[n]) / FRAMES10
           for n in ("force", "hvp", "diag")}
    check(min(per.values()) > 0, f"phase10 dist step launches {per}")
    res["dist_step"] = dict(
        ms_per_frame=ms74, newton=ks, fn_max=max(fns), device_ops=round(sum(
            n for n, _ in ops74.values())), launches_per_frame=per,
        per_newton={k: v / newton for k, v in ex74.items()})
    log(f"phase10 dist step 74k {SLABS10} slabs {FRAMES10} frames: ms/frame "
        f"{ms74:.2f} (CUDA events)  newton {ks}  max||f|| {max(fns):.3e}  "
        f"device ops in frame 1 {res['dist_step']['device_ops']}  launches "
        "a frame " + " ".join(f"{n} {v:.1f}" for n, v in per.items()))
    log("phase10 dist step exchange a Newton iteration: " + " ".join(
        f"{k} {v / newton:.1f}" for k, v in ex74.items()))

    # 2. the distributed multigrid at 19k
    pdist.reset_counts()
    calls0 = dict(solve.mg.calls)
    cross0 = dict(solve.mg.crossings)
    before = dict(lk.launches)
    start.record()
    xq, kq, fq = solve(place_q(sc19.x0))
    end.record()
    torch.cuda.synchronize()
    ms_q = start.elapsed_time(end)
    per_solve = {"19k": crossings_since(solve.mg, cross0)}
    check(fq <= TOL, f"phase10 dist MG quasistatic: ||f|| {fq:.3e}")
    mv = solve.mg.calls["matvec"] - calls0["matvec"]
    lq = {n: lk.launches[n] - before[n] for n in
          ("hvp", "diag", "cheby", "diag_shift", "power")}
    check(lq["hvp"] == SLABS10 * mv and lq["cheby"] == lq["power"] == 0,
          f"phase10 dist MG launches {lq}, {mv} sharded matvecs")
    log(f"phase10 dist MG quasistatic 19k: newton {kq} ||f|| {fq:.3e} ms "
        f"{ms_q:.1f} (CUDA events)  sharded matvecs {mv} -> lat_hvp "
        f"{lq['hvp']}, lat_diag {lq['diag']}; replicated-level kernels cheby "
        f"{lq['cheby']} power {lq['power']} diag_shift {lq['diag_shift']}; "
        "exchange " + " ".join(f"{k} {v}" for k, v in pdist.counts.items()))
    before = dict(lk.launches)
    cross0 = dict(solve8.mg.crossings)
    x8, k8, f8 = solve8(place_q(sc19.x0))
    per_solve["19k replicated coarsest"] = crossings_since(solve8.mg, cross0)
    check(f8 <= TOL, f"phase10 dist MG (8 planes): ||f|| {f8:.3e}")
    l8 = {n: lk.launches[n] - before[n] for n in
          ("hvp", "cheby", "diag_shift", "power")}
    check(l8["cheby"] > 0 and l8["power"] > 0 and l8["diag_shift"] > 0,
          f"phase10 replicated coarsest launched {l8}")
    log(f"phase10 dist MG quasistatic 19k, coarsest replicated: newton {k8} "
        f"||f|| {f8:.3e}  launches " + " ".join(f"{n} {v}"
                                                for n, v in l8.items()))
    calls0 = dict(solve74.mg.calls)
    cross0 = dict(solve74.mg.crossings)
    before = dict(lk.launches)
    start.record()
    x74, k74, f74 = solve74(place74(sc74.x0))
    end.record()
    torch.cuda.synchronize()
    ms_q74 = start.elapsed_time(end)
    per_solve["74k"] = crossings_since(solve74.mg, cross0)
    check(f74 <= TOL, f"phase10 dist MG quasistatic 74k: ||f|| {f74:.3e}")
    mv74 = solve74.mg.calls["matvec"] - calls0["matvec"]
    l74 = {n: lk.launches[n] - before[n] for n in ("hvp", "diag", "cheby")}
    check(l74["hvp"] == SLABS10 * mv74 and l74["cheby"] == 0,
          f"phase10 dist MG 74k launches {l74}, {mv74} sharded matvecs")
    log(f"phase10 dist MG quasistatic 74k: newton {k74} ||f|| {f74:.3e} ms "
        f"{ms_q74:.1f} (CUDA events)  sharded matvecs {mv74} -> lat_hvp "
        f"{l74['hvp']}, lat_diag {l74['diag']}")
    for label, (mg_, k_) in {"19k": (solve.mg, kq),
                             "19k replicated coarsest": (solve8.mg, k8),
                             "74k": (solve74.mg, k74)}.items():
        c = per_solve[label]
        # a linearization a Newton iteration splits the fine positions
        # once; every V-cycle and outer matvec splits once and joins once
        check(c["split"] - c["join"] == k_, f"phase10 dist MG {label} "
              f"crossings a solve {c}, newton {k_}")
        log(f"phase10 dist MG {label} crossings in the solve: " + " ".join(
            f"{n} {v}" for n, v in c.items()))
    got_mg = ([], [], [], [])
    ins_mg = got_mg[3]
    st = place(sc19.init_state())
    start.record()
    for _ in range(FRAMES10):
        ins_mg.append(st)
        st, k, fn = step_mg(st)
        for lst, v in zip(got_mg, (k, fn, st.x)):
            lst.append(v)
    end.record()
    torch.cuda.synchronize()
    ms_mg = start.elapsed_time(end) / FRAMES10
    check(max(got_mg[1]) <= TOL, "phase10 dist MG step missed tol")
    log(f"phase10 dist MG step 19k {FRAMES10} frames: ms/frame {ms_mg:.2f}  "
        f"newton {got_mg[0]}  max||f|| {max(got_mg[1]):.3e}; sharded calls "
        f"{step_mg.mg.calls}")

    # 3. the unstructured halo path at 19k
    om = [torch.from_numpy(part.own_mask[d]).to(xr.device)[:, None]
          for d in range(SLABS10)]
    vl = matvec.prepare([vals[torch.from_numpy(part.own_global[d]).long()
                              .to(vals.device)] for d in range(SLABS10)])
    y = gather(matvec(vl, scatter(xr)))
    xs_cg = gather(phalo.dist_cg(lambda v: matvec(vl, v),
                                 [b * m for b, m in zip(scatter(xr), om)],
                                 grid, iterations=40, tol=1e-6))
    got_u = ([], [], [], [])
    ins_u = got_u[3]
    n_u = usc19.hier.levels[0].n_verts
    x_sh = phalo.slab_scatter(part, usc19.x0, grid.line("sp"))
    v_sh = [torch.zeros_like(a) for a in x_sh]
    start.record()
    for _ in range(NEWTON_FRAMES10):
        ins_u.append((phalo.slab_gather(part, x_sh, n_u),
                      phalo.slab_gather(part, v_sh, n_u)))
        x_sh, v_sh, k, fn = nstep(x_sh, v_sh)
        for lst, v in zip(got_u, (k, fn, phalo.slab_gather(part, x_sh, n_u))):
            lst.append(v)
    end.record()
    torch.cuda.synchronize()
    ms_u = start.elapsed_time(end) / NEWTON_FRAMES10
    check(max(got_u[1]) <= 1.01 * TOL, "phase10 dist Newton missed tol")
    log(f"phase10 dist unstructured Newton 19k {NEWTON_FRAMES10} frames: "
        f"ms/frame {ms_u:.2f}  newton {got_u[0]}  max||f|| "
        f"{max(got_u[1]):.3e}")

    # 4. the dp batch: 8 scenes of the 8x8x24 beam on a 2 x 2 grid
    xbt = pdist.stack_batch(bstep(bparams, bstate)).x
    ms_b, fns_b = batched_scenes.main(["--frames", "10", "--n-devices", "4"])

    # 5. the dry run of the six programs on 4 slabs
    lines = entry.dryrun_multichip(SLABS10)

    # 6. the placed state: the distributed multigrid's Newton state, its
    # residual, energy and outer PCG in slabs
    placed = phase10_placed_path(pscenes, psolves, pstep)
    torch.cuda.synchronize()
    cap.stop()
    launches = {**dict(lk.launches), **dict(ek.launches)}
    check(ek.launches["spmv"] == ell.cuda_calls["spmv"] > 0,
          f"phase10 spmv launches {ek.launches['spmv']} vs calls "
          f"{ell.cuda_calls['spmv']}")
    log("phase10 kernel launches " + json.dumps(launches))
    launches["level_by_form"] = dict(lk.level_launches)

    # every kernel at every shape the path gave it, against its plain
    # version; first, that the shapes the distributed solvers build are
    # among them: the 74k slabs, each sharded multigrid level's slabs, the
    # replicated coarsest level (8 planes a slab), the halo rows
    t0 = time.perf_counter()
    slab74 = (sc74.shape[0], sc74.shape[1], slabs.n_own + 2)
    want = {a: {slab74} for a in ("force_cf", "hvp_cf")}
    want["hess_diag6_cf"] = {slab74}
    want["level_matvec_cf"] = set()
    # the placed residual's lat_force at both beams' fine slabs, the line
    # search's lat_energy at the 16x16x63 beam's (channel-last)
    for psolve_, _ in psolves.values():
        X, Y, Z = psolve_.mg.pad_shape
        want["force_cf"].add((X, Y, Z // SLABS10 + 2))
    X, Y, Z = psolves["16x16x63"][0].mg.pad_shape
    want["elastic_energy_lattice"] = {(X, Y, Z // SLABS10 + 2)}
    for mg in (solve.mg, step_mg.mg, solve74.mg, pstep[0].mg,
               *(ps.mg for ps, _ in psolves.values())):
        for li, lvl in enumerate(mg.levels):
            X, Y, Z = lvl.vert_mask.shape
            if mg.sharded(li):
                sl = (X, Y, Z // mg.n_sp + 2)
                want["level_matvec_cf"].add(sl)
                want["hess_diag6_cf"].add(sl)
    for li, lvl in enumerate(solve8.mg.levels):
        if not solve8.mg.sharded(li):
            for a in ("cheby_smooth_cf", "power_lmax_cf",
                      "hess_diag_shift_cf"):
                want.setdefault(a, set()).add(tuple(lvl.vert_mask.shape))
    n_rows = part.n_own + part.n_halo + 1
    halo_rows = {(n_rows, vals.shape[1], 0, part.n_own)}
    for attr, grids in want.items():
        check(grids <= cap.shapes(attr), f"phase10 {attr}: the path ran at "
              f"{sorted(cap.shapes(attr))}, not at {sorted(grids)}")
    check(halo_rows <= cap.shapes("_spmv_rows"),
          f"phase10 spmv: halo rows {halo_rows} not among "
          f"{sorted(cap.shapes('_spmv_rows'))}")
    n_sig = cap.check(rows)
    log(f"phase10 path shapes: {n_sig} wrapper signatures, each kernel "
        "against its plain version on inputs followed by "
        f"{SENTINEL} NaNs, in {time.perf_counter() - t0:.1f} s")
    res["path_shapes"] = n_sig

    # -- the references, after the counters were read ------------------------
    t0 = time.perf_counter()
    grid1 = pdist.make_device_mesh(1, dp=1)
    slabs1 = plh.LatticeSlabs(sc74, 1, grid1)
    step1, blockify1 = plh.make_dist_step(slabs1, grid1)

    def one_slab(x, v):
        xb, _, k, fn = step1(blockify1(x), blockify1(v))
        return k, fn, slabs1.gather(xb)
    dfn, dx = check_policy("phase10 dist step 4 vs 1 slab", *got74[:3],
                           *reference_frames(one_slab, got74[3]))
    res["dist_step"].update(max_d_fn=dfn, max_d_x=dx)
    log(f"phase10 dist step vs the same code on 1 slab, frame by frame: "
        f"Newton equal, max|d fn| {dfn:.3e} max|d x| {dx:.3e}")
    ref74 = slab_frames(step1, blockify1, slabs1, sc74, FRAMES10)
    capped = {}

    def norm74(code, ins, j):
        sl, gr = (slabs, grid) if code == "got" else (slabs1, grid1)
        if (code, j) not in capped:
            capped[code, j] = plh.make_dist_step(sl, gr, max_newton=j)
        st_j, bl = capped[code, j]
        return st_j(bl(ins[0]), bl(ins[1]))[3]
    tx, splits = trajectory_policy(
        "phase10 dist step trajectory 4 vs 1 slab", got74, ref74, norm74)
    res["dist_step"].update(trajectory=dict(newton_1slab=ref74[0],
                                            max_d_x=tx, taken_apart=splits))
    log(f"phase10 dist step trajectory from rest, 4 vs 1 slab: newton "
        f"{got74[0]} vs {ref74[0]}, max|d x| {tx:.3e}, {len(splits)} frames "
        "taken apart")

    mg_q = tmg.LatticeMG(sc19, n_levels=3, dt=None, z_multiple=SLABS10)
    ref_q = tmg.quasistatic_to_tol_mg(sc19, mg_q, sc19.x0, tol=TOL,
                                      max_newton=100)
    dq = check_policy("phase10 dist MG quasistatic", [kq], [fq], [xq],
                      [ref_q[1]], [ref_q[2]], [ref_q[0]])
    d8 = check_policy("phase10 dist MG quasistatic, replicated coarsest",
                      [k8], [f8], [x8], [ref_q[1]], [ref_q[2]], [ref_q[0]])
    mg_d = tmg.LatticeMG(sc19, n_levels=3, z_multiple=SLABS10)

    def whole_mg(x, v):
        st1, k, fn = tmg.step_to_tol_mg(sc19, mg_d, x, tol=TOL)
        return k, fn, st1.x
    dmg = check_policy("phase10 dist MG step", *got_mg[:3],
                       *reference_frames(whole_mg,
                                         [(st, None) for st in ins_mg]))
    ref_mg = ([], [], [], [])
    st = sc19.init_state()
    for _ in range(FRAMES10):
        ref_mg[3].append(st)
        st, k, fn = tmg.step_to_tol_mg(sc19, mg_d, st, tol=TOL)
        for lst, v in zip(ref_mg, (k, fn, st.x)):
            lst.append(v)

    def norm_mg(code, st, j):
        return tmg.step_to_tol_mg(sc19, step_mg.mg if code == "got" else
                                  mg_d, st, tol=TOL, max_newton=j)[2]
    tmgx, splits_mg = trajectory_policy(
        "phase10 dist MG step trajectory vs LatticeMG", got_mg, ref_mg,
        norm_mg)
    log(f"phase10 dist MG vs LatticeMG (z_multiple {SLABS10}): quasistatic "
        f"newton {kq} / {k8} vs {ref_q[1]}, ||f|| {fq:.3e} / {f8:.3e} vs "
        f"{ref_q[2]:.3e}, max|d x| {dq[1]:.3e} / {d8[1]:.3e}; step frame by "
        f"frame max|d fn| {dmg[0]:.3e} max|d x| {dmg[1]:.3e}")
    slabs_res = phase10_mg_slabs(
        scenes, grid, {"19k": (solve, place_q, xq, kq, fq, ms_q),
                       "19k replicated coarsest": (solve8, place_q, x8, k8,
                                                   f8, None),
                       "74k": (solve74, place74, x74, k74, f74, ms_q74)},
        step_mg, place, ms_mg, newton7)
    slabs_res["crossings_per_solve"] = per_solve
    res["dist_mg"] = dict(
        quasistatic=dict(newton=kq, fn=fq, ms=ms_q, sharded_matvecs=mv,
                         launches=lq, max_d_x=dq[1]),
        replicated_coarsest=dict(newton=k8, fn=f8, launches=l8,
                                 max_d_x=d8[1]),
        quasistatic_74k=dict(newton=k74, fn=f74, ms=ms_q74,
                             sharded_matvecs=mv74, launches=l74),
        slabs=slabs_res,
        step=dict(ms_per_frame=ms_mg, newton=got_mg[0],
                  fn_max=max(got_mg[1]), max_d_fn=dmg[0], max_d_x=dmg[1],
                  sharded_calls=dict(step_mg.mg.calls),
                  trajectory=dict(newton_whole=ref_mg[0], max_d_x=tmgx,
                                  taken_apart=splits_mg)))
    log(f"phase10 dist MG step trajectory from rest vs LatticeMG: newton "
        f"{got_mg[0]} vs {ref_mg[0]}, max|d x| {tmgx:.3e}, {len(splits_mg)} "
        "frames taken apart")

    ref_y = ell.spmv(full, p0["nbr"], p0["mask"], xr)
    ey = max_err(y, ref_y)
    check(ey <= 1e-5 * float(ref_y.abs().max()), f"phase10 dist spmv {ey}")
    ref_cg = cgmod.cg_operator(lambda v: ell.spmv(full, p0["nbr"], p0["mask"],
                                                  v), xr, iterations=40,
                               tol=1e-12)

    def rel_res(xx):
        r = xr - ell.spmv(full, p0["nbr"], p0["mask"], xx)
        return float(torch.linalg.norm(r) / torch.linalg.norm(xr))
    r_d, r_w = rel_res(xs_cg), rel_res(ref_cg)
    check(r_d <= 1.05 * r_w + 1e-6, f"phase10 dist CG residual {r_d:.3e} vs "
          f"{r_w:.3e}")
    zero = torch.zeros(n_u, dtype=torch.float32, device=usc19.device)

    def whole_mesh(x, v):
        x = torch.from_numpy(x).to(usc19.device)
        st0 = dynamic.DynState(x=x, v=torch.from_numpy(v).to(usc19.device),
                               drag_mask=zero, drag_pos=usc19.x0)
        st1, k, fn = dynamic.step_to_tol(usc19, usc19.params, st0, tol=TOL,
                                         max_newton=20, matrix_free=True)
        return k, fn, st1.x
    du = check_policy("phase10 dist unstructured Newton", *got_u[:3],
                      *reference_frames(whole_mesh, ins_u))
    ref_u = ([], [], [], [])
    st = dynamic.init_state(usc19)
    for _ in range(NEWTON_FRAMES10):
        ref_u[3].append((st.x.cpu().numpy(), st.v.cpu().numpy()))
        st, k, fn = dynamic.step_to_tol(usc19, usc19.params, st, tol=TOL,
                                        max_newton=20, matrix_free=True)
        for lst, val in zip(ref_u, (k, fn, st.x)):
            lst.append(val)

    capped_u = {}

    def norm_u(code, ins, j):
        x, v = (torch.from_numpy(a).to(usc19.device) for a in ins)
        if code == "ref":
            st0 = dynamic.DynState(x=x, v=v, drag_mask=zero,
                                   drag_pos=usc19.x0)
            return dynamic.step_to_tol(usc19, usc19.params, st0, tol=TOL,
                                       max_newton=j, matrix_free=True)[2]
        if j not in capped_u:
            capped_u[j] = phalo.make_dist_newton_step(usc19, part, grid,
                                                      tol=TOL, max_newton=j)
        step_j, sh = capped_u[j], grid.line("sp")
        return step_j(phalo.slab_scatter(part, x, sh),
                      phalo.slab_scatter(part, v, sh))[3]
    tux, splits_u = trajectory_policy(
        "phase10 dist unstructured Newton trajectory vs step_to_tol", got_u,
        ref_u, norm_u)
    log(f"phase10 dist unstructured Newton trajectory from rest vs "
        f"step_to_tol(matrix_free): newton {got_u[0]} vs {ref_u[0]}, "
        f"max|d x| {tux:.3e}, {len(splits_u)} frames taken apart")
    log(f"phase10 dist spmv 19k max|d| {ey:.3e}; dist CG 40 iterations "
        f"relative residual {r_d:.3e} (whole mesh {r_w:.3e}); dist Newton vs "
        f"step_to_tol(matrix_free) frame by frame max|d fn| {du[0]:.3e} "
        f"max|d x| {du[1]:.3e}")
    res["dist_unstructured"] = dict(spmv_err=ey, cg_rel_res=r_d,
                                    ms_per_frame=ms_u, newton=got_u[0],
                                    fn_max=max(got_u[1]), max_d_x=du[1],
                                    trajectory=dict(newton_whole=ref_u[0],
                                                    max_d_x=tux,
                                                    taken_apart=splits_u))

    ref_b = dynamic.step(usc2, usc2.params, dynamic.init_state(usc2)).x
    same = all(bool(torch.equal(xbt[i], xbt[0])) for i in range(8))
    check(same and bool(torch.equal(xbt[0], ref_b)),
          "phase10 batched step: entries differ or differ from one step")
    log(f"phase10 batched step: 8 scenes on {grid_b.shape}, entries "
        "identical and equal to the single-scene step; batched_scenes "
        f"{ms_b:.2f} ms a batched frame, max||f|| {float(fns_b.max()):.3e}")
    res["batched"] = dict(ms_per_batched_frame=ms_b,
                          fn_max=float(fns_b.max()))
    res["dryrun"] = lines
    res["placed"] = phase10_placed_checks(pscenes, psolves, pstep, placed,
                                          rows, card_line())
    log(f"phase10 references in {time.perf_counter() - t0:.1f} s")
    res["hierarchy_build"] = hierarchy_build_times()
    return res, launches


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
    rows.update(phase4_smoothers(uscenes, reps=20))
    rows["fused_pcg"], rhs = phase4_pcg(scenes, inputs, reps=20)
    counts["fused_pcg"] = phase4_pcg_path(scenes, inputs, rhs)
    uresults, ell_counts = phase5(uscenes)
    counts.update(ell_counts)
    # ell_gs's launches on the main paths by (rows, form): phases 5, 8, 9
    # and 10 each zero the counts first
    gs_shapes = {}

    def add_gs_shapes():
        for key, v in ek.gs_launches.items():
            gs_shapes[key] = gs_shapes.get(key, 0) + v
    add_gs_shapes()
    rel6, err6 = phase6(uscenes["19k"])
    levels7 = phase7_kernels(scenes, rows, reps=20)
    results7, counts7 = phase7_path(scenes)
    phase7_against_first_forms(results7)
    for name in ("cheby", "diag_shift", "power", "hvp", "diag"):
        counts[name] = counts7[name]
    # lat_cheby's and lat_power's launches on the main paths by (kernel,
    # shape, form): phases 7 and 10 each zero the counts first
    level_shapes = dict(lk.level_launches)
    rel7 = phase7_cpu(scenes["19k"])
    cloths = {label: cloth_scene(res, dev) for label, res in CLOTHS.items()}
    phase8_spmv(cloths, rows["spmv"], reps=50)
    results8, counts8 = phase8(cloths, uscenes["2k"])
    add_gs_shapes()
    for name in ELL_FORWARD:
        counts[name] += counts8[name]
    t0 = time.perf_counter()
    sc21 = Scene(meshlib.beam(*EXP_BEAM, dx=DX),
                 solver=SolverConfig(n_levels=2), device=dev)
    sc21_cpu = Scene(sc21.mesh, solver=sc21.solver, device="cpu")
    log(f"phase9 scene 21k levels {sc21.n_levels} vertices "
        + " / ".join(str(lv.n_verts) for lv in sc21.hier.levels)
        + f" K {sc21.level(0).K} (card and CPU built in "
        f"{time.perf_counter() - t0:.1f} s)")
    rows9, jacobi9, jacobi9_err = phase9_kernels(uscenes, sc21, cloths,
                                                 reps=20)
    rows.update(rows9)
    rows["jacobi"]["by_level"] += jacobi9
    rows["jacobi"]["max_abs_err"] = max(rows["jacobi"]["max_abs_err"],
                                        jacobi9_err)
    results9, counts9 = phase9(sc21, uscenes["2k"], sc21_cpu)
    add_gs_shapes()
    for name in ELL_FORWARD:
        counts[name] += counts9[name]
    for name in ELL_BACKWARD:
        counts[name] = counts9[name]

    results10 = phase10_operators(scenes["74k"], rows, reps=20)
    path10, counts10 = phase10_path(
        scenes, uscenes, rows,
        results7["solves"]["74k quasistatic_to_tol_mg"]["newton"])
    results10.update(path10)
    add_gs_shapes()
    for key, v in counts10.pop("level_by_form").items():
        level_shapes[key] = level_shapes.get(key, 0) + v
    for name in counts:
        counts[name] += counts10.get(name, 0)
    results11, counts11 = phase11(rows)
    for name, cname in COVER_MODES.items():
        counts[name] += counts11[cname]

    log("gs launches on the main paths by (rows, form): "
        + ", ".join(f"{n} {form} {c}"
                    for (n, form), c in sorted(gs_shapes.items())))
    check(sum(gs_shapes.values()) == counts["gs"], f"gs launches by shape "
          f"{gs_shapes} do not add up to {counts['gs']}")
    log("jacobi launches on the main paths by (rows, form): "
        + ", ".join(f"{n} {form} {c}" for (n, form), c in sorted(
            JACOBI_PATH_SHAPES.items())))
    check(sum(JACOBI_PATH_SHAPES.values()) == counts["jacobi"], f"jacobi "
          f"launches by shape {JACOBI_PATH_SHAPES} do not add up to "
          f"{counts['jacobi']}")
    log("level kernel launches on the main paths by (kernel, shape, form): "
        + ", ".join(f"{k} {s} {f} {c}"
                    for (k, s, f), c in sorted(level_shapes.items())))
    for name in ("cheby", "power"):
        n = sum(c for (k, _, _), c in level_shapes.items() if k == name)
        check(n == counts[name], f"{name} launches by shape and form {n} "
              f"do not add up to {counts[name]}")
    summary = {label: {k: v for k, v in r.items() if k != "state8"}
               for label, r in results.items()}
    log("phase2 summary " + json.dumps(summary))
    log("phase5 summary " + json.dumps(uresults))
    log("phase7 summary " + json.dumps(results7))
    log("phase8 summary " + json.dumps(results8))
    log("phase9 summary " + json.dumps(results9))
    log("phase10 summary " + json.dumps(results10))
    log("phase11 summary " + json.dumps(results11, default=str))
    log(f"phase3 max|dx| {err3:.3e}  phase6 max rel |d f| {rel6:.3e} "
        f"max|d x| {err6:.3e}  phase7 max rel |d f| {rel7:.3e}")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    # the kernels the multigrid path launches: the line's numbers from its
    # 19k fine level (lat_cheby: a pre-smooth with its residual;
    # lat_diag_shift: projected; lat_power), the backward kernels' from the
    # 21k beam's coarse level, the others' from the 19k beam
    fine19 = levels7["19k"][0]
    at_level = {"cheby": fine19["cheby_pre"],
                "diag_shift": fine19["diag_shift"], "power": fine19["power"]}
    # the backward kernels' numbers at the exp2 cycle's coarse matrix of the
    # 21k beam, the shape the learning path gives them
    for name in ELL_BACKWARD:
        at_level[name] = next(e for e in rows[name]["by_level"]
                              if (e["beam"], e["level"]) == ("21k", 1)
                              and e["form"] in (None, JACOBI_BWD_PATH_FORM))
    # ell_jacobi's there too: exp2's coarse solve, one iteration from zero,
    # the most launched of its paths' calls
    at_level["jacobi"] = next(e for e in rows["jacobi"]["by_level"]
                              if (e["beam"], e["level"], e["form"])
                              == ("21k", 1, "zero start"))
    per_level = {"cheby": ("cheby_pre", "cheby_post", "cheby_coarse",
                           "cheby_plan"),
                 "diag_shift": ("diag_shift", "diag_shift_unprojected",
                                "diag_shift_ties", "diag_shift_plan"),
                 "diag": ("diag", "diag_plan"),
                 "hvp": ("hvp", "hvp_two_pass", "level_matvec", "hvp_plan"),
                 "power": ("power", "power_plan", "lmax")}

    def row(name, launches):
        r = rows[name]
        at = at_level.get(name, r["by_beam"].get("19k"))
        out = {"name": name, "route": "cuda",
               "source": (ELL_SOURCE if name in ELL_FORWARD + ELL_BACKWARD
                          else LATTICE_SOURCE),
               "replaces": TPU_KERNELS[name], "launches": launches,
               "max_abs_err": r["max_abs_err"], "ms": at["ms"],
               "plain_ms": at["plain_ms"], "bound_ms": at["bound_ms"],
               "bound_by": at["bound_by"],
               "library_ms": at.get("library_ms"), "by_beam": r["by_beam"]}
        if "by_slab" in r:           # phase 10: at the 74k slab shape
            out["by_slab"] = r["by_slab"]
        if "by_path_shape" in r:     # phase 10: every shape of its path;
                                     # phase 11: the cover modes
            out["by_path_shape"] = r["by_path_shape"]
        if "by_cloth" in r:          # phase 8: at the cloth Hessians
            out["by_cloth"] = r["by_cloth"]
        if name in ELL_BACKWARD:     # phase 9: every shape it ran at
            out["by_level"] = r["by_level"]
        if name == "jacobi":         # phase 4's levels and phase 9's exp2
                                     # coarse matrix, each form; the paths'
            out["by_level"] = r["by_level"]
            out["by_shape"] = [{"n": n, "form": form, "launches": c}
                               for (n, form), c in sorted(
                                   JACOBI_PATH_SHAPES.items())]
        if name == "gs":             # phase 4's levels, the paths' shapes
            out["by_level"] = r["by_level"]
            out["by_shape"] = [{"n": n, "form": form, "launches": c}
                               for (n, form), c in sorted(gs_shapes.items())]
        if name in per_level:        # phase 7: at the multigrid level shapes
            out["by_level"] = {
                label: [{"level": e["level"], "shape": e["shape"],
                         **{case: e[case] for case in per_level[name]
                            if case in e}} for e in entries]
                for label, entries in levels7.items()}
        if name in ("cheby", "power"):  # phase 7: every form, each shape;
                                        # the paths' launches by form
            out["by_form"] = {
                label: [{"level": e["level"], **{
                    call: forms for call, forms in e["level_forms"].items()
                    if (call == "power") == (name == "power")}}
                    for e in entries]
                for label, entries in levels7.items()}
            out["by_shape"] = [{"shape": list(s), "form": f, "launches": c}
                               for (k, s, f), c in sorted(
                                   level_shapes.items()) if k == name]
        return out
    log(card)
    print(json.dumps({
        "kernels": [row(n, counts[n]) for n in ("fused_newton", "force",
                                                "energy", "fused_pcg",
                                                "spmv", "gs", "jacobi",
                                                "hvp", "diag", "cheby",
                                                "diag_shift", "power",
                                                "spmv_t", "outer",
                                                "jacobi_bwd")],
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
