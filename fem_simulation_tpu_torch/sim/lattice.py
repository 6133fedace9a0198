"""Structured-lattice simulation: implicit Euler and quasi-static Newton.

Port of `fem_simulation_tpu/sim/lattice.py` (dense-grid scene, residual,
energy, elastic Hessian operators, `step_to_tol`, `frame_adaptive`,
`armijo_step`, `newton_update`, `adaptive_continuation`,
`quasistatic_to_tol`, `LatticeDynamicSim`). Every field lives on the
bounding vertex lattice (X, Y, Z, 3) on the scene's device. Each Newton
iteration is one `fused_newton` call: the CUDA kernel for CUDA tensors,
its plain torch composition for CPU tensors.

The Newton, Armijo, substepping and load-continuation loops run on the
host. Each Newton iteration reads the trial residual norm back (one device
sync); a solve reads its initial residual once more. Host-side scalar tests
are made in float32, as the reference makes them on device scalars.

Every blocking device-to-host read goes through `readback`. `counts` holds
the frames, the fused Newton iterations, the reads and the rescues, always
on (`reset_counts`). While tracing is on (`utils/profiling.py`), a frame is
the span `lattice.frame` (its request id the frame's number in `counts`),
with `lattice.setup` (the predictor and the frame-constant fields),
`lattice.newton` (an iteration), `lattice.rescue` (the Armijo rescue) and
`lattice.readback` (a read) inside it; a scene's build is the span
`lattice.scene`, recorded always.

Low-fill meshes (shells, thin plates, multi-part scenes) take the cover of
`ops/boxes.py`, the counterpart of the reference's box cover: when the
fused Newton kernel's modelled cell passes over the cover cost less than
`box_threshold` times the dense grid's, the scene holds a `cover`, and the
residual force, the energy and every `fused_newton` call compute its real
cells or active tiles only (one launch each, as on the dense grid). The
vertex-diagonal and Hessian operators (`elastic_diag`, `elastic_hvp_fn`)
stay on the dense grid, which is exact.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device_or_cuda
from .. import hierarchy as hl
from .. import mesh as meshlib
from ..config import DynamicsConfig, MaterialConfig
from ..ops import boxes as boxlib
from ..ops import ell, stencil
from ..ops import lattice_kernels as lk
from ..solvers import cg as cgmod
from ..utils import profiling

# frames: step_to_tol calls; newton: fused_newton iterations of step_to_tol
# and quasistatic_to_tol; syncs: blocking reads through readback; rescues:
# the Armijo rescues of step_to_tol
counts = {"frames": 0, "newton": 0, "syncs": 0, "rescues": 0}


def reset_counts() -> None:
    for name in counts:
        counts[name] = 0


def readback(t: torch.Tensor):
    """t.item(): a blocking device-to-host read, counted in counts["syncs"]
    and traced as the span lattice.readback."""
    counts["syncs"] += 1
    with profiling.span("lattice.readback"):
        return t.item()


class LatState(NamedTuple):
    x: torch.Tensor          # (X, Y, Z, 3)
    v: torch.Tensor
    drag_mask: torch.Tensor  # (X, Y, Z) 1.0 where grabbed
    drag_pos: torch.Tensor   # (X, Y, Z, 3) grab targets


class LatticeScene:
    """Lattice embedding of a voxel mesh + per-vertex fields on `device`.

    use_boxes / box_threshold: the low-fill cover (ops/boxes.py) engages
    when the mask leaves a cell empty and box_cost_ratio, the fused Newton
    kernel's modelled cell-pass time over the cover against the dense
    grid's (on this device's SMs; an H100's for a CPU scene), is below
    box_threshold. `cover` is the engaged Cover or None."""

    def __init__(self, mesh: meshlib.HexMesh,
                 material: MaterialConfig = MaterialConfig(), pins=None,
                 device=None, use_boxes: bool = True,
                 box_threshold: float = 0.5):
        self.mesh = mesh
        self.material = material
        self.device = device_or_cuda(device)
        with profiling.span("lattice.scene", always=True):
            self._build(mesh, material, pins, use_boxes, box_threshold)

    def _build(self, mesh, material, pins, use_boxes, box_threshold):
        """The lattice map, the fields on the device and the cover."""
        lvl = hl.build_level_topology(mesh.x, mesh.ijk, mesh.hexes, mesh.dx)
        self.lvl = lvl
        self.shape, lat, _, self.fill = stencil.build_lattice_map(lvl)

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        self.lat = dev(lat)

        # cell mask from hex min corners
        cell_shape = tuple(s - 1 for s in self.shape)
        cmask = np.zeros(cell_shape, np.float32)
        lo = lvl.ijk.min(axis=0)
        cidx = lvl.ijk[lvl.hexes[:, 0].astype(np.int64)] - lo
        cmask[cidx[:, 0], cidx[:, 1], cidx[:, 2]] = 1.0
        self.cell_mask = dev(cmask)

        self.g_tab, self.det = stencil.lattice_material_tables(mesh.dx,
                                                               self.device)

        vmask = np.zeros(self.shape, np.float32)
        vmask[lat[:, 0], lat[:, 1], lat[:, 2]] = 1.0
        self.vert_mask = dev(vmask)

        # lumped mass: each corner of each real cell gets det*8 (cell volume)
        cell_vol = float(self.det * 8.0) * material.density
        m = np.zeros(self.shape, np.float32)
        for (di, dj, dk) in stencil._CORNERS:
            m[di:di + cell_shape[0], dj:dj + cell_shape[1],
              dk:dk + cell_shape[2]] += cmask * cell_vol
        self.mass = dev(m)

        self.x0 = stencil.field_to_lattice(dev(lvl.x0), self.lat, self.shape)
        # pins: top slab by default
        if pins is None or len(pins) == 0:
            y = lvl.x0[:, 1]
            pin_ids = np.nonzero(y >= y.max() - mesh.dx - 1e-5)[0]
        else:
            # pins given in original mesh vertex order -> canonical
            perm, _ = hl.color_sort(mesh.ijk)
            inv = np.empty_like(perm)
            inv[perm] = np.arange(perm.size)
            pin_ids = inv[np.asarray(pins, np.int64)]
        pm = np.zeros(self.shape, np.float32)
        pl = lat[pin_ids]
        pm[pl[:, 0], pl[:, 1], pl[:, 2]] = 1.0
        self.pin_mask = dev(pm)
        self.pin_pos = self.x0

        cover = boxlib.Cover(cmask)
        sms = (lk._sms(self.cell_mask.device.index)
               if self.device.type == "cuda" else boxlib.PLAN_SMS)
        self.box_cost_ratio = cover.cost_ratio(sms) if cover.sparse else 1.0
        self.cover = (cover if use_boxes and cover.sparse
                      and self.box_cost_ratio < box_threshold else None)
        if self.cover is not None:
            # the vertices the covered Newton kernel walks: the lattice map's
            self.cover.walked(self.vert_mask, len(lat))

    # -- elastic ops (displacement form: u = x - x0 is taken here, once) ----
    def elastic_force(self, x):
        mat = self.material
        u_cf = (x - self.x0).permute(3, 0, 1, 2).contiguous()
        f = lk.force_cf(u_cf, self.cell_mask, self.mesh.dx, mat.lame_mu,
                        mat.lame_la, cover=self.cover)
        return f.permute(1, 2, 3, 0)

    def elastic_diag(self, x):
        """Vertex-diagonal elastic Hessian blocks (X, Y, Z, 3, 3) at x."""
        mat = self.material
        return lk.hess_diag_lattice(x - self.x0, self.cell_mask, self.mesh.dx,
                                    mat.lame_mu, mat.lame_la)

    def elastic_hvp_fn(self, x):
        """matvec(p) = (elastic Hessian at x) @ p on (X, Y, Z, 3) fields, the
        negated derivative of elastic_force along p. The displacement's
        channel-first copy is taken once, here."""
        mat = self.material
        u_cf = (x - self.x0).permute(3, 0, 1, 2).contiguous()

        def matvec(p):
            return lk.hvp_cf(u_cf, p.permute(3, 0, 1, 2).contiguous(),
                             self.cell_mask, self.mesh.dx, mat.lame_mu,
                             mat.lame_la).permute(1, 2, 3, 0)
        return matvec

    def elastic_energy(self, x):
        mat = self.material
        return lk.elastic_energy_lattice(x - self.x0, self.cell_mask,
                                         self.mesh.dx, mat.lame_mu,
                                         mat.lame_la, cover=self.cover)

    def init_state(self) -> LatState:
        return LatState(x=self.x0, v=torch.zeros_like(self.x0),
                        drag_mask=torch.zeros(self.shape, dtype=self.x0.dtype,
                                              device=self.device),
                        drag_pos=self.x0)

    # residual force of the implicit step at x, given predictor x_tilde
    def dyn_force(self, x, x_tilde, inv_dt, drag_mask=None, drag_pos=None,
                  gravity_scale=1.0):
        mat = self.material
        f = self.elastic_force(x).clone()
        f[..., 1] += self.mass * mat.gravity * gravity_scale
        f = f + mat.control_mag * self.pin_mask[..., None] * (self.pin_pos - x)
        if drag_mask is not None:
            f = f + mat.control_mag * drag_mask[..., None] * (drag_pos - x)
        f = f - (self.mass * inv_dt * inv_dt)[..., None] * (x - x_tilde)
        return f * self.vert_mask[..., None]

    def total_energy(self, x, gravity_scale=1.0):
        """Quasi-static total energy: elastic + gravity + pin penalty."""
        mat = self.material
        e_el = self.elastic_energy(x)
        e_g = -torch.sum(self.mass * mat.gravity * gravity_scale * x[..., 1])
        d = (x - self.pin_pos) * self.vert_mask[..., None]
        e_pin = 0.5 * mat.control_mag * torch.sum(
            self.pin_mask[..., None] * d * d)
        return e_el + e_g + e_pin


def step_to_tol(scene: LatticeScene, st: LatState,
                dyn: DynamicsConfig = DynamicsConfig(),
                tol: float = 1e-4, max_newton: int = 20,
                cg_iterations: int = 60, cg_tol: float = 1e-2,
                dt=None, damping=None, gravity_scale=1.0,
                return_cg: bool = False):
    """One frame: predictor + Newton with block-Jacobi PCG to ||f||_inf <= tol.

    Every Newton iteration is one `fused_newton` call. A full step that
    grows the residual wildly or non-finitely is redone as an Armijo
    backtrack on the incremental potential (the blowup rescue).

    Returns (state, newton iterations, exit norm), plus the frame's total
    PCG matvec count with return_cg=True. The frame, its iterations, its
    reads and its rescues are counted in `counts`.
    """
    counts["frames"] += 1
    with profiling.span("lattice.frame", request=counts["frames"]):
        with profiling.span("lattice.setup"):
            dt = dyn.dt if dt is None else dt
            damping = dyn.damping if damping is None else damping
            inv_dt = 1.0 / dt
            mat = scene.material
            x_old = st.x
            v = st.v * damping
            x = st.x + v * dt
            x_tilde = x

            def resid(xx):
                return scene.dyn_force(xx, x_tilde, inv_dt,
                                       drag_mask=st.drag_mask,
                                       drag_pos=st.drag_pos,
                                       gravity_scale=gravity_scale)

            ctrl = (mat.control_mag * torch.maximum(scene.pin_mask,
                                                    st.drag_mask)
                    + scene.mass * inv_dt * inv_dt
                    # empty lattice rows get identity so the 3x3 solve is
                    # benign
                    + (1.0 - scene.vert_mask))
            vmask3 = scene.vert_mask[..., None]

            def ie_energy(xe):
                """Implicit-Euler incremental potential (resid == -grad of
                this)."""
                e = scene.total_energy(xe, gravity_scale=gravity_scale)
                dd = (xe - st.drag_pos) * vmask3
                e = e + 0.5 * mat.control_mag * torch.sum(
                    st.drag_mask[..., None] * dd * dd)
                di = (xe - x_tilde) * vmask3
                return e + 0.5 * inv_dt * inv_dt * torch.sum(
                    scene.mass[..., None] * di * di)

            # frame-constant affine residual: f(x) = f_el(u) + s - rc*u,
            # u = x - x0; rc is the exact SUM of penalty/inertia
            # coefficients, distinct from ctrl's max(pin, drag) Hessian shift
            rc = (mat.control_mag * (scene.pin_mask + st.drag_mask)
                  + scene.mass * inv_dt * inv_dt)
            s_aff = (mat.control_mag
                     * (scene.pin_mask[..., None] * scene.pin_pos
                        + st.drag_mask[..., None] * st.drag_pos)
                     + (scene.mass * inv_dt * inv_dt)[..., None] * x_tilde)
            s_aff[..., 1] += scene.mass * mat.gravity * gravity_scale
            s_cf = (s_aff - rc[..., None] * scene.x0).permute(
                3, 0, 1, 2).contiguous()

        tol32 = np.float32(tol)
        cond = cgmod.newton_cond(tol, max_newton)
        fn = host_inf_norm(resid(x))
        fmin = fn
        k = 0
        cg_tot = (torch.zeros((), dtype=torch.int32, device=scene.device)
                  if return_cg else None)
        while cond((x, k, fn, fmin)):
            counts["newton"] += 1
            with profiling.span("lattice.newton"):
                dx_cf, f_cf, fn_full, cg_k = lk.fused_newton(
                    (x - scene.x0).permute(3, 0, 1, 2).contiguous(), s_cf,
                    scene.cell_mask, ctrl, rc, scene.vert_mask,
                    scene.mesh.dx, mat.lame_mu, mat.lame_la,
                    iterations=cg_iterations, tol=cg_tol, cover=scene.cover)
                if return_cg:
                    # pcg's iteration count starts at 1: matvecs executed =
                    # cg_k - 1
                    cg_tot = cg_tot + cg_k - 1
                dx = dx_cf.permute(1, 2, 3, 0)
                fn_full = np.float32(readback(fn_full))
                with np.errstate(over="ignore"):
                    bad = (not np.isfinite(fn_full)
                           or fn_full > np.float32(30.0) * max(fn, tol32))
                if bad:
                    # Rescue: a full step on a fast-swinging StVK body can
                    # blow up; Armijo on the incremental potential
                    # guarantees descent.
                    counts["rescues"] += 1
                    with profiling.span("lattice.rescue"):
                        f = f_cf.permute(1, 2, 3, 0)
                        x = armijo_step(ie_energy, x, f, dx, vmask3)
                        fn = host_inf_norm(resid(x))
                else:
                    x = x + dx * vmask3
                    fn = fn_full
                k += 1
                fmin = np.minimum(fmin, fn)
        v = (x - x_old) * inv_dt
        out = st._replace(x=x, v=v), k, cgmod.newton_exit_norm(fn, fmin)
        return out + (int(readback(cg_tot)),) if return_cg else out


def adaptive_frame(step, st: LatState, dyn: DynamicsConfig, tol: float,
                   max_halvings: int):
    """The substepping protocol of frame_adaptive (shared with
    lattice_mg.frame_adaptive_mg): run the frame as 1, 2, 4, ... substeps
    until every substep reaches tol, each attempt from the original state,
    at most 2^max_halvings substeps. `step(state, dt, damping)` returns
    (state, k, fn); dt = dyn.dt / n and damping = dyn.damping^(1/n) in
    float32, so n substeps advance dyn.dt and compose to the frame's decay.
    Returns (state, max Newton over the accepted attempt's substeps, its
    worst exit norm, n_substeps)."""
    f32 = np.float32
    tol32 = f32(tol)
    h, n_sub, s, kmax, fworst = 0, 1, st, 0, f32(np.inf)
    while fworst > tol32 and h <= max_halvings:
        n_sub = 1 << h
        n_f = f32(n_sub)
        dt = f32(dyn.dt) / n_f
        damp = f32(dyn.damping) ** (f32(1.0) / n_f)
        s, i, kmax, fworst = st, 0, 0, f32(0.0)
        # stop early once a substep misses tol: the frame is redone
        while i < n_sub and fworst <= tol32:
            s, k, fn = step(s, dt, damp)
            i += 1
            kmax = max(kmax, k)
            fworst = np.maximum(fworst, f32(fn))
        h += 1
    return s, kmax, float(fworst), n_sub


def frame_adaptive(scene: LatticeScene, st: LatState,
                   dyn: DynamicsConfig = DynamicsConfig(),
                   tol: float = 1e-4, max_newton: int = 20,
                   cg_iterations: int = 60, cg_tol: float = 1e-2,
                   max_halvings: int = 3, gravity_scale=1.0):
    """One frame of dyn.dt with adaptive time substepping: when a substep
    exits its Newton budget above tol, the whole frame is redone from the
    original state at half the substep length (adaptive_frame). Implicit
    Euler's solve gets easier as dt shrinks (m/dt^2 dominates). Returns
    (state, max Newton, worst substep exit norm, n_substeps)."""
    def step(s, dt, damp):
        return step_to_tol(scene, s, dyn, tol, max_newton, cg_iterations,
                           cg_tol, dt=dt, damping=damp,
                           gravity_scale=gravity_scale)
    return adaptive_frame(step, st, dyn, tol, max_halvings)


def armijo_step(energy_fn, xx, f, dx, vmask3, n_back: int = 16,
                c1: float = 1e-4):
    """Backtracking line search on the energy (f = -grad E): truncated
    Newton direction + Armijo, falling back to steepest descent when the
    direction is not a descent direction."""
    d = dx * vmask3
    gTd = -ell.vdot(f, d)
    if readback(gTd >= 0.0):
        d = f
        gTd = -ell.vdot(f, f)
    e0 = energy_fn(xx)
    t = torch.ones((), dtype=xx.dtype, device=xx.device)
    done = False
    k = 0
    while not done and k < n_back:
        e1 = energy_fn(xx + t * d)
        done = readback(e1 <= e0 + c1 * t * gTd)
        if not done:
            t = t * 0.5
        k += 1
    return xx + (t if done else torch.zeros_like(t)) * d


class LatticeDynamicSim:
    def __init__(self, mesh: meshlib.HexMesh,
                 material: MaterialConfig = MaterialConfig(),
                 dyn: DynamicsConfig = DynamicsConfig(), pins=None,
                 device=None):
        self.scene = LatticeScene(mesh, material, pins=pins, device=device)
        self.dyn = dyn
        self.state = self.scene.init_state()

    def positions(self):
        """Current positions in canonical (color-sorted) vertex order."""
        return stencil.field_from_lattice(self.state.x, self.scene.lat)

    def frame_to_tol(self, tol=1e-4, max_newton=20):
        self.state, k, f = step_to_tol(self.scene, self.state, self.dyn, tol,
                                       max_newton)
        return self.state, k, f

    def frame_adaptive_to_tol(self, tol=1e-4, max_newton=20,
                              max_halvings=3):
        """frame_to_tol with adaptive time substepping (frame_adaptive).
        Returns (state, k, fn, n_substeps)."""
        self.state, k, f, n = frame_adaptive(self.scene, self.state,
                                             self.dyn, tol, max_newton,
                                             max_halvings=max_halvings)
        return self.state, k, f, n

    def set_drag(self, mask_canonical, targets_canonical):
        """Drag constraints given in canonical vertex order: a (N,) mask and
        (N, 3) targets, numpy arrays or tensors."""
        sc = self.scene

        def dev(a):
            return torch.as_tensor(a, dtype=torch.float32, device=sc.device)
        dm = stencil.field_to_lattice(dev(mask_canonical)[:, None], sc.lat,
                                      sc.shape)[..., 0]
        dp = stencil.field_to_lattice(dev(targets_canonical), sc.lat,
                                      sc.shape)
        self.state = self.state._replace(drag_mask=dm, drag_pos=dp)

    def clear_drag(self):
        self.state = self.state._replace(
            drag_mask=torch.zeros_like(self.state.drag_mask))


def host_inf_norm(t: torch.Tensor) -> np.float32:
    """max |t| read back to the host as a float32 (one device sync)."""
    return np.float32(readback(ell.inf_norm(t)))


def newton_update(xx, f, dx, vmask3, fn_prev, energy_fn, resid_inf,
                  line_search: bool, fn_full=None):
    """Quasi-static Newton step acceptance: the full step when it lowers
    the residual, else an Armijo backtrack on the energy. A full step at
    ||f|| ~ 1e-4 lowers the total energy by less than its float32 noise,
    so an unconditional line search stalls near tolerance; the energy
    search still guards the indefinite large-deformation region, where
    diverging steps grow the residual. The test is strict: a PCG that meets
    negative curvature in its first iteration returns dx = 0, which leaves
    the residual as it was and must go to the fallback (steepest descent
    there), or Newton repeats the same null step to its budget. The
    reference's `<=` reaches the fallback in that case only through the
    rounding of its two residual evaluations. `fn_full` may carry
    ||f(x + dx)||_inf (the fused kernel computes it in its launch);
    resid_inf(x) returns a host float32. Returns (x, fn) with fn a host
    float32."""
    x_full = xx + dx * vmask3
    fn_full = resid_inf(x_full) if fn_full is None else np.float32(fn_full)
    if not line_search or fn_full < np.float32(fn_prev):
        return x_full, fn_full
    x_ls = armijo_step(energy_fn, xx, f, dx, vmask3)
    return x_ls, resid_inf(x_ls)


def adaptive_continuation(solve_at, x, tol: float, max_newton_stage: int,
                          max_stages: int = 64, fast_k: int | None = None,
                          dgs0: float = 1.0, min_dgs: float = 1.0 / 256.0,
                          return_trace: bool = False):
    """Adaptive incremental loading: march gravity_scale 0 -> 1 with a
    step-doubling / halving trust region on the load increment.

    Each stage solves at gs = gs_done + dgs with a bounded Newton budget.
    Success commits the stage (and doubles dgs if it took at most fast_k
    iterations). A failed stage that halved the residual of the previous
    attempt at this load is retried from its own end state (warm start);
    any other failure halves dgs and retries from the last committed
    state. The first stage tries gs = 1 outright.

    solve_at(x, gs) -> (x, k, fn). Returns (x, k_total, fn_final), k_total
    summing every stage, rejected ones included; fn_final is +inf when the
    continuation stalled before gs = 1. With return_trace=True also a
    (max_stages, 3) float32 numpy array of per-stage (gs, newton, fn) rows,
    nan-padded."""
    f32 = np.float32
    if fast_k is None:
        fast_k = max(max_newton_stage // 4, 4)
    tol32, one = f32(tol), f32(1.0)
    gs_done, dgs = f32(0.0), f32(dgs0)
    x_good, ktot, n = x, 0, 0
    fn, fn_prev = f32(np.inf), f32(np.inf)
    trace = np.full((max_stages, 3), np.nan, np.float32)
    while gs_done < one and n < max_stages and dgs >= f32(min_dgs):
        gs = gs_done + min(dgs, one - gs_done)
        xn, k, fn = solve_at(x, gs)
        fn = f32(fn)
        ok = bool(fn <= tol32)
        # warm start: the attempt halved the residual of the previous
        # attempt at this same load; keep grinding it instead of rejecting
        warm = (not ok) and bool(np.isfinite(fn)) and bool(
            fn <= f32(0.5) * fn_prev)
        if ok:
            x_good = xn
            gs_done = gs
            if k <= fast_k:
                dgs = dgs * f32(2.0)
        elif not warm:
            dgs = dgs * f32(0.5)
        x = xn if (ok or warm) else x_good
        # fn_prev tracks attempts at ONE load value; reset when gs changes
        fn_prev = fn if warm else f32(np.inf)
        trace[n] = (gs, k, fn)
        ktot += k
        n += 1
    if gs_done < one:
        x, fn = x_good, f32(np.inf)
    out = x, ktot, float(fn)
    return out + (trace,) if return_trace else out


def run_load_schedule(solve_at, x, tol, max_newton, load_steps,
                      return_trace: bool = False):
    """Shared tail of the quasi-static drivers: single shot (load_steps 1),
    fixed K-stage gravity continuation at scales i/K (each stage warm
    started from the last, k summed), or adaptive_continuation ("auto")."""
    if load_steps == "auto":
        return adaptive_continuation(solve_at, x, tol, max_newton,
                                     return_trace=return_trace)
    if return_trace:
        raise ValueError("return_trace requires load_steps='auto'")
    if load_steps <= 1:
        return solve_at(x, 1.0)
    ktot = 0
    for gs in np.linspace(1.0 / load_steps, 1.0, load_steps,
                          dtype=np.float32):
        x, k, fn = solve_at(x, gs)
        ktot += k
    return x, ktot, fn


def quasistatic_to_tol(scene: LatticeScene, x, tol: float = 1e-4,
                       max_newton: int = 50, cg_iterations: int = 60,
                       cg_tol: float = 1e-2, line_search: bool = True,
                       load_steps: int | str = 1,
                       return_trace: bool = False,
                       cg_forcing: str | None = None,
                       return_cg: bool = False):
    """Quasi-static Newton to ||f||_inf <= tol on the lattice: the machinery
    of step_to_tol with no inertia and no predictor. Each Newton iteration
    is one fused_newton call with the pin-only affine decomposition at the
    stage's load scale; a step that grows the residual is redone as an
    Armijo backtrack on the total energy (newton_update). Returns
    (x, k, fn).

    load_steps > 1: gravity continuation at scales i/K, max_newton per
    stage, k summed over stages; "auto": adaptive_continuation.
    cg_forcing="ew": the Eisenstat-Walker inner tolerance (ew_eta; the PCG
    tol is eta^2, relative on ||r||^2) in place of cg_tol. return_cg
    (single shot only) appends the PCG matvec total."""
    mat = scene.material
    ctrl = mat.control_mag * scene.pin_mask + (1.0 - scene.vert_mask)
    rc = mat.control_mag * scene.pin_mask
    vmask3 = scene.vert_mask[..., None]

    def resid_inf(xx, gs):
        return host_inf_norm(scene.dyn_force(xx, xx, 0.0, gravity_scale=gs))

    def solve_at(x0, gs):
        # affine residual at this load: f(x) = f_el(u) + s - rc u, u = x - x0
        s_aff = rc[..., None] * scene.pin_pos
        s_aff[..., 1] += scene.mass * mat.gravity * gs
        s_cf = (s_aff - rc[..., None] * scene.x0).permute(3, 0, 1,
                                                           2).contiguous()
        cond = cgmod.newton_cond(tol, max_newton)
        xx, k, fn = x0, 0, resid_inf(x0, gs)
        fmin, eta = fn, np.float32(0.5)
        cg_tot = (torch.zeros((), dtype=torch.int32, device=scene.device)
                  if return_cg else None)
        while cond((xx, k, fn, fmin)):
            counts["newton"] += 1
            tol_rr = eta * eta if cg_forcing == "ew" else cg_tol
            dx_cf, f_cf, fn_full, cg_k = lk.fused_newton(
                (xx - scene.x0).permute(3, 0, 1, 2).contiguous(), s_cf,
                scene.cell_mask, ctrl, rc, scene.vert_mask, scene.mesh.dx,
                mat.lame_mu, mat.lame_la, iterations=cg_iterations,
                tol=tol_rr, cover=scene.cover)
            if return_cg:
                cg_tot = cg_tot + cg_k - 1
            fn_prev = fn
            xx, fn = newton_update(
                xx, f_cf.permute(1, 2, 3, 0), dx_cf.permute(1, 2, 3, 0),
                vmask3, fn_prev,
                lambda xe: scene.total_energy(xe, gravity_scale=gs),
                lambda xe: resid_inf(xe, gs), line_search,
                fn_full=readback(fn_full))
            if cg_forcing == "ew":
                eta = cgmod.ew_eta(fn, fn_prev)
            k += 1
            fmin = np.minimum(fmin, fn)
        out = xx, k, cgmod.newton_exit_norm(fn, fmin)
        return out + (int(readback(cg_tot)),) if return_cg else out

    if return_cg:
        if load_steps != 1 or return_trace:
            raise ValueError("return_cg counts a single-shot solve only")
        return solve_at(x, 1.0)
    return run_load_schedule(solve_at, x, tol, max_newton, load_steps,
                             return_trace=return_trace)


def state_from_numpy(x, v, drag_mask, drag_pos, device=None) -> LatState:
    """A LatState on `device` (the GPU by default) from numpy arrays (e.g. a
    JAX LatState read back with np.asarray)."""
    device = device_or_cuda(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return LatState(x=t(x), v=t(v), drag_mask=t(drag_mask),
                    drag_pos=t(drag_pos))


def state_to_numpy(st: LatState):
    """(x, v, drag_mask, drag_pos) as float32 numpy arrays."""
    return tuple(a.detach().cpu().numpy() for a in st)
