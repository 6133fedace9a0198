"""Dynamic implicit-Euler FEM simulation on the unstructured block-ELL path.

Port of `fem_simulation_tpu/sim/dynamic.py` (`DynState`, `init_state`,
`_dyn_force`, `_dyn_hessian`, `fas_dynamic_cycle`, `step`, `step_to_tol`,
`frame_adaptive`, `DynamicSim`). Per frame:

  predictor   v *= damping; x += v dt
  assemble    H = pin/drag diag + m/h^2 I + elastic Hessian
              f = elastic + gravity + pins + drag + inertia
  solve       H dx = f
  update      x += dx;  v = (x - x_old)/dt

The Newton loop of `step_to_tol` runs on the host and reads the residual
norm once per Newton iteration; its linear solves (MG-preconditioned CG by
default) go through the block-ELL SpMV kernel wrapper. Host-side scalar
tests are made in float32, as the reference makes them on device scalars.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device_or_cuda
from ..config import DynamicsConfig
from ..ops import elastic, ell, transfer
from ..solvers import cg as cgmod, smoothers
from .lattice import adaptive_frame
from .scene import Scene
from . import quasistatic as qs


class DynState(NamedTuple):
    x: torch.Tensor          # (N, 3) positions (canonical order)
    v: torch.Tensor          # (N, 3) velocities
    drag_mask: torch.Tensor  # (N,)  1.0 where temporarily grabbed
    drag_pos: torch.Tensor   # (N, 3) grab targets


def init_state(scene: Scene) -> DynState:
    x0 = scene.x0
    return DynState(x=x0, v=torch.zeros_like(x0),
                    drag_mask=torch.zeros(x0.shape[0], dtype=x0.dtype,
                                          device=x0.device),
                    drag_pos=x0)


def state_from_numpy(x, v, drag_mask, drag_pos, device=None) -> DynState:
    """A DynState on `device` (the GPU by default) from numpy arrays (e.g. a
    JAX DynState read back with np.asarray)."""
    device = device_or_cuda(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return DynState(x=t(x), v=t(v), drag_mask=t(drag_mask),
                    drag_pos=t(drag_pos))


def state_to_numpy(st: DynState):
    """(x, v, drag_mask, drag_pos) as float32 numpy arrays."""
    return tuple(a.detach().cpu().numpy() for a in st)


def _dyn_force(scene: Scene, params, st: DynState, x, x_tilde, inv_dt,
               gravity_scale=1.0):
    """Full implicit-Euler residual force at x (canonical order)."""
    p0 = params["levels"][0]
    mat = scene.material
    f = qs.elastic_force(scene, params, x)
    f = f + gravity_scale * elastic.gravity_force(
        p0["mass"], mat.gravity, x.shape[0], x.dtype)
    f = f + elastic.pin_force(x, p0["pin_mask"], p0["pin_pos"], mat.control_mag)
    f = f + mat.control_mag * st.drag_mask[:, None] * (st.drag_pos - x)
    f = f + elastic.inertia_force(x, x_tilde, p0["mass"], inv_dt)
    return f


def _ctrl(scene: Scene, params, st: DynState, inv_dt):
    """Per-vertex Hessian diagonal shift: max(pin, drag) control + m/h^2."""
    p0 = params["levels"][0]
    return (scene.material.control_mag
            * torch.maximum(p0["pin_mask"], st.drag_mask)
            + p0["mass"] * inv_dt * inv_dt)


def _dyn_hessian(scene: Scene, params, st: DynState, x, inv_dt):
    """H = elastic + (pin|drag) control diag + m/h^2 diag."""
    p0 = params["levels"][0]
    vals = qs.assemble_elastic(scene, params, 0, x)
    diag = _ctrl(scene, params, st, inv_dt)[:, None, None] * qs._eye(x)
    return ell.add_to_diag(vals, p0["diag_slot"], diag)


def fas_dynamic_cycle(scene: Scene, params, st: DynState, x, x_tilde, inv_dt,
                      gravity_scale=1.0):
    """One two-level FAS cycle on the full implicit-Euler residual: fine
    GS(1), restrict the solution (normalized weights) and the fresh residual
    (hat weights), re-discretized coarse Hessian plus the restricted
    control+mass diagonal, tau-corrected coarse CG seeded at xc, prolongate
    the error."""
    p1 = params["levels"][1]
    t = params["transfers"][0]

    def resid(xx):
        return _dyn_force(scene, params, st, xx, x_tilde, inv_dt,
                          gravity_scale=gravity_scale)

    vals0 = _dyn_hessian(scene, params, st, x, inv_dt)
    op0 = scene.make_op(0, params)
    dx = smoothers.gauss_seidel(op0, vals0, resid(x), iterations=1)
    x = x + dx

    xc = transfer.restrict(t["r_idx"], t["r_w_norm"], x)
    r = resid(x)
    bc = transfer.restrict(t["r_idx"], t["r_w"], r)

    vals_c = qs.assemble_elastic(scene, params, 1, xc)
    ctrl_f = _ctrl(scene, params, st, inv_dt)
    ctrl_c = transfer.restrict(t["r_idx"], t["r_w"], ctrl_f[:, None])[:, 0]
    vals_c = ell.add_to_diag(vals_c, p1["diag_slot"],
                             ctrl_c[:, None, None] * qs._eye(x))
    op1 = scene.make_op(1, params)

    fullc = vals_c * op1.mask[..., None, None]
    bc_tau = bc + ell.spmv(fullc, op1.nbr, op1.mask, xc)
    sol = cgmod.cg(op1, vals_c, bc_tau,
                   iterations=scene.solver.coarse_cg_iterations,
                   tol=scene.solver.cg_tol, x0=xc)
    x = x + transfer.prolong(t["p_idx"], t["p_w"], sol - xc)
    return x, r


def step(scene: Scene, params, st: DynState,
         dyn: DynamicsConfig = DynamicsConfig()) -> DynState:
    """One frame, reference parity: predictor + a single Newton(CG) solve."""
    inv_dt = 1.0 / dyn.dt
    x_old = st.x
    v = st.v * dyn.damping
    x = st.x + v * dyn.dt
    x_tilde = x

    vals = _dyn_hessian(scene, params, st, x, inv_dt)
    f = _dyn_force(scene, params, st, x, x_tilde, inv_dt)
    op = scene.make_op(0, params)
    dx = cgmod.cg(op, vals, f, iterations=scene.solver.cg_iterations,
                  tol=scene.solver.cg_tol)
    x = x + dx
    v = (x - x_old) * inv_dt
    return st._replace(x=x, v=v)


def step_to_tol(scene: Scene, params, st: DynState,
                dyn: DynamicsConfig = DynamicsConfig(),
                tol: float = 1e-4, max_newton: int = 20,
                use_multigrid: bool = True, matrix_free: bool = False,
                use_fas: bool = False, gravity_scale=1.0,
                dt=None, damping=None, x_init=None):
    """One frame with Newton iterations until ||f||_inf <= tol.

    Linear solve per Newton iteration: one nonlinear two-level FAS cycle
    (use_fas), matrix-free block-Jacobi PCG with the closed-form HVP
    (matrix_free), MG-preconditioned CG with one V-cycle as M^{-1}
    (use_multigrid, the default), or CG on the assembled Hessian.
    `x_init` seeds the Newton iteration instead of the inertia predictor.
    Returns (state, n_newton, final ||f||_inf as a float).
    """
    dt = dyn.dt if dt is None else dt
    damping = dyn.damping if damping is None else damping
    inv_dt = 1.0 / dt
    x_old = st.x
    v = st.v * damping
    x = st.x + v * dt
    x_tilde = x
    if x_init is not None:
        x = x_init
    op = scene.make_op(0, params)
    p0 = params["levels"][0]
    mat = scene.material
    solver = scene.solver

    def resid(xx):
        return _dyn_force(scene, params, st, xx, x_tilde, inv_dt,
                          gravity_scale=gravity_scale)

    def newton_iteration(xx):
        if use_fas:
            xx, _ = fas_dynamic_cycle(scene, params, st, xx, x_tilde, inv_dt,
                                      gravity_scale=gravity_scale)
            return xx
        f = resid(xx)
        if matrix_free:
            ctrl = _ctrl(scene, params, st, inv_dt)

            def matvec(p):
                hp = elastic.hvp_gather(
                    xx, p, p0["hexes"], p0["det"], p0["g"],
                    mat.lame_mu, mat.lame_la,
                    p0["vc_idx"], p0["vc_mask"], xx.shape[0])
                return hp + ctrl[:, None] * p

            diag = elastic.hessian_diag_gather(
                xx, p0["hexes"], p0["det"], p0["g"],
                mat.lame_mu, mat.lame_la,
                p0["vc_idx"], p0["vc_mask"], xx.shape[0])
            diag = diag + ctrl[:, None, None] * qs._eye(xx)
            dx = cgmod.pcg_operator(matvec, lambda r: ell.solve3x3(diag, r),
                                    f, iterations=solver.pcg_iterations,
                                    tol=solver.pcg_tol)
        elif use_multigrid:
            vals = _dyn_hessian(scene, params, st, xx, inv_dt)
            values = qs.galerkin_chain(scene, params, vals)
            full0 = values[0] * op.mask[..., None, None]
            dx = cgmod.pcg_operator(
                lambda p: ell.spmv(full0, op.nbr, op.mask, p),
                lambda r: qs.vcycle(scene, params, values, r, gs_iterations=1),
                f, iterations=solver.cg_iterations * 2, tol=solver.pcg_tol)
        else:
            vals = _dyn_hessian(scene, params, st, xx, inv_dt)
            dx = cgmod.cg(op, vals, f, iterations=solver.cg_iterations,
                          tol=solver.cg_tol)
        return xx + dx

    cond = cgmod.newton_cond(tol, max_newton)
    fn = np.float32(ell.inf_norm(resid(x)).item())
    fmin = fn
    k = 0
    while cond((x, k, fn, fmin)):
        x = newton_iteration(x)
        fn = np.float32(ell.inf_norm(resid(x)).item())
        k += 1
        fmin = np.minimum(fmin, fn)
    v = (x - x_old) * inv_dt
    return st._replace(x=x, v=v), k, cgmod.newton_exit_norm(fn, fmin)


def frame_adaptive(scene: Scene, params, st: DynState,
                   dyn: DynamicsConfig = DynamicsConfig(),
                   tol: float = 1e-4, max_newton: int = 20,
                   use_multigrid: bool = True, matrix_free: bool = False,
                   use_fas: bool = False, max_halvings: int = 3,
                   gravity_scale=1.0):
    """step_to_tol with adaptive time substepping: a frame whose Newton
    budget exits above tol (or diverges: +inf) is redone from the original
    state as 2^h substeps of dt/2^h, up to 2^max_halvings
    (lattice.adaptive_frame). Returns (state, max Newton over the accepted
    substeps, worst substep exit norm, n_substeps)."""
    def step(s, dt, damp):
        return step_to_tol(scene, params, s, dyn, tol, max_newton,
                           use_multigrid, matrix_free, use_fas,
                           gravity_scale=gravity_scale, dt=dt, damping=damp)
    return adaptive_frame(step, st, dyn, tol, max_halvings)


class DynamicSim:
    """User-facing dynamic simulator on a Scene."""

    def __init__(self, scene: Scene, dyn: DynamicsConfig = DynamicsConfig()):
        self.scene = scene
        self.dyn = dyn
        self.state = init_state(scene)

    def frame(self):
        self.state = step(self.scene, self.scene.params, self.state, self.dyn)
        return self.state

    def frame_to_tol(self, tol=1e-4, max_newton=20, use_multigrid=True):
        self.state, k, fn_inf = step_to_tol(
            self.scene, self.scene.params, self.state, self.dyn, tol,
            max_newton, use_multigrid)
        return self.state, k, fn_inf

    def set_drag(self, mask, targets):
        dev, dt = self.state.x.device, self.state.x.dtype
        self.state = self.state._replace(
            drag_mask=torch.as_tensor(mask, dtype=dt, device=dev),
            drag_pos=torch.as_tensor(targets, dtype=dt, device=dev))

    def clear_drag(self):
        self.state = self.state._replace(
            drag_mask=torch.zeros_like(self.state.drag_mask))
