"""Quasi-static solvers: Newton, Newton-Multigrid, FAS v0-v3, Adam, GD.

Port of `fem_simulation_tpu/sim/quasistatic.py` with the same step
functions and return values. `lax.scan` and `while_loop` become host loops.
A multi-step run keeps its per-step series (energy, ||f||_inf) on the
device and reads them back once, at its end; Newton-MG and FAS v1-v3 steps
have no host sync of their own, plain Newton and FAS v0 sync once per CG
iteration and gradient descent once per backtrack.

Every SpMV (V-cycle residuals, Gauss-Seidel sweeps, CG matvecs) goes
through the block-ELL SpMV kernel wrapper (`ops/ell_kernels.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import elastic, ell, transfer
from ..solvers import smoothers, cg as cgmod
from .scene import Scene


def _eye(x):
    return torch.eye(3, dtype=x.dtype, device=x.device)


# -- assembly ------------------------------------------------------------------

def elastic_force(scene: Scene, params, x):
    """Elastic force of level 0 through the vertex gather map."""
    p0 = params["levels"][0]
    mat = scene.material
    return elastic.force_gather(x, p0["hexes"], p0["det"], p0["g"],
                                mat.lame_mu, mat.lame_la, p0["vc_idx"],
                                p0["vc_mask"], x.shape[0])


def total_force(scene: Scene, params, x):
    """f = -grad E: elastic + gravity + pin springs (canonical order)."""
    p0 = params["levels"][0]
    mat = scene.material
    f = elastic_force(scene, params, x)
    f = f + elastic.gravity_force(p0["mass"], mat.gravity, x.shape[0], x.dtype)
    f = f + elastic.pin_force(x, p0["pin_mask"], p0["pin_pos"], mat.control_mag)
    return f


def total_energy(scene: Scene, params, x):
    p0 = params["levels"][0]
    mat = scene.material
    e = elastic.energy(x, p0["hexes"], p0["det"], p0["g"], mat.lame_mu,
                       mat.lame_la)
    e = e + elastic.gravity_energy(x, p0["mass"], mat.gravity)
    e = e + elastic.pin_energy(x, p0["pin_mask"], p0["pin_pos"], mat.control_mag)
    return e


def assemble_elastic(scene: Scene, params, li: int, x):
    """Elastic Hessian of level li by the gather-based assembly."""
    p = params["levels"][li]
    lvl = scene.level(li)
    mat = scene.material
    return elastic.assemble_hessian_ell_gather(
        x, p["hexes"], p["det"], p["g"], mat.lame_mu, mat.lame_la,
        p["contrib_idx"], p["contrib_mask"], lvl.n_verts, lvl.K)


def assemble_fine(scene: Scene, params, x, include_pins=True):
    """Fine-level Hessian in block-ELL, pin springs on the diagonal."""
    p0 = params["levels"][0]
    mat = scene.material
    vals = assemble_elastic(scene, params, 0, x)
    if include_pins:
        pin_diag = (mat.control_mag * p0["pin_mask"])[:, None, None] * _eye(x)
        vals = ell.add_to_diag(vals, p0["diag_slot"], pin_diag)
    return vals


def assemble_coarse_rediscretized(scene: Scene, params, li: int, xc,
                                  with_fix_diag: bool):
    """Re-discretized coarse Hessian at restricted positions (FAS path)."""
    p = params["levels"][li]
    vals = assemble_elastic(scene, params, li, xc)
    if with_fix_diag and li == 1:
        fd = params["transfers"][0]["fix_diag"]
        vals = ell.add_to_diag(vals, p["diag_slot"],
                               fd[:, None, None] * _eye(xc))
    return vals


def galerkin_chain(scene: Scene, params, values0, spd: bool = True):
    """[A_0, A_1, ...]: coarse operators by Galerkin products + SPD
    projection."""
    out = [values0]
    for li in range(1, scene.n_levels):
        t = params["transfers"][li - 1]
        lvl = scene.level(li)
        vc = transfer.galerkin(out[-1], t["galerkin_plan"], lvl.n_verts,
                               lvl.K)
        if spd:
            vc = ell.spd_project(vc, scene.material.spd_eps)
        out.append(vc)
    return out


# -- V-cycle -------------------------------------------------------------------

def vcycle(scene: Scene, params, values_list, b, gs_iterations: int = 3,
           level: int = 0):
    """Recursive V-cycle; returns the correction dx."""
    op = scene.make_op(level, params)
    vals = values_list[level]
    dx = smoothers.gauss_seidel(op, vals, b, iterations=gs_iterations)
    if level == scene.n_levels - 1:
        return dx
    full = vals * op.mask[..., None, None]
    r = b - ell.spmv(full, op.nbr, op.mask, dx)
    t = params["transfers"][level]
    bc = transfer.restrict(t["r_idx"], t["r_w"], r)
    dxc = vcycle(scene, params, values_list, bc, gs_iterations, level + 1)
    x_acc = dx + transfer.prolong(t["p_idx"], t["p_w"], dxc)
    b2 = b - ell.spmv(full, op.nbr, op.mask, x_acc)
    dx2 = smoothers.gauss_seidel(op, vals, b2, iterations=gs_iterations)
    return x_acc + dx2


# -- step functions ------------------------------------------------------------

def newton_step(scene: Scene, params, x):
    """Single-level Newton with `cg_iterations` CG iterations."""
    f = total_force(scene, params, x)
    vals = assemble_fine(scene, params, x)
    op = scene.make_op(0, params)
    dx = cgmod.cg(op, vals, f, iterations=scene.solver.cg_iterations,
                  tol=scene.solver.cg_tol)
    return x + dx, f


def newton_multigrid_step(scene: Scene, params, x):
    """Newton step preconditioned by one V-cycle on Galerkin coarse
    operators."""
    f = total_force(scene, params, x)
    values0 = assemble_fine(scene, params, x)
    values = galerkin_chain(scene, params, values0)
    dx = vcycle(scene, params, values, f,
                gs_iterations=scene.solver.gs_iterations)
    return x + dx, f


def fas_step(scene: Scene, params, x, variant: int = 3):
    """One FAS two-level cycle.

    v0: elastic only, SPD on, coarse CG-with-init + tau correction.
    v1: elastic only, SPD on, coarse Jacobi on restricted-position Hessian.
    v2: full forces, no SPD, no coarse pin treatment.
    v3: full forces, no SPD, coarse pin diagonal via interpolated weights.
    """
    if scene.n_levels < 2:
        raise ValueError("FAS needs a >=2-level hierarchy; this scene has "
                         f"{scene.n_levels} (increase SolverConfig.n_levels "
                         "or use a larger mesh).")
    elastic_only = variant in (0, 1)
    use_spd = variant in (0, 1)
    mat = scene.material

    def forces(xx):
        if elastic_only:
            return elastic_force(scene, params, xx)
        return total_force(scene, params, xx)

    vals0 = assemble_fine(scene, params, x, include_pins=not elastic_only)
    if use_spd:
        vals0 = ell.spd_project(vals0, mat.spd_eps)
    b = forces(x)
    op0 = scene.make_op(0, params)
    dx = smoothers.gauss_seidel(op0, vals0, b, iterations=1)
    x = x + dx

    t = params["transfers"][0]
    xc = transfer.restrict(t["r_idx"], t["r_w_norm"], x)
    r = forces(x)
    bc = transfer.restrict(t["r_idx"], t["r_w"], r)

    valsc = assemble_coarse_rediscretized(
        scene, params, 1, xc, with_fix_diag=(variant == 3))
    if use_spd:
        valsc = ell.spd_project(valsc, mat.spd_eps)
    op1 = scene.make_op(1, params)

    if variant == 0:
        # tau correction: solve A_c e = bc + A_c xc starting from xc, take
        # the error e - xc up
        fullc = valsc * op1.mask[..., None, None]
        bc_tau = bc + ell.spmv(fullc, op1.nbr, op1.mask, xc)
        sol = cgmod.cg(op1, valsc, bc_tau,
                       iterations=scene.solver.coarse_cg_iterations,
                       tol=scene.solver.cg_tol, x0=xc)
        x = x + transfer.prolong(t["p_idx"], t["p_w"], sol - xc)
    else:
        dxc = smoothers.jacobi(op1, valsc, bc,
                               iterations=scene.solver.jacobi_iterations)
        x = x + transfer.prolong(t["p_idx"], t["p_w"], dxc)
    return x, r


# -- first-order baselines -----------------------------------------------------

def adam_run(scene: Scene, params, x, iterations=1000, lr=1e-3,
             beta1=0.9, beta2=0.999, eps=1e-8):
    """Adam on the total energy; returns (x, ||grad||_inf series)."""
    m = torch.zeros_like(x)
    v = torch.zeros_like(x)
    series = []
    for step in range(iterations):
        gneg = -total_force(scene, params, x)   # gradient
        m = beta1 * m + (1 - beta1) * gneg
        v = beta2 * v + (1 - beta2) * gneg * gneg
        # bias corrections in float32, as the reference's f32 step counter
        c1 = float(1 - np.float32(beta1) ** np.float32(step + 1))
        c2 = float(1 - np.float32(beta2) ** np.float32(step + 1))
        x = x - lr * (m / c1) / (torch.sqrt(v / c2) + eps)
        series.append(ell.inf_norm(gneg))
    return x, torch.stack(series).cpu()


def gradient_descent_run(scene: Scene, params, x, iterations=100, lr=1e-3,
                         backtracks=20):
    """GD with backtracking line search on the total energy; returns
    (x, ||f||_inf series)."""
    series = []
    for _ in range(iterations):
        f = total_force(scene, params, x)
        e0 = total_energy(scene, params, x)
        alpha = torch.tensor(lr, dtype=x.dtype, device=x.device)
        e = total_energy(scene, params, x + alpha * f)
        i = 0
        while i < backtracks and bool(e >= e0):
            alpha = alpha * 0.2
            e = total_energy(scene, params, x + alpha * f)
            i += 1
        take = (e < e0).to(x.dtype)
        x = take * (x + alpha * f) + (1.0 - take) * x
        series.append(ell.inf_norm(f))
    return x, torch.stack(series).cpu()


# -- user-facing simulator -------------------------------------------------------

class QuasiStaticSim:
    """User-facing simulator: each run returns its (energy, ||f||_inf) series
    as CPU float32 tensors, one entry per step."""

    def __init__(self, scene: Scene):
        self.scene = scene
        self.x = scene.x0

    def _run(self, step, iterations: int):
        p = self.scene.params
        x = self.x
        es, fns = [], []
        for _ in range(iterations):
            x, f = step(self.scene, p, x)
            es.append(total_energy(self.scene, p, x))
            fns.append(ell.inf_norm(f))
        self.x = x
        series = torch.stack([torch.stack(es), torch.stack(fns)]).cpu()
        return series[0], series[1]

    def newton(self, iterations=100):
        return self._run(newton_step, iterations)

    def newton_multigrid(self, iterations=100):
        return self._run(newton_multigrid_step, iterations)

    def fas(self, iterations=100, variant=3):
        return self._run(lambda s, p, x: fas_step(s, p, x, variant=variant),
                         iterations)

    def adam(self, iterations=1000, lr=1e-3):
        self.x, series = adam_run(self.scene, self.scene.params, self.x,
                                  iterations, lr)
        return series

    def gradient_descent(self, iterations=100, lr=1e-3):
        self.x, series = gradient_descent_run(self.scene, self.scene.params,
                                              self.x, iterations, lr)
        return series

    def force_inf_norm(self):
        f = total_force(self.scene, self.scene.params, self.x)
        return float(ell.inf_norm(f))
