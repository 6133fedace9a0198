"""A/B harnesses of the solver comparison studies.

Port of `fem_simulation_tpu/harness/compare.py`: Newton vs Newton-MG
(`compare`), the FAS variants (`compare_fas`), Newton-CG vs Newton-MG vs
FAS v3 (`solver_study`) and the linear-residual study of GS vs CG vs
V-cycles on one dragged system (`drag_study`). Each returns its raw series
as numpy arrays and can also save the plot through `utils.viz`. The JAX
runners' `lax.scan` loops are host loops here; each iteration's residual
norm stays on the device until the series is read back once.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import elastic, ell
from ..sim import QuasiStaticSim
from ..sim import quasistatic as qs
from ..solvers import cg as cgmod, smoothers


def _series(e, fn):
    return {"energy": e.numpy(), "f_inf": fn.numpy()}


def _plot(out, plot_path, title):
    if plot_path:
        from ..utils.viz import plot_convergence
        plot_convergence({k: v["f_inf"] for k, v in out.items()},
                         plot_path, title=title)


def compare(scene_factory, iterations: int = 100, plot_path: str | None = None):
    """Newton vs Newton-Multigrid convergence; scene_factory: () -> Scene
    (a fresh state per method). Returns {"newton": {...}, "newton_mg":
    {...}} with "energy" and "f_inf" series."""
    out = {}
    for name, runner in (("newton", "newton"),
                         ("newton_mg", "newton_multigrid")):
        sim = QuasiStaticSim(scene_factory())
        out[name] = _series(*getattr(sim, runner)(iterations))
    _plot(out, plot_path, "||f||_inf: Newton vs Newton-MG")
    return out


def compare_fas(scene_factory, iterations: int = 100, variants=(2, 3),
                plot_path: str | None = None):
    """The FAS variants, including the attachment ablation (v2 has no
    coarse pin treatment, v3 adds it)."""
    out = {}
    for v in variants:
        sim = QuasiStaticSim(scene_factory())
        out[f"fas_v{v}"] = _series(*sim.fas(iterations, variant=v))
    _plot(out, plot_path, "FAS variants ||f||_inf")
    return out


def solver_study(scene_factory, iterations: int = 50,
                 plot_path: str | None = None):
    """Newton-CG vs Newton-MG vs FAS v3: ||f||_inf over solver
    iterations."""
    out = {}
    for name, call in (
        ("newton_cg", lambda s: s.newton(iterations)),
        ("newton_mg", lambda s: s.newton_multigrid(iterations)),
        ("fas_v3", lambda s: s.fas(iterations, variant=3)),
    ):
        out[name] = _series(*call(QuasiStaticSim(scene_factory())))
    _plot(out, plot_path, "solver comparison ||f||_inf")
    return out


def drag_study(scene_factory, iterations: int = 10, drag_vertex=None,
               drag_delta=(0.15, 0.0, 0.0), settle_steps: int = 3,
               plot_path: str | None = None):
    """At a dragged state, assemble one SPD-projected Hessian A and
    b = f(x), then record the linear residual ||b - A dx_i||_inf per
    iteration of three solvers of that fixed system: colored GS sweeps, CG,
    and V-cycles (Galerkin coarse operators).

    Returns {"gs": r, "cg": r, "mg": r} with r[i] = residual after i
    iterations (r[0] = ||b||_inf for every arm).
    """
    scene = scene_factory()
    sim = QuasiStaticSim(scene)
    if settle_steps:
        sim.newton_multigrid(settle_steps)
    params = scene.params
    p0 = params["levels"][0]
    # dragged state: displace the vertex farthest from the pins
    if drag_vertex is None:
        pin = p0["pin_mask"].cpu().numpy() > 0
        xs = scene.x0.cpu().numpy()
        anchor = xs[pin].mean(axis=0) if pin.any() else xs.mean(axis=0)
        drag_vertex = int(np.argmax(((xs - anchor) ** 2).sum(axis=1)))
    x = sim.x.clone()
    x[drag_vertex] += torch.tensor(drag_delta, dtype=x.dtype, device=x.device)

    mat = scene.material
    op = scene.make_op(0, params)
    # gradient: elastic + pin only
    b = qs.elastic_force(scene, params, x)
    b = b + elastic.pin_force(x, p0["pin_mask"], p0["pin_pos"],
                              mat.control_mag)
    vals = ell.spd_project(qs.assemble_fine(scene, params, x), mat.spd_eps)
    values = qs.galerkin_chain(scene, params, vals)
    full = vals * op.mask[..., None, None]

    def matvec(v):
        return ell.spmv(full, op.nbr, op.mask, v)

    def resid(dx):
        return ell.inf_norm(b - matvec(dx))

    def run_gs():
        dx, out = torch.zeros_like(b), []
        for _ in range(iterations):
            dx = smoothers.gauss_seidel(op, vals, b, iterations=1, x0=dx)
            out.append(resid(dx))
        return out

    def run_cg():
        # one CG iteration per entry, continuing the same Krylov process
        dx, r, p, rs = torch.zeros_like(b), b, b, ell.vdot(b, b)
        out = []
        for _ in range(iterations):
            ap = matvec(p)
            pap = ell.vdot(p, ap)
            alpha = cgmod._guarded_div(pap >= 1e-12, rs, pap)
            dx = dx + alpha * p
            r = r - alpha * ap
            rs_new = ell.vdot(r, r)
            p = r + (rs_new / torch.clamp(rs, min=1e-30)) * p
            rs = rs_new
            out.append(resid(dx))
        return out

    def run_mg():
        dx, out = torch.zeros_like(b), []
        for _ in range(iterations):
            r = b - matvec(dx)
            dx = dx + qs.vcycle(scene, params, values, r,
                                gs_iterations=scene.solver.gs_iterations)
            out.append(resid(dx))
        return out

    r0 = ell.inf_norm(b)
    out = {}
    for name, runner in (("gs", run_gs), ("cg", run_cg), ("mg", run_mg)):
        out[name] = torch.stack([r0] + runner()).cpu().numpy()
    if plot_path:
        from ..utils.viz import plot_convergence
        plot_convergence(out, plot_path,
                         title="linear residual: GS vs CG vs V-cycle")
    return out
