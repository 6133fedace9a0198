"""Newton guards and the conjugate-gradient solvers.

Port of `fem_simulation_tpu/solvers/cg.py` (`newton_cond`,
`newton_exit_norm`, `ew_eta`, `_normalize_rhs`, `cg_operator`,
`pcg_operator` with its flexible variant, `cg`).
The loops run on the host: each CG iteration reads its loop condition
back (one device sync per iteration on a GPU; the fused lattice kernels
run the same loop on the device). Host-side scalar tests are made in
float32, as the reference makes them on device scalars.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import ell

EPSILON = 1e-7

# Newton divergence backstop: exit when the residual norm grows this factor
# above its running minimum (see the reference module for the rationale).
NEWTON_BLOWUP = 1e6


def newton_cond(tol, max_newton, blowup: float = NEWTON_BLOWUP):
    """Guarded Newton loop condition over carries (x, k, fn, fmin): go on
    while fn > tol, k < max_newton, fn is finite and fn <= blowup * fmin."""
    tol32, blow32 = np.float32(tol), np.float32(blowup)

    def cond(c):
        _, k, fn, fmin = c
        fn32 = np.float32(fn)
        with np.errstate(over="ignore"):
            limit = blow32 * np.float32(fmin)
        return bool(fn32 > tol32 and k < max_newton and np.isfinite(fn32)
                    and fn32 <= limit)
    return cond


def newton_exit_norm(fn, fmin=None, blowup: float = NEWTON_BLOWUP) -> float:
    """+inf for a non-finite final residual or a blowup-guard exit, so that
    a caller's `fn <= tol` cannot mistake divergence for convergence."""
    fn32 = np.float32(fn)
    bad = not np.isfinite(fn32)
    if fmin is not None:
        with np.errstate(over="ignore"):
            bad = bad or bool(fn32 > np.float32(blowup) * np.float32(fmin))
    return float("inf") if bad else float(fn32)


def ew_eta(fn_new, fn_old, gamma: float = 0.9, alpha: float = 2.0,
           floor: float = 0.1, cap: float = 0.8) -> np.float32:
    """Next Eisenstat-Walker forcing term (choice 2) from two host residual
    norms: gamma * (fn_new / fn_old)^alpha clamped to [floor, cap], in
    float32. Callers pass eta^2 as pcg_operator's tol (relative on
    ||r||^2); the floor matches the fixed default cg_tol = 1e-2."""
    f32 = np.float32
    fn_new, fn_old = f32(fn_new), f32(fn_old)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        r = (fn_new / max(fn_old, f32(1e-30)) if fn_old > f32(0.0)
             else f32(1.0))
        return f32(np.clip(f32(gamma) * r ** f32(alpha), f32(floor),
                           f32(cap)))


def _normalize_rhs(b):
    """Scale the RHS to unit norm so the absolute small-denominator guards
    (pap >= 1e-12, ||r||^2 > EPSILON) are scale-free; returns
    (b_normalized, scale_back, inv_scale) with scale_back = 0 for an all-zero
    RHS (the solution is exactly zero and the solve must be a no-op)."""
    rr_b = ell.vdot(b, b)
    ok_b = rr_b > 0.0
    inv_scale = torch.sqrt(torch.where(ok_b, rr_b, torch.ones_like(rr_b)))
    return (b / inv_scale, torch.where(ok_b, inv_scale,
                                       torch.zeros_like(inv_scale)),
            inv_scale)


def _go(alive, rr, limit) -> bool:
    """The CG loop condition after the budget test, read back in one sync:
    no guard tripped (alive), rr > limit and rr finite."""
    return bool(alive & (rr > limit) & torch.isfinite(rr))


def _guarded_div(ok, num, den):
    """num / den where ok, else 0 (a step not taken)."""
    return torch.where(ok, num / torch.where(ok, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def cg_operator(matvec, b, iterations: int = 10, tol: float = 1e-5, x0=None):
    """CG on an abstract linear operator, on the normalized RHS (so the
    absolute small-denominator guards are scale-free), from x0 (zero by
    default).

    Runs while k <= iterations, ||r||^2 > tol ||r0||^2, ||r0||^2 > EPSILON,
    ||r||^2 finite and the previous iteration had p.Ap >= 1e-10; k starts
    at 1 and the first iteration takes p = r."""
    b, scale_back, inv_scale = _normalize_rhs(b)
    if x0 is None:
        x = torch.zeros_like(b)
        r = b
    else:
        x = x0 / inv_scale
        r = b - matvec(x)
    rs0 = ell.vdot(r, r)
    rs = rs0
    p = r
    k = 1
    alive = rs0 > EPSILON
    while k <= iterations and _go(alive, rs, tol * rs0):
        ap = matvec(p)
        pap = ell.vdot(p, ap)
        ok = pap >= 1e-10
        alpha = _guarded_div(ok, rs, pap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = ell.vdot(r, r)
        beta = rs_new / rs
        p = r + beta * p
        rs = rs_new
        k += 1
        alive = alive & ok
    return x * scale_back


def cg(op, values, b, iterations: int = 10, tol: float = 1e-5, x0=None):
    """Solve A x = b on a block-ELL operator (op: smoothers.EllOperator),
    at most `iterations` steps from x0 (zero by default), on the normalized
    RHS; every matvec is one block-ELL SpMV."""
    full_vals = values * op.mask[..., None, None]
    return cg_operator(lambda v: ell.spmv(full_vals, op.nbr, op.mask, v), b,
                       iterations, tol, x0)


def pcg_operator(matvec, minv, b, iterations: int = 50, tol: float = 1e-5,
                 return_iters: bool = False, flexible: bool = False):
    """Preconditioned CG on an abstract operator, on the normalized RHS.

    Tolerance is relative on ||r||^2. The iteration count starts at 1, so
    matvecs executed = k - 1; the loop stops on k > iterations,
    ||r||^2 <= tol ||r0||^2, ||r0||^2 <= EPSILON, a non-finite ||r||^2, or
    after an iteration with p.Ap < 1e-12 (which takes no step).

    flexible=True takes the Polak-Ribiere beta z_new.(r_new - r_old) / rz,
    which a non-stationary minv needs (a V-cycle whose coarsest level is
    itself a CG solve, LatticeMG coarse_cg > 0).

    b may be a field in z-slabs (parallel.slab_field.SlabField, the
    distributed multigrid's placed state): the vectors then stay in slabs
    and every dot product is a psum of the slabs' partials (ell.vdot)."""
    b, scale_back, _ = _normalize_rhs(b)
    x = torch.zeros_like(b) if torch.is_tensor(b) else b.zeros_like()
    r = b
    z = minv(r)
    p = z
    rz = ell.vdot(r, z)
    rr0 = ell.vdot(r, r)
    rr = rr0
    k = 1
    alive = rr0 > EPSILON
    while k <= iterations and _go(alive, rr, tol * rr0):
        ap = matvec(p)
        pap = ell.vdot(p, ap)
        ok = pap >= 1e-12
        alpha = _guarded_div(ok, rz, pap)
        x = x + alpha * p
        r = r - alpha * ap
        z = minv(r)
        rz_new = ell.vdot(r, z)
        if flexible:
            # r_new - r_old = -alpha Ap
            beta = -alpha * ell.vdot(z, ap) / rz
        else:
            beta = rz_new / rz
        p = z + beta * p
        rz = rz_new
        rr = ell.vdot(r, r)
        k += 1
        alive = alive & ok
    x = x * scale_back
    return (x, k) if return_iters else x
