"""The plain reference: a voxel StVK body in plain PyTorch.

Written from the configuration's statement of the physics, not from the
program: trilinear hexahedra on the body's own vertex and hex arrays,
2x2x2 Gauss points at +-1/sqrt(3) with weight (dx/2)^3, the deformation
gradient F = sum_i x_i (grad N_i)^T from the positions, the Green strain
E = (F^T F - I) / 2 and the St. Venant-Kirchhoff energy density
mu |E|^2 + la/2 tr(E)^2. Forces are minus the gradient of the total
potential, taken by autograd:

  quasi-static  E_el(x) - sum m g gs y + control/2 sum_pinned |x - X|^2
  implicit step the same + 1/(2 dt^2) sum m |x - x_tilde|^2

so the residual of a frame is f = -grad E_el + m g e_y + control pin (X - x)
- m/dt^2 (x - x_tilde), that of a quasi-static solve the same without the
last term. Masses, pins and the rest positions come from geometry.py.

`Model(..., dtype=torch.float64)` is the judge. `prec="tf32"` computes the
same model with every contraction's inputs rounded to TF32 (10 explicit
mantissa bits, float32 accumulation), the precision below the float32 with
TF32 off that the configurations state; its Newton solvers put in the
program's place are the control that the comparison must fail.

Imports neither jax nor the JAX package nor anything of the program.
"""
from __future__ import annotations

import numpy as np
import torch

from .geometry import Geometry

_OFFSETS = np.array([[i, j, k] for i in range(2) for j in range(2)
                     for k in range(2)], dtype=np.float64)
_SIGNS = 2.0 * _OFFSETS - 1.0              # corner i's reference coordinates


def shape_gradients(dx: float) -> np.ndarray:
    """G[i, q, d] = dN_i / dX_d at Gauss point q (float64, (8, 8, 3)),
    N_i(xi) = prod_d (1 + s_id xi_d) / 2 and X = origin + (xi + 1) dx / 2."""
    quad = _SIGNS / np.sqrt(3.0)
    G = np.zeros((8, 8, 3))
    for i in range(8):
        for q in range(8):
            for d in range(3):
                v = _SIGNS[i, d] / 2.0
                for e in range(3):
                    if e != d:
                        v *= (1.0 + _SIGNS[i, e] * quad[q, e]) / 2.0
                G[i, q, d] = v * 2.0 / dx
    return G


def round_tf32(a: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32: 10 explicit mantissa bits, to
    nearest (ties away from zero), as the tensor cores take their inputs."""
    bits = a.detach().to(torch.float32).contiguous().view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32)


class Model:
    """The body of `geo` under `material` on `device`, in `dtype`."""

    def __init__(self, geo: Geometry, material: dict, device,
                 dtype=torch.float64, prec: str = "exact"):
        if prec not in ("exact", "tf32"):
            raise ValueError(f"prec {prec!r}: 'exact' or 'tf32'")
        if prec == "tf32" and dtype != torch.float32:
            raise ValueError("prec 'tf32' computes in float32")
        self.geo = geo
        self.dtype, self.device, self.prec = dtype, torch.device(device), prec

        def t(a, dt=dtype):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=self.device)
        self.hexes = t(geo.hexes, torch.int64)
        self.X = t(geo.x0)
        self.G = t(shape_gradients(geo.dx))
        self.w = (geo.dx / 2.0) ** 3
        self.mass = t(geo.mass)
        self.pin = t(geo.pinned.astype(np.float64))
        self.lat = t(geo.lat, torch.int64)
        self.mu = float(material["lame_mu"])
        self.la = float(material["lame_la"])
        self.gravity = float(material["gravity"])
        self.control = float(material["control_mag"])

    # -- the contractions, at this model's precision ------------------------
    def _in(self, a):
        """A contraction's input: rounded to TF32 under prec 'tf32' (the
        gradient passes through the rounding unchanged)."""
        if self.prec != "tf32":
            return a
        return a + (round_tf32(a) - a.detach())

    def elastic_energy(self, x: torch.Tensor) -> torch.Tensor:
        """sum over cells and Gauss points of w (mu |E|^2 + la/2 tr(E)^2)."""
        F = torch.einsum("hir,iqd->hqrd", self._in(x[self.hexes]),
                         self._in(self.G))
        Fi = self._in(F)
        C = torch.einsum("hqri,hqrj->hqij", Fi, Fi)
        eye = torch.eye(3, dtype=x.dtype, device=x.device)
        E = 0.5 * (C - eye)
        trE = E.diagonal(dim1=-2, dim2=-1).sum(-1)
        psi = self.mu * (E * E).sum((-2, -1)) + 0.5 * self.la * trE * trE
        return psi.sum() * self.w

    def potential(self, x, x_tilde=None, inv_dt: float = 0.0,
                  gravity_scale: float = 1.0):
        """The total potential whose gradient is minus the residual."""
        e = self.elastic_energy(x)
        e = e - torch.sum(self.mass * self.gravity * gravity_scale * x[:, 1])
        d = x - self.X
        e = e + 0.5 * self.control * torch.sum(self.pin[:, None] * d * d)
        if x_tilde is not None:
            di = x - x_tilde
            e = e + 0.5 * inv_dt * inv_dt * torch.sum(self.mass[:, None]
                                                      * di * di)
        return e

    def residual(self, x, x_tilde=None, inv_dt: float = 0.0,
                 gravity_scale: float = 1.0) -> torch.Tensor:
        """f = -grad potential at x (N, 3)."""
        xg = x.detach().to(self.dtype).requires_grad_(True)
        with torch.enable_grad():
            g, = torch.autograd.grad(
                self.potential(xg, x_tilde, inv_dt, gravity_scale), xg)
        return -g

    # -- the body's fields on the program's lattice ------------------------
    def gather(self, field: torch.Tensor) -> torch.Tensor:
        """A lattice field (X, Y, Z, C) at the body's vertices (N, C), in
        this model's dtype."""
        f = field.to(self.device)
        return f[self.lat[:, 0], self.lat[:, 1], self.lat[:, 2]].to(self.dtype)

    def scatter(self, rows: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
        """Rows (N, C) written into a copy of the lattice field `like`."""
        out = like.clone()
        out[self.lat[:, 0].to(out.device), self.lat[:, 1].to(out.device),
            self.lat[:, 2].to(out.device)] = rows.to(out.dtype).to(out.device)
        return out

    # -- Newton solvers: the control, put in the program's place ------------
    def newton(self, x, x_tilde=None, inv_dt: float = 0.0,
               gravity_scale: float = 1.0, tol: float = 1e-4,
               max_newton: int = 20, cg_iterations: int = 60,
               cg_tol: float = 1e-2):
        """Newton with Jacobi-preconditioned CG on autograd Hessian-vector
        products, in this model's precision, to ||f||inf <= tol as this
        model computes f; a step that grows ||f||inf thirtyfold is halved
        (at most ten times). Returns (x, k, ||f||inf)."""
        x = x.detach().to(self.dtype).clone()
        pre = 1.0 / (self.mass * inv_dt * inv_dt + self.control * self.pin
                     + 8.0 * self.mu * self.geo.dx)[:, None]
        fn, k = float("inf"), 0
        for k in range(max_newton + 1):
            xg = x.requires_grad_(True)
            with torch.enable_grad():
                g, = torch.autograd.grad(
                    self.potential(xg, x_tilde, inv_dt, gravity_scale), xg,
                    create_graph=True)
            fn = inf_norm(g)
            if fn <= tol or not np.isfinite(fn) or k == max_newton:
                break

            def hvp(p):
                return torch.autograd.grad(g, xg, p, retain_graph=True)[0]
            d = _pcg(hvp, -g.detach(), pre, cg_iterations, cg_tol)
            x0 = x.detach()
            step = 1.0
            for _ in range(10):
                x = (x0 + step * d).detach()
                fnew = inf_norm(self.residual(x, x_tilde, inv_dt,
                                              gravity_scale))
                if np.isfinite(fnew) and fnew <= 30.0 * fn:
                    break
                step *= 0.5
        return x.detach(), k, fn


def inf_norm(f: torch.Tensor) -> float:
    """max |f| as a host float; +inf where it is not finite."""
    v = float(f.detach().abs().max())
    return v if np.isfinite(v) else float("inf")


def _pcg(matvec, b, pre, iterations: int, tol: float):
    """Preconditioned CG from zero to ||r|| <= tol ||b||."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = pre * r
    p = z.clone()
    rz = torch.sum(r * z)
    bb = float(torch.sum(b * b))
    for _ in range(iterations):
        ap = matvec(p)
        pap = torch.sum(p * ap)
        if not float(pap) > 0.0:
            break
        a = rz / pap
        x = x + a * p
        r = r - a * ap
        if float(torch.sum(r * r)) <= tol * tol * bb:
            break
        z = pre * r
        rz_new = torch.sum(r * z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    return x
