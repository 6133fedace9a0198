"""Structured-lattice dynamic simulation: implicit Euler, Newton to tolerance.

Port of `fem_simulation_tpu/sim/lattice.py` (dense-grid scene, residual,
energy, `step_to_tol`, `armijo_step`, `LatticeDynamicSim.frame_to_tol`).
Every field lives on the bounding vertex lattice (X, Y, Z, 3) on the scene's
device. Each Newton iteration is one `fused_newton` call: the CUDA kernel
for CUDA tensors, its plain torch composition for CPU tensors.

The Newton and Armijo loops run on the host. Each Newton iteration reads the
trial residual norm back (one device sync); a frame reads its initial
residual and its PCG total once more. Host-side scalar tests are made in
float32, as the reference makes them on device scalars.

Only the dense grid is ported: a mesh that the reference would cover with
boxes runs here on its whole bounding lattice, which is an exact relabeling.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from fem_simulation_tpu import hierarchy as hl
from fem_simulation_tpu import mesh as meshlib
from fem_simulation_tpu.config import DynamicsConfig, MaterialConfig

from ..ops import ell, stencil
from ..ops import lattice_kernels as lk
from ..solvers import cg as cgmod


class LatState(NamedTuple):
    x: torch.Tensor          # (X, Y, Z, 3)
    v: torch.Tensor
    drag_mask: torch.Tensor  # (X, Y, Z) 1.0 where grabbed
    drag_pos: torch.Tensor   # (X, Y, Z, 3) grab targets


class LatticeScene:
    """Lattice embedding of a voxel mesh + per-vertex fields on `device`."""

    def __init__(self, mesh: meshlib.HexMesh,
                 material: MaterialConfig = MaterialConfig(), pins=None,
                 device="cpu"):
        self.mesh = mesh
        self.material = material
        self.device = torch.device(device)
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

    # -- elastic ops (displacement form: u = x - x0 is taken here, once) ----
    def elastic_force(self, x):
        mat = self.material
        u_cf = (x - self.x0).permute(3, 0, 1, 2).contiguous()
        f = lk.force_cf(u_cf, self.cell_mask, self.mesh.dx, mat.lame_mu,
                        mat.lame_la)
        return f.permute(1, 2, 3, 0)

    def elastic_energy(self, x):
        mat = self.material
        return lk.elastic_energy_lattice(x - self.x0, self.cell_mask,
                                         self.mesh.dx, mat.lame_mu,
                                         mat.lame_la)

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
                return_cg: bool = False, info: dict | None = None):
    """One frame: predictor + Newton with block-Jacobi PCG to ||f||_inf <= tol.

    Every Newton iteration is one `fused_newton` call. A full step that
    grows the residual wildly or non-finitely is redone as an Armijo
    backtrack on the incremental potential (the blowup rescue).

    Returns (state, newton iterations, exit norm), plus the frame's total
    PCG matvec count with return_cg=True. When `info` is given, its
    "rescues" entry counts the rescue steps taken.
    """
    dt = dyn.dt if dt is None else dt
    damping = dyn.damping if damping is None else damping
    inv_dt = 1.0 / dt
    mat = scene.material
    x_old = st.x
    v = st.v * damping
    x = st.x + v * dt
    x_tilde = x

    def resid(xx):
        return scene.dyn_force(xx, x_tilde, inv_dt, drag_mask=st.drag_mask,
                               drag_pos=st.drag_pos,
                               gravity_scale=gravity_scale)

    ctrl = (mat.control_mag * torch.maximum(scene.pin_mask, st.drag_mask)
            + scene.mass * inv_dt * inv_dt
            # empty lattice rows get identity so the 3x3 solve is benign
            + (1.0 - scene.vert_mask))
    vmask3 = scene.vert_mask[..., None]

    def ie_energy(xe):
        """Implicit-Euler incremental potential (resid == -grad of this)."""
        e = scene.total_energy(xe, gravity_scale=gravity_scale)
        dd = (xe - st.drag_pos) * vmask3
        e = e + 0.5 * mat.control_mag * torch.sum(
            st.drag_mask[..., None] * dd * dd)
        di = (xe - x_tilde) * vmask3
        return e + 0.5 * inv_dt * inv_dt * torch.sum(
            scene.mass[..., None] * di * di)

    # frame-constant affine residual: f(x) = f_el(u) + s - rc*u, u = x - x0;
    # rc is the exact SUM of penalty/inertia coefficients, distinct from
    # ctrl's max(pin, drag) Hessian shift
    rc = (mat.control_mag * (scene.pin_mask + st.drag_mask)
          + scene.mass * inv_dt * inv_dt)
    s_aff = (mat.control_mag * (scene.pin_mask[..., None] * scene.pin_pos
                                + st.drag_mask[..., None] * st.drag_pos)
             + (scene.mass * inv_dt * inv_dt)[..., None] * x_tilde)
    s_aff[..., 1] += scene.mass * mat.gravity * gravity_scale
    s_cf = (s_aff - rc[..., None] * scene.x0).permute(3, 0, 1, 2).contiguous()

    tol32 = np.float32(tol)
    cond = cgmod.newton_cond(tol, max_newton)
    fn = np.float32(ell.inf_norm(resid(x)).item())
    fmin = fn
    k = 0
    cg_tot = torch.zeros((), dtype=torch.int32, device=scene.device)
    rescues = 0
    while cond((x, k, fn, fmin)):
        dx_cf, f_cf, fn_full, cg_k = lk.fused_newton(
            (x - scene.x0).permute(3, 0, 1, 2).contiguous(), s_cf,
            scene.cell_mask, ctrl, rc, scene.vert_mask, scene.mesh.dx,
            mat.lame_mu, mat.lame_la, iterations=cg_iterations, tol=cg_tol)
        # pcg's iteration count starts at 1: matvecs executed = cg_k - 1
        cg_tot = cg_tot + cg_k - 1
        dx = dx_cf.permute(1, 2, 3, 0)
        fn_full = np.float32(fn_full.item())
        with np.errstate(over="ignore"):
            bad = (not np.isfinite(fn_full)
                   or fn_full > np.float32(30.0) * max(fn, tol32))
        if bad:
            # Rescue: a full step on a fast-swinging StVK body can blow up;
            # Armijo on the incremental potential guarantees descent.
            f = f_cf.permute(1, 2, 3, 0)
            x = armijo_step(ie_energy, x, f, dx, vmask3)
            fn = np.float32(ell.inf_norm(resid(x)).item())
            rescues += 1
        else:
            x = x + dx * vmask3
            fn = fn_full
        k += 1
        fmin = np.minimum(fmin, fn)
    v = (x - x_old) * inv_dt
    if info is not None:
        info["rescues"] = info.get("rescues", 0) + rescues
    out = st._replace(x=x, v=v), k, cgmod.newton_exit_norm(fn, fmin)
    return out + (int(cg_tot.item()),) if return_cg else out


def armijo_step(energy_fn, xx, f, dx, vmask3, n_back: int = 16,
                c1: float = 1e-4):
    """Backtracking line search on the energy (f = -grad E): truncated
    Newton direction + Armijo, falling back to steepest descent when the
    direction is not a descent direction."""
    d = dx * vmask3
    gTd = -ell.vdot(f, d)
    if bool(gTd >= 0.0):
        d = f
        gTd = -ell.vdot(f, f)
    e0 = energy_fn(xx)
    t = torch.ones((), dtype=xx.dtype, device=xx.device)
    done = False
    k = 0
    while not done and k < n_back:
        e1 = energy_fn(xx + t * d)
        done = bool(e1 <= e0 + c1 * t * gTd)
        if not done:
            t = t * 0.5
        k += 1
    return xx + (t if done else torch.zeros_like(t)) * d


class LatticeDynamicSim:
    def __init__(self, mesh: meshlib.HexMesh,
                 material: MaterialConfig = MaterialConfig(),
                 dyn: DynamicsConfig = DynamicsConfig(), pins=None,
                 device="cpu"):
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


def state_from_numpy(x, v, drag_mask, drag_pos, device="cpu") -> LatState:
    """A LatState on `device` from numpy arrays (e.g. a JAX LatState read
    back with np.asarray)."""
    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return LatState(x=t(x), v=t(v), drag_mask=t(drag_mask),
                    drag_pos=t(drag_pos))


def state_to_numpy(st: LatState):
    """(x, v, drag_mask, drag_pos) as float32 numpy arrays."""
    return tuple(a.detach().cpu().numpy() for a in st)
