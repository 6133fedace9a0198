"""Geometric-multigrid-preconditioned Newton-Krylov on the structured lattice.

Port of `fem_simulation_tpu/sim/lattice_mg.py`. Block-Jacobi PCG needs
O(mesh diameter) iterations without the m/dt^2 shift; a V-cycle
preconditioner keeps the count about flat. Everything is structured:

  transfers       separable trilinear stencils (ops.stencil.prolong_lat /
                  restrict_lat, an exact adjoint pair, shifted slices)
  coarse operator the elastic operator re-discretized on each coarse
                  lattice (dx doubling per level) at the restricted
                  displacement; its ctrl-shifted, SPD-projected vertex
                  blocks by `lat_diag_shift` (one launch a level on halo
                  tiles, two passes where its plan says;
                  lattice_kernels.hess_diag_shift_cf)
  smoother        Chebyshev on the block-Jacobi-preconditioned operator,
                  every sweep of a smoothing call in one `lat_cheby` launch
                  (lattice_kernels.cheby_smooth_cf); its bound by power
                  iteration, one `lat_power` launch a level
                  (lattice_kernels.power_lmax_cf)
  outer loop      inexact Newton + (flexible) preconditioned CG, whose
                  matvec, the HVP plus the ctrl term, is one `lat_hvp`
                  launch (lattice_kernels.level_matvec_cf)

The kernels' plain versions run on CPU tensors. Coarse control and mass
diagonals are restricted conservatively. The hierarchy is built once on
the host and moved to the scene's device.

Layout: the operators, the V-cycle and the outer PCG of the solvers run on
channel-first fields (3, X, Y, Z) of the padded level grids, as the kernels
take them; a solver's Newton loop on a whole state stays channel-last on
the scene lattice and crosses over once per Newton step (pad_cf /
unpad_cf, `WholeState`). A state placed in z-slabs by the distributed
multigrid (parallel.lattice_mg_dist) is already channel-first on the
padded level-0 grid, and its Newton loop runs there (`SlabState`).

Every level, the fine one included, runs the kernels on its own padded
lattice: the reference's routing of the fine level through the scene and
its axis permutation exist for the TPU's box cover and tile padding, which
the port does not have (the padding ring has no cells and no vertices).

The Newton, PCG and smoother loops run on the host. Host-side scalar tests
and the Chebyshev coefficients are computed in float32, as the reference
computes them on device scalars.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..config import DynamicsConfig
from ..ops import ell, stencil
from ..ops import lattice_kernels as lk
from ..solvers import cg as cgmod
from .lattice import (LatState, LatticeScene, adaptive_frame, armijo_step,
                      host_inf_norm, newton_update, quasistatic_to_tol,
                      run_load_schedule)


class MGLevel(NamedTuple):
    cell_mask: torch.Tensor  # (Cx, Cy, Cz)
    vert_mask: torch.Tensor  # (X, Y, Z)
    ctrl: torch.Tensor       # (X, Y, Z) control (+ baked mass/dt^2) diagonal
    dx: float
    # (X, Y, Z) lumped vertex mass, conservatively restricted from the fine
    # level (the total is kept exactly), not re-lumped from the coarse cell
    # mask: the binary coarse mask inflates jagged boundaries, and a coarse
    # gravity load from that mass pulls the coarse equilibrium past the fine
    # one. Used by the FMG level solves and the solve-time inertia term.
    mass: torch.Tensor


class LevelOps(NamedTuple):
    """One level of a linearization, channel-first."""
    matvec: Callable         # p -> (H(u) p + ctrl p) vm, (3, X, Y, Z)
    d6: torch.Tensor         # (6, X, Y, Z) the smoother's blocks (xx xy xz
                             # yy yz zz): diagonal + (ctrl + 1 - vm) I,
                             # SPD-projected with spd_smoother
    vmask: torch.Tensor      # (X, Y, Z)
    lmax: np.float32         # the Chebyshev upper bound of D^-1 A
    u_cf: torch.Tensor       # (3, X, Y, Z) displacement from the rest grid
    ctrl: torch.Tensor       # (X, Y, Z) the whole diagonal shift


class LevelFields(NamedTuple):
    """A level's fields where linearize and the V-cycle take them: the
    level's own tensors here, slabs on a sharded level of
    parallel.lattice_mg_dist.DistLatticeMG."""
    vert_mask: torch.Tensor  # (X, Y, Z)
    ctrl: torch.Tensor       # (X, Y, Z)
    mass: torch.Tensor       # (X, Y, Z)
    x0_cf: torch.Tensor      # (3, X, Y, Z) the rest grid, channel-first
    restrict_w: torch.Tensor | None  # (X, Y, Z) _restrict_w_cf of the
                             # level above (None on level 0)


class WholeState:
    """How the Newton solvers take a whole state (X, Y, Z, 3) on the scene
    lattice: padded into the level-0 grid (pad, pad_cf) and back
    (unpad_cf) once a Newton step, the vertex mask, the scene's residual
    and energies. parallel.lattice_mg_dist.SlabState is the same for a
    state placed in z-slabs; LatticeMG.state_ops picks by placement."""

    def __init__(self, scene: LatticeScene, mg: "LatticeMG"):
        self.scene = scene
        self.pad, self.pad_cf, self.unpad_cf = mg.pad, mg.pad_cf, mg.unpad_cf
        self.vmask3 = scene.vert_mask[..., None]

    def dyn_force(self, x, x_tilde, inv_dt, gravity_scale):
        return self.scene.dyn_force(x, x_tilde, inv_dt,
                                    gravity_scale=gravity_scale)

    def total_energy(self, x, gravity_scale):
        return self.scene.total_energy(x, gravity_scale=gravity_scale)

    def ie_energy(self, x, x_tilde, inv_dt, gravity_scale):
        """The implicit-Euler incremental potential (dyn_force is minus its
        gradient)."""
        e = self.scene.total_energy(x, gravity_scale=gravity_scale)
        di = (x - x_tilde) * self.vmask3
        return e + 0.5 * inv_dt * inv_dt * torch.sum(
            self.scene.mass[..., None] * di * di)


def _pad_to(a: torch.Tensor, shape) -> torch.Tensor:
    """a zero-padded at the high end of its first three axes to `shape`."""
    out = a.new_zeros(tuple(shape) + tuple(a.shape[3:]))
    out[:a.shape[0], :a.shape[1], :a.shape[2]] = a
    return out


def _pad_cf(a: torch.Tensor, shape) -> torch.Tensor:
    """A channel-first field zero-padded at the high end of its last three
    axes to `shape`."""
    out = a.new_zeros(tuple(a.shape[:-3]) + tuple(shape))
    out[..., :a.shape[-3], :a.shape[-2], :a.shape[-1]] = a
    return out


def _odd(n: int) -> int:
    return n if n % 2 else n + 1


class LatticeMG:
    """The structured hierarchy of a LatticeScene, on the scene's device,
    and a V-cycle preconditioner for its Newton solves.

    dt: the inertia term mass/dt^2 baked into every level's ctrl; None
    builds a quasi-static (pin-only) hierarchy, which can still serve a
    dynamic solve: linearize(inv_dt=...) adds the restricted mass times
    inv_dt^2 per level (the restriction is linear, so this is exact).
    coarse_cg > 0 solves the coarsest level with that many block-Jacobi
    PCG iterations instead of coarse_sweeps Chebyshev sweeps (the outer
    PCG is then flexible). spd_smoother projects the smoother's diagonal
    blocks onto SPD (the operator itself is left as it is). z_multiple > 1
    pads z so that every level's z extent is a multiple of it (the
    distributed multigrid's slabs); 1 keeps the odd extents."""

    def __init__(self, scene: LatticeScene, n_levels: int = 3, nu: int = 2,
                 coarse_sweeps: int = 12,
                 dt: float | None = DynamicsConfig().dt,
                 coarse_cg: int = 0, spd_smoother: bool = True,
                 z_multiple: int = 1):
        self.scene = scene
        self.nu = nu
        self.coarse_sweeps = coarse_sweeps
        self.coarse_cg = coarse_cg
        self.spd_smoother = spd_smoother
        self.build_dt = dt
        mat = scene.material
        dev = scene.device

        # built on the host in float32, then moved. z_multiple == 1: every
        # level's vertex grid padded to odd extents (the 2n-1 transfers).
        # z_multiple > 1 (the distributed multigrid): z padded to a multiple
        # of z_multiple * 2^(n_levels-1) instead, so that every level's z
        # extent splits evenly over z_multiple slabs; z then halves exactly
        # a level (the even-grid transfers of stencil.prolong_lat), x and y
        # stay odd.
        vm0 = scene.vert_mask.cpu()
        mass0 = scene.mass.cpu()
        ctrl0 = mat.control_mag * scene.pin_mask.cpu()
        if dt is not None:
            ctrl0 = ctrl0 + mass0 * (1.0 / dt) ** 2

        def build(tz0):
            """The levels with level-0 z padded to tz0, or None where the
            even-z scheme would drop a real coarse cell (the caller retries
            with more z padding)."""
            tgt = (_odd(vm0.shape[0]), _odd(vm0.shape[1]), tz0)
            vm, ctrl, mass = (_pad_to(a, tgt) for a in (vm0, ctrl0, mass0))
            cm = _pad_to(scene.cell_mask.cpu(), tuple(n - 1 for n in tgt))
            levels = []
            dx = scene.mesh.dx
            for li in range(n_levels):
                levels.append((cm, vm, ctrl, dx, mass))
                if li == n_levels - 1:
                    break
                # a coarse cell is real when any of its 8 fine cells is
                cpad = _pad_to(cm, tuple(n + n % 2 for n in cm.shape))
                c2 = cpad.reshape(cpad.shape[0] // 2, 2,
                                  cpad.shape[1] // 2, 2,
                                  cpad.shape[2] // 2, 2)
                cm_c = (c2.amax(dim=(1, 3, 5)) > 0).to(torch.float32)
                if z_multiple > 1:
                    # even z: Z / 2 coarse vertex planes, Z / 2 - 1 cell
                    # planes; a real cell beyond them: too little slack
                    zc = vm.shape[2] // 2 - 1
                    if bool(cm_c[:, :, zc:].max() > 0):
                        return None
                    cm_c = cm_c[:, :, :zc]
                cx, cy, cz = cm_c.shape
                vm_c = torch.zeros((cx + 1, cy + 1, cz + 1))
                for (di, dj, dk) in stencil._CORNERS:
                    sl = vm_c[di:di + cx, dj:dj + cy, dk:dk + cz]
                    sl.copy_(torch.maximum(sl, cm_c))
                # conservative restriction of the control and mass diagonals
                ctrl_c = _pad_to(stencil.restrict_lat(ctrl[..., None])[..., 0],
                                 vm_c.shape) * vm_c
                mass_c = _pad_to(stencil.restrict_lat(mass[..., None])[..., 0],
                                 vm_c.shape) * vm_c
                tz = vm_c.shape[2] if z_multiple > 1 else _odd(vm_c.shape[2])
                tgt = (_odd(vm_c.shape[0]), _odd(vm_c.shape[1]), tz)
                vm, ctrl, mass = (_pad_to(a, tgt)
                                  for a in (vm_c, ctrl_c, mass_c))
                cm = _pad_to(cm_c, tuple(n - 1 for n in tgt))
                dx = dx * 2.0
            return levels

        Z = vm0.shape[2]
        if z_multiple == 1:
            levels = build(_odd(Z))
        else:
            unit = z_multiple * 2 ** (n_levels - 1)
            q = -(-(Z + 1) // unit)
            while (levels := build(q * unit)) is None:
                q += 1

        self.levels = [MGLevel(cell_mask=cm.to(dev), vert_mask=vm.to(dev),
                               ctrl=ctrl.to(dev), dx=dx, mass=mass.to(dev))
                       for cm, vm, ctrl, dx, mass in levels]
        self.n_levels = len(self.levels)
        self.pad_shape = tuple(self.levels[0].vert_mask.shape)

        # Per-level rest grids: coarse node (I, J, K) is fine node
        # (2I, 2J, 2K), so every level's rest geometry is the analytic
        # lattice base + (2^l dx) (i, j, k). linearize restricts
        # DISPLACEMENTS and anchors each level at x0_l + R(u): restricting
        # positions puts boundary coarse nodes far from the coarse rest
        # lattice, a pre-strained, strongly indefinite coarse Hessian.
        lat0 = scene.lat[0].cpu().numpy()
        base = (scene.x0[tuple(int(i) for i in lat0)].cpu().numpy()
                - lat0.astype(np.float32) * scene.mesh.dx)
        self.x0_levels = []
        for lvl in self.levels:
            sx, sy, sz = lvl.vert_mask.shape
            gi, gj, gk = np.meshgrid(np.arange(sx), np.arange(sy),
                                     np.arange(sz), indexing="ij")
            grid = np.stack([gi, gj, gk], axis=-1).astype(np.float32)
            self.x0_levels.append(
                torch.from_numpy(base + lvl.dx * grid).to(dev))
        self._x0_cf = [x.permute(3, 0, 1, 2).contiguous()
                       for x in self.x0_levels]
        # normalization of the displacement restriction (rigid modes map to
        # rigid modes): the restricted vertex mask, clamped; (X, Y, Z)
        self._restrict_w_cf = [
            torch.clamp(self._pad_coarse(
                li, stencil.restrict_lat_cf(lvl.vert_mask[None])),
                min=1e-6)[0] for li, lvl in enumerate(self.levels[:-1])]
        self.fields = [LevelFields(lvl.vert_mask, lvl.ctrl, lvl.mass, x0, w)
                       for lvl, x0, w in zip(self.levels, self._x0_cf,
                                             [None] + self._restrict_w_cf)]

    # -- the sharding hook ---------------------------------------------------
    def constrain(self, li: int, a):
        """Called on every level-li field entering linearize and vcycle.
        The identity here; parallel.lattice_mg_dist.DistLatticeMG places the
        field where its level's fields live (slabs on a sharded level)."""
        return a

    def state_ops(self, x) -> WholeState:
        """The Newton solvers' operations on a state whose positions are x: a
        whole state's here (DistLatticeMG adds the placed state's)."""
        return WholeState(self.scene, self)

    # -- the fine lattice inside the padded level-0 grid ---------------------
    def pad(self, a: torch.Tensor) -> torch.Tensor:
        """A scene-lattice field zero-padded to the level-0 grid."""
        if tuple(a.shape[:3]) == self.pad_shape:
            return a
        return _pad_to(a, self.pad_shape)

    def unpad(self, a: torch.Tensor) -> torch.Tensor:
        sx, sy, sz = self.scene.vert_mask.shape
        return a[:sx, :sy, :sz]

    def pad_cf(self, a: torch.Tensor) -> torch.Tensor:
        """A scene-lattice field (X, Y, Z, 3) as a channel-first field of
        the level-0 grid, zero-padded: one copy."""
        out = a.new_zeros((a.shape[3],) + self.pad_shape)
        sx, sy, sz = a.shape[:3]
        out[:, :sx, :sy, :sz] = a.permute(3, 0, 1, 2)
        return out

    def unpad_cf(self, a: torch.Tensor) -> torch.Tensor:
        """A channel-first level-0 field as a scene-lattice field
        (X, Y, Z, 3), contiguous: one copy."""
        sx, sy, sz = self.scene.vert_mask.shape
        return a[:, :sx, :sy, :sz].permute(1, 2, 3, 0).contiguous()

    # -- per-level operators -------------------------------------------------
    def _level_ops(self, li: int, u_cf, ctrl):
        """(matvec, d6) of level li at the channel-first displacement u_cf
        from its rest grid, with the diagonal shift ctrl (X, Y, Z): matvec
        p -> (H(u) p + ctrl p) vm in one lat_hvp launch, and the smoother's
        blocks, diagonal + (ctrl + 1 - vm) I, SPD-projected with
        spd_smoother, by lat_diag_shift. The projection: at large
        deformation StVK diagonal blocks go indefinite and a near-singular
        block makes the block solve emit huge steps; only the
        preconditioner is regularized."""
        lvl = self.levels[li]
        mat = self.scene.material
        vm = lvl.vert_mask

        def matvec(p):
            return lk.level_matvec_cf(u_cf, p, lvl.cell_mask, ctrl, vm,
                                      lvl.dx, mat.lame_mu, mat.lame_la)

        d6 = lk.hess_diag_shift_cf(u_cf, lvl.cell_mask, ctrl, vm, lvl.dx,
                                   mat.lame_mu, mat.lame_la,
                                   self.spd_smoother)
        return matvec, d6

    # -- per-Newton linearization ------------------------------------------
    def linearize(self, x_pad, inv_dt=None, lmax_cache=None):
        """Per-level LevelOps at the fine positions x_pad (X, Y, Z, 3) on
        the padded level-0 grid, taken channel-first once here (a placed
        state's positions, channel-first slabs already, as they are). lmax,
        the
        Chebyshev upper bound for D^-1 A, is a host float32: lmax_cache[li]
        when given, else estimated here by power iteration (one lat_power
        launch a level, every level's bound read back in one device sync).
        inv_dt adds the implicit-Euler inertia inv_dt^2 * mass to every
        level's ctrl (a hierarchy built with dt=None)."""
        ops = []
        mat = self.scene.material
        lmaxes = None
        if lmax_cache is None:
            lmaxes = torch.empty((self.n_levels,), dtype=torch.float32,
                                 device=self.levels[0].vert_mask.device)
        x_l = (x_pad.permute(3, 0, 1, 2).contiguous() if torch.is_tensor(x_pad)
               else x_pad)
        for li, fl in enumerate(self.fields):
            x_l = self.constrain(li, x_l)
            vm = fl.vert_mask
            u_cf = x_l - fl.x0_cf
            ctrl = fl.ctrl
            if inv_dt is not None:
                # restricted mass * inv_dt^2 == the restriction of the fine
                # mass / dt^2 term (restrict_lat is linear)
                ctrl = ctrl + fl.mass * (inv_dt * inv_dt)
            matvec, d6 = self._level_ops(li, u_cf, ctrl)
            if lmaxes is not None:
                self._power(li, u_cf, d6, ctrl, matvec, lmaxes)
            ops.append(LevelOps(matvec, d6, vm, None, u_cf, ctrl))
            if li < self.n_levels - 1:
                # restrict the displacement (weight-normalized) and anchor
                # it at the next level's rest grid
                nxt = self.fields[li + 1]
                ur = self._down(li, u_cf * vm) / nxt.restrict_w
                x_l = nxt.x0_cf + ur * nxt.vert_mask
        host = lmax_cache if lmaxes is None else lmaxes.cpu().numpy()
        return [op._replace(lmax=np.float32(host[li]))
                for li, op in enumerate(ops)]

    @staticmethod
    def lmax_cache(ops, margin: float = 1.2):
        """The Chebyshev bounds of `ops` times a drift margin, as a float32
        numpy array (n_levels,), for reuse by every later linearization of
        a solve: the power iteration costs 6 matvecs per level, and
        lmax(D^-1 A) varies slowly along a Newton path."""
        return np.array([op[3] for op in ops], np.float32) * np.float32(margin)

    def newton_ops(self, x_pad, inv_dt=None, lmaxes=None):
        """(ops, lmaxes) of one Newton linearization of a solve. The first
        (lmaxes None) estimates the bounds on its own operators and takes
        them times 1.2 as the solve's cache: the reference builds that
        cache by a separate linearization at the same point, so the
        numbers are the same with one linearization fewer."""
        if lmaxes is None:
            ops = self.linearize(x_pad, inv_dt)
            lmaxes = self.lmax_cache(ops)
            return [op._replace(lmax=lm) for op, lm in zip(ops, lmaxes)], \
                lmaxes
        return self.linearize(x_pad, inv_dt, lmax_cache=lmaxes), lmaxes

    def _power(self, li: int, u_cf, d6, ctrl, matvec, out):
        """The Chebyshev bound of level li into out[li]: one lat_power
        launch."""
        lvl = self.levels[li]
        mat = self.scene.material
        lk.power_lmax_cf(u_cf, d6, ctrl, lvl.vert_mask, lvl.cell_mask,
                         lvl.dx, mat.lame_mu, mat.lame_la, out=out, slot=li)

    # -- inter-level transfers (channel-first) -------------------------------
    def _pad_coarse(self, li: int, rc):
        """A raw restrict_lat_cf output padded up to level li+1's grid."""
        tgt = tuple(self.levels[li + 1].vert_mask.shape)
        return rc if tuple(rc.shape[1:]) == tgt else _pad_cf(rc, tgt)

    def _restrict(self, li: int, r):
        """Level-li vertex field (C, X, Y, Z) -> level li+1 grid (padded,
        unmasked)."""
        return self._pad_coarse(li, stencil.restrict_lat_cf(r))

    def _prolong(self, li: int, xc):
        """Level li+1 vertex field (C, X, Y, Z) -> level li grid."""
        src = tuple(self.levels[li].vert_mask.shape)
        return stencil.prolong_lat_cf(
            xc[:, :(src[0] + 1) // 2, :(src[1] + 1) // 2,
               :(src[2] + 1) // 2], shape=src)

    def _down(self, li: int, r):
        """The restriction as linearize and the V-cycle apply it, onto
        where level li+1's fields live (_restrict here)."""
        return self._restrict(li, r)

    def _up(self, li: int, xc):
        """The prolongation as the V-cycle applies it, onto where level
        li's fields live (_prolong here)."""
        return self._prolong(li, xc)

    # -- V-cycle preconditioner ---------------------------------------------
    def _smooth(self, level: int, op: LevelOps, b, x, degree: int,
                want_residual: bool = False):
        """Chebyshev smoother on D^-1 A targeting [lmax/4, lmax] from x
        (None: from zero, where the first residual is b itself), in one
        lat_cheby launch; with want_residual also b - A x."""
        lvl = self.levels[level]
        mat = self.scene.material
        return lk.cheby_smooth_cf(op.u_cf, b, x, op.d6, op.ctrl, op.vmask,
                                  lvl.cell_mask, lvl.dx, mat.lame_mu,
                                  mat.lame_la, lk.cheby_coeffs(op.lmax, degree),
                                  want_residual)

    def vcycle(self, ops, b, level: int = 0):
        """One V-cycle from level `level` on the channel-first right-hand
        side b (3, X, Y, Z) of that level's grid; returns the channel-first
        correction."""
        b = self.constrain(level, b)
        op = ops[level]
        if level == self.n_levels - 1:
            if self.coarse_cg > 0:
                return cgmod.pcg_operator(
                    op.matvec, lambda r: lk.sym_solve_cf(op.d6, r) * op.vmask,
                    b, iterations=self.coarse_cg, tol=1e-4)
            return self._smooth(level, op, b, None, self.coarse_sweeps)
        x, r = self._smooth(level, op, b, None, self.nu, want_residual=True)
        rc = self._down(level, r) * ops[level + 1].vmask
        xc = self.vcycle(ops, rc, level + 1)
        x = x + self._up(level, xc) * op.vmask
        return self._smooth(level, op, b, x, self.nu)


def step_to_tol_mg(scene: LatticeScene, mg: LatticeMG, st: LatState,
                   dyn: DynamicsConfig = DynamicsConfig(),
                   tol: float = 1e-4, max_newton: int = 20,
                   cg_iterations: int = 30, cg_tol: float = 1e-2,
                   gravity_scale=1.0, dt=None, damping=None,
                   return_cg: bool = False):
    """Dynamic frame with GMG-preconditioned inexact Newton-CG, and the
    blowup rescue of step_to_tol (Armijo on the incremental potential when
    a full step explodes). `dt`/`damping` override the config's and need a
    hierarchy built with dt=None (its levels take inv_dt^2 * mass at solve
    time). Returns (state, k, fn), plus the PCG matvec total with
    return_cg=True.

    A state placed in z-slabs (parallel.lattice_mg_dist: `place` of
    make_dist_mg_step) is stepped in its slabs, the predictor, residual,
    outer PCG, Newton and velocity updates and the rescue's energy
    included, and returned placed."""
    if dt is not None and mg.build_dt is not None:
        raise ValueError("dt override needs LatticeMG(..., dt=None): the "
                         "hierarchy's baked ctrl already holds a mass/dt^2 "
                         "term at its build dt")
    dt = dyn.dt if dt is None else dt
    damping = dyn.damping if damping is None else damping
    inv_dt = 1.0 / dt
    lin_inv_dt = inv_dt if mg.build_dt is None else None
    so = mg.state_ops(st.x)
    x_old = st.x
    v = st.v * damping
    x = st.x + v * dt
    x_tilde = x
    vmask3 = so.vmask3

    def resid(xx):
        return so.dyn_force(xx, x_tilde, inv_dt, gravity_scale)

    def ie_energy(xe):
        return so.ie_energy(xe, x_tilde, inv_dt, gravity_scale)

    tol32 = np.float32(tol)
    cond = cgmod.newton_cond(tol, max_newton)
    fn = host_inf_norm(resid(x))
    fmin, k, cg_tot, lmaxes = fn, 0, 0, None
    while cond((x, k, fn, fmin)):
        f = resid(x)
        ops, lmaxes = mg.newton_ops(so.pad(x), lin_inv_dt, lmaxes)
        dx, cg_k = cgmod.pcg_operator(
            ops[0].matvec, lambda r: mg.vcycle(ops, r), so.pad_cf(f),
            iterations=cg_iterations, tol=cg_tol,
            flexible=mg.coarse_cg > 0, return_iters=True)
        cg_tot += cg_k - 1
        dx = so.unpad_cf(dx)
        x_full = x + dx * vmask3
        fn_full = host_inf_norm(resid(x_full))
        with np.errstate(over="ignore"):
            bad = (not np.isfinite(fn_full)
                   or fn_full > np.float32(30.0) * max(fn, tol32))
        if bad:
            x = armijo_step(ie_energy, x, f, dx, vmask3)
            fn = host_inf_norm(resid(x))
        else:
            x, fn = x_full, fn_full
        k += 1
        fmin = np.minimum(fmin, fn)
    v = (x - x_old) * inv_dt
    out = st._replace(x=x, v=v), k, cgmod.newton_exit_norm(fn, fmin)
    return out + (cg_tot,) if return_cg else out


def frame_adaptive_mg(scene: LatticeScene, mg: LatticeMG, st: LatState,
                      dyn: DynamicsConfig = DynamicsConfig(),
                      tol: float = 1e-4, max_newton: int = 20,
                      cg_iterations: int = 30, cg_tol: float = 1e-2,
                      max_halvings: int = 3, gravity_scale=1.0):
    """step_to_tol_mg with adaptive time substepping (the protocol of
    lattice.frame_adaptive); needs a hierarchy built with dt=None. A placed
    state is stepped and returned placed. Returns (state, max Newton, worst
    substep exit norm, n_substeps)."""
    if mg.build_dt is not None:
        raise ValueError("frame_adaptive_mg needs LatticeMG(..., dt=None)")

    def step(s, dt, damp):
        return step_to_tol_mg(scene, mg, s, dyn, tol, max_newton,
                              cg_iterations, cg_tol,
                              gravity_scale=gravity_scale, dt=dt,
                              damping=damp)
    return adaptive_frame(step, st, dyn, tol, max_halvings)


def _solve_level_quasistatic(mg: LatticeMG, li: int, x0, tol, max_newton,
                             cg_iterations, cg_tol, line_search, load_steps):
    """Guarded Newton-PCG quasi-static solve on MG level li: the level's
    re-discretized elastic operator (force, energy, hvp and diag kernels at
    its dx and cell mask), its restricted pin penalty anchored at its rest
    grid, and its restricted gravity load; block-Jacobi PCG."""
    mat = mg.scene.material
    lvl = mg.levels[li]
    vm3 = lvl.vert_mask[..., None]
    ctrl3 = lvl.ctrl[..., None]
    x0_l = mg.x0_levels[li]
    args = (lvl.cell_mask, lvl.dx, mat.lame_mu, mat.lame_la)

    def resid(xx, gs):
        f = lk.force_cf((xx - x0_l).permute(3, 0, 1, 2).contiguous(),
                        *args).permute(1, 2, 3, 0)
        f[..., 1] += lvl.mass * mat.gravity * gs
        f = f + lvl.ctrl[..., None] * (x0_l - xx)
        return f * vm3

    def energy(xx, gs):
        e = lk.elastic_energy_lattice(xx - x0_l, *args)
        e = e - torch.sum(lvl.mass * mat.gravity * gs * xx[..., 1])
        d = (xx - x0_l) * vm3
        return e + 0.5 * torch.sum(lvl.ctrl[..., None] * d * d)

    def solve_at(xc, gs):
        cond = cgmod.newton_cond(tol, max_newton)
        xx, k = xc, 0
        fn = host_inf_norm(resid(xc, gs))
        fmin = fn
        while cond((xx, k, fn, fmin)):
            f = resid(xx, gs)
            u_cf = (xx - x0_l).permute(3, 0, 1, 2).contiguous()
            blocks = lk.sym_blocks(lk.hess_diag_shift_cf(
                u_cf, lvl.cell_mask, lvl.ctrl, lvl.vert_mask, *args[1:],
                mg.spd_smoother))

            def matvec(p, u_cf=u_cf):
                hp = lk.hvp_cf(u_cf, p.permute(3, 0, 1, 2).contiguous(),
                               *args)
                return (hp.permute(1, 2, 3, 0) + ctrl3 * p) * vm3

            # this PCG stays channel-last: summed channel-first, its dots
            # move the deep-bend cantilever's FMG result by 1.5e-3 in x
            # against the reference (f32 drift, PERF.md)
            dx = cgmod.pcg_operator(
                matvec, lambda r, blocks=blocks: ell.solve3x3(blocks, r)
                * vm3, f, iterations=cg_iterations, tol=cg_tol)
            xx, fn = newton_update(
                xx, f, dx, vm3, fn, lambda xe: energy(xe, gs),
                lambda xe: host_inf_norm(resid(xe, gs)), line_search)
            k += 1
            fmin = np.minimum(fmin, fn)
        return xx, k, cgmod.newton_exit_norm(fn, fmin)

    return run_load_schedule(solve_at, x0, tol, max_newton, load_steps)


def quasistatic_fmg(scene: LatticeScene, mg: LatticeMG, tol: float = 1e-4,
                    max_newton: int = 50, cg_iterations: int = 30,
                    cg_tol: float = 1e-2, line_search: bool = True,
                    load_steps: int | str = 1, coarse_max_newton: int = 50,
                    mid_max_newton: int = 15, coarse_cg_iterations: int = 60,
                    fine_solver: str = "mg", return_stats: bool = False):
    """Full-multigrid (nested iteration) quasi-static solve: the equilibrium
    on the coarsest level first (load_steps, int or "auto", applies there
    only), its displacement prolonged as the next level's start, down to
    the fine level, whose corrector is "mg" (quasistatic_to_tol_mg) or
    "jacobi" (quasistatic_to_tol with a diameter-scaled PCG cap: right for
    deep bends, where the coarse operator at the bent state makes a poor
    V-cycle). Middle levels get mid_max_newton: their output is only a
    start. Returns (x, k_total, fn), k_total summing every level's Newton
    iterations; return_stats=True appends the per-level counts, coarsest
    first.

    Every level solve, the fine corrector included, runs on whole fields,
    also on a DistLatticeMG: `_solve_level_quasistatic`'s PCG stays
    channel-last (its dots summed channel-first move the cantilever's
    result, see there), and the fine solve starts from the prolonged
    whole x."""
    if fine_solver not in ("mg", "jacobi"):
        raise ValueError(f"fine_solver {fine_solver!r}: 'mg' or 'jacobi'")
    ks = []
    x_l = mg.x0_levels[mg.n_levels - 1]
    for li in range(mg.n_levels - 1, 0, -1):
        lvl = mg.levels[li]
        x_in = x_l
        coarsest = li == mg.n_levels - 1
        x_l, k_l, fn_l = _solve_level_quasistatic(
            mg, li, x_l, tol * (2.0 ** li),
            coarse_max_newton if coarsest else mid_max_newton,
            coarse_cg_iterations, cg_tol, line_search,
            load_steps if coarsest else 1)
        # a diverged level (fn = +inf) must not poison the finer ones: its
        # input is still a valid, less converged start
        if not np.isfinite(fn_l):
            x_l = x_in
        ks.append(k_l)
        nxt = mg.levels[li - 1]
        u_c = (x_l - mg.x0_levels[li]) * lvl.vert_mask[..., None]
        u_f = mg._prolong(li - 1, u_c.permute(3, 0, 1, 2))
        x_l = (mg.x0_levels[li - 1]
               + u_f.permute(1, 2, 3, 0) * nxt.vert_mask[..., None]
               ).contiguous()
    x_fine0 = mg.unpad(x_l)
    if fine_solver == "jacobi":
        # block-Jacobi PCG needs O(diameter) iterations: the cap scales with
        # the lattice (truncation is also regularization on small ones)
        cap = max(cg_iterations, 60, max(scene.vert_mask.shape))
        x, k, fn = quasistatic_to_tol(scene, x_fine0, tol=tol,
                                      max_newton=max_newton,
                                      cg_iterations=cap, cg_tol=cg_tol,
                                      line_search=line_search)
    else:
        x, k, fn = quasistatic_to_tol_mg(scene, mg, x_fine0, tol=tol,
                                         max_newton=max_newton,
                                         cg_iterations=cg_iterations,
                                         cg_tol=cg_tol,
                                         line_search=line_search)
    ks.append(k)
    out = x, sum(ks), fn
    return out + (tuple(ks),) if return_stats else out


def quasistatic_to_tol_mg(scene: LatticeScene, mg: LatticeMG, x,
                          tol: float = 1e-4, max_newton: int = 50,
                          cg_iterations: int = 30, cg_tol: float = 1e-2,
                          line_search: bool = True,
                          load_steps: int | str = 1,
                          return_trace: bool = False,
                          cg_forcing: str | None = None,
                          return_cg: bool = False):
    """Quasi-static Newton with GMG-preconditioned CG on the lattice (build
    the LatticeMG with dt=None). Without the inertia term the Hessian's
    conditioning degrades with the mesh diameter, and the V-cycle keeps the
    PCG counts about flat. The Chebyshev bounds are estimated once per
    stage (at its first linearization) and reused by its later Newton
    iterations. load_steps, cg_forcing, return_trace and return_cg as in
    lattice.quasistatic_to_tol. Returns (x, newton_iters, f_inf). An x
    placed in z-slabs (parallel.lattice_mg_dist: `place` of
    make_dist_mg_quasistatic) is solved in its slabs, every load stage
    included, and returned placed."""
    so = mg.state_ops(x)
    vmask3 = so.vmask3

    def resid(xx, gs):
        return so.dyn_force(xx, xx, 0.0, gs)

    def solve_at(x0, gs):
        def resid_inf(xe):
            return host_inf_norm(resid(xe, gs))
        cond = cgmod.newton_cond(tol, max_newton)
        xx, k, fn = x0, 0, resid_inf(x0)
        fmin, eta, cg_tot, lmaxes = fn, np.float32(0.5), 0, None
        while cond((xx, k, fn, fmin)):
            f = resid(xx, gs)
            ops, lmaxes = mg.newton_ops(so.pad(xx), None, lmaxes)
            tol_rr = eta * eta if cg_forcing == "ew" else cg_tol
            dx, cg_k = cgmod.pcg_operator(
                ops[0].matvec, lambda r: mg.vcycle(ops, r), so.pad_cf(f),
                iterations=cg_iterations, tol=tol_rr,
                flexible=mg.coarse_cg > 0, return_iters=True)
            cg_tot += cg_k - 1
            fn_prev = fn
            xx, fn = newton_update(
                xx, f, so.unpad_cf(dx), vmask3, fn_prev,
                lambda xe: so.total_energy(xe, gs), resid_inf, line_search)
            if cg_forcing == "ew":
                eta = cgmod.ew_eta(fn, fn_prev)
            k += 1
            fmin = np.minimum(fmin, fn)
        out = xx, k, cgmod.newton_exit_norm(fn, fmin)
        return out + (cg_tot,) if return_cg else out

    if return_cg:
        if load_steps != 1 or return_trace:
            raise ValueError("return_cg counts a single-shot solve only")
        return solve_at(x, 1.0)
    return run_load_schedule(solve_at, x, tol, max_newton, load_steps,
                             return_trace=return_trace)
