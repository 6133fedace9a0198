"""The distributed lattice multigrid: fine levels in z-slabs, coarse ones whole.

Port of `fem_simulation_tpu/parallel/lattice_mg_dist.py`. The solver is
`sim/lattice_mg.py`: `DistLatticeMG` overrides only the level operators
(matvec and diagonal), the smoother and power iteration that run on them,
the inter-level transfers, the level fields and the `constrain` hook, so
the single-device and distributed multigrids cannot drift apart.

A level whose z extent has at least `min_planes_per_dev` planes a slab (and
splits evenly) is sharded: its fields live in z-slabs on the grid's `sp`
devices (parallel/slab_field.py: one tensor a device group of slabs) from
`linearize` through every V-cycle, as the reference's `constrain`
(with_sharding_constraint) keeps them: the displacement, the control
shift, the smoother's blocks, the masks, the rest grid and every V-cycle
vector. Smaller levels are replicated (coarse-grid agglomeration) on the
grid's first device: their compute is O(N / 8^level) and they keep the
single-device level kernels.

Sharded levels, by kernel:
  matvec      slab field -> slab field: extend, `lat_hvp` a slab
              (`level_matvec_cf`, the control shift and mask in its vertex
              pass; the shift's ghost planes are zero, so the ghost planes
              carry the HVP's partial sums alone), fold.
  diagonal    `lat_diag` a slab (`hess_diag6_cf`), folded, and only then
              shifted and SPD-projected on the slabs: on a boundary plane a
              slab's block is still a partial sum, and the projection is
              not linear (`lat_diag_shift` projects in its vertex pass).
  smoother    Chebyshev sweeps through the halo matvec (`lat_cheby` is one
              cooperative launch over a whole level, with no exchange
              inside); the power iteration likewise (`lat_power`), its dot
              products `psum`s of the slabs' partials in slab order.
  transfers   restriction and prolongation a slab with a one-plane halo;
              into a replicated level one gather of the coarse field, out
              of one a scatter of each slab's coarse planes.

The Newton state. `_state_sharding` is the reference's rule: the state
goes in z-slabs when the scene's unpadded vertex z extent divides the slab
count (and the fine level is sharded), else it stays whole on the scene's
device, the counterpart of the reference's replicated inputs. `place`
commits a placed state once into the fine level's own slab layout:
channel-first and zero-padded to the level-0 grid, (s, 3, X, Y, Zp / D) a
vector field's group tensor, (s, X, Y, Zp / D) a scalar's, so that its
slab boundaries are the level's and no plane moves between slabs inside a
solve (the scene's Z and the padded Zp never split alike: 24 and 32 on the
3x3x23 beam). The padded planes hold no cell and no vertex: their force,
energy and residual are 0 and their update is masked. The Newton solvers
then run on the slabs (`SlabState`): the residual is `lat_force` on each
extended slab, folded, plus the slab's gravity, control and inertia
terms; its ||f||_inf a pmax; the energy of the line search and the rescue
`lat_energy` on each slab over its own cells plus the slab's other terms,
one psum in slab order; the outer PCG's vectors are slab fields, its dots
psums (solvers/cg.pcg_operator through ops/ell.vdot), its matvec the
slab matvec, the V-cycle's right-hand side and correction slab fields.
`unplace` brings a placed state back whole.

What still crosses whole, counted in `crossings`: `place` and `unplace`,
one a field ("place", "unplace"); on a whole state, a V-cycle splits its
right-hand side once and joins its correction once, the outer PCG's
matvec splits and joins once a call and `linearize` splits the fine
positions once (a placed state crosses none of these); into and out of a
replicated level, a gather and a scatter a V-cycle; a sharded coarsest
level with coarse_cg > 0 runs the whole-field PCG there (its reduction
order), a join on entry, a split on exit, a join of its blocks and a split
and join a matvec.

The reference's `use_pallas` and `min_lane_cells` (its TPU lane gate) are
not ported: every level runs the CUDA kernels.
"""
from __future__ import annotations

import torch

from ..config import DynamicsConfig
from ..ops import ell, stencil
from ..ops import lattice_kernels as lk
from ..sim.lattice import LatState, LatticeScene
from ..sim.lattice_mg import (LatticeMG, LevelFields, _pad_cf,
                              quasistatic_to_tol_mg, step_to_tol_mg)
from ..solvers import cg as cgmod
from . import dist
from .dist import DeviceGrid, canonical_device
from .slab_field import SlabField, SlabLayout


def _state_sharding(grid: DeviceGrid, axis: str, z: int) -> bool:
    """The reference's rule for the input state: in z-slabs when the
    scene's unpadded vertex z extent divides the slab count, else whole
    (the reference's replicated inputs)."""
    return z % grid.shape[axis] == 0


def _cell_slabs(cell_mask, n_sp: int, devices):
    """(Cx, Cy, z_loc + 1) extended local cell masks of a level whose vertex
    z extent Z (= Cz + 1) splits into n_sp slabs of z_loc planes. Slab d's
    extended block covers global vertex planes [d z_loc - 1, (d+1) z_loc],
    z_loc + 1 cell planes; local cell plane c (global d z_loc - 1 + c) is
    the slab's iff it owns the cell's lower vertex plane (c >= 1): each
    cell is computed on exactly one slab, so the fold is a partition sum."""
    Cx, Cy, Cz = cell_mask.shape
    z_loc = (Cz + 1) // n_sp
    out = []
    for d in range(n_sp):
        b = cell_mask.new_zeros((Cx, Cy, z_loc + 1))
        for c in range(1, z_loc + 1):
            zc = d * z_loc - 1 + c
            if zc < Cz:
                b[:, :, c] = cell_mask[:, :, zc]
        out.append(b.to(devices[d]))
    return out


class DistLatticeMG(LatticeMG):
    """LatticeMG whose fine levels keep their fields in z-slabs on the
    grid's `sp` devices and run z-slab operators there; levels with fewer
    than `min_planes_per_dev` vertex planes a slab are replicated.
    `level_specs[li]` is (None, None, axis) for a sharded level and () for
    a replicated one, as the reference's PartitionSpecs read. z_multiple
    defaults to the slab count, so every level's z extent splits evenly;
    where it is 1 (one slab) the levels keep odd z extents, whose
    transfers are not the slab ones, and every level is replicated.

    `placed`: whether `place` puts a state in slabs (_state_sharding and a
    sharded fine level).

    `calls` counts the sharded operator calls (each launches its kernel on
    every slab), `crossings` the whole fields split into slabs, joined from
    them, gathered into a replicated level and scattered out of one, and
    the fields placed and brought back whole (place, unplace)."""

    def __init__(self, scene: LatticeScene, grid: DeviceGrid,
                 axis: str = "sp", min_planes_per_dev: int = 4, **kw):
        self.grid = grid
        self.axis = axis
        self.devices = [canonical_device(d) for d in grid.line(axis)]
        self.home = canonical_device(scene.x0.device)
        if self.home != canonical_device(grid.device):
            raise ValueError(f"the scene lives on {self.home}, the grid's "
                             f"first device is {grid.device}")
        n_sp = grid.shape[axis]
        self.n_sp = n_sp
        self.layout = SlabLayout(self.devices)
        kw.setdefault("z_multiple", n_sp)
        super().__init__(scene, **kw)
        self.level_specs = []
        self._cells = {}
        self._vm_slabs = {}
        self._v0 = {}
        for li, lvl in enumerate(self.levels):
            z = lvl.vert_mask.shape[2]
            # the slab transfers halve z exactly: an odd-z hierarchy
            # (z_multiple 1, one slab's default) shards no level
            sharded = (kw["z_multiple"] > 1 and z % n_sp == 0
                       and z >= min_planes_per_dev * n_sp)
            self.level_specs.append((None, None, axis) if sharded else ())
            if not sharded:
                continue
            self._cells[li] = _cell_slabs(lvl.cell_mask, n_sp, self.devices)
            fl = self.fields[li]
            self.fields[li] = LevelFields(*(
                None if a is None else self.layout.split(a) for a in fl))
            # the mask's ghost planes are the neighbors' own: the ghost
            # partial sums of the HVP pass through it unchanged
            self._vm_slabs[li] = self.fields[li].vert_mask.extend().slabs()
            # the power iteration's start vector (lat_power's)
            vm = lvl.vert_mask
            shape = tuple(vm.shape)
            n = shape[0] * shape[1] * shape[2]
            start = torch.sin(torch.arange(n, dtype=torch.float32,
                                           device=vm.device))
            self._v0[li] = self.layout.split(
                (vm * start.reshape(shape)).expand((3,) + shape).contiguous())
        self.calls = {"matvec": 0, "diag": 0, "smooth": 0, "power": 0}
        self.crossings = {"split": 0, "join": 0, "gather": 0, "scatter": 0,
                          "place": 0, "unplace": 0}
        self.placed = (_state_sharding(grid, axis, scene.vert_mask.shape[2])
                       and self.sharded(0))
        self._slab_state = SlabState(self) if self.placed else None

    def sharded(self, li: int) -> bool:
        return li in self._cells

    # -- the Newton state ----------------------------------------------------
    def place(self, a):
        """A LatState, or positions (X, Y, Z, 3), where the solver keeps
        them: each field in the fine level's slabs (channel-first, padded)
        where `placed`, else whole on the scene's device. A placed field
        stays as it is."""
        if isinstance(a, LatState):
            return LatState(*(self.place(f) for f in a))
        if isinstance(a, SlabField):
            return a
        a = a.to(self.home)
        if not self.placed:
            return a
        self.crossings["place"] += 1
        return self.layout.split(self.pad_cf(a) if a.dim() == 4
                                 else self.pad(a))

    def unplace(self, a):
        """A placed LatState or field brought back whole on the scene's
        device, channel-last on the scene lattice; a whole one as it is."""
        if isinstance(a, LatState):
            return LatState(*(self.unplace(f) for f in a))
        if not isinstance(a, SlabField):
            return a
        self.crossings["unplace"] += 1
        w = a.join(self.home)
        return self.unpad_cf(w) if w.dim() == 4 else \
            self.unpad(w).contiguous()

    def state_ops(self, x):
        """The Newton solvers' operations: SlabState for a placed state."""
        if isinstance(x, SlabField):
            return self._slab_state
        return super().state_ops(x)

    # -- whole fields into slabs and back (counted) --------------------------
    def _split(self, a) -> SlabField:
        self.crossings["split"] += 1
        return self.layout.split(a)

    def _join(self, f: SlabField):
        self.crossings["join"] += 1
        return f.join(self.home)

    def constrain(self, li, a):
        """A field entering level li where the level's fields live: split
        into slabs on a sharded level (a slab field stays as it is), whole
        on the home device on a replicated one."""
        if not self.sharded(li):
            return a.to(self.home)
        if isinstance(a, SlabField):
            return a
        if a.shape[-1] % self.n_sp:
            raise ValueError(f"level {li}: z extent {a.shape[-1]} does not "
                             f"split over {self.n_sp} slabs")
        return self._split(a)

    # -- level operators on sharded levels -----------------------------------
    def _level_ops(self, li: int, u_cf, ctrl):
        if not self.sharded(li):
            return super()._level_ops(li, u_cf, ctrl)
        lvl = self.levels[li]
        mat = self.scene.material
        mu, la, dx = mat.lame_mu, mat.lame_la, lvl.dx
        cells, vms = self._cells[li], self._vm_slabs[li]
        u = u_cf.extend()
        ctrl_s = ctrl.ghost_zero().slabs()
        u_s = u.slabs()

        def slab_matvec(p):
            self.calls["matvec"] += 1
            hp = [lk.level_matvec_cf(ub, pb, cm, c, vm, dx, mu, la)
                  for ub, pb, cm, c, vm in zip(u_s, p.extend().slabs(),
                                               cells, ctrl_s, vms)]
            return self.layout.stack(hp).fold()

        def matvec(p):
            """Slabs to slabs; a whole field (the outer PCG's) is split and
            the product joined."""
            if isinstance(p, SlabField):
                return slab_matvec(p)
            return self._join(slab_matvec(self._split(p)))

        self.calls["diag"] += 1
        d6 = self.layout.stack([lk.hess_diag6_cf(ub, cm, dx, mu, la)
                                for ub, cm in zip(u_s, cells)]).fold()
        spd = self.spd_smoother

        def shift_project(d, c, vm):
            eye = torch.eye(3, dtype=d.dtype, device=d.device)
            blocks = lk.sym_blocks(d) + (c + (1.0 - vm))[..., None, None] * eye
            if spd:
                blocks = ell.spd_project(blocks, eps=1e-6, rel_floor=1e-3)
            return lk.sym_channels(blocks)
        return matvec, SlabField.apply(shift_project, d6, ctrl,
                                       self.fields[li].vert_mask)

    def _power(self, li, u_cf, d6, ctrl, matvec, out, iters: int = 6):
        """Power iteration on D^-1 A through the halo matvec, from
        lat_power's start vector; the dot products are psums."""
        if not self.sharded(li):
            return super()._power(li, u_cf, d6, ctrl, matvec, out)
        self.calls["power"] += 1
        vm = self.fields[li].vert_mask
        v = self._v0[li]
        lam = None
        for _ in range(iters):
            w = SlabField.apply(lk.sym_solve_cf, d6, matvec(v)) * vm
            ww = w.dot(w)
            lam = torch.sqrt(ww / torch.clamp(v.dot(v), min=1e-30))
            v = w / torch.clamp(torch.sqrt(ww), min=1e-30)
        out[li] = lam * 1.1

    def _smooth(self, level, op, b, x, degree, want_residual=False):
        """Chebyshev on D^-1 A through the level's matvec (on a sharded
        level the halo matvec on slab fields; lat_cheby elsewhere)."""
        if not self.sharded(level):
            return super()._smooth(level, op, b, x, degree, want_residual)
        self.calls["smooth"] += 1
        coeffs = lk.cheby_coeffs(op.lmax, degree)

        def solve(r):
            return SlabField.apply(lk.sym_solve_cf, op.d6, r) * op.vmask
        z = solve(b if x is None else b - op.matvec(x))
        d = z / coeffs[0]
        x = d if x is None else x + d
        for a, c in zip(coeffs[1::2], coeffs[2::2]):
            z = solve(b - op.matvec(x))
            d = a * d + c * z
            x = x + d
        return (x, b - op.matvec(x)) if want_residual else x

    def vcycle(self, ops, b, level: int = 0):
        """LatticeMG.vcycle on slab fields; a whole right-hand side on a
        sharded level is split once and its correction joined once."""
        if not self.sharded(level):
            return super().vcycle(ops, b, level)
        whole = not isinstance(b, SlabField)
        if level == self.n_levels - 1 and self.coarse_cg > 0:
            # the whole-field PCG, its reduction order as on one device
            op = ops[level]
            d6 = self._join(op.d6)
            vm = self.levels[level].vert_mask
            x = cgmod.pcg_operator(
                op.matvec, lambda r: lk.sym_solve_cf(d6, r) * vm,
                b if whole else self._join(b), iterations=self.coarse_cg,
                tol=1e-4)
            return x if whole else self._split(x)
        x = super().vcycle(ops, b, level)
        return self._join(x) if whole else x

    # -- transfers with a one-plane halo on sharded fine levels --------------
    def _down(self, li, r):
        """Slab restriction: onto the next level's slabs, or gathered once
        into a replicated next level."""
        if not self.sharded(li):
            return super()._down(li, r)
        # slab d's left ghost is global plane d z_loc - 1 (zeros on the
        # first slab: the zero boundary); coarse plane K reads fine planes
        # 2K-1 .. 2K+1, all inside the ghost-extended slab (z_loc is even on
        # every level, so the coarse planes split evenly too)
        lo = r.neighbor_plane(+1)

        def body(own, lo):
            ext = torch.cat([lo.unsqueeze(-1), own], -1)
            y = stencil._conv_half(stencil._conv_half(ext, -3), -2)
            y = stencil._conv_half(y, -1)
            return y[..., ::2, ::2, 1::2]
        rc = SlabField(self.layout, [body(p, l) for p, l in zip(r.parts, lo)])
        if not self.sharded(li + 1):
            self.crossings["gather"] += 1
            return self._pad_coarse(li, rc.join(self.home))
        # pad x and y up to the next level's grid (z halves exactly)
        X, Y, Z = self.levels[li + 1].vert_mask.shape
        tgt = (X, Y, Z // self.n_sp)
        return SlabField.apply(lambda a: a.contiguous() if a.shape[-3:] == tgt
                               else _pad_cf(a, tgt), rc)

    def _up(self, li, xc):
        """Slab prolongation onto level li's slabs, from the coarse level's
        slabs or, out of a replicated coarse level, one scatter of each
        slab's coarse plane range."""
        if not self.sharded(li):
            return super()._up(li, xc)
        sx, sy, sz = self.levels[li].vert_mask.shape
        cx, cy = (sx + 1) // 2, (sy + 1) // 2
        z_loc = sz // self.n_sp
        zc_loc = sz // 2 // self.n_sp
        if self.sharded(li + 1):
            # the right ghost is the next slab's first coarse plane (zeros
            # after the last slab: the zero boundary)
            xc = SlabField.apply(lambda a: a[..., :cx, :cy, :], xc)
            hi = xc.neighbor_plane(-1)
            locs = [torch.cat([p, h.unsqueeze(-1)], -1)
                    for p, h in zip(xc.parts, hi)]
        else:
            self.crossings["scatter"] += 1
            xc = xc[:, :cx, :cy, :sz // 2]
            xcp = torch.cat([xc, torch.zeros_like(xc[..., :1])], -1)
            locs = [torch.stack([xcp[..., d * zc_loc:d * zc_loc + zc_loc + 1]
                                 for d in range(a, b)])
                    .to(self.devices[a], non_blocking=True)
                    for a, b in self.layout.groups]

        def body(loc):
            # slab-local fine plane i (global d z_loc + i, even): loc[i / 2]
            # for even i, the mean of its two coarse neighbors for odd i
            z = loc.new_zeros(tuple(loc.shape[:-1]) + (2 * (zc_loc + 1),))
            z[..., ::2] = loc
            z = stencil._conv_half(z, -1)[..., :z_loc]
            f = z.new_zeros(tuple(z.shape[:-3]) + (sx, sy, z_loc))
            f[..., ::2, ::2, :] = z
            return stencil._conv_half(stencil._conv_half(f, -3), -2)
        return SlabField(self.layout, [body(loc) for loc in locs])

    # -- the transfers on whole fields -------------------------------------
    def _restrict(self, li, r):
        """Whole level-li field -> whole level li+1 field (the slab
        restriction on a sharded level)."""
        if not self.sharded(li):
            return super()._restrict(li, r)
        rc = self._down(li, self._split(r))
        return self._join(rc) if isinstance(rc, SlabField) else rc

    def _prolong(self, li, xc):
        """Whole level li+1 field -> whole level-li field (the slab
        prolongation on a sharded level)."""
        if not self.sharded(li):
            return super()._prolong(li, xc)
        if self.sharded(li + 1):
            xc = self._split(xc)
        return self._join(self._up(li, xc))


class SlabState:
    """The Newton solvers' operations on a placed state
    (sim/lattice_mg.WholeState for a whole one): the scene's fields in the
    fine level's slabs, split once here, and the residual and energies on
    the slabs. Each vector field is (s, 3, X, Y, z) a group, each scalar
    field (s, X, Y, z)."""

    def __init__(self, mg: DistLatticeMG):
        scene = mg.scene
        self.scene, self.layout = scene, mg.layout
        self.x0 = mg.layout.split(mg.pad_cf(scene.x0))
        self.pin = mg.layout.split(mg.pad(scene.pin_mask))
        self.pin_pos = mg.layout.split(mg.pad_cf(scene.pin_pos))
        fl = mg.fields[0]
        # level 0's mass and vertex mask are the scene's, padded
        self.mass, self.vmask3 = fl.mass, fl.vert_mask
        self.cells = mg._cells[0]
        self.dx = mg.levels[0].dx

    @staticmethod
    def pad(x):
        return x

    pad_cf = unpad_cf = pad

    def _elastic(self, x):
        """The displacement from the scene's rest positions, each slab
        extended by its ghost planes."""
        return (x - self.x0).extend()

    def dyn_force(self, x, x_tilde, inv_dt, gravity_scale):
        """scene.dyn_force on the slabs (no drag, as the multigrid steps
        take it): lat_force on each extended slab, folded, then the slab's
        gravity, control and inertia terms, masked."""
        mat = self.scene.material
        u = self._elastic(x)
        f = self.layout.stack([
            lk.force_cf(ub, cm, self.dx, mat.lame_mu, mat.lame_la)
            for ub, cm in zip(u.slabs(), self.cells)]).fold()

        def body(f, x, xt, pin, pp, mass, vm):
            f[:, 1] += mass * mat.gravity * gravity_scale
            f = f + mat.control_mag * pin[:, None] * (pp - x)
            f = f - (mass * inv_dt * inv_dt)[:, None] * (x - xt)
            return f * vm[:, None]
        return SlabField.apply(body, f, x, x_tilde, self.pin, self.pin_pos,
                               self.mass, self.vmask3)

    def _energy(self, x, gravity_scale, x_tilde=None, inv_dt=0.0):
        """scene.total_energy (plus the inertia term where x_tilde is
        given) on the slabs: lat_energy on each extended slab over its own
        cells (each cell on one slab) plus the slab's other terms, summed
        in slab order (one psum)."""
        mat = self.scene.material
        u = self._elastic(x)
        e_el = [lk.elastic_energy_lattice(ub.permute(1, 2, 3, 0).contiguous(),
                                          cm, self.dx, mat.lame_mu,
                                          mat.lame_la)
                for ub, cm in zip(u.slabs(), self.cells)]

        def rest(x, pin, pp, mass, vm, xt):
            def slab_sum(a):
                return torch.sum(a.reshape(a.shape[0], -1), 1)
            vm3 = vm[:, None]
            e = -slab_sum(mass * mat.gravity * gravity_scale * x[:, 1])
            d = (x - pp) * vm3
            e = e + 0.5 * mat.control_mag * slab_sum(pin[:, None] * d * d)
            if xt is not None:
                di = (x - xt) * vm3
                e = e + 0.5 * inv_dt * inv_dt * slab_sum(
                    mass[:, None] * di * di)
            return e
        other = SlabField.apply(rest, x, self.pin, self.pin_pos, self.mass,
                                self.vmask3, x_tilde).slabs()
        return dist.psum([a + b for a, b in zip(e_el, other)])

    def total_energy(self, x, gravity_scale):
        return self._energy(x, gravity_scale)

    def ie_energy(self, x, x_tilde, inv_dt, gravity_scale):
        return self._energy(x, gravity_scale, x_tilde, inv_dt)


def make_dist_mg_step(scene: LatticeScene, grid: DeviceGrid,
                      axis: str = "sp", n_levels: int = 3, tol: float = 1e-4,
                      max_newton: int = 20,
                      dyn: DynamicsConfig = DynamicsConfig(), **mg_kw):
    """The distributed dynamic step: (step, place), step(state) -> (state,
    newton_iters, f_inf) the multigrid-preconditioned implicit-Euler frame
    (step_to_tol_mg) on a DistLatticeMG, the state returned in the
    placement it was given; place(state) the state where the solver keeps
    it (DistLatticeMG.place: in slabs where `mg.placed`, else whole on the
    scene's device). The hierarchy is `step.mg`; `step.unplace(state)`
    brings a placed state back whole."""
    mg = DistLatticeMG(scene, grid, axis=axis, n_levels=n_levels,
                       dt=dyn.dt, **mg_kw)

    def step(st):
        return step_to_tol_mg(scene, mg, st, dyn=dyn, tol=tol,
                              max_newton=max_newton)

    step.mg = mg
    step.unplace = mg.unplace
    return step, mg.place


def make_dist_mg_quasistatic(scene: LatticeScene, grid: DeviceGrid,
                             axis: str = "sp", n_levels: int = 3,
                             tol: float = 1e-4, max_newton: int = 50,
                             **mg_kw):
    """The distributed quasi-static solve: (solve, place), solve(x) -> (x,
    newton_iters, f_inf) by quasistatic_to_tol_mg on a DistLatticeMG built
    with dt=None, x returned in the placement it was given; place(x) the
    positions (X, Y, Z, 3) where the solver keeps them (in slabs where
    `mg.placed`). The hierarchy is `solve.mg`; `solve.unplace(x)` brings
    placed positions back whole."""
    mg = DistLatticeMG(scene, grid, axis=axis, n_levels=n_levels, dt=None,
                       **mg_kw)

    def solve(x):
        return quasistatic_to_tol_mg(scene, mg, x, tol=tol,
                                     max_newton=max_newton)

    solve.mg = mg
    solve.unplace = mg.unplace
    return solve, mg.place
