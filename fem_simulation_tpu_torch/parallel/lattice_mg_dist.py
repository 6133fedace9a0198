"""The distributed lattice multigrid: fine levels in z-slabs, coarse ones whole.

Port of `fem_simulation_tpu/parallel/lattice_mg_dist.py`. The solver is
`sim/lattice_mg.py`: `DistLatticeMG` overrides only the level operators
(matvec and diagonal), the smoother and power iteration that run on them,
the inter-level transfers and the `constrain` hook, so the single-device
and distributed multigrids cannot drift apart.

A level whose z extent has at least `min_planes_per_dev` planes a slab (and
splits evenly) is sharded: its operators run on z-slabs on the grid's `sp`
devices with the plane halo of parallel/lattice_halo.py (extend, the
kernel on each slab, fold). Smaller levels are replicated (coarse-grid
agglomeration): their compute is O(N / 8^level) and they keep the
single-device level kernels.

Sharded levels, by kernel:
  matvec      `lat_hvp` a slab (`level_matvec_cf`, the control shift and
              mask in its vertex pass; the shift's ghost planes are zero, so
              the ghost planes carry the HVP's partial sums alone), folded.
  diagonal    the two-pass `lat_diag` a slab, folded, and only then shifted
              and SPD-projected: on a boundary plane a slab's block is still
              a partial sum, and the projection is not linear (the fused
              `lat_diag_shift` projects in its vertex pass).
  smoother    Chebyshev sweeps through the halo matvec (`lat_cheby` is one
              cooperative launch over a whole level, with no exchange
              inside); the power iteration likewise (`lat_power`), its dot
              products `psum`s of the slabs' partials.
  transfers   restriction and prolongation a slab with a one-plane halo.

Between operators the multigrid's fields are whole, on the grid's first
device (where the scene is): a sharded operator splits its inputs into
slabs, one on each `sp` device, and joins its result there, and
`constrain` moves a field home. This is not the reference's layout: its
`constrain` (with_sharding_constraint) keeps a sharded level's fields
split along z between operators, so the vector work and the memory of a
level are spread over the devices. On one card, where every slab shares
the card, the two layouts do the same work. On several cards this port
keeps all of the multigrid's vector work and fields on the first card and
copies each slab out and back for every sharded operator, a known gap
(ROADMAP).

The reference's `use_pallas` and `min_lane_cells` (its TPU lane gate) are
not ported: every level runs the CUDA kernels.
"""
from __future__ import annotations

import torch

from ..config import DynamicsConfig
from ..ops import ell, stencil
from ..ops import lattice_kernels as lk
from ..sim.lattice import LatState, LatticeScene
from ..sim.lattice_mg import (LatticeMG, quasistatic_to_tol_mg,
                              step_to_tol_mg)
from .dist import DeviceGrid, canonical_device, dot, shift_planes
from .lattice_halo import extend, fold


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
    """LatticeMG whose fine levels run z-slab operators on the grid's `sp`
    devices; levels with fewer than `min_planes_per_dev` vertex planes a
    slab are replicated. `level_specs[li]` is (None, None, axis) for a
    sharded level and () for a replicated one, as the reference's
    PartitionSpecs read. z_multiple defaults to the slab count, so every
    level's z extent splits evenly."""

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
        kw.setdefault("z_multiple", n_sp)
        super().__init__(scene, **kw)
        self.level_specs = []
        self._cells = {}
        self._vm_slabs = {}
        for li, lvl in enumerate(self.levels):
            z = lvl.vert_mask.shape[2]
            sharded = z >= min_planes_per_dev * n_sp and z % n_sp == 0
            self.level_specs.append((None, None, axis) if sharded else ())
            if sharded:
                self._cells[li] = _cell_slabs(lvl.cell_mask, n_sp,
                                              self.devices)
                # the mask's ghost planes are the neighbors' own: the ghost
                # partial sums of the HVP pass through it unchanged
                self._vm_slabs[li] = extend(self._split(lvl.vert_mask))
        # sharded operator calls (each launches its kernel on every slab)
        self.calls = {"matvec": 0, "diag": 0, "smooth": 0, "power": 0}

    def sharded(self, li: int) -> bool:
        return li in self._cells

    # -- splitting a whole field into slabs and joining it back --------------
    def _split(self, a):
        """A whole level field (..., Z) -> its owned slabs, slab d on the
        grid's device d."""
        z = a.shape[-1] // self.n_sp
        return [a[..., d * z:(d + 1) * z].to(dev, non_blocking=True)
                for d, dev in enumerate(self.devices)]

    def _join(self, blocks):
        """Slabs with ghost planes -> the whole field of their owned planes
        on the home device."""
        return torch.cat([b[..., 1:-1].to(self.home, non_blocking=True)
                          for b in blocks], -1)

    def _dot(self, a, b):
        return dot(self._split(a), self._split(b))

    def constrain(self, li, a):
        """The field whole on the home device (the reference keeps a
        sharded level's field split; see the module docstring)."""
        if self.sharded(li) and a.shape[-1] % self.n_sp:
            raise ValueError(f"level {li}: z extent {a.shape[-1]} does not "
                             f"split over {self.n_sp} slabs")
        return a.to(self.home)

    # -- level operators on sharded levels -----------------------------------
    def _level_ops(self, li: int, u_cf, ctrl):
        if not self.sharded(li):
            return super()._level_ops(li, u_cf, ctrl)
        lvl = self.levels[li]
        mat = self.scene.material
        mu, la, dx = mat.lame_mu, mat.lame_la, lvl.dx
        cells, vms = self._cells[li], self._vm_slabs[li]
        u = extend(self._split(u_cf))
        ctrl_s = [torch.cat([torch.zeros_like(c[..., :1]), c,
                             torch.zeros_like(c[..., :1])], -1)
                  for c in self._split(ctrl)]

        def matvec(p):
            self.calls["matvec"] += 1
            hp = [lk.level_matvec_cf(ub, pb, cm, c, vm, dx, mu, la)
                  for ub, pb, cm, c, vm in zip(u, extend(self._split(p)),
                                               cells, ctrl_s, vms)]
            return self._join(fold(hp))

        self.calls["diag"] += 1
        d6 = self._join(fold([lk.sym_channels(lk.hess_diag_cf(
            ub, cm, dx, mu, la)) for ub, cm in zip(u, cells)]))
        eye = torch.eye(3, dtype=d6.dtype, device=d6.device)
        blocks = (lk.sym_blocks(d6)
                  + (ctrl + (1.0 - lvl.vert_mask))[..., None, None] * eye)
        if self.spd_smoother:
            blocks = ell.spd_project(blocks, eps=1e-6, rel_floor=1e-3)
        return matvec, lk.sym_channels(blocks)

    def _power(self, li, u_cf, d6, ctrl, matvec, out, iters: int = 6):
        """Power iteration on D^-1 A through the halo matvec, from
        lat_power's start vector; the dot products are psums."""
        if not self.sharded(li):
            return super()._power(li, u_cf, d6, ctrl, matvec, out)
        self.calls["power"] += 1
        vm = self.levels[li].vert_mask
        shape = tuple(vm.shape)
        n = shape[0] * shape[1] * shape[2]
        start = torch.sin(torch.arange(n, dtype=torch.float32,
                                       device=vm.device))
        v = (vm * start.reshape(shape)).expand((3,) + shape).contiguous()
        lam = None
        for _ in range(iters):
            w = lk.sym_solve_cf(d6, matvec(v)) * vm
            ww = self._dot(w, w)
            lam = torch.sqrt(ww / torch.clamp(self._dot(v, v), min=1e-30))
            v = w / torch.clamp(torch.sqrt(ww), min=1e-30)
        out[li] = lam * 1.1

    def _smooth(self, level, op, b, x, degree, want_residual=False):
        """Chebyshev on D^-1 A through the level's matvec (on a sharded
        level the halo matvec; lat_cheby elsewhere)."""
        if not self.sharded(level):
            return super()._smooth(level, op, b, x, degree, want_residual)
        self.calls["smooth"] += 1
        coeffs = lk.cheby_coeffs(op.lmax, degree)

        def solve(r):
            return lk.sym_solve_cf(op.d6, r) * op.vmask
        z = solve(b if x is None else b - op.matvec(x))
        d = z / coeffs[0]
        x = d if x is None else x + d
        for a, c in zip(coeffs[1::2], coeffs[2::2]):
            z = solve(b - op.matvec(x))
            d = a * d + c * z
            x = x + d
        return (x, b - op.matvec(x)) if want_residual else x

    # -- transfers with a one-plane halo on sharded fine levels --------------
    def _restrict(self, li, r):
        if not self.sharded(li):
            return super()._restrict(li, r)
        # slab d's left ghost is global plane d z_loc - 1 (zeros on the
        # first slab: the zero boundary); coarse plane K reads fine planes
        # 2K-1 .. 2K+1, all inside the ghost-extended slab (z_loc is even on
        # every level, so the coarse planes split evenly too)
        own = self._split(r)
        lo = shift_planes([b[..., -1] for b in own], +1)
        out = []
        for b, l in zip(own, lo):
            ext = torch.cat([torch.zeros_like(b[..., :1]) if l is None
                             else l.unsqueeze(-1), b], -1)
            y = stencil._conv_half(stencil._conv_half(ext, 1), 2)
            y = stencil._conv_half(y, 3)
            out.append(y[:, ::2, ::2, 1::2].to(self.home, non_blocking=True))
        return self._pad_coarse(li, torch.cat(out, -1))

    def _prolong(self, li, xc):
        if not self.sharded(li):
            return super()._prolong(li, xc)
        sx, sy, sz = self.levels[li].vert_mask.shape
        xc = xc[:, :(sx + 1) // 2, :(sy + 1) // 2, :sz // 2]
        z_loc = sz // self.n_sp
        zc_loc = sz // 2 // self.n_sp
        if self.sharded(li + 1):
            # the right ghost is the next slab's first coarse plane (zeros
            # after the last slab: the zero boundary)
            own = self._split(xc)
            hi = shift_planes([b[..., 0] for b in own], -1)
            locs = [torch.cat([b, torch.zeros_like(b[..., :1]) if h is None
                               else h.unsqueeze(-1)], -1)
                    for b, h in zip(own, hi)]
        else:
            xcp = torch.cat([xc, torch.zeros_like(xc[..., :1])], -1)
            locs = [xcp[..., d * zc_loc:d * zc_loc + zc_loc + 1].to(dev)
                    for d, dev in enumerate(self.devices)]
        out = []
        for loc in locs:
            # slab-local fine plane i (global d z_loc + i, even): loc[i / 2]
            # for even i, the mean of its two coarse neighbors for odd i
            C, Xc, Yc, _ = loc.shape
            z = loc.new_zeros((C, Xc, Yc, 2 * (zc_loc + 1)))
            z[..., ::2] = loc
            z = stencil._conv_half(z, 3)[..., :z_loc]
            f = z.new_zeros((C, sx, sy, z_loc))
            f[:, ::2, ::2] = z
            f = stencil._conv_half(stencil._conv_half(f, 1), 2)
            out.append(f.to(self.home, non_blocking=True))
        return torch.cat(out, -1)


def _place(st, device):
    return type(st)(*(a.to(device) for a in st))


def make_dist_mg_step(scene: LatticeScene, grid: DeviceGrid,
                      axis: str = "sp", n_levels: int = 3, tol: float = 1e-4,
                      max_newton: int = 20,
                      dyn: DynamicsConfig = DynamicsConfig(), **mg_kw):
    """The distributed dynamic step: (step, place), step(state) -> (state,
    newton_iters, f_inf) the multigrid-preconditioned implicit-Euler frame
    (step_to_tol_mg) on a DistLatticeMG, place(state) the state on the
    scene's device. The hierarchy is `step.mg`."""
    mg = DistLatticeMG(scene, grid, axis=axis, n_levels=n_levels,
                       dt=dyn.dt, **mg_kw)

    def step(st):
        return step_to_tol_mg(scene, mg, st, dyn=dyn, tol=tol,
                              max_newton=max_newton)

    def place(st: LatState) -> LatState:
        return _place(st, mg.home)
    step.mg = mg
    return step, place


def make_dist_mg_quasistatic(scene: LatticeScene, grid: DeviceGrid,
                             axis: str = "sp", n_levels: int = 3,
                             tol: float = 1e-4, max_newton: int = 50,
                             **mg_kw):
    """The distributed quasi-static solve: (solve, place), solve(x) -> (x,
    newton_iters, f_inf) by quasistatic_to_tol_mg on a DistLatticeMG built
    with dt=None, x (X, Y, Z, 3). The hierarchy is `solve.mg`."""
    mg = DistLatticeMG(scene, grid, axis=axis, n_levels=n_levels, dt=None,
                       **mg_kw)

    def solve(x):
        return quasistatic_to_tol_mg(scene, mg, x, tol=tol,
                                     max_newton=max_newton)

    def place(x):
        return x.to(mg.home)
    solve.mg = mg
    return solve, place
