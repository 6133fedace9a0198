"""Distributed structured-lattice operators: z-slabs with a plane halo.

Port of `fem_simulation_tpu/parallel/lattice_halo.py`. The vertex lattice
is split into contiguous z-slabs, one per entry of the grid's `sp` axis.
Each block holds its owned planes plus one ghost plane a side,
[ghost_lo, owned..., ghost_hi] = n_own + 2 planes. An operator is

  1. refresh the ghost planes from the neighbors' owned boundary planes
     (two `shift_planes` of one vertex plane),
  2. run the single-device kernel on the extended block, its cells masked
     to the block's own (`ops.lattice_kernels`: `force_cf` -> lat_force,
     `hvp_cf` -> lat_hvp, `hess_diag6_cf` -> lat_diag),
  3. fold the ghost planes' partial sums into the neighbors' boundary
     planes and zero the ghosts (two more `shift_planes`).

That is 4 vertex planes a block for a matvec, the least a 1-ring stencil
needs. Each cell is computed on exactly one block, so the fold is a
partition of the single-device sums: equal to them up to summation order.

Layout: a block is channel-first with z last, as the kernels take it: a
vector field (3, X, Y, n_own + 2), a scalar field (X, Y, n_own + 2), the
diagonal blocks as their upper triangle (6, X, Y, n_own + 2) (xx xy xz yy
yz zz, as `lattice_kernels.hess_diag6_cf` gives them). Global fields are
the scene's channel-last (X, Y, Z[, C]). The kernels take the displacement
u = x - x0.

The Newton and PCG loops of `make_dist_step` run on the host: a PCG
iteration reads its loop condition back once, a Newton iteration its
residual norm. The fused Newton kernel of the single-device step is one
cooperative launch over the whole lattice with no exchange inside, so the
distributed step runs the unfused PCG, as the reference does.
"""
from __future__ import annotations

import torch

from ..ops import lattice_kernels as lk
from .dist import (DeviceGrid, canonical_device, dist_newton_frame,
                   dist_pcg, shift_planes)


class LatticeSlabs:
    """Static partition of a LatticeScene's z-axis over n_dev blocks.

    Owned planes are equal-sized (the lattice is padded in z). The blocks
    live on the grid's devices along `axis` (every block on the scene's
    device when no grid is given)."""

    def __init__(self, scene, n_dev: int, grid: DeviceGrid | None = None,
                 axis: str = "sp"):
        X, Y, Z = scene.vert_mask.shape
        if grid is not None and grid.shape[axis] != n_dev:
            raise ValueError(f"{n_dev} slabs on a grid of {grid.shape}")
        self.scene = scene
        self.n_dev = n_dev
        self.n_own = -(-Z // n_dev)
        self.Z = Z
        self.Zp = self.n_own * n_dev
        home = canonical_device(scene.x0.device)
        self.devices = ([canonical_device(d) for d in grid.line(axis)] if grid
                        is not None else [home] * n_dev)
        cm = scene.cell_mask
        self.cell_mask = torch.cat(
            [cm, cm.new_zeros(cm.shape[:2] + (self.Zp - cm.shape[2],))], 2)

    def _pad_z(self, field):
        pad = list(field.shape)
        pad[2] = self.Zp - self.Z
        return torch.cat([field, field.new_zeros(pad)], 2)

    def scatter(self, field):
        """(X, Y, Z[, C]) global -> a list of n_dev blocks with their ghost
        planes, (C, X, Y, n_own + 2) or (X, Y, n_own + 2)."""
        f = self._pad_z(field)
        n = self.n_own
        out = []
        for d in range(self.n_dev):
            z0 = d * n
            zero = torch.zeros_like(f[:, :, :1])
            lo = f[:, :, z0 - 1:z0] if z0 > 0 else zero
            hi = f[:, :, z0 + n:z0 + n + 1] if z0 + n < self.Zp else zero
            b = torch.cat([lo, f[:, :, z0:z0 + n], hi], 2)
            if b.dim() == 4:
                b = b.permute(3, 0, 1, 2)
            out.append(b.contiguous().to(self.devices[d]))
        return out

    def gather(self, blocks):
        """A list of blocks -> the global (X, Y, Z[, C]) field of their owned
        planes, on the first block's device."""
        dev = blocks[0].device
        own = torch.cat([b[..., 1:-1].to(dev) for b in blocks], -1)
        own = own[..., :self.Z]
        return own.permute(1, 2, 3, 0).contiguous() if own.dim() == 4 \
            else own

    def scatter_cells(self):
        """A list of (X-1, Y-1, n_own + 1) local cell masks: the cells whose
        lower vertex plane the block owns (+1 to cover the cell touching
        the upper ghost). Local cell plane 0 (global z0 - 1) belongs to the
        block on the left and is masked out here."""
        cm = self.cell_mask
        out = []
        for d in range(self.n_dev):
            z0 = d * self.n_own
            b = torch.zeros(cm.shape[:2] + (self.n_own + 1,),
                            dtype=cm.dtype, device=cm.device)
            for c in range(1, self.n_own + 1):
                zc = z0 - 1 + c
                if zc < cm.shape[2]:
                    b[:, :, c] = cm[:, :, zc]
            out.append(b.to(self.devices[d]))
        return out


def _zero_plane(b):
    return torch.zeros_like(b[..., :1])


def extend(owned):
    """Blocks of owned planes (..., n) -> new blocks (..., n + 2) with a ghost
    plane a side holding the neighbors' owned boundary planes (zeros past
    either end of the lattice): two `shift_planes` and one copy a block."""
    lo = shift_planes([b[..., -1] for b in owned], +1)
    hi = shift_planes([b[..., 0] for b in owned], -1)
    return [torch.cat([_zero_plane(b) if l is None else l.unsqueeze(-1), b,
                       _zero_plane(b) if h is None else h.unsqueeze(-1)],
                      -1) for b, l, h in zip(owned, lo, hi)]


def refresh(blocks):
    """New blocks whose ghost planes hold the neighbors' owned boundary
    planes."""
    return extend([b[..., 1:-1] for b in blocks])


def fold(blocks):
    """Add each block's ghost-plane partial sums into its neighbors'
    boundary planes, then zero the ghosts; in place, returns the blocks."""
    from_left = shift_planes([b[..., -1] for b in blocks], +1)
    from_right = shift_planes([b[..., 0] for b in blocks], -1)
    for b, l, r in zip(blocks, from_left, from_right):
        if l is not None:
            b[..., 1] += l
        if r is not None:
            b[..., -2] += r
    for b in blocks:
        b[..., ::b.shape[-1] - 1] = 0.0
    return blocks


class SlabOps:
    """The per-block tables of the halo operators of one LatticeSlabs."""

    def __init__(self, slabs: LatticeSlabs, grid: DeviceGrid, axis: str,
                 mu: float, la: float):
        if [canonical_device(d) for d in grid.line(axis)] != slabs.devices:
            raise ValueError("the slabs live on other devices than the "
                             f"grid's {axis!r} axis")
        self.slabs = slabs
        self.cells = slabs.scatter_cells()
        # displacement form: u = x - x0 (its ghost planes are refreshed)
        self.x0 = slabs.scatter(slabs.scene.x0)
        self.dx = slabs.scene.mesh.dx
        self.mu, self.la = mu, la

    def disp(self, x_blocks):
        """u = x - x0 with its ghost planes refreshed."""
        return refresh([x - x0 for x, x0 in zip(x_blocks, self.x0)])

    def force(self, u):
        return fold([lk.force_cf(ub, cm, self.dx, self.mu, self.la)
                     for ub, cm in zip(u, self.cells)])

    def hvp(self, u, p_blocks):
        p = refresh(p_blocks)
        return fold([lk.hvp_cf(ub, pb, cm, self.dx, self.mu, self.la)
                     for ub, pb, cm in zip(u, p, self.cells)])

    def diag(self, u):
        return fold([lk.hess_diag6_cf(ub, cm, self.dx, self.mu, self.la)
                     for ub, cm in zip(u, self.cells)])


def make_dist_force(slabs: LatticeSlabs, grid: DeviceGrid, axis: str = "sp",
                    mu: float = 250.0, la: float = 0.0):
    """force(x_blocks) -> blocks (3, X, Y, n_own + 2), ghosts zero: the
    elastic force by lat_force on every block, with the halo exchange."""
    ops = SlabOps(slabs, grid, axis, mu, la)

    def force(x_blocks):
        return ops.force(ops.disp(x_blocks))
    return force


def make_dist_hvp(slabs: LatticeSlabs, grid: DeviceGrid, axis: str = "sp",
                  mu: float = 250.0, la: float = 0.0):
    """hvp(x_blocks, p_blocks) -> blocks: the elastic Hessian-vector
    product (positive-definite convention) by lat_hvp on every block."""
    ops = SlabOps(slabs, grid, axis, mu, la)

    def hvp(x_blocks, p_blocks):
        return ops.hvp(ops.disp(x_blocks), p_blocks)
    return hvp


def make_dist_diag(slabs: LatticeSlabs, grid: DeviceGrid, axis: str = "sp",
                   mu: float = 250.0, la: float = 0.0):
    """diag(x_blocks) -> blocks (6, X, Y, n_own + 2), ghosts zero: the
    upper triangles of the vertex-diagonal Hessian blocks, by lat_diag on
    every block (hess_diag6_cf). A boundary vertex's block needs the
    neighbor's boundary cells, so it is folded like the force."""
    ops = SlabOps(slabs, grid, axis, mu, la)

    def diag(x_blocks):
        return ops.diag(ops.disp(x_blocks))
    return diag


def make_dist_step(slabs: LatticeSlabs, grid: DeviceGrid, axis: str = "sp",
                   dt: float = 0.033, damping: float = 0.9995,
                   tol: float = 1e-4, max_newton: int = 20,
                   cg_iterations: int = 60, cg_tol: float = 1e-2):
    """The distributed dynamic step on z-slab blocks: (step, blockify).

    step(x_blocks, v_blocks) -> (x_blocks, v_blocks, newton_iters, f_inf):
    predictor, then inexact Newton with block-Jacobi PCG. The matvec is the
    halo HVP plus the control and mass diagonal, the preconditioner the
    halo diagonal plus the same; every dot product is a `psum` of the
    blocks' partials and the residual norm a `pmax`. blockify(field) is the
    scatter with the ghost planes zeroed."""
    scene = slabs.scene
    mat = scene.material
    inv_dt = 1.0 / dt
    ops = SlabOps(slabs, grid, axis, mat.lame_mu, mat.lame_la)

    def blockify(field):
        blocks = slabs.scatter(field)
        for b in blocks:
            b[..., ::b.shape[-1] - 1] = 0.0
        return blocks

    vmask = blockify(scene.vert_mask)
    pin = blockify(scene.pin_mask)
    mass = blockify(scene.mass)
    pin_pos = blockify(scene.pin_pos)
    ctrl = [mat.control_mag * p + m * inv_dt * inv_dt + (1.0 - vm)
            for p, m, vm in zip(pin, mass, vmask)]
    inertia = [m * inv_dt * inv_dt for m in mass]

    def resid(xb, x_tilde):
        f = ops.force(ops.disp(xb))
        for fb, x, xt, m, ic, pn, pp, vm in zip(f, xb, x_tilde, mass,
                                                inertia, pin, pin_pos, vmask):
            fb[1] += m * mat.gravity
            fb += mat.control_mag * pn * (pp - x)
            fb -= ic * (x - xt)
            fb *= vm
        return f

    def solve(xb, f):
        u = ops.disp(xb)
        d6 = ops.diag(u)
        for d, c in zip(d6, ctrl):
            d[0::3] += c              # xx and yy
            d[5] += c                 # zz

        def matvec(p):
            hp = ops.hvp(u, p)
            return [(h + c * pb) * vm
                    for h, c, pb, vm in zip(hp, ctrl, p, vmask)]

        def minv(r):
            return [lk.sym_solve_cf(d, rb) * vm
                    for d, rb, vm in zip(d6, r, vmask)]
        return dist_pcg(matvec, minv, f, cg_iterations, cg_tol)

    def step(xb, vb):
        return dist_newton_frame(xb, vb, resid, solve, vmask, dt, damping,
                                 tol, max_newton)

    return step, blockify
