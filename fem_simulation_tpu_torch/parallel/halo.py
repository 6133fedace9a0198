"""Domain-decomposed SpMV, CG and Newton on the unstructured block-ELL path.

Port of `fem_simulation_tpu/parallel/halo.py`. Vertices are split into
contiguous slabs along the longest lattice axis, one slab per entry of the
grid's `sp` axis. Each block owns its slab's rows and keeps a one-layer
halo of neighbor vertices; a matvec is

    halo exchange (two `shift_planes` of the boundary rows)  ->
    local block-ELL SpMV on the owned rows (`ops.ell.spmv_rows` -> ell_spmv)

and CG dot products are `psum`s of the blocks' partials. Blocks are lists
of per-slab tensors, (n_own, ...) on the slab's device; the partition's
tables are built on the host in numpy (`partition_slabs`, copied from the
reference).

Local row layout: [own (n_own) ++ halo (n_halo) ++ scratch]. Padded receive
slots land on the scratch row, which no table references.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..ops import elastic, ell
from .dist import (DeviceGrid, canonical_device, dist_newton_frame,
                   dist_pcg, shift_planes)


@dataclasses.dataclass
class SlabPartition:
    """Host-built partition tables (all (D, ...) arrays, device-major)."""
    n_dev: int
    n_own: int                 # padded owned count per device
    n_halo: int                # padded halo count per device (left+right)
    own_global: np.ndarray     # (D, n_own) global vertex id (pad: repeat last)
    own_mask: np.ndarray       # (D, n_own) 1.0 for real owned rows
    local_nbr: np.ndarray      # (D, n_own, K) local ids into [own ++ halo]
    local_mask: np.ndarray     # (D, n_own, K)
    send_left: np.ndarray      # (D, n_send) local own-ids this device sends left
    send_right: np.ndarray     # (D, n_send)
    recv_left_at: np.ndarray   # (D, n_send) halo slots receiving from the right
    recv_right_at: np.ndarray  # (D, n_send) halo slots receiving from the left
    n_send: int
    halo_global: np.ndarray = None  # (D, n_halo) global vertex id, -1 = pad


def partition_slabs(lvl, n_dev: int) -> SlabPartition:
    """Slab partition along the longest lattice axis of a LevelTopology."""
    ijk = lvl.ijk
    axis = int(np.argmax(ijk.max(0) - ijk.min(0)))
    coord = ijk[:, axis]
    # equal-count slabs by sorted coordinate
    order = np.argsort(coord, kind="stable")
    slabs = np.array_split(order, n_dev)
    owner = np.empty(lvl.n_verts, dtype=np.int64)
    for d, s in enumerate(slabs):
        owner[s] = d

    nbr, mask = lvl.nbr.astype(np.int64), lvl.nbr_mask
    K = lvl.K
    own_lists = [np.sort(s) for s in slabs]
    n_own = max(len(s) for s in own_lists)

    halo_lists = []
    for d in range(n_dev):
        own = own_lists[d]
        cols = nbr[own][mask[own]]
        halo_lists.append(np.unique(cols[owner[cols] != d]))

    def need_from(e, d):
        """The halo of block e that block d owns (empty past the ends)."""
        if 0 <= e < n_dev:
            return halo_lists[e][owner[halo_lists[e]] == d]
        return np.array([], np.int64)
    send_L = [need_from(d - 1, d) for d in range(n_dev)]
    send_R = [need_from(d + 1, d) for d in range(n_dev)]

    n_halo = max((len(h) for h in halo_lists), default=1) or 1
    n_send = max([len(s) for s in send_L + send_R] + [1])

    own_global = np.zeros((n_dev, n_own), np.int32)
    own_mask = np.zeros((n_dev, n_own), np.float32)
    local_nbr = np.zeros((n_dev, n_own, K), np.int32)
    local_mask = np.zeros((n_dev, n_own, K), np.float32)
    send_left = np.zeros((n_dev, n_send), np.int32)
    send_right = np.zeros((n_dev, n_send), np.int32)
    recv_left_at = np.zeros((n_dev, n_send), np.int32)
    recv_right_at = np.zeros((n_dev, n_send), np.int32)

    for d in range(n_dev):
        own = own_lists[d]
        halo = halo_lists[d]
        k_own = len(own)
        own_global[d, :k_own] = own
        if k_own < n_own:
            own_global[d, k_own:] = own[-1] if k_own else 0
        own_mask[d, :k_own] = 1.0
        # global -> local map: own -> [0, k_own), halo -> [n_own, n_own+|halo|)
        g2l = {int(g): i for i, g in enumerate(own)}
        for i, g in enumerate(halo):
            g2l[int(g)] = n_own + i
        ln = np.zeros((n_own, K), np.int32)
        lm = np.zeros((n_own, K), np.float32)
        for i, g in enumerate(own):
            for k in range(K):
                if mask[g, k]:
                    ln[i, k] = g2l[int(nbr[g, k])]
                    lm[i, k] = 1.0
                else:
                    ln[i, k] = i
        local_nbr[d] = ln
        local_mask[d] = lm
        # send lists in LOCAL own coordinates
        sl = np.array([g2l[int(g)] for g in send_L[d]], np.int32)
        sr = np.array([g2l[int(g)] for g in send_R[d]], np.int32)
        send_left[d, :len(sl)] = sl
        send_right[d, :len(sr)] = sr
        # where received buffers land: d's halo slots for verts owned by d-1
        # (arriving from the LEFT) and by d+1 (arriving from the RIGHT)
        from_left = [n_own + i for i, g in enumerate(halo) if owner[g] == d - 1]
        from_right = [n_own + i for i, g in enumerate(halo) if owner[g] == d + 1]
        recv_left_at[d, :len(from_left)] = np.asarray(from_left, np.int32)
        recv_right_at[d, :len(from_right)] = np.asarray(from_right, np.int32)
        # slab partitions couple only adjacent slabs
        if len(from_left) + len(from_right) != len(halo):
            raise ValueError("partition has non-adjacent coupling; use more "
                             "vertices per slab")
    halo_global = np.full((n_dev, n_halo), -1, np.int64)
    for d in range(n_dev):
        halo_global[d, :len(halo_lists[d])] = halo_lists[d]
    return SlabPartition(
        n_dev=n_dev, n_own=n_own, n_halo=n_halo,
        own_global=own_global, own_mask=own_mask,
        local_nbr=local_nbr, local_mask=local_mask,
        send_left=send_left, send_right=send_right,
        recv_left_at=recv_left_at, recv_right_at=recv_right_at,
        n_send=n_send, halo_global=halo_global)


def _slab_devices(part: SlabPartition, grid: DeviceGrid, axis: str):
    devs = [canonical_device(d) for d in grid.line(axis)]
    if len(devs) != part.n_dev:
        raise ValueError(f"{part.n_dev} slabs on a grid of {grid.shape}")
    return devs


class _Exchange:
    """The halo exchange of one partition: owned rows (n_own, C) of every
    block -> local rows (R, C) with the halos landed, R = n_own + n_halo +
    1 (the last row is the scratch row)."""

    def __init__(self, part: SlabPartition, devs):
        self.n_own = part.n_own
        self.R = part.n_own + part.n_halo + 1

        def t(a, d):
            return torch.from_numpy(np.ascontiguousarray(a)).long().to(d)
        scratch = self.R - 1
        self.send_l = [t(part.send_left[d], v) for d, v in enumerate(devs)]
        self.send_r = [t(part.send_right[d], v) for d, v in enumerate(devs)]
        self.recv_l = [t(np.where(part.recv_left_at[d] > 0,
                                  part.recv_left_at[d], scratch), v)
                       for d, v in enumerate(devs)]
        self.recv_r = [t(np.where(part.recv_right_at[d] > 0,
                                  part.recv_right_at[d], scratch), v)
                       for d, v in enumerate(devs)]

    def __call__(self, y_blocks):
        got_l = shift_planes([y[s] for y, s in zip(y_blocks, self.send_r)],
                             +1)
        got_r = shift_planes([y[s] for y, s in zip(y_blocks, self.send_l)],
                             -1)
        out = []
        for y, gl, gr, rl, rr in zip(y_blocks, got_l, got_r, self.recv_l,
                                     self.recv_r):
            yl = y.new_zeros((self.R,) + tuple(y.shape[1:]))
            yl[:self.n_own] = y
            if gl is not None:
                yl[rl] = gl
            if gr is not None:
                yl[rr] = gr
            out.append(yl)
        return out


def make_dist_matvec(part: SlabPartition, grid: DeviceGrid,
                     axis: str = "sp"):
    """(matvec, scatter, gather) on lists of (n_own, 3) owned blocks.

    matvec(values_local, x_own): values_local a list of (n_own, K, 3, 3)
    owned value rows (or the (R, K, 3, 3) rows `prepare` pads them to,
    which a caller reusing the values passes to save the padding); each
    block's product is one `ell.spmv_rows` over its owned rows."""
    devs = _slab_devices(part, grid, axis)
    ex = _Exchange(part, devs)
    R, n_own = ex.R, part.n_own

    def t(a, d, dtype=None):
        out = torch.from_numpy(np.ascontiguousarray(a)).to(d)
        return out if dtype is None else out.to(dtype)
    nbr, mask = [], []
    for d, v in enumerate(devs):
        nb = np.zeros((R, part.local_nbr.shape[2]), np.int32)
        nb[:n_own] = part.local_nbr[d]
        mk = np.zeros(nb.shape, np.float32)
        mk[:n_own] = part.local_mask[d]
        nbr.append(t(nb, v))
        mask.append(t(mk, v))
    own_mask = [t(part.own_mask[d], v) for d, v in enumerate(devs)]

    def prepare(values_local):
        """The owned value rows masked and padded to R rows."""
        out = []
        for vals, mk in zip(values_local, mask):
            vp = vals.new_zeros((R,) + tuple(vals.shape[1:]))
            vp[:n_own] = vals * mk[:n_own, :, None, None]
            out.append(vp)
        return out

    def matvec(values_local, x_own):
        if values_local[0].shape[0] != R:
            values_local = prepare(values_local)
        xl = ex(x_own)
        return [ell.spmv_rows(v, nb, mk, x, 0, n_own) * om[:, None]
                for v, nb, mk, x, om in zip(values_local, nbr, mask, xl,
                                            own_mask)]

    def scatter(x_global):
        """(N, 3) -> the list of (n_own, 3) owned blocks."""
        return slab_scatter(part, x_global, devs)

    def gather(x_shards):
        """The owned blocks -> (N, 3) on the first block's device."""
        dev = x_shards[0].device
        n = int(part.own_mask.sum())
        idx = torch.from_numpy(part.own_global.reshape(-1)).long().to(dev)
        m = torch.from_numpy(part.own_mask.reshape(-1) > 0).to(dev)
        flat = torch.cat([x.to(dev) for x in x_shards])
        out = flat.new_zeros((n,) + tuple(flat.shape[1:]))
        out[idx[m]] = flat[m]
        return out

    matvec.prepare = prepare
    return matvec, scatter, gather


def dist_cg(matvec, b_shards, grid: DeviceGrid | None = None,
            axis: str = "sp", iterations: int = 50, tol: float = 1e-5):
    """CG over distributed blocks (dist_pcg with no preconditioner), the dot
    products psums of the blocks' partials. tol is relative: stop when
    ||r|| <= tol ||b||."""
    return dist_pcg(matvec, lambda r: r, list(b_shards), iterations,
                    tol * tol)


# -- the distributed Newton step ----------------------------------------------

def partition_elements(lvl, part: SlabPartition):
    """Overlap-element tables for per-device FEM assembly.

    Each device gets every hex touching >= 1 of its owned vertices, with
    corner ids rewritten to local row coordinates [own ++ halo ++ scratch].
    Boundary hexes are duplicated on both neighboring devices: every hex
    that contributes to an owned row is local, so force, Hessian diagonal
    and HVP values on owned rows are complete after the x / p halo refresh
    alone, with no fold.

    Returns (hex_local (D, Hl, 8) int32, hex_mask (D, Hl) f32,
    hex_global (D, Hl) int64); padded hexes (at the end of each row) point
    at the scratch row."""
    if part.halo_global is None:
        raise ValueError("need partition_slabs' halo tables")
    D, n_own = part.n_dev, part.n_own
    hexes = np.asarray(lvl.hexes, np.int64)
    owner = np.full(lvl.n_verts, -1, np.int64)
    for d in range(D):
        real = part.own_mask[d] > 0
        owner[part.own_global[d][real]] = d

    hex_dev = [np.nonzero((owner[hexes] == d).any(axis=1))[0]
               for d in range(D)]
    n_loc = max(len(h) for h in hex_dev)
    scratch = n_own + part.n_halo
    hex_local = np.full((D, n_loc, 8), scratch, np.int32)
    hex_mask = np.zeros((D, n_loc), np.float32)
    hex_global = np.zeros((D, n_loc), np.int64)
    for d in range(D):
        g2l = {int(g): i for i, g in enumerate(part.own_global[d])
               if part.own_mask[d, i] > 0}
        for i, g in enumerate(part.halo_global[d]):
            if g >= 0:
                g2l[int(g)] = n_own + i
        hs = hex_dev[d]
        hex_global[d, :len(hs)] = hs
        hex_mask[d, :len(hs)] = 1.0
        for j, h in enumerate(hs):
            hex_local[d, j] = [g2l[int(v)] for v in hexes[h]]
    return hex_local, hex_mask, hex_global


def slab_scatter(part: SlabPartition, x_global, devices=None):
    """(N, ...) -> the list of (n_own, ...) owned blocks (pad rows repeat
    data; every product masks them out), block d on devices[d] (default:
    x_global's device, numpy input: the CPU)."""
    x = torch.as_tensor(np.asarray(x_global)) if not torch.is_tensor(
        x_global) else x_global
    devices = devices or [x.device] * part.n_dev
    idx = torch.from_numpy(part.own_global).long().to(x.device)
    return [x[idx[d]].to(devices[d]) for d in range(part.n_dev)]


def slab_gather(part: SlabPartition, x_shards, n_verts: int) -> np.ndarray:
    """The owned blocks -> (N, ...) as a numpy array."""
    blocks = [np.asarray(x.detach().cpu()) if torch.is_tensor(x)
              else np.asarray(x) for x in x_shards]
    flat = np.concatenate(blocks).reshape(part.n_dev * part.n_own, -1)
    idx = part.own_global.reshape(-1)
    m = part.own_mask.reshape(-1) > 0
    out = np.zeros((n_verts, flat.shape[1]), flat.dtype)
    out[idx[m]] = flat[m]
    return out.reshape((n_verts,) + blocks[0].shape[1:])


def make_dist_newton_step(scene, part: SlabPartition, grid: DeviceGrid,
                          axis: str = "sp", dt: float = 0.033,
                          damping: float = 0.9995, tol: float = 1e-4,
                          max_newton: int = 20, cg_iterations: int = 60,
                          cg_tol: float = 1e-2):
    """The distributed implicit-Euler Newton step on the unstructured path
    (the general-mesh twin of lattice_halo.make_dist_step).

    step(x_shards, v_shards) -> (x', v', newton_iters, f_inf): predictor,
    then inexact Newton with block-Jacobi PCG. The halo refresh is two
    `shift_planes` a force or HVP evaluation, dot products are `psum`s and
    the residual norm a `pmax`. Matrix-free: the local HVP and diagonal are
    `ops.elastic.hvp_gather` / `hessian_diag_gather` on the block's overlap
    elements, the operators of the single-device
    `dynamic.step_to_tol(matrix_free=True)`."""
    lvl = scene.hier.levels[0]
    p0 = scene.params["levels"][0]
    mat = scene.material
    inv_dt = 1.0 / dt
    n_own = part.n_own
    devs = _slab_devices(part, grid, axis)
    ex = _Exchange(part, devs)
    R = ex.R

    hex_local, hex_mask, hex_global = partition_elements(lvl, part)
    det_all = p0["det"].cpu().numpy()
    g_all = p0["g"].cpu().numpy()

    def t(a, d):
        return torch.from_numpy(np.ascontiguousarray(a)).to(d)
    own_mask = [t(part.own_mask[d], v) for d, v in enumerate(devs)]
    tabs = []
    for d, v in enumerate(devs):
        n_real = int(hex_mask[d].sum())      # padded hexes are at the end
        hx = hex_local[d, :n_real]
        cidx, cmask = elastic.vertex_contrib_map(hx, R)
        tabs.append(dict(hexes=t(hx, v),
                         det=t(det_all[hex_global[d, :n_real]], v),
                         g=t(g_all[hex_global[d, :n_real]], v),
                         cidx=t(cidx, v), cmask=t(cmask, v)))
    mass = [m * om for m, om in zip(slab_scatter(part, p0["mass"], devs),
                                    own_mask)]
    pin = [p * om for p, om in zip(slab_scatter(part, p0["pin_mask"], devs),
                                   own_mask)]
    pin_pos = slab_scatter(part, p0["pin_pos"], devs)
    ctrl = [mat.control_mag * pn + m * inv_dt * inv_dt + (1.0 - om)
            for pn, m, om in zip(pin, mass, own_mask)]
    eye = [torch.eye(3, dtype=torch.float32, device=v) for v in devs]
    mu, la = mat.lame_mu, mat.lame_la

    def el_force(yl):
        return [elastic.force_gather(y, tb["hexes"], tb["det"], tb["g"], mu,
                                     la, tb["cidx"], tb["cmask"], R)[:n_own]
                for y, tb in zip(yl, tabs)]

    def resid(y, y_tilde):
        f = el_force(ex(y))
        out = []
        for fb, yb, yt, m, pn, pp, om in zip(f, y, y_tilde, mass, pin,
                                             pin_pos, own_mask):
            fb[:, 1] += m * mat.gravity
            fb = fb + mat.control_mag * pn[:, None] * (pp - yb)
            fb = fb - (m * inv_dt * inv_dt)[:, None] * (yb - yt)
            out.append(fb * om[:, None])
        return out

    def solve(xx, f):
        xl = ex(xx)
        diag = [elastic.hessian_diag_gather(
            y, tb["hexes"], tb["det"], tb["g"], mu, la, tb["cidx"],
            tb["cmask"], R)[:n_own] + c[:, None, None] * e
            for y, tb, c, e in zip(xl, tabs, ctrl, eye)]

        def matvec(p):
            hp = [elastic.hvp_gather(y, pl, tb["hexes"], tb["det"], tb["g"],
                                     mu, la, tb["cidx"], tb["cmask"],
                                     R)[:n_own]
                  for y, pl, tb in zip(xl, ex(p), tabs)]
            return [(h + c[:, None] * pb) * om[:, None]
                    for h, c, pb, om in zip(hp, ctrl, p, own_mask)]

        def minv(r):
            return [ell.solve3x3(d, rb) * om[:, None]
                    for d, rb, om in zip(diag, r, own_mask)]
        return dist_pcg(matvec, minv, f, cg_iterations, cg_tol)

    mask = [om[:, None] for om in own_mask]

    def step(x_shards, v_shards):
        return dist_newton_frame(x_shards, v_shards, resid, solve, mask, dt,
                                 damping, tol, max_newton)

    return step
