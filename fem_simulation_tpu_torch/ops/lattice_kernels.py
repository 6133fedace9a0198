"""Lattice kernels: public wrappers, their plain torch versions, launch counts.

Port of the entry points of `fem_simulation_tpu/ops/pallas_lattice.py`
(`force_cf`, `hvp_cf`, `hess_diag_lattice`, `elastic_energy_lattice`,
`fused_newton`, `fused_pcg`) with the same signatures and layouts. The
Pallas kernels become the CUDA kernels of `csrc/lattice_kernels.cu`;
`hess_diag6_cf` is the diagonal's launch as its 6 channels, as the slab
paths take it. The lattice multigrid's level operators have kernels of
their own around the HVP and diagonal chains: `cheby_smooth_cf` (every
sweep of one Chebyshev smoothing call), `hess_diag_shift_cf` (the shifted,
SPD-projected diagonal blocks as 6 channels, lat_diag's launch with its
epilogue), `level_matvec_cf` (the level operator (H(u) p + ctrl p) vm,
`hvp_cf`'s launch with its epilogue) and `power_lmax_cf` (a level's power
iteration for the Chebyshev bound).

`force_cf`, `elastic_energy_lattice` and `fused_newton` take an optional
`cover` (`ops/boxes.Cover`, the low-fill path): the kernel then walks the
cover's active tiles or real cells only, under a plan made over the cover,
with its own workspaces, counted under its own name (`force_cover`,
`energy_cover`, `fused_newton_cover`); the plain version computes the
listed cells only (ops/stencil.py's `cells`).

Dispatch: a wrapper runs its plain version (`*_plain`) only when its tensors
lie on the CPU. For CUDA tensors it launches the kernel or raises; it never
falls back. Every wrapper adds one to `launches[name]` where it launches its
kernel, and nowhere else. `fused_newton` also sums each call's PCG count on
the call's device, without a sync (`pcg`, read by `pcg_matvecs`), and a
covered call adds the vertices its PCG updates walk, and the lattice's, to
`cover_vertices`. No kernel here has a backward: a wrapper raises
when autograd records and one of its inputs requires grad, on either
device, rather than return an output with no grad_fn.
"""
from __future__ import annotations

import ctypes
import functools
import itertools
from typing import NamedTuple

import numpy as np
import torch

from . import _cuda, ell, stencil
from ..solvers import cg as cgmod

# Useful f32 FLOPs per active cell per call, counted from the unrolled chains
# (per quad point: force 449, hvp 763, diag 930; x 8 quad points).
FORCE_FLOPS_PER_CELL = 449 * 8
HVP_FLOPS_PER_CELL = 763 * 8
DIAG_FLOPS_PER_CELL = 930 * 8
# f32 FLOPs per vertex: a smoother sweep (A x 9, residual 3, the adjugate
# solve sym_solve 47, the update of d and x 12); the shift (5) and
# spd_project (18 rotations of 41, the floor 10, the rebuild 6 x 8).
CHEBY_VERTEX_FLOPS = 9 + 3 + 47 + 12
# a power iteration at a vertex: A v 9, v = w / norm 3, sym_solve 47, the
# w.w and v.v partials 12
POWER_VERTEX_FLOPS = 9 + 3 + 47 + 12
SPD_PROJECT_FLOPS = 5 + 18 * 41 + 10 + 6 * 8
# sweeps one lat_cheby launch takes (the coefficients in its argument struct)
CHEBY_MAX_SWEEPS = 32

launches = {"force": 0, "hvp": 0, "diag": 0, "energy": 0, "fused_newton": 0,
            "fused_pcg": 0, "cheby": 0, "diag_shift": 0, "power": 0,
            "force_cover": 0, "energy_cover": 0, "fused_newton_cover": 0}
# The vertices the covered fused_newton launches' PCG updates walk (those
# of the vertex mask passed, ops/boxes.Cover.walked) and the lattices'
# vertices, summed over the launches: a dense launch walks every vertex and
# adds nothing.
cover_vertices = {"walked": 0, "lattice": 0}

# Launch shapes of csrc/lattice_kernels.cu (kForceThreads, kForceRows,
# kForceSmem, kEnergyThreads).
FORCE_THREADS = 256
FORCE_ROWS = 24
FORCE_SMEM_FLOATS = 48 * 1024 // 4
ENERGY_THREADS = 256
# lat_force's and lat_hvp's plans: `FORCE_TWO_PASS` selects the two
# launches (a thread a cell into a scratch, then a vertex gather) instead of
# one launch on halo tiles (FORCE_RESIDENT tiles an SM, __launch_bounds__).
FORCE_TWO_PASS = (0, 0, 0, 0, 0, 0)
FORCE_RESIDENT = 2


class TileModel(NamedTuple):
    """A halo-tile kernel's shared floats per vertex of a tile's box, and
    its cost model in device microseconds (force_cost); its shared scratch
    rows (corners x channels), shared memory and, where the kernel's rows
    have a fixed length, that length (the most cells a tile may have)."""
    box_floats: int
    tile_us: float       # one launch: one wave of one round, no cells
    wave_us: float       # each further wave of tiles on an SM
    round_us: float      # each further round of a tile's threads
    cell_us: float       # a cell on the busiest SM
    pass_us: float       # two launches: fixed
    pass_cell_us: float  # two launches: a cell of the lattice
    rows: int = FORCE_ROWS
    smem_floats: int = FORCE_SMEM_FLOATS
    fixed_stride: int = 0  # nonzero: the kernel's rows are this long


# lat_force: fitted to the times scripts/force_tilings.py measured on an
# H100 (15 tilings, within 0.8 us)
FORCE_MODEL = TileModel(4, 4.3, 5.4, 1.2, 0.0074, 5.5, 7.6e-5)
# lat_hvp (u and p staged): fitted to the times scripts/level_tilings.py
# measured on an H100 at the multigrid's level shapes (one-wave tilings
# within 0.7 us but one; the two passes within 0.7 us); it picks the two
# passes at the 19k and 74k fine levels, as measured
HVP_MODEL = TileModel(8, 6.26, 4.3, 2.26, 0.0144, 7.8, 1.0e-4)
# lat_diag and lat_diag_shift (u staged, 48 rows of corner sums and, for
# lat_diag_shift, 48 more of partial sums, up to kDiagSmem of shared
# memory): least squares over the times scripts/diag_tilings.py measured on
# an H100 at every shape the main paths give them (17 shapes, 9 tilings and
# the two passes each, a thread a cell; lat_diag within 1.7 us rms,
# lat_diag_shift 3.1, whose projection the model does not separate); they
# pick the two passes at the 74k beam and a tiling measured within 3% of
# the fastest at every other shape, lat_diag_shift with its small tiles on
# eight lanes a cell too
DIAG_ROWS = 48
DIAG_SMEM_FLOATS = 110 * 1024 // 4
DIAG_MODEL = TileModel(4, 6.37, 4.53, 2.23, 0.0154, 10.2, 1.30e-4,
                       DIAG_ROWS, DIAG_SMEM_FLOATS)
DIAG_SHIFT_MODEL = TileModel(4, 14.03, 8.89, 8.37, 0.0161, 17.9, 1.585e-4,
                             2 * DIAG_ROWS, DIAG_SMEM_FLOATS, FORCE_THREADS)
# lat_diag_shift's tiles of at most this many cells run eight lanes a cell
# (scripts/diag_tilings.py on an H100: eight lanes are faster on tiles of up
# to 99 cells, even at 120, slower from 225)
DIAG_LANE_CELLS = 128
# lat_energy takes eight lanes a cell while the lanes of every cell fit in
# a block an SM, a thread a cell beyond, with at most 2 blocks an SM
# (scripts/force_tilings.py on an H100: lanes win at 2k, a thread a cell at
# 19k and 74k).
ENERGY_BLOCKS_PER_SM = 2
# lat_newton_plan's tiles and cost model (csrc/lattice_kernels.cu:
# kTileWidth, kScratchRows, kSmemCap, kFusedThreads / 8), mirrored by
# newton_tiling for plans over a cover
NEWTON_TILE_WIDTH = 5
NEWTON_SCRATCH_ROWS = 48
NEWTON_SMEM_FLOATS = 200 * 1024 // 4
NEWTON_CELLS_PER_ROUND = 512 // 8

_newton_plans: dict = {}
_level_plans: dict = {}
_force_plans: dict = {}
_hvp_plans: dict = {}
_diag_plans: dict = {}
_workspaces: dict = {}
_tables_cache: dict = {}
_starts: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0
    cover_vertices.update(walked=0, lattice=0)
    level_launches.clear()
    pcg.clear()


def _vertex_grid(x: torch.Tensor, cell_mask: torch.Tensor,
                 channel_last: bool = False):
    """(X, Y, Z) after checking the field, (3, X, Y, Z) or with channel_last
    (X, Y, Z, 3), and the cell mask."""
    if x.dim() != 4 or x.shape[3 if channel_last else 0] != 3:
        want = "(X, Y, Z, 3)" if channel_last else "(3, X, Y, Z)"
        raise ValueError(f"expected a {want} field, got {tuple(x.shape)}")
    X, Y, Z = (int(s) for s in (x.shape[:3] if channel_last else x.shape[1:]))
    if min(X, Y, Z) < 2:
        raise ValueError(f"lattice {X, Y, Z} has no cells")
    _cuda.require(x, (X, Y, Z, 3) if channel_last else (3, X, Y, Z), "field")
    _cuda.require(cell_mask, (X - 1, Y - 1, Z - 1), "cell_mask")
    return X, Y, Z


def _tables(dx: float, device):
    """(g, det): the (8, 8, 3) float32 shape-gradient table and (dx/2)^3,
    built once per dx and device (cached, so never modify g)."""
    key = (dx, str(device))
    if key not in _tables_cache:
        _tables_cache[key] = stencil.lattice_material_tables(dx, device)
    return _tables_cache[key]


def _stream(device) -> int:
    """The handle of the current stream on a CUDA device, asked anew on
    every call (torch's raw getter: no Stream object is built)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _chain_tail(X, Y, Z, dx, mu, la, device):
    """The trailing C arguments shared by every kernel: X, Y, Z, the host
    g table (cached, so it outlives the call), det, mu, la, stream."""
    g, det = _tables(dx, "cpu")
    return (X, Y, Z, g.data_ptr(), float(det), float(mu), float(la),
            _stream(device))


# -- launch plans of the standalone force and energy kernels ----------------


def tile_axis(n: int, nt: int, it: int):
    """(v0, nv, c0, nc): halo tile `it` of `nt` along an axis of n vertices
    owns vertices [v0, v0 + nv) and computes cells [c0, c0 + nc), every
    cell incident to its vertices. Mirror of tile_axis(..., halo = 1) in
    csrc/lattice_kernels.cu."""
    v0 = it * n // nt
    v1 = (it + 1) * n // nt
    c0 = v0 - 1 if v0 > 0 else v0
    c1 = min(v1 - 1, n - 2)
    return v0, v1 - v0, c0, c1 - c0 + 1


def _tile_counts(n: int):
    """Tile counts along an axis of n vertices worth trying: every count
    up to 32, and above that one per distinct tile width."""
    return sorted(set(range(1, min(n, 32) + 1))
                  | {-(-n // w) for w in range(1, n + 1)})


@functools.lru_cache(maxsize=None)
def _cell_extent(n: int, nt: int) -> int:
    """The most cells a halo tile of `nt` along n vertices computes."""
    return max(tile_axis(n, nt, it)[3] for it in range(nt))


def force_tiling(shape, tiles, box_floats: int = 4, rows: int = FORCE_ROWS,
                 smem_floats: int = FORCE_SMEM_FLOATS, fixed_stride: int = 0):
    """(ntiles, ntx, nty, ntz, stride, box) of a one-launch plan on halo
    tiles (lat_force; lat_hvp with box_floats 8; lat_diag with its 48 rows
    and its shared memory, lat_diag_shift with 96 rows of fixed_stride):
    `stride` holds the cells of the largest tile (with fixed_stride: is
    their count, at most fixed_stride), `box` the vertex box around them.
    None when that tile does not fit the kernel's shared memory."""
    ext = [_cell_extent(n, nt) for n, nt in zip(shape, tiles)]
    cells = ext[0] * ext[1] * ext[2]
    if fixed_stride and cells > fixed_stride:
        return None
    stride = cells if fixed_stride else cells | 1
    box = (ext[0] + 1) * (ext[1] + 1) * (ext[2] + 1)
    if rows * (fixed_stride or stride) + box_floats * box > smem_floats:
        return None
    ntx, nty, ntz = tiles
    return (ntx * nty * ntz, ntx, nty, ntz, stride, box)


def force_cost(plan, shape, sms: int, model: TileModel = FORCE_MODEL,
               n_tiles=None, n_cells=None):
    """Modelled device microseconds of a halo-tile kernel (lat_force; lat_hvp
    under HVP_MODEL) under a plan. One launch: the busiest SM runs
    ceil(tiles / sms) tiles, FORCE_RESIDENT at a time (waves), each of
    ceil(cells / FORCE_THREADS) rounds, and computes their cells (halo cells
    count). Two launches: a fixed part and every cell once. Under a cover,
    n_tiles active tiles and n_cells real cells in place of all."""
    if plan == FORCE_TWO_PASS:
        cells = ((shape[0] - 1) * (shape[1] - 1) * (shape[2] - 1)
                 if n_cells is None else n_cells)
        return model.pass_us + model.pass_cell_us * cells
    per_sm = -(-(plan[0] if n_tiles is None else n_tiles) // sms)
    waves = -(-per_sm // FORCE_RESIDENT)
    rounds = -(-plan[4] // FORCE_THREADS)
    return (model.tile_us + model.wave_us * (waves - 1)
            + model.round_us * (rounds - 1)
            + model.cell_us * per_sm * plan[4])


def best_force_tiling(X: int, Y: int, Z: int, sms: int,
                      model: TileModel = FORCE_MODEL, cover=None,
                      bound: float = float("inf")):
    """The halo tiling of least force_cost that fits (ties: fewer tiles).
    With a cover (ops/boxes.Cover), a tiling is costed over its active
    tiles, and only tilings that may cost less than `bound` are counted (a
    tiling costs at least one tile an SM); None when none may."""
    shape = (X, Y, Z)
    best = None
    for ntx, nty in itertools.product(_tile_counts(X), _tile_counts(Y)):
        fits = []
        for ntz in _tile_counts(Z):
            plan = force_tiling(shape, (ntx, nty, ntz), model.box_floats,
                                model.rows, model.smem_floats,
                                model.fixed_stride)
            if plan is not None and force_cost(plan, shape, sms, model,
                                               n_tiles=1) < bound:
                fits.append(plan)
        if not fits:
            continue
        counts = ([p[0] for p in fits] if cover is None else
                  cover.active_counts(ntx, nty, [p[3] for p in fits]))
        for plan, n in zip(fits, counts):
            key = (force_cost(plan, shape, sms, model, n_tiles=int(n)),
                   int(n))
            if best is None or key < best[0]:
                best = (key, plan)
    return None if best is None else best[1]


def force_plan(X: int, Y: int, Z: int, sms: int,
               model: TileModel = FORCE_MODEL, cover=None):
    """What a halo-tile kernel (lat_force; lat_hvp under HVP_MODEL) runs on
    an X x Y x Z vertex lattice on a card of `sms` SMs: the best halo
    tiling, one launch, or FORCE_TWO_PASS where the model says the cells
    computed twice by halo tiles cost more than a second launch (the 74k
    beam for lat_force). With a cover (ops/boxes.Cover), both are costed
    over its active tiles and real cells."""
    shape = (X, Y, Z)
    if cover is None:
        two = force_cost(FORCE_TWO_PASS, shape, sms, model)
        tiling = best_force_tiling(X, Y, Z, sms, model)
        n_tiles = tiling[0]
    else:
        two = force_cost(FORCE_TWO_PASS, shape, sms, model,
                         n_cells=cover.cells.size)
        tiling = best_force_tiling(X, Y, Z, sms, model, cover, bound=two)
        if tiling is None:
            return FORCE_TWO_PASS
        n_tiles = cover.tiles(*tiling[1:4])[1]
    if two < force_cost(tiling, shape, sms, model, n_tiles=n_tiles):
        return FORCE_TWO_PASS
    return tiling


def hvp_plan(X: int, Y: int, Z: int, sms: int):
    """lat_hvp's plan: force_plan under HVP_MODEL (the two passes at the 19k
    and 74k fine levels)."""
    return force_plan(X, Y, Z, sms, HVP_MODEL)


def diag_plan(X: int, Y: int, Z: int, sms: int,
              model: TileModel = DIAG_MODEL):
    """lat_diag's plan: force_plan under DIAG_MODEL (lat_diag_shift's under
    DIAG_SHIFT_MODEL): one launch on halo tiles, or FORCE_TWO_PASS where
    the model says the cells computed twice cost more (the 74k beam)."""
    return force_plan(X, Y, Z, sms, model)


def energy_plan(X: int, Y: int, Z: int, sms: int, cover=None):
    """(blocks, lanes) of lat_energy: eight lanes a cell (lanes = 1) while
    they fit in a block an SM, else a thread a cell; at most
    ENERGY_BLOCKS_PER_SM blocks an SM (the threads walk the cells beyond
    that). With a cover, the cells are its real cells."""
    cells = ((X - 1) * (Y - 1) * (Z - 1) if cover is None
             else cover.cells.size)
    lanes = int(8 * cells <= sms * ENERGY_THREADS)
    threads = 8 * cells if lanes else cells
    return (max(1, min(-(-threads // ENERGY_THREADS),
                       ENERGY_BLOCKS_PER_SM * sms)), lanes)


def newton_tiling(X: int, Y: int, Z: int, cap: int, cover=None,
                  mode: int = 0):
    """(plan, cell_us): the fused Newton kernel's plan (grid, ntx, nty, ntz,
    stride, box, halo) as lat_newton_plan picks it (the same candidates in
    the same order, the same model in double precision) on a card that
    holds `cap` of its blocks at once (its SM count: a block takes an SM's
    registers), and the model's cell-pass term of that plan, 5 passes of
    0.9 us a round times the tiles a block walks. With a cover
    (ops/boxes.Cover) a tiling runs its active tiles only: they set the
    grid and the waves. mode: as lat_newton_plan's (1 halo, 2 exchange)."""
    if min(X, Y, Z) < 2 or mode not in (0, 1, 2):
        raise ValueError(f"lattice {X, Y, Z}, mode {mode}: lat_newton_plan "
                         "takes X, Y, Z >= 2 and mode 0, 1 or 2")
    ntx = -(-X // NEWTON_TILE_WIDTH)
    nty = -(-Y // NEWTON_TILE_WIDTH)
    active = (None if cover is None
              else cover.active_counts(ntx, nty, range(1, Z + 1)))
    best = None
    for halo in (1, 0):
        if (mode == 1 and not halo) or (mode == 2 and halo):
            continue
        ex = min(-(-X // ntx) + halo, X - 1)
        ey = min(-(-Y // nty) + halo, Y - 1)
        for ntz in range(1, Z + 1):
            ez = min(-(-Z // ntz) + halo, Z - 1)
            ext = ex * ey * ez
            box = (ex + 1) * (ey + 1) * (ez + 1)
            if (NEWTON_SCRATCH_ROWS * (ext | 1) + 8 * box
                    > NEWTON_SMEM_FLOATS):
                continue
            ntiles = (ntx * nty * ntz if active is None
                      else int(active[ntz - 1]))
            blocks = min(ntiles, cap)
            waves = float(-(-ntiles // cap))
            rounds = float(-(-ext // NEWTON_CELLS_PER_ROUND))
            cell_us = 5.0 * rounds * 0.9 * waves
            cost = cell_us + (7.0 if halo else 12.0) * (2.0 + 0.016 * blocks)
            if best is not None and cost >= best[0]:
                continue
            best = (cost, (blocks, ntx, nty, ntz, ext | 1, box, halo),
                    cell_us)
    if best is None:
        raise ValueError(f"no fused Newton tiling fits the lattice "
                         f"{X, Y, Z}")
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    """SM count of CUDA device `index`."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _force_plan(X, Y, Z, device):
    """force_plan for this lattice and device, computed once. A test or a
    measurement puts another plan under that key to run it."""
    key = (str(device), X, Y, Z)
    if key not in _force_plans:
        _force_plans[key] = force_plan(X, Y, Z, _sms(device.index))
    return _force_plans[key]


def _hvp_plan(X, Y, Z, device):
    """hvp_plan for this lattice and device, computed once. A test or a
    measurement puts another plan under that key to run it."""
    key = (str(device), X, Y, Z)
    if key not in _hvp_plans:
        _hvp_plans[key] = hvp_plan(X, Y, Z, _sms(device.index))
    return _hvp_plans[key]


def _diag_plan(X, Y, Z, device, shift: bool):
    """diag_plan for this lattice and device (shift: lat_diag_shift's, under
    DIAG_SHIFT_MODEL), computed once. A test or a measurement puts another
    plan under that key to run it."""
    key = (str(device), X, Y, Z, shift)
    if key not in _diag_plans:
        _diag_plans[key] = diag_plan(
            X, Y, Z, _sms(device.index),
            DIAG_SHIFT_MODEL if shift else DIAG_MODEL)
    return _diag_plans[key]


def _kept_scratch(key, floats: int, tickets: int):
    """(pointer to `floats` floats, pointer to `tickets` uint32), allocated
    zeroed at the first call with this key and kept."""
    if key not in _workspaces:
        buf = torch.zeros((floats + tickets,), dtype=torch.float32,
                          device=key[0])
        _workspaces[key] = (buf, (buf.data_ptr(),
                                  buf.data_ptr() + 4 * floats))
    return _workspaces[key][1]


def _cover_plan(cover, kind: str, device):
    """The plan of `kind` ("force", "energy", "newton") over the cover for
    this device's SM count, made once and kept on the cover."""
    sms = _sms(device.index)
    key = (kind, sms)
    if key not in cover.plans:
        X, Y, Z = cover.shape
        if kind == "force":
            cover.plans[key] = force_plan(X, Y, Z, sms, cover=cover)
        elif kind == "energy":
            cover.plans[key] = energy_plan(X, Y, Z, sms, cover=cover)
        else:
            cover.plans[key] = newton_tiling(X, Y, Z, sms, cover=cover)[0]
    return cover.plans[key]


def _cover_tiles(cover, tiling, device):
    """(pointer to the int32 tile order, n_active) of the cover under the
    tiling (ntx, nty, ntz) on the device, kept on the cover."""
    name = "tiles %d %d %d" % tuple(tiling)
    order, n_active = cover.tiles(*tiling)
    return cover.tensor(name, device, lambda: order).data_ptr(), n_active


def _cover_cells(cover, device):
    """Pointer to the cover's int32 real cells on the device (kept)."""
    return cover.tensor("cells", device, lambda: cover.cells).data_ptr()


def _check_cover(cover, X, Y, Z):
    if tuple(cover.shape) != (X, Y, Z):
        raise ValueError(f"cover of the lattice {tuple(cover.shape)} given "
                         f"for {X, Y, Z}")


# -- plain torch versions (channel-first wrappers over ops.stencil) ---------


def _cells(cover, device):
    """The stencil CellList of a cover (None: every cell)."""
    return None if cover is None else cover.cell_list(device)


def force_cf_plain(x_cf, cell_mask, dx: float, mu: float, la: float,
                   cover=None):
    g, det = _tables(dx, x_cf.device)
    f = stencil.elastic_force_lattice(x_cf.permute(1, 2, 3, 0), cell_mask,
                                      g, det, mu, la,
                                      _cells(cover, x_cf.device))
    return f.permute(3, 0, 1, 2).contiguous()


def hvp_cf_plain(x_cf, p_cf, cell_mask, dx: float, mu: float, la: float,
                 cover=None):
    g, det = _tables(dx, x_cf.device)
    h = stencil.elastic_hvp_lattice(x_cf.permute(1, 2, 3, 0),
                                    p_cf.permute(1, 2, 3, 0), cell_mask,
                                    g, det, mu, la,
                                    _cells(cover, x_cf.device))
    return h.permute(3, 0, 1, 2).contiguous()


def level_matvec_cf_plain(u_cf, p_cf, cell_mask, ctrl, vert_mask, dx: float,
                          mu: float, la: float):
    return (hvp_cf_plain(u_cf, p_cf, cell_mask, dx, mu, la)
            + ctrl * p_cf) * vert_mask


def hess_diag_lattice_plain(x_lat, cell_mask, dx: float, mu: float, la: float,
                            cover=None):
    g, det = _tables(dx, x_lat.device)
    return stencil.elastic_hessian_diag_lattice(x_lat, cell_mask, g, det,
                                                mu, la,
                                                _cells(cover, x_lat.device))


def elastic_energy_lattice_plain(x_lat, cell_mask, dx: float, mu: float,
                                 la: float, cover=None):
    g, det = _tables(dx, x_lat.device)
    return stencil.elastic_energy_lattice(x_lat, cell_mask, g, det, mu, la,
                                          _cells(cover, x_lat.device))


def _pcg_plain(u, b, cell_mask, ctrl, vert_mask, g, det, mu, la, iterations,
               tol, cells=None):
    """Block-Jacobi PCG of (H(u) + diag(ctrl)) dx = b on the lattice, with
    the analytic HVP and the ctrl-shifted vertex diagonal; u, b (X, Y, Z, 3);
    cells: a cover's CellList or None. Returns (dx (X, Y, Z, 3), k)."""
    vm3 = vert_mask[..., None]
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    diag = (stencil.elastic_hessian_diag_lattice(u, cell_mask, g, det, mu, la,
                                                 cells)
            + ctrl[..., None, None] * eye)

    def matvec(p):
        hp = stencil.elastic_hvp_lattice(u, p, cell_mask, g, det, mu, la,
                                         cells)
        return (hp + ctrl[..., None] * p) * vm3

    def minv(r):
        return ell.solve3x3(diag, r) * vm3

    return cgmod.pcg_operator(matvec, minv, b, iterations=iterations,
                              tol=float(tol), return_iters=True)


def fused_pcg_plain(u_cf, f_cf, cell_mask, ctrl, vert_mask, dx: float,
                    mu: float, la: float, iterations: int = 50, tol=1e-5):
    """The fused PCG solve as a composition of the plain operators and
    pcg_operator. Returns (dx_cf, k) with k a 0-d int32 tensor."""
    g, det = _tables(dx, u_cf.device)
    dxl, k = _pcg_plain(u_cf.permute(1, 2, 3, 0), f_cf.permute(1, 2, 3, 0),
                        cell_mask, ctrl, vert_mask, g, det, mu, la,
                        iterations, tol)
    return (dxl.permute(3, 0, 1, 2).contiguous(),
            torch.tensor(k, dtype=torch.int32, device=u_cf.device))


def fused_newton_plain(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask, dx: float,
                       mu: float, la: float, iterations: int = 50, tol=1e-5,
                       cover=None):
    """The fused Newton iteration as a composition of the plain operators:
    residual, ctrl-shifted block-Jacobi PCG with the analytic HVP, and the
    trial-step residual norm; over a cover's real cells when one is given.
    Returns (dx_cf, f_cf, fn_full, k)."""
    g, det = _tables(dx, u_cf.device)
    cells = _cells(cover, u_cf.device)
    u = u_cf.permute(1, 2, 3, 0)
    s = s_cf.permute(1, 2, 3, 0)
    vm3 = vert_mask[..., None]
    rc3 = rc[..., None]

    def resid(uu):
        fe = stencil.elastic_force_lattice(uu, cell_mask, g, det, mu, la,
                                           cells)
        return (fe + s - rc3 * uu) * vm3

    f = resid(u)
    dxl, k = _pcg_plain(u, f, cell_mask, ctrl, vert_mask, g, det, mu, la,
                        iterations, tol, cells)
    fn = ell.inf_norm(resid(u + dxl * vm3))
    return (dxl.permute(3, 0, 1, 2).contiguous(),
            f.permute(3, 0, 1, 2).contiguous(), fn,
            torch.tensor(k, dtype=torch.int32, device=u.device))


# the 3x3 block's entries as indices into the 6 symmetric channels
# (xx, xy, xz, yy, yz, zz) of lat_diag and lat_diag_shift; the channels are
# the upper triangle
_SYM_BLOCK = (0, 1, 2, 1, 3, 4, 2, 4, 5)
_UPPER = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def sym_blocks(d6):
    """(..., 6, X, Y, Z) symmetric channels -> (..., X, Y, Z, 3, 3) blocks."""
    return d6.movedim(-4, -1)[..., list(_SYM_BLOCK)].reshape(
        tuple(d6.shape[:-4]) + tuple(d6.shape[-3:]) + (3, 3))


def sym_channels(blocks):
    """(..., X, Y, Z, 3, 3) blocks -> their upper triangle,
    (..., 6, X, Y, Z)."""
    return torch.stack([blocks[..., r, c] for r, c in _UPPER], dim=-4)


def sym_solve_cf(d6, r_cf):
    """Adjugate solve of the 6-channel blocks on a channel-first field
    (leading axes allowed: (..., 6, X, Y, Z) and (..., 3, X, Y, Z)):
    ell.solve3x3(sym_blocks(d6), r) bit for bit (the same products in the
    same order: on a symmetric block c10 = c01, c20 = c02, c21 = c12),
    without expanding the blocks or permuting the field."""
    a, b, c, d, e, f = d6.unbind(-4)
    c00 = d * f - e * e
    c01 = e * c - b * f
    c02 = b * e - d * c
    det = a * c00 + b * c01 + c * c02
    c11 = a * f - c * c
    c12 = b * c - a * e
    c22 = a * d - b * b
    inv_det = det / (det * det + 1e-12)
    r0, r1, r2 = r_cf.unbind(-4)
    return torch.stack([(c00 * r0 + c01 * r1 + c02 * r2) * inv_det,
                        (c01 * r0 + c11 * r1 + c12 * r2) * inv_det,
                        (c02 * r0 + c12 * r1 + c22 * r2) * inv_det], dim=-4)


@functools.lru_cache(maxsize=64)
def cheby_coeffs(lmax, degree: int):
    """The Chebyshev smoother's coefficients on D^-1 A targeting
    [lmax/4, lmax], in float32 as the host computes them: (theta, a_1,
    b_1, ..., a_{degree-1}, b_{degree-1}); sweep k > 0 updates
    d = a_k d + b_k z."""
    f32 = np.float32
    lmax = f32(lmax)
    lmin = lmax / f32(4.0)
    theta = f32(0.5) * (lmax + lmin)
    delta = f32(0.5) * (lmax - lmin)
    sigma = theta / delta
    rho = f32(1.0) / sigma
    out = [float(theta)]
    for _ in range(degree - 1):
        rho_new = f32(1.0) / (f32(2.0) * sigma - rho)
        out += [float(rho_new * rho), float(f32(2.0) * rho_new / delta)]
        rho = rho_new
    return tuple(out)


def cheby_smooth_cf_plain(u_cf, b_cf, x_cf, d6, ctrl, vert_mask, cell_mask,
                          dx: float, mu: float, la: float, coeffs,
                          want_residual: bool = False):
    """The Chebyshev smoother as a composition of the plain operators: the
    HVP at u plus ctrl, the block solve (ell.solve3x3 on the blocks expanded
    from d6), x from x_cf (None: from zero, where the first residual is b
    itself). Returns x_cf, or (x_cf, b - A x) with want_residual."""
    blocks = sym_blocks(d6)

    def matvec(p):
        return (hvp_cf_plain(u_cf, p, cell_mask, dx, mu, la)
                + ctrl * p) * vert_mask

    def solve(r):
        z = ell.solve3x3(blocks, r.permute(1, 2, 3, 0))
        return z.permute(3, 0, 1, 2) * vert_mask

    z = solve(b_cf if x_cf is None else b_cf - matvec(x_cf))
    d = z / coeffs[0]
    x = d if x_cf is None else x_cf + d
    for a, b in zip(coeffs[1::2], coeffs[2::2]):
        z = solve(b_cf - matvec(x))
        d = a * d + b * z
        x = x + d
    return (x, b_cf - matvec(x)) if want_residual else x


def power_lmax_cf_plain(u_cf, d6, ctrl, vert_mask, cell_mask, dx: float,
                        mu: float, la: float, iters: int = 6):
    """Power iteration on D^-1 A for the Chebyshev upper bound (a 0-d
    tensor, times 1.1); A = level_matvec_cf_plain at u_cf, D the blocks d6;
    channel-first, vert_mask (X, Y, Z)."""
    vmask = vert_mask

    def matvec(p):
        return level_matvec_cf_plain(u_cf, p, cell_mask, ctrl, vmask, dx, mu,
                                     la)
    shape = tuple(vmask.shape)
    n = shape[0] * shape[1] * shape[2]
    start = torch.sin(torch.arange(n, dtype=torch.float32,
                                   device=vmask.device))
    v = (vmask * start.reshape(shape)).expand((3,) + shape).contiguous()
    lam = None
    for _ in range(iters):
        w = sym_solve_cf(d6, matvec(v)) * vmask
        ww = ell.vdot(w, w)
        lam = torch.sqrt(ww / torch.clamp(ell.vdot(v, v), min=1e-30))
        v = w / torch.clamp(torch.sqrt(ww), min=1e-30)
    return lam * 1.1


def shifted_diag_blocks_plain(u_cf, cell_mask, ctrl, vert_mask, dx: float,
                              mu: float, la: float):
    """The vertex-diagonal blocks plus (ctrl + 1 - vm) I, (X, Y, Z, 3, 3):
    what hess_diag_shift_cf_plain projects."""
    blocks = hess_diag_lattice_plain(u_cf.permute(1, 2, 3, 0), cell_mask, dx,
                                     mu, la)
    eye = torch.eye(3, dtype=blocks.dtype, device=blocks.device)
    return blocks + (ctrl + (1.0 - vert_mask))[..., None, None] * eye


def hess_diag_shift_cf_plain(u_cf, cell_mask, ctrl, vert_mask, dx: float,
                             mu: float, la: float, project: bool = True):
    """The vertex-diagonal blocks plus (ctrl + 1 - vm) I, SPD-projected with
    ell.spd_project(eps=1e-6, rel_floor=1e-3) when project; (6, X, Y, Z),
    the upper triangle of each block."""
    blocks = shifted_diag_blocks_plain(u_cf, cell_mask, ctrl, vert_mask, dx,
                                       mu, la)
    if project:
        blocks = ell.spd_project(blocks, eps=1e-6, rel_floor=1e-3)
    return sym_channels(blocks)


# -- public wrappers ---------------------------------------------------------

def force_cf(x_cf, cell_mask, dx: float, mu: float, la: float, cover=None):
    """Elastic force of a displacement field; (3, X, Y, Z) -> (3, X, Y, Z).
    Allocates only its output: one launch on halo tiles, or the two passes
    with their cell scratch kept per device, stream and lattice (and
    cover). With a cover: the plan over it, the active tiles or the real
    cells only, counted as "force_cover"."""
    _cuda.refuse_grad("lattice_kernels.force_cf", x_cf, cell_mask)
    if _cuda.on_cpu(x_cf, cell_mask):
        return force_cf_plain(x_cf, cell_mask, dx, mu, la, cover)
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    lib = _cuda.load()
    dev = x_cf.device
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    cf, lst, n_lst = None, None, 0
    if cover is None:
        plan = _force_plan(X, Y, Z, dev)
        if plan == FORCE_TWO_PASS:
            cf = _kept_scratch((str(dev), tail[-1], "force", X, Y, Z),
                               24 * cell_mask.numel(), 0)[0]
    else:
        _check_cover(cover, X, Y, Z)
        plan = _cover_plan(cover, "force", dev)
        if plan == FORCE_TWO_PASS:
            # the cover's own scratch: the cells it never writes stay zero
            cf = _kept_scratch((str(dev), tail[-1], "force_cover", X, Y, Z,
                                cover.key), 24 * cell_mask.numel(), 0)[0]
            lst, n_lst = _cover_cells(cover, dev), int(cover.cells.size)
        else:
            lst, n_lst = _cover_tiles(cover, plan[1:4], dev)
    out = torch.empty_like(x_cf)
    with torch.cuda.device(dev):
        err = lib.lat_force(x_cf.data_ptr(), cell_mask.data_ptr(),
                            out.data_ptr(), cf, lst, n_lst, *plan[1:], *tail)
    launches["force" if cover is None else "force_cover"] += 1
    _cuda.check(err, "lat_force")
    return out


def hvp_cf(x_cf, p_cf, cell_mask, dx: float, mu: float, la: float):
    """Elastic Hessian-vector product (positive-definite convention) of a
    displacement field: (3, X, Y, Z) x2 -> (3, X, Y, Z). One launch on halo
    tiles, or the two passes where hvp_plan picks them (their cell scratch
    kept per device, stream and lattice); allocates only its output."""
    _cuda.refuse_grad("lattice_kernels.hvp_cf", x_cf, p_cf, cell_mask)
    if _cuda.on_cpu(x_cf, p_cf, cell_mask):
        return hvp_cf_plain(x_cf, p_cf, cell_mask, dx, mu, la)
    return _lat_hvp(x_cf, p_cf, cell_mask, None, None, dx, mu, la)


def level_matvec_cf(u_cf, p_cf, cell_mask, ctrl, vert_mask, dx: float,
                    mu: float, la: float):
    """A multigrid level's operator (H(u) p + ctrl p) vm on channel-first
    fields: u_cf, p_cf (3, X, Y, Z); ctrl, vert_mask (X, Y, Z). hvp_cf's
    launch with the shift and mask in its vertex pass (counted as "hvp");
    allocates only its output."""
    _cuda.refuse_grad("lattice_kernels.level_matvec_cf",
                      u_cf, p_cf, cell_mask, ctrl, vert_mask)
    if _cuda.on_cpu(u_cf, p_cf, cell_mask, ctrl, vert_mask):
        return level_matvec_cf_plain(u_cf, p_cf, cell_mask, ctrl, vert_mask,
                                     dx, mu, la)
    return _lat_hvp(u_cf, p_cf, cell_mask, ctrl, vert_mask, dx, mu, la)


def _lat_hvp(u_cf, p_cf, cell_mask, ctrl, vert_mask, dx, mu, la):
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    _cuda.require(p_cf, u_cf.shape, "p_cf")
    if ctrl is not None:
        for name, t in (("ctrl", ctrl), ("vert_mask", vert_mask)):
            _cuda.require(t, (X, Y, Z), name)
    lib = _cuda.load()
    dev = u_cf.device
    plan = _hvp_plan(X, Y, Z, dev)
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    cf = None
    if plan == FORCE_TWO_PASS:
        cf = _kept_scratch((str(dev), tail[-1], "hvp", X, Y, Z),
                           24 * cell_mask.numel(), 0)[0]
    out = torch.empty_like(u_cf)
    with torch.cuda.device(dev):
        err = lib.lat_hvp(u_cf.data_ptr(), p_cf.data_ptr(),
                          cell_mask.data_ptr(),
                          None if ctrl is None else ctrl.data_ptr(),
                          None if ctrl is None else vert_mask.data_ptr(),
                          out.data_ptr(), cf, *plan[1:], *tail)
    launches["hvp"] += 1
    _cuda.check(err, "lat_hvp")
    return out


_sym_index: dict = {}


def _lat_diag(x_cf, cell_mask, ctrl, vert_mask, project: bool, dx, mu, la,
              out):
    """Launch lat_diag into out (6, X, Y, Z) under its plan (with ctrl:
    lat_diag_shift's), after the argument checks; the two passes' cell
    scratch is kept per device, stream and lattice. Counts the launch as
    "diag", or "diag_shift" with ctrl."""
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    shift = ctrl is not None
    if shift:
        for name, t in (("ctrl", ctrl), ("vert_mask", vert_mask)):
            _cuda.require(t, (X, Y, Z), name)
    lib = _cuda.load()
    dev = x_cf.device
    plan = _diag_plan(X, Y, Z, dev, shift)
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    cd = None
    if plan == FORCE_TWO_PASS:
        cd = _kept_scratch((str(dev), tail[-1], "diag", X, Y, Z),
                           48 * cell_mask.numel(), 0)[0]
    with torch.cuda.device(dev):
        err = lib.lat_diag(x_cf.data_ptr(), cell_mask.data_ptr(),
                           ctrl.data_ptr() if shift else None,
                           vert_mask.data_ptr() if shift else None,
                           out.data_ptr(), cd, int(project),
                           DIAG_LANE_CELLS if shift else 0, *plan[1:],
                           *tail)
    launches["diag_shift" if shift else "diag"] += 1
    _cuda.check(err, "lat_diag")
    return out


def hess_diag6_cf(x_cf, cell_mask, dx: float, mu: float, la: float):
    """Vertex-diagonal Hessian blocks of a channel-first displacement field
    as their 6 symmetric channels: (3, X, Y, Z) -> (6, X, Y, Z), the
    channels (xx, xy, xz, yy, yz, zz). One launch on tiles, or two where
    diag_plan says; allocates only its output (a new tensor every call)."""
    _cuda.refuse_grad("lattice_kernels.hess_diag6_cf", x_cf, cell_mask)
    if _cuda.on_cpu(x_cf, cell_mask):
        return sym_channels(hess_diag_lattice_plain(
            x_cf.permute(1, 2, 3, 0), cell_mask, dx, mu, la))
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    out = torch.empty((6, X, Y, Z), dtype=torch.float32, device=x_cf.device)
    return _lat_diag(x_cf, cell_mask, None, None, False, dx, mu, la, out)


def hess_diag_cf(x_cf, cell_mask, dx: float, mu: float, la: float):
    """Vertex-diagonal Hessian blocks of a channel-first displacement field:
    (3, X, Y, Z) -> (X, Y, Z, 3, 3). Allocates only its output: the six
    channels are kept per device, stream and lattice, and one gather makes
    the blocks."""
    _cuda.refuse_grad("lattice_kernels.hess_diag_cf", x_cf, cell_mask)
    if _cuda.on_cpu(x_cf, cell_mask):
        return hess_diag_lattice_plain(x_cf.permute(1, 2, 3, 0), cell_mask,
                                       dx, mu, la)
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    dev = x_cf.device
    key = (str(dev), _stream(dev), "diag6", X, Y, Z)
    _kept_scratch(key, 6 * X * Y * Z, 0)
    d6 = _workspaces[key][0][:6 * X * Y * Z].view(6, X, Y, Z)
    _lat_diag(x_cf, cell_mask, None, None, False, dx, mu, la, d6)
    if str(dev) not in _sym_index:
        _sym_index[str(dev)] = torch.tensor(_SYM_BLOCK, device=dev)
    blocks = torch.index_select(d6.permute(1, 2, 3, 0), 3,
                                _sym_index[str(dev)])
    return blocks.view(X, Y, Z, 3, 3)


def hess_diag_lattice(x_lat, cell_mask, dx: float, mu: float, la: float):
    """Vertex-diagonal Hessian blocks: (X, Y, Z, 3) -> (X, Y, Z, 3, 3)
    (hess_diag_cf after one channel-first copy of the field)."""
    _cuda.refuse_grad("lattice_kernels.hess_diag_lattice", x_lat, cell_mask)
    if _cuda.on_cpu(x_lat, cell_mask):
        return hess_diag_lattice_plain(x_lat, cell_mask, dx, mu, la)
    return hess_diag_cf(x_lat.permute(3, 0, 1, 2).contiguous(), cell_mask,
                        dx, mu, la)


def elastic_energy_lattice(x_lat, cell_mask, dx: float, mu: float, la: float,
                           cover=None):
    """Total StVK elastic energy of a displacement field (X, Y, Z, 3), a 0-d
    tensor on the field's device. One launch on the field as it is;
    allocates only its output (the partials and the ticket are kept per
    device, stream and lattice, and cover). With a cover: its real cells
    only, under energy_plan over them, counted as "energy_cover"."""
    _cuda.refuse_grad("lattice_kernels.elastic_energy_lattice",
                      x_lat, cell_mask)
    if _cuda.on_cpu(x_lat, cell_mask):
        return elastic_energy_lattice_plain(x_lat, cell_mask, dx, mu, la,
                                            cover)
    X, Y, Z = _vertex_grid(x_lat, cell_mask, channel_last=True)
    lib = _cuda.load()
    dev = x_lat.device
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    if cover is None:
        grid, lanes = energy_plan(X, Y, Z, _sms(dev.index))
        key = (str(dev), tail[-1], "energy", X, Y, Z, grid)
        cells, n_cells = None, 0
    else:
        _check_cover(cover, X, Y, Z)
        grid, lanes = _cover_plan(cover, "energy", dev)
        key = (str(dev), tail[-1], "energy_cover", X, Y, Z, grid, cover.key)
        cells, n_cells = _cover_cells(cover, dev), int(cover.cells.size)
    part, ticket = _kept_scratch(key, grid, 1)
    out = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.lat_energy(x_lat.data_ptr(), cell_mask.data_ptr(),
                             out.data_ptr(), part, ticket, cells, n_cells,
                             grid, lanes, *tail)
    launches["energy" if cover is None else "energy_cover"] += 1
    _cuda.check(err, "lat_energy")
    return out


def ask_newton_plan(lib, X, Y, Z, device, pcg: bool = False, mode: int = 0):
    """(grid, ntx, nty, ntz, stride, box, halo): the cooperative grid and
    the vertex tiling `lat_newton_plan` gives the fused kernel for this
    lattice and device. mode 0: picked by its cost model; 1: halo tiles (a
    block computes every cell touching its vertices); 2: exchange tiles
    (each cell once, partial vertex sums through device memory)."""
    plan = (ctypes.c_int * 7)()
    with torch.cuda.device(device):
        _cuda.check(lib.lat_newton_plan(X, Y, Z, int(pcg), int(mode), plan),
                    "lat_newton_plan")
    return tuple(plan)


def _newton_plan(lib, X, Y, Z, device, pcg: bool = False):
    """The cost model's plan, asked once per (device, X, Y, Z, pcg). A test
    or a measurement puts another tiling under that key to run it."""
    key = (str(device), X, Y, Z, pcg)
    if key not in _newton_plans:
        _newton_plans[key] = ask_newton_plan(lib, X, Y, Z, device, pcg)
    return _newton_plans[key]


def _fused_scratch(key, plans, n: int):
    """The scratch pointers (r, z, p, ap, xacc, d6, part, pbuf) of the fused
    kernels under `plans`, for a lattice of n vertices: one zeroed tensor
    per key, allocated at first use and kept (part: 5 per-block partials a
    block, then one a tile). Under a cover, what no active tile writes
    keeps its zeros."""
    if key not in _workspaces:
        grid = max(plan[0] for plan in plans)
        ntiles = max(plan[1] * plan[2] * plan[3] for plan in plans)
        exchange = any(not plan[6] for plan in plans)
        floats = (3 * n, 3 * n, 6 * n, 3 * n, 3 * n, 6 * n,
                  5 * grid + ntiles, 72 * n if exchange else 0)
        buf = torch.zeros((sum(floats),), dtype=torch.float32,
                          device=key[0])
        ptrs, at = [], buf.data_ptr()
        for count in floats:
            ptrs.append(at)
            at += 4 * count
        _workspaces[key] = (buf, tuple(ptrs))
    return _workspaces[key][1]


def _workspace(lib, X, Y, Z, device, stream: int):
    """The fused kernels' scratch pointers: one tensor per lattice, device,
    stream and pair of plans. fused_newton and fused_pcg share it, so calls
    that share it are ordered on its stream."""
    plans = tuple(_newton_plan(lib, X, Y, Z, device, pcg)
                  for pcg in (False, True))
    return _fused_scratch((str(device), stream, X, Y, Z, plans), plans,
                          X * Y * Z)


# the fused_newton calls' PCG counts by device: {device: (the sum of their k,
# a 0-d int64 tensor on the device; the calls)}. Each call stores a new
# tensor, one device op and no sync, so a reference kept reads the sum as it
# stood then.
pcg: dict = {}


def _count_pcg(k: torch.Tensor) -> None:
    total, calls = pcg.get(k.device, (None, 0))
    pcg[k.device] = (k.long() if total is None else total + k, calls + 1)


def pcg_matvecs() -> int:
    """The PCG matvecs of the fused_newton calls counted in `pcg` (k - 1 a
    call), summed over the devices: one sync a device."""
    return sum(int(total.item()) - calls for total, calls in pcg.values())


def fused_newton(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask, dx: float,
                 mu: float, la: float, iterations: int = 50, tol=1e-5,
                 cover=None):
    """One Newton iteration of the implicit step on the lattice:
      f   = (f_el(u) + s - rc u) vm
      dx  = block-Jacobi PCG of (H(u) + diag(ctrl)) dx = f
      fn  = ||f(u + dx vm)||_inf
    u_cf, s_cf: (3, X, Y, Z); ctrl, rc, vert_mask: (X, Y, Z). s includes the
    -rc*x0 shift; rc is the residual's linear coefficient (pin + drag +
    m/dt^2, a SUM) and ctrl the Hessian diagonal shift (max(pin, drag) +
    m/dt^2 + (1 - vm)). With a cover (ops/boxes.Cover), the cell passes
    walk its active tiles only and the PCG updates the vertices with vm !=
    0, under newton_tiling's plan over it, with the cover's own zeroed
    scratch; counted as "fused_newton_cover" and in `cover_vertices`.
    Returns (dx_cf, f_cf, fn_full, k) with fn_full a 0-d float32 and k a
    0-d int32 tensor (matvecs executed = k - 1), which is added to `pcg`."""
    _cuda.refuse_grad("lattice_kernels.fused_newton",
                      u_cf, s_cf, cell_mask, ctrl, rc, vert_mask)
    if _cuda.on_cpu(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask):
        out = fused_newton_plain(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask,
                                 dx, mu, la, iterations, tol, cover)
        _count_pcg(out[3])
        return out
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    _cuda.require(s_cf, u_cf.shape, "s_cf")
    for name, t in (("ctrl", ctrl), ("rc", rc), ("vert_mask", vert_mask)):
        _cuda.require(t, (X, Y, Z), name)
    lib = _cuda.load()
    dev = u_cf.device
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    if cover is None:
        plan = _newton_plan(lib, X, Y, Z, dev)
        scratch = _workspace(lib, X, Y, Z, dev, tail[-1])
        tiles, n_active = None, 0
    else:
        _check_cover(cover, X, Y, Z)
        plan = _cover_plan(cover, "newton", dev)
        scratch = _fused_scratch((str(dev), tail[-1], X, Y, Z, (plan,),
                                  cover.key), (plan,), X * Y * Z)
        tiles, n_active = _cover_tiles(cover, plan[1:4], dev)
    out = torch.empty((2,) + tuple(u_cf.shape), dtype=torch.float32,
                      device=dev)
    dxc, fc = out[0], out[1]
    fn = torch.empty((), dtype=torch.float32, device=dev)
    k = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (u_cf, s_cf, cell_mask, ctrl, rc, vert_mask,
                                   dxc, fc, fn, k)]
    with torch.cuda.device(dev):
        err = lib.lat_fused_newton(float(tol), *ptrs, *scratch, tiles,
                                   n_active, *plan, *tail[:-1],
                                   int(iterations), tail[-1])
    if cover is None:
        launches["fused_newton"] += 1
    else:
        launches["fused_newton_cover"] += 1
        cover_vertices["walked"] += cover.walked(vert_mask)
        cover_vertices["lattice"] += X * Y * Z
    _cuda.check(err, "lat_fused_newton")
    _count_pcg(k)
    return dxc, fc, fn, k


def fused_pcg(u_cf, f_cf, cell_mask, ctrl, vert_mask, dx: float, mu: float,
              la: float, iterations: int = 50, tol=1e-5):
    """One-launch block-Jacobi PCG solve of (H(u) + diag(ctrl)) dx = f on
    the dense lattice (pcg_operator semantics, normalized RHS).
    u_cf, f_cf: (3, X, Y, Z) displacement and right-hand side; ctrl,
    vert_mask: (X, Y, Z); tol a float or a 0-d tensor. Returns (dx_cf, k)
    with k a 0-d int32 tensor (matvecs executed = k - 1); a zero RHS gives
    dx == 0 and k == 1."""
    _cuda.refuse_grad("lattice_kernels.fused_pcg",
                      u_cf, f_cf, cell_mask, ctrl, vert_mask)
    if _cuda.on_cpu(u_cf, f_cf, cell_mask, ctrl, vert_mask):
        return fused_pcg_plain(u_cf, f_cf, cell_mask, ctrl, vert_mask, dx, mu,
                               la, iterations, tol)
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    _cuda.require(f_cf, u_cf.shape, "f_cf")
    for name, t in (("ctrl", ctrl), ("vert_mask", vert_mask)):
        _cuda.require(t, (X, Y, Z), name)
    lib = _cuda.load()
    dev = u_cf.device
    plan = _newton_plan(lib, X, Y, Z, dev, pcg=True)
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    scratch = _workspace(lib, X, Y, Z, dev, tail[-1])
    dxc = torch.empty_like(u_cf)
    k = torch.empty((), dtype=torch.int32, device=dev)
    ptrs = [t.data_ptr() for t in (u_cf, f_cf, cell_mask, ctrl, vert_mask,
                                   dxc, k)]
    with torch.cuda.device(dev):
        err = lib.lat_fused_pcg(float(tol), *ptrs, *scratch, *plan,
                                *tail[:-1], int(iterations), tail[-1])
    launches["fused_pcg"] += 1
    _cuda.check(err, "lat_fused_pcg")
    return dxc, k


# -- the multigrid's level kernels: lat_cheby and lat_power -----------------

# lat_level_plan's kernels
CHEBY, POWER = 0, 1
# their forms (csrc/lattice_kernels.cu: kLevelCluster, kLevelTiles,
# kLevelExchange: the first form's exchange arithmetic, where it took
# exchange tiles) and launch shapes: kLevelThreads threads a block, eight
# lanes a cell (kLevelCellsPerRound cells a round), one block an SM, at most
# kLevelSmemCap bytes of dynamic shared memory, kOwnFloats shared floats for
# each vertex a block owns; kMaxLevelCluster blocks a cluster; the tiles
# form weighs these tile counts along x and y (kLevelXY: those its model
# was fitted over; lat_power's never split y), with any count along z
LEVEL_FORMS = ("cluster", "tiles", "exchange")
LEVEL_CLUSTER, LEVEL_TILES, LEVEL_EXCHANGE = range(3)
LEVEL_THREADS = 512
LEVEL_CELLS_PER_ROUND = LEVEL_THREADS // 8
LEVEL_SMEM_CAP = 230400
LEVEL_OWN_FLOATS = 14
# lat_power sums its dots by vertex slots on levels of at most this many
# vertices (kSlots)
LEVEL_SLOTS = 512
LEVEL_MAX_CLUSTER = 16
LEVEL_XY_TILES = ((1, 1), (2, 1), (4, 1), (2, 2), (4, 4))
# lat_level_plan's cost model (kLevelModel), device us of an H100 per form:
# (launch, a KB of a block's shared layout, a round of a block's cell pass
# an HVP, a wait between sweeps, a wait and block, a KB of x a block
# receives a wait, a round of a block's vertex pass a sweep, an HVP, the
# first round's share of its lanes an HVP, a block's own vertices over
# LEVEL_THREADS a sweep, a block's cells over a round's an HVP); fitted by
# scripts/level_tilings.py --fit to its --sweep of both forms at the main
# paths' level shapes
LEVEL_MODEL = (
    (5.71, 0.009732, 0.08189, 1.57, 0.009467, 0.196, 0.0, 0.0, 2.143, 0.0,
     1.595),
    (3.01, 0.02291, 0.3062, 0.5013, 0.00286, 0.2154, 1.449, 0.5969, 2.048,
     0.4956, 1.07),
)
# lat_cheby and lat_power launches by (kernel, (X, Y, Z), form name)
level_launches: dict = {}


@functools.lru_cache(maxsize=None)
def level_layout(shape, tiles, halo: bool = True, power: bool = False):
    """(box, cells, stride, own, bytes) of a level kernel's shared layout on
    the tiles `tiles` (ntx, nty, ntz) of the lattice `shape` (mirror of
    level_layout in csrc/lattice_kernels.cu): the largest tile's vertex
    box, cells (stride: their count made odd) and own vertices, by the most
    along each axis (halo tiles, or the cells a tile owns); the bytes of u
    and x's two buffers on the box, lat_power's planes' or slots'
    partials, the corner sums and cell mask, and the own vertices'
    fields."""
    own, ext = 1, []
    for n, nt in zip(shape, tiles):
        own *= max(tile_axis(n, nt, it)[1] for it in range(nt))
        ext.append(_cell_extent(n, nt) if halo else max(
            min((it + 1) * n // nt - 1, n - 2) - it * n // nt + 1
            for it in range(nt)))
    box = (ext[0] + 1) * (ext[1] + 1) * (ext[2] + 1)
    cells = ext[0] * ext[1] * ext[2]
    stride = cells | 1
    floats = (12 * box + (8 * max(shape[2], LEVEL_SLOTS) if power else 0)
              + (FORCE_ROWS + 1) * stride + LEVEL_OWN_FLOATS * own)
    return box, cells, stride, own, 4 * floats


def level_calls(kernel: int, sweeps: int, warm: bool = False,
                residual: bool = False):
    """(hvps, waits) of a call: the cell passes it runs and the waits for
    other blocks' values between them (lat_power: every iteration, for its
    dots)."""
    if kernel == POWER:
        return sweeps, sweeps
    return sweeps - (not warm) + bool(residual), sweeps - 1 + bool(residual)


def level_features(shape, form: int, tiles, sweeps: int, hvps: int,
                   waits: int, power: bool = False):
    """The terms LEVEL_MODEL weighs (level_cost): 1, KB of a block's shared
    layout, hvps x rounds of a block's cell pass, waits, waits x blocks,
    waits x KB of x a block receives (the cluster: its halo planes; the
    tiles form: its box's vertices other blocks own), sweeps x rounds of a
    block's vertex pass, hvps, hvps x the first round's share of its lanes
    (the warps a round keeps busy), sweeps x a block's own vertices over
    LEVEL_THREADS, hvps x a block's cells over a round's."""
    box, cells, _, own, nbytes = level_layout(shape, tiles, True, power)
    blocks = tiles[0] * tiles[1] * tiles[2]
    rounds = float(-(-cells // LEVEL_CELLS_PER_ROUND))
    vrounds = float(-(-own // LEVEL_THREADS))
    halo_kb = (16.0 * shape[0] * shape[1] * min(blocks - 1, 2) / 1024.0
               if form == LEVEL_CLUSTER else 16.0 * (box - own) / 1024.0)
    return (1.0, nbytes / 1024.0, hvps * rounds, float(waits),
            float(waits) * blocks, waits * halo_kb, sweeps * vrounds,
            float(hvps),
            hvps * min(cells, LEVEL_CELLS_PER_ROUND) / LEVEL_CELLS_PER_ROUND,
            sweeps * own / LEVEL_THREADS,
            hvps * cells / LEVEL_CELLS_PER_ROUND)


def level_cost(shape, form: int, tiles, sweeps: int, hvps: int,
               waits: int, power: bool = False) -> float:
    """The modelled device us of a call (level_cost in csrc)."""
    f = level_features(shape, form, tiles, sweeps, hvps, waits, power)
    m = LEVEL_MODEL[form]
    return (m[0] + m[1] * f[1] + m[2] * f[2] + m[3] * f[3] + m[4] * f[4]
            + m[5] * f[5] + m[6] * f[6] + m[7] * f[7] + m[8] * f[8]
            + m[9] * f[9] + m[10] * f[10])


def level_exchange(shape, sms: int, kernel: int = CHEBY):
    """The exchange form's tiles (ntx, nty, ntz) where the first form took
    exchange tiles, else None (mirror of level_exchange in csrc): its halo
    tiles, NEWTON_TILE_WIDTH wide in x and y, fit its shared scratch
    (NEWTON_SCRATCH_ROWS rows of cells and 8 floats a box vertex in
    NEWTON_SMEM_FLOATS) only at more tiles than `sms`. NEWTON_TILE_WIDTH
    wide in x, and in y for lat_cheby (the first form's tiles: its bits),
    y whole for lat_power (its dots add whole rows); as many along z as the
    card holds blocks."""
    X, Y, Z = shape
    ntx = -(-X // NEWTON_TILE_WIDTH)
    nty = -(-Y // NEWTON_TILE_WIDTH)
    ex = min(-(-X // ntx) + 1, X - 1)
    ey = min(-(-Y // nty) + 1, Y - 1)
    for ntz in range(1, Z + 1):
        if ntx * nty * ntz > sms:
            break
        ez = min(-(-Z // ntz) + 1, Z - 1)
        if (NEWTON_SCRATCH_ROWS * ((ex * ey * ez) | 1)
                + 8 * (ex + 1) * (ey + 1) * (ez + 1) <= NEWTON_SMEM_FLOATS):
            return None
    if kernel == POWER:
        nty = 1
    return ntx, nty, min(Z, sms // (ntx * nty))


def level_candidates(shape, sms: int, kernel: int, sweeps: int,
                     warm: bool = False, residual: bool = False):
    """[(modelled us, form, tiles)] of every launch lat_level_plan weighs,
    in its order: clusters of 1 to LEVEL_MAX_CLUSTER z-slabs, then the
    tiles form's tiles ((ntx, nty) of LEVEL_XY_TILES, lat_power's nty 1:
    its dots add whole rows along y; at most one block an SM of `sms`),
    each within LEVEL_SMEM_CAP; where level_exchange holds, only the
    exchange form on its tiles (unmodelled: cost 0)."""
    X, Y, Z = shape
    tiles = level_exchange(shape, sms, kernel)
    if tiles is not None:
        return [(0.0, LEVEL_EXCHANGE, tiles)]
    hvps, waits = level_calls(kernel, sweeps, warm, residual)
    power = kernel == POWER
    out = []
    for form in (LEVEL_CLUSTER, LEVEL_TILES):
        cluster = form == LEVEL_CLUSTER
        for ntx, nty in ((1, 1),) if cluster else LEVEL_XY_TILES:
            if ntx > X or nty > Y or (power and nty > 1):
                continue
            for ntz in range(1, (min(Z, LEVEL_MAX_CLUSTER) if cluster
                                 else Z) + 1):
                tiles = (ntx, nty, ntz)
                if not cluster and ntx * nty * ntz > sms:
                    break
                if level_layout(shape, tiles, True, power)[4] \
                        > LEVEL_SMEM_CAP:
                    continue
                out.append((level_cost(shape, form, tiles, sweeps, hvps,
                                       waits, power), form, tiles))
    return out


def level_plan(shape, sms: int, kernel: int, sweeps: int,
               warm: bool = False, residual: bool = False):
    """(form, ntx, nty, ntz) of a call as lat_level_plan picks it on a card
    of `sms` SMs that places every cluster of up to 16 blocks: the least
    modelled cost, the first of a tie."""
    best = None
    for cost, form, tiles in level_candidates(shape, sms, kernel, sweeps,
                                              warm, residual):
        if best is None or cost < best[0]:
            best = (cost, form, tiles)
    if best is None:
        raise ValueError(f"no level kernel launch fits the lattice {shape}")
    return (best[1],) + best[2]


def _level_plan(lib, X, Y, Z, device, kernel: int, sweeps: int,
                warm: bool = False, residual: bool = False):
    """(form, ntx, nty, ntz) that lat_level_plan picks for this call on this
    device, asked once per (device, X, Y, Z, kernel, sweeps, warm,
    residual). A test or a measurement puts another plan under that key to
    run it."""
    key = (str(device), X, Y, Z, kernel, sweeps, bool(warm), bool(residual))
    if key not in _level_plans:
        plan = (ctypes.c_int * 5)()
        with torch.cuda.device(device):
            _cuda.check(lib.lat_level_plan(X, Y, Z, int(kernel), int(sweeps),
                                           int(bool(warm)),
                                           int(bool(residual)), plan),
                        "lat_level_plan")
        _level_plans[key] = tuple(plan[:4])
    return _level_plans[key]


def _level_scratch(dev, stream: int, X, Y, Z):
    """Pointers (xs, part, pbuf) to the level kernels' scratch of this
    device, stream and lattice, kept: the cooperative forms' two iterate
    buffers (a float4 a vertex, 8 N floats), lat_power's rows' or slots'
    partials (4 max(Z X, LEVEL_SLOTS)), the exchange form's partial sums
    by slot (24 N)."""
    n, rows = X * Y * Z, max(Z * X, LEVEL_SLOTS)
    base = _kept_scratch((str(dev), stream, "level", X, Y, Z),
                         32 * n + 4 * rows, 0)[0]
    return base, base + 32 * n, base + 32 * n + 16 * rows


def _count_level(kernel: str, shape, form: int) -> None:
    key = (kernel, tuple(shape), LEVEL_FORMS[form])
    level_launches[key] = level_launches.get(key, 0) + 1


def cheby_smooth_cf(u_cf, b_cf, x_cf, d6, ctrl, vert_mask, cell_mask,
                    dx: float, mu: float, la: float, coeffs,
                    want_residual: bool = False):
    """Chebyshev smoothing on a lattice multigrid level, every sweep in one
    launch: on A = (H(u) + diag(ctrl)) vm with the block-Jacobi
    preconditioner D (d6, the 6-channel blocks of hess_diag_shift_cf), from
    x_cf (None: from zero), with coeffs = cheby_coeffs(lmax, degree).
    u_cf, b_cf, x_cf: (3, X, Y, Z); d6: (6, X, Y, Z); ctrl, vert_mask:
    (X, Y, Z). Returns x_cf, or (x_cf, b - A x) with want_residual. In the
    form and on the tiles lat_level_plan picks for the call; allocates its
    outputs only (the tiles form's scratch is kept per device, stream and
    lattice)."""
    _cuda.refuse_grad("lattice_kernels.cheby_smooth_cf", u_cf, b_cf, x_cf,
                      d6, ctrl, vert_mask, cell_mask)
    if _cuda.on_cpu(u_cf, b_cf, d6, ctrl, vert_mask, cell_mask,
                    *(() if x_cf is None else (x_cf,))):
        return cheby_smooth_cf_plain(u_cf, b_cf, x_cf, d6, ctrl, vert_mask,
                                     cell_mask, dx, mu, la, coeffs,
                                     want_residual)
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    for name, t in (("b_cf", b_cf), ("x_cf", x_cf)):
        if t is not None:
            _cuda.require(t, u_cf.shape, name)
    _cuda.require(d6, (6, X, Y, Z), "d6")
    for name, t in (("ctrl", ctrl), ("vert_mask", vert_mask)):
        _cuda.require(t, (X, Y, Z), name)
    sweeps = (len(coeffs) + 1) // 2
    if len(coeffs) != 2 * sweeps - 1 or not 1 <= sweeps <= CHEBY_MAX_SWEEPS:
        raise ValueError(f"{len(coeffs)} coefficients: lat_cheby takes 1 to "
                         f"{CHEBY_MAX_SWEEPS} sweeps (2 * sweeps - 1 "
                         f"coefficients)")
    lib = _cuda.load()
    dev = u_cf.device
    plan = _level_plan(lib, X, Y, Z, dev, CHEBY, sweeps, x_cf is not None,
                       want_residual)
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    xs, _, pbuf = _level_scratch(dev, tail[-1], X, Y, Z)
    x_out = torch.empty_like(u_cf)
    r_out = torch.empty_like(u_cf) if want_residual else None
    coef = (ctypes.c_float * len(coeffs))(*coeffs)
    with torch.cuda.device(dev):
        err = lib.lat_cheby(
            u_cf.data_ptr(), b_cf.data_ptr(),
            None if x_cf is None else x_cf.data_ptr(), cell_mask.data_ptr(),
            ctrl.data_ptr(), vert_mask.data_ptr(), d6.data_ptr(),
            x_out.data_ptr(), None if r_out is None else r_out.data_ptr(),
            xs, pbuf, coef, sweeps, *plan, *tail)
    launches["cheby"] += 1
    _count_level("cheby", (X, Y, Z), plan[0])
    _cuda.check(err, "lat_cheby")
    return (x_out, r_out) if want_residual else x_out


def hess_diag_shift_cf(u_cf, cell_mask, ctrl, vert_mask, dx: float,
                       mu: float, la: float, project: bool = True):
    """The multigrid smoother's diagonal blocks: the vertex-diagonal Hessian
    blocks of u_cf (3, X, Y, Z) plus (ctrl + 1 - vert_mask) I,
    SPD-projected (ell.spd_project, eps 1e-6, rel_floor 1e-3) when project;
    returns (6, X, Y, Z), the channels (xx, xy, xz, yy, yz, zz). lat_diag
    with the shift and projection in its vertex pass, under lat_diag_shift's
    plan (one launch on tiles, or two); allocates only its output."""
    _cuda.refuse_grad("lattice_kernels.hess_diag_shift_cf",
                      u_cf, cell_mask, ctrl, vert_mask)
    if _cuda.on_cpu(u_cf, cell_mask, ctrl, vert_mask):
        return hess_diag_shift_cf_plain(u_cf, cell_mask, ctrl, vert_mask, dx,
                                        mu, la, project)
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    out = torch.empty((6, X, Y, Z), dtype=torch.float32, device=u_cf.device)
    return _lat_diag(u_cf, cell_mask, ctrl, vert_mask, project, dx, mu, la,
                     out)


def _start(n: int, device):
    """sin(0, 1, ..., n - 1) in float32, made by torch on the device once per
    (device, n) and kept: the power iteration's start before its mask."""
    key = (str(device), n)
    if key not in _starts:
        _starts[key] = torch.sin(torch.arange(n, dtype=torch.float32,
                                              device=device))
    return _starts[key]


def power_lmax_cf(u_cf, d6, ctrl, vert_mask, cell_mask, dx: float, mu: float,
                  la: float, out=None, slot: int = 0, iters: int = 6):
    """A multigrid level's Chebyshev upper bound: `iters` power iterations
    on D^-1 A (A = level_matvec_cf at u_cf, D the 6-channel blocks d6) from
    vm sin(arange(n)), times 1.1, written to out[slot] (out: a contiguous
    float32 vector on the fields' device; None: a new one of 1) and
    returned as that 0-d view. One launch, in the form lat_level_plan
    picks; the tiles form's scratch is kept per device, stream and
    lattice."""
    if out is None:
        out = torch.empty((1,), dtype=torch.float32, device=u_cf.device)
    if not 0 <= slot < out.numel():
        raise ValueError(f"slot {slot} outside out ({out.numel()} floats)")
    _cuda.refuse_grad("lattice_kernels.power_lmax_cf",
                      u_cf, d6, ctrl, vert_mask, cell_mask, out)
    if _cuda.on_cpu(u_cf, d6, ctrl, vert_mask, cell_mask, out):
        out[slot] = power_lmax_cf_plain(u_cf, d6, ctrl, vert_mask, cell_mask,
                                        dx, mu, la, iters)
        return out[slot]
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    _cuda.require(d6, (6, X, Y, Z), "d6")
    for name, t in (("ctrl", ctrl), ("vert_mask", vert_mask)):
        _cuda.require(t, (X, Y, Z), name)
    _cuda.require(out, (out.numel(),), "out")
    if iters < 1:
        raise ValueError(f"iters {iters}: lat_power takes at least one")
    lib = _cuda.load()
    dev = u_cf.device
    plan = _level_plan(lib, X, Y, Z, dev, POWER, int(iters))
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    n = X * Y * Z
    start = _start(n, dev)
    xs, part, pbuf = _level_scratch(dev, tail[-1], X, Y, Z)
    with torch.cuda.device(dev):
        err = lib.lat_power(
            u_cf.data_ptr(), cell_mask.data_ptr(), ctrl.data_ptr(),
            vert_mask.data_ptr(), d6.data_ptr(), start.data_ptr(),
            out.data_ptr() + 4 * slot, xs, part, pbuf, int(iters), *plan,
            *tail)
    launches["power"] += 1
    _count_level("power", (X, Y, Z), plan[0])
    _cuda.check(err, "lat_power")
    return out[slot]
