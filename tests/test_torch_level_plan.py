"""The launch plan of the multigrid's level kernels lat_cheby and lat_power, on the CPU.

`level_plan` mirrors lat_level_plan in csrc/lattice_kernels.cu: for each
call it picks a cluster of up to 16 blocks whose tiles are z-slabs, or a
cooperative launch of halo tiles, each block keeping its tile's fields in
shared memory for the whole call. These tests check, without a card, that
every launch the plan weighs gives each vertex to exactly one block, that a
block's halo tile holds every cell around its vertices, that the shared
layout fits a block, what the plan picks at the main paths' multigrid
levels, and that the wrappers raise when the C entry reports a failed
launch.
"""
import contextlib

import numpy as np
import pytest
import torch

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.ops import _cuda
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import lattice as tlat
from fem_simulation_tpu_torch.sim import lattice_mg as tmg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


H100_SMS = 132
H100_SMEM = 232448           # the shared memory a block may opt in to
H100_SM_SMEM = 228 * 1024    # an SM's, 1 KB of it reserved a block
# the vertex lattices of LatticeMG(n_levels=3) on the main paths' beams
# (mesh.beam(..., dx=0.05): 8x8x24, 16x16x64 and 16x16x256 cells)
LEVELS = {
    "2k fine": (9, 9, 25), "2k level 1": (5, 5, 13), "2k level 2": (3, 3, 7),
    "19k fine": (17, 17, 65), "19k level 1": (9, 9, 33),
    "19k level 2": (5, 5, 17),
    "74k fine": (17, 17, 257), "74k level 1": (9, 9, 129),
    "74k level 2": (5, 5, 65),
}
# the calls the V-cycle and the linearization make on a level: (kernel,
# sweeps, warm, residual); the coarsest level takes "coarse" for "pre" and
# "post"
CALLS = {"pre": (lk.CHEBY, 2, False, True), "post": (lk.CHEBY, 2, True, False),
         "coarse": (lk.CHEBY, 12, False, False),
         "power": (lk.POWER, 6, False, False)}


def _calls(label):
    coarsest = label.endswith("level 2")
    return [c for c in CALLS if (c == "coarse") == coarsest or c == "power"]


def test_levels_are_the_multigrid_hierarchy():
    """LEVELS holds the level shapes LatticeMG builds on the 2k beam (the
    larger beams' come from the same halving)."""
    sc = tlat.LatticeScene(meshlib.beam(8, 8, 24, dx=0.05), device="cpu")
    mg = tmg.LatticeMG(sc, n_levels=3, dt=None)
    got = [tuple(lvl.vert_mask.shape) for lvl in mg.levels]
    assert got == [LEVELS[f"2k {k}"] for k in ("fine", "level 1", "level 2")]
    for beam in ("19k", "74k"):
        fine = LEVELS[f"{beam} fine"]
        for k, name in enumerate(("level 1", "level 2"), start=1):
            assert LEVELS[f"{beam} {name}"] == tuple(
                (n - 1) // 2 ** k + 1 for n in fine)


def _axis_partition(n, nt):
    """[(v0, nv, c0, nc)] of the tiles along an axis (tile_axis)."""
    return [lk.tile_axis(n, nt, it) for it in range(nt)]


@pytest.mark.parametrize("label", sorted(LEVELS))
def test_every_launch_owns_each_vertex_once(label):
    """Every (form, tiles) the plan weighs, for every call at a path level:
    the tiles' vertex ranges along each axis follow one another from 0 to
    n, so each vertex of the lattice belongs to exactly one block; the
    cluster form takes z-slabs of at most 16 blocks, lat_power's tiles never
    split y, the cooperative forms have at most one block an SM; the
    exchange form is the only one where the first form took it (the 74k
    fine level)."""
    shape = LEVELS[label]
    for call in _calls(label):
        kernel, sweeps, warm, res = CALLS[call]
        cands = lk.level_candidates(shape, H100_SMS, kernel, sweeps, warm,
                                    res)
        forms = {form for _, form, _ in cands}
        assert forms == ({lk.LEVEL_EXCHANGE} if label == "74k fine"
                         else forms - {lk.LEVEL_EXCHANGE}), (call, forms)
        assert lk.LEVEL_TILES in forms or lk.LEVEL_EXCHANGE in forms
        for _, form, tiles in cands:
            blocks = tiles[0] * tiles[1] * tiles[2]
            if form == lk.LEVEL_CLUSTER:
                assert tiles[:2] == (1, 1), (call, form, tiles)
            if kernel == lk.POWER:
                assert tiles[1] == 1, (call, form, tiles)
            assert blocks <= (lk.LEVEL_MAX_CLUSTER if form == lk.LEVEL_CLUSTER
                              else H100_SMS)
            owners = np.zeros(shape, np.int64)
            parts = [_axis_partition(n, nt) for n, nt in zip(shape, tiles)]
            for (x0, nx, _, _) in parts[0]:
                for (y0, ny, _, _) in parts[1]:
                    for (z0, nz, _, _) in parts[2]:
                        owners[x0:x0 + nx, y0:y0 + ny, z0:z0 + nz] += 1
            assert (owners == 1).all(), (call, form, tiles)


@pytest.mark.parametrize("label", sorted(LEVELS))
def test_tiles_hold_the_cells_their_vertices_need(label):
    """For every tiling the plan weighs at a path level, along each axis:
    a halo tile's cells hold both cells around each of its vertices (so its
    vertex sums are complete in its block); the exchange form's tiles own
    the cells whose lowest corner they own, each cell once, and their boxes
    hold their own vertices; every box lies in the lattice, and the shared
    layout's box, cells and own vertices are those of the largest tile."""
    shape = LEVELS[label]
    seen = set()
    for call in _calls(label):
        kernel, sweeps, warm, res = CALLS[call]
        for _, form, tiles in lk.level_candidates(shape, H100_SMS, kernel,
                                                  sweeps, warm, res):
            halo = form != lk.LEVEL_EXCHANGE
            if (halo, tiles) in seen:
                continue
            seen.add((halo, tiles))
            box, cells, stride, own, _ = lk.level_layout(shape, tiles, halo)
            ext, most = [], []
            for n, nt in zip(shape, tiles):
                parts = [(v0, nv, c0, nc) if halo else
                         (v0, nv, v0, min(v0 + nv - 1, n - 2) - v0 + 1)
                         for v0, nv, c0, nc in _axis_partition(n, nt)]
                for v0, nv, c0, nc in parts:
                    if halo:
                        lo, hi = max(v0 - 1, 0), min(v0 + nv - 1, n - 2)
                        assert c0 <= lo and c0 + nc - 1 >= hi, (tiles, v0)
                    assert c0 >= 0 and c0 + nc <= n - 1
                    assert c0 <= v0 and c0 + nc + 1 >= v0 + nv
                if not halo:
                    assert [c for _, _, c0, nc in parts
                            for c in range(c0, c0 + nc)] == list(range(n - 1))
                ext.append(max(nc for _, _, _, nc in parts))
                most.append(max(nv for _, nv, _, _ in parts))
            assert cells == ext[0] * ext[1] * ext[2] and stride == cells | 1
            assert box == (ext[0] + 1) * (ext[1] + 1) * (ext[2] + 1)
            assert own == most[0] * most[1] * most[2]


@pytest.mark.parametrize("label", sorted(LEVELS))
def test_shared_layout_fits_a_block(label):
    """Every launch the plan weighs, the picks among them, fits a block's
    shared memory with room for the kernel's static shared memory; the
    cluster form is weighed wherever 16 blocks hold the level (the levels
    of up to ~10k vertices) and not at the 19k and 74k fine levels."""
    shape = LEVELS[label]
    for call in _calls(label):
        kernel, sweeps, warm, res = CALLS[call]
        cands = lk.level_candidates(shape, H100_SMS, kernel, sweeps, warm,
                                    res)
        for _, form, tiles in cands:
            nbytes = lk.level_layout(shape, tiles, form != lk.LEVEL_EXCHANGE,
                                     kernel == lk.POWER)[4]
            assert nbytes <= lk.LEVEL_SMEM_CAP <= H100_SMEM
            assert nbytes + 1024 <= H100_SM_SMEM
        clusters = [t for _, f, t in cands if f == lk.LEVEL_CLUSTER]
        assert bool(clusters) == (not label.endswith("fine")
                                  or label == "2k fine"), (label, call)
        form, *tiles = lk.level_plan(shape, H100_SMS, kernel, sweeps, warm,
                                     res)
        assert (form, tuple(tiles)) in {(f, t) for _, f, t in cands}


# what the plan picks at each level of the main paths for the calls made
# there: (form, tiles)
PICKS = {
    "2k fine": {"pre": ("tiles", (4, 4, 8)), "post": ("tiles", (4, 4, 8)),
                "power": ("tiles", (4, 1, 24))},
    "2k level 1": {"pre": ("tiles", (4, 4, 6)), "post": ("tiles", (4, 4, 6)),
                   "power": ("tiles", (4, 1, 12))},
    "2k level 2": {"coarse": ("cluster", (1, 1, 6)),
                   "power": ("cluster", (1, 1, 6))},
    "19k fine": {"pre": ("tiles", (4, 4, 8)), "post": ("tiles", (4, 4, 8)),
                 "power": ("tiles", (4, 1, 32))},
    "19k level 1": {"pre": ("tiles", (4, 4, 8)), "post": ("tiles", (4, 4, 8)),
                    "power": ("tiles", (4, 1, 32))},
    "19k level 2": {"coarse": ("tiles", (4, 4, 8)),
                    "power": ("tiles", (4, 1, 16))},
    "74k fine": {"pre": ("exchange", (4, 4, 8)),
                 "post": ("exchange", (4, 4, 8)),
                 "power": ("exchange", (4, 1, 33))},
    "74k level 1": {"pre": ("tiles", (2, 1, 64)), "post": ("tiles", (2, 1, 64)),
                    "power": ("tiles", (2, 1, 64))},
    "74k level 2": {"coarse": ("tiles", (2, 1, 64)),
                    "power": ("tiles", (2, 1, 64))},
}


@pytest.mark.parametrize("label", sorted(LEVELS))
def test_plan_picks_at_path_levels(label):
    """The mirror's pick at each level of the main paths on an H100, for
    each call made there: the tiles form (eight lanes a cell, halo tiles)
    nearly everywhere, a cluster of 6 blocks on the 2k beam's 63-vertex
    coarsest level, and the exchange form at the 74k fine level: lat_cheby
    on the first form's 4 x 4 x 8 tiles (its bits), lat_power on 4 x 1 x
    33 (y whole)."""
    shape = LEVELS[label]
    for call, (form, tiles) in PICKS[label].items():
        kernel, sweeps, warm, res = CALLS[call]
        got = lk.level_plan(shape, H100_SMS, kernel, sweeps, warm, res)
        assert (lk.LEVEL_FORMS[got[0]], tuple(got[1:])) == (form, tiles), \
            (call, got)


class _FailingLib:
    """A kernel library whose lat_cheby and lat_power (or lat_level_plan)
    report a CUDA error."""

    def __init__(self, plan_err=0, launch_err=0):
        self.plan_err, self.launch_err, self.calls = plan_err, launch_err, []

    def lat_level_plan(self, X, Y, Z, kernel, sweeps, warm, residual, plan):
        plan[0], plan[1], plan[2], plan[3] = lk.LEVEL_CLUSTER, 1, 1, 2
        return self.plan_err

    def lat_cheby(self, *args):
        self.calls.append(("cheby", args[13:17]))
        return self.launch_err

    def lat_power(self, *args):
        self.calls.append(("power", args[11:15]))
        return self.launch_err

    def lat_error_string(self, err):
        return b"injected"


@pytest.mark.parametrize("kernel", ["cheby", "power"])
@pytest.mark.parametrize("where", ["launch", "plan"])
def test_level_kernels_raise_on_a_failed_launch(monkeypatch, kernel, where):
    """A non-zero code from the C entry (a cluster the card cannot place,
    too little shared memory for the planned tiles) raises in the wrapper;
    it returns nothing and runs neither another form nor the plain
    version."""
    lib = _FailingLib(plan_err=int(where == "plan") * 2,
                      launch_err=int(where == "launch") * 719)
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_cuda, "load", lambda: lib)
    monkeypatch.setattr(_cuda, "_lib", lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(lk, "_level_plans", {})
    monkeypatch.setattr(lk, "_stream", lambda d: 0)
    monkeypatch.setattr(lk, "_level_scratch", lambda *a: (0, 0, 0))
    monkeypatch.setattr(lk, "_start", lambda n, d: torch.zeros(n))

    def refuse(*args, **kwargs):
        raise AssertionError("the plain version ran")
    monkeypatch.setattr(lk, "cheby_smooth_cf_plain", refuse)
    monkeypatch.setattr(lk, "power_lmax_cf_plain", refuse)
    shape = (3, 3, 4)
    u = torch.zeros((3,) + shape)
    d6 = torch.zeros((6,) + shape)
    vm, cm = torch.ones(shape), torch.ones(tuple(n - 1 for n in shape))
    before = dict(lk.launches)
    counted = dict(lk.level_launches)
    with pytest.raises(RuntimeError, match="injected"):
        if kernel == "cheby":
            lk.cheby_smooth_cf(u, u, None, d6, vm, vm, cm, 0.05, 1.0, 1.0,
                               lk.cheby_coeffs(np.float32(2.0), 2), True)
        else:
            lk.power_lmax_cf(u, d6, vm, vm, cm, 0.05, 1.0, 1.0)
    if where == "launch":
        assert lib.calls == [(kernel, (lk.LEVEL_CLUSTER, 1, 1, 2))]
        assert lk.launches[kernel] == before[kernel] + 1
        key = (kernel, shape, "cluster")
        assert lk.level_launches[key] == counted.get(key, 0) + 1
    else:
        assert lib.calls == [] and lk.launches[kernel] == before[kernel]
        assert lk.level_launches == counted
