"""The launch plans of the standalone force, hvp, diagonal and energy kernels, on the CPU.

`force_plan` picks what `lat_force` runs, `hvp_plan` what `lat_hvp` runs
and `diag_plan` what `lat_diag` and `lat_diag_shift` run: one launch on
halo tiles of the vertex lattice (one block a tile; `tile_axis` mirrors the
kernel's own partition), or the two passes where its model says halo cells
cost more.
These tests check, without a card, that every tiling the plan can pick
covers the lattice as the kernel's vertex pass needs (every vertex in one
tile, every cell incident to a tile's vertices among the tile's cells,
the tile within the kernel's shared memory), what the plans pick on the
main path's beams, and that the wrappers keep their plain path on CPU
tensors.
"""
import itertools

import numpy as np
import pytest
import torch

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.ops import stencil


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
BEAMS = {"2k": (9, 9, 25), "19k": (17, 17, 65), "74k": (17, 17, 257)}
ODD = {"odd": (4, 6, 8), "x2": (2, 9, 5), "y2": (7, 2, 6), "z2": (5, 4, 2),
       "cube2": (2, 2, 2)}


def _check_tiling(plan, shape, box_floats=4, rows=lk.FORCE_ROWS,
                  smem_floats=lk.FORCE_SMEM_FLOATS, fixed_stride=0):
    ntiles, ntx, nty, ntz, stride, box = plan
    assert ntiles == ntx * nty * ntz
    assert rows * (fixed_stride or stride) + box_floats * box <= smem_floats
    assert not fixed_stride or stride <= fixed_stride
    owner = np.zeros(shape, np.int64)
    for it in itertools.product(range(ntx), range(nty), range(ntz)):
        axes = [lk.tile_axis(n, nt, i)
                for n, nt, i in zip(shape, (ntx, nty, ntz), it)]
        verts = [range(v0, v0 + nv) for v0, nv, _, _ in axes]
        cells = [range(c0, c0 + nc) for _, _, c0, nc in axes]
        # the kernel's scratch and box hold the tile's cells
        ext = [len(r) for r in cells]
        assert ext[0] * ext[1] * ext[2] <= stride
        assert (ext[0] + 1) * (ext[1] + 1) * (ext[2] + 1) <= box
        owner[np.ix_(*verts)] += 1
        # every cell incident to one of the tile's vertices is its own
        for a in range(3):
            assert cells[a].start <= max(verts[a].start - 1, 0)
            assert cells[a].stop >= min(verts[a].stop, shape[a] - 1)
    assert (owner == 1).all(), "a vertex in no tile or in two"


@pytest.mark.parametrize("label", sorted(BEAMS) + sorted(ODD))
def test_force_plan_covers_every_vertex_once(label):
    """The best halo tiling on an H100 covers every vertex exactly once,
    holds every cell incident to its vertices and fits the kernel's shared
    memory; the plan takes it unless the two passes cost less by the
    model."""
    shape = {**BEAMS, **ODD}[label]
    tiling = lk.best_force_tiling(*shape, H100_SMS)
    _check_tiling(tiling, shape)
    plan = lk.force_plan(*shape, H100_SMS)
    two = lk.force_cost(lk.FORCE_TWO_PASS, shape, H100_SMS)
    one = lk.force_cost(tiling, shape, H100_SMS)
    assert plan == (lk.FORCE_TWO_PASS if two < one else tiling)


@pytest.mark.parametrize("shape", [(4, 6, 8), (3, 5, 4), (2, 9, 5),
                                   (7, 2, 6), (5, 4, 2), (2, 2, 2),
                                   (9, 9, 10), (3, 3, 17), (6, 7, 8),
                                   (17, 3, 3)])
def test_every_fitting_tiling_covers_the_lattice(shape):
    """Not only the plan's pick: every tiling of these lattices that fits,
    with tile counts up to the vertex counts (tiles of one vertex
    included)."""
    n = 0
    for tiles in itertools.product(*(sorted({1, 2, 3, s}) for s in shape)):
        plan = lk.force_tiling(shape, tiles)
        if plan is not None:
            _check_tiling(plan, shape)
            n += 1
    assert n > 0


def test_plans_on_the_main_path_beams():
    """On the main path's beams the force plan takes one launch on ~a tile
    an SM at 2k and 19k (a block per 256 cells would fill 6 and 64) and
    the two passes at 74k; the energy plan eight lanes a cell at 2k and a
    thread a cell from 19k up, a cell a thread at most twice."""
    for label in ("2k", "19k"):
        plan = lk.force_plan(*BEAMS[label], H100_SMS)
        assert 0.95 * H100_SMS <= plan[0] <= H100_SMS
    assert lk.force_plan(*BEAMS["74k"], H100_SMS) == lk.FORCE_TWO_PASS
    assert lk.energy_plan(*BEAMS["2k"], H100_SMS) == (48, 1)
    assert lk.energy_plan(*BEAMS["19k"], H100_SMS) == (64, 0)
    assert lk.energy_plan(*BEAMS["74k"], H100_SMS) == (256, 0)
    assert lk.energy_plan(2, 2, 2, H100_SMS) == (1, 1)


# the level shapes of the beams' 3-level multigrid hierarchies
LEVELS = {"2k": ((9, 9, 25), (5, 5, 13), (3, 3, 7)),
          "19k": ((17, 17, 65), (9, 9, 33), (5, 5, 17)),
          "74k": ((17, 17, 257), (9, 9, 129), (5, 5, 65))}


@pytest.mark.parametrize("label", sorted(LEVELS))
def test_hvp_plan_on_the_level_shapes(label):
    """On an H100 the hvp plan takes the two passes at the 19k and 74k fine
    levels, where they measured faster, and one launch on halo tiles at
    every other level shape; each tiling covers every vertex once, holds
    the cells around its vertices and fits the shared memory with u and p
    staged (8 floats a box vertex)."""
    for li, shape in enumerate(LEVELS[label]):
        plan = lk.hvp_plan(*shape, H100_SMS)
        if li == 0 and label != "2k":
            assert plan == lk.FORCE_TWO_PASS, shape
        else:
            _check_tiling(plan, shape, lk.HVP_MODEL.box_floats)


# the distributed multigrid's sharded-level slabs (4 slabs; z + 2 ghost
# planes) at 19k and 74k, its replicated coarsest level at 19k (8 planes a
# slab), and the 74k halo step's slab
SLABS = ((17, 17, 22), (9, 9, 12), (5, 5, 7), (17, 17, 70), (9, 9, 36),
         (5, 5, 19), (5, 5, 20), (17, 17, 67))


@pytest.mark.parametrize("kernel", ["diag", "diag_shift"])
def test_diag_plan_on_the_launched_shapes(kernel):
    """On an H100, lat_diag's plan (lat_diag_shift's: under its own model)
    takes the two passes at the 74k beam, where they measured faster, and
    one launch on halo tiles at every other shape a main path launches it
    at; each tiling covers every vertex once, holds the cells around its
    vertices and fits the tiles' shared memory (48 rows of corner sums, u
    staged)."""
    model = lk.DIAG_SHIFT_MODEL if kernel == "diag_shift" else lk.DIAG_MODEL
    shapes = [s for levels in LEVELS.values() for s in levels] + list(SLABS)
    for shape in shapes:
        plan = lk.diag_plan(*shape, H100_SMS, model)
        if shape == BEAMS["74k"]:
            assert plan == lk.FORCE_TWO_PASS, shape
        else:
            _check_tiling(plan, shape, model.box_floats, model.rows,
                          model.smem_floats, model.fixed_stride)
            assert plan == lk.best_force_tiling(*shape, H100_SMS, model)
    assert lk.diag_plan(*BEAMS["19k"], H100_SMS) == lk.diag_plan(
        *BEAMS["19k"], H100_SMS, lk.DIAG_MODEL)


def test_hess_diag6_is_the_blocks_channels_on_cpu():
    """hess_diag6_cf (the slab paths' entry) on CPU tensors is the upper
    triangle of hess_diag_cf's blocks, bit for bit; each call returns a
    tensor of its own (the slabs of one shape must not alias each other);
    nothing is launched."""
    from fem_simulation_tpu_torch.sim.lattice import LatticeScene
    sc = LatticeScene(meshlib.beam(3, 4, 6, dx=0.1), device="cpu")
    rng = np.random.default_rng(4)
    u = torch.from_numpy(0.03 * rng.standard_normal(
        (3,) + tuple(sc.vert_mask.shape)).astype(np.float32))
    before = dict(lk.launches)
    d6 = lk.hess_diag6_cf(u, sc.cell_mask, 0.1, 250.0, 37.0)
    again = lk.hess_diag6_cf(u, sc.cell_mask, 0.1, 250.0, 37.0)
    blocks = lk.hess_diag_cf(u, sc.cell_mask, 0.1, 250.0, 37.0)
    assert d6.shape == (6,) + tuple(sc.vert_mask.shape)
    assert torch.equal(d6, lk.sym_channels(blocks))
    assert torch.equal(lk.sym_blocks(d6), blocks)
    assert torch.equal(d6, again)
    assert d6.untyped_storage().data_ptr() != \
        again.untyped_storage().data_ptr()
    assert lk.launches == before


def test_force_and_energy_take_plain_path_on_cpu():
    """force_cf and elastic_energy_lattice on CPU tensors run their plain
    versions and launch nothing; the energy takes the channel-last field as
    the caller holds it, a non-contiguous view included."""
    from fem_simulation_tpu_torch.sim.lattice import LatticeScene
    sc = LatticeScene(meshlib.shell(5, 5, 6, thickness=1, dx=0.1),
                      device="cpu")
    rng = np.random.default_rng(2)
    u = torch.from_numpy(0.03 * rng.standard_normal(
        tuple(sc.x0.shape)).astype(np.float32)) * sc.vert_mask[..., None]
    g, det = stencil.lattice_material_tables(0.1)
    before = dict(lk.launches)
    f = lk.force_cf(u.permute(3, 0, 1, 2).contiguous(), sc.cell_mask, 0.1,
                    250.0, 37.0)
    ref = stencil.elastic_force_lattice(u, sc.cell_mask, g, det, 250.0, 37.0)
    assert torch.equal(f, ref.permute(3, 0, 1, 2))
    view = u.permute(3, 0, 1, 2).contiguous().permute(1, 2, 3, 0)
    assert not view.is_contiguous()
    e = lk.elastic_energy_lattice(view, sc.cell_mask, 0.1, 250.0, 37.0)
    assert float(e) == float(stencil.elastic_energy_lattice(
        u, sc.cell_mask, g, det, 250.0, 37.0))
    assert lk.launches == before
