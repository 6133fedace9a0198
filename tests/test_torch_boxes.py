"""The port's low-fill lattice path (ops/boxes.py) against the JAX box cover,
on the CPU.

The port covers a sparse mask with the active tiles of a launch plan and
the sorted real cells; the JAX package with tight boxes (tests/test_boxes.py).
Both compute a partition of the real cells and vertex sums over each
vertex's incident cells, so the covered scene is held to the JAX box path
(use_pallas=False, box_quantum (1, 1, 8), as tests/test_boxes.py builds it)
and, bit for bit up to the sign of zero, to the port's own dense force. On
CPU tensors the kernel wrappers run their plain versions over the cover.
Inputs are made with numpy from a seed; the JAX references are built once,
in a module fixture.
"""
import itertools

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as jmeshlib
from fem_simulation_tpu.sim import lattice as jlat

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.ops import boxes
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import lattice as tlat


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SHELL = (20, 20, 20)
DX = 0.05


def _shell(lib):
    return lib.shell(*SHELL, thickness=2, dx=DX)


@pytest.fixture(scope="module")
def scenes():
    """(JAX box scene, covered port scene, dense port scene) of the 20^3
    shell; the threshold forces both covers on at this size."""
    js = jlat.LatticeScene(_shell(jmeshlib), box_threshold=2.0,
                           box_quantum=(1, 1, 8))
    sc = tlat.LatticeScene(_shell(meshlib), device="cpu", box_threshold=2.0)
    dense = tlat.LatticeScene(_shell(meshlib), device="cpu", use_boxes=False)
    return js, sc, dense


@pytest.fixture(scope="module")
def displaced(scenes):
    """x = x0 + 0.01 noise on the real vertices, as numpy."""
    js = scenes[0]
    rng = np.random.default_rng(0)
    noise = 0.01 * rng.standard_normal(js.x0.shape).astype(np.float32)
    return (np.asarray(js.x0) + noise
            * np.asarray(js.vert_mask)[..., None]).astype(np.float32)


@pytest.fixture(scope="module")
def jax_solves(scenes):
    """The JAX box path's first frame from rest and quasi-static solve."""
    js = scenes[0]
    st, k, fn = jax.jit(lambda s: jlat.step_to_tol(
        js, s, tol=1e-4, max_newton=10, use_pallas=False))(js.init_state())
    x, kq, fq = jax.jit(lambda xx: jlat.quasistatic_to_tol(
        js, xx, tol=1e-4, max_newton=100, use_pallas=False))(js.x0)
    return (np.asarray(st.x), int(k), float(fn)), (np.asarray(x), int(kq),
                                                   float(fq))


def _tilings(shape):
    """The fused Newton tiling of the lattice and a few others."""
    X, Y, Z = shape
    return [lk.newton_tiling(X, Y, Z, boxes.PLAN_SMS)[0][1:4], (1, 1, 1),
            (3, 2, 5), (X - 1, 4, Z - 1), (7, 7, 7)]


def _tile_cells(shape, tiling, t):
    """The halo cell box of tile t as slices (lattice_kernels.tile_axis)."""
    ntx, nty, ntz = tiling
    it = ((t // ntz) // nty, (t // ntz) % nty, t % ntz)
    axes = [lk.tile_axis(n, nt, i) for n, nt, i in zip(shape, tiling, it)]
    return (tuple(slice(c0, c0 + nc) for _, _, c0, nc in axes),
            tuple(slice(v0, v0 + nv) for v0, nv, _, _ in axes))


def test_cover_covers_every_real_cell(scenes):
    """Port of test_cover_partitions_cells: the real-cell list is the mask's
    cells in order; under each tiling every real cell lies among some
    active tile's cells, no inactive tile holds one, and every real vertex
    lies in an active tile."""
    _, sc, _ = scenes
    cov = sc.cover
    assert cov is not None and sc.box_cost_ratio < 2.0
    cm = sc.cell_mask.numpy() > 0
    np.testing.assert_array_equal(cov.cells, np.flatnonzero(cm))
    assert cov.cells.dtype == np.int32
    vm = sc.vert_mask.numpy() > 0
    for tiling in _tilings(sc.shape):
        order, n_active = cov.tiles(*tiling)
        assert sorted(order.tolist()) == list(range(int(np.prod(tiling))))
        assert list(order[:n_active]) == sorted(order[:n_active])
        covered = np.zeros_like(cm)
        owned = np.zeros_like(vm)
        for j, t in enumerate(order):
            cells, verts = _tile_cells(sc.shape, tiling, int(t))
            if j < n_active:
                covered[cells] = True
                owned[verts] = True
            else:
                assert not cm[cells].any(), (tiling, int(t))
        assert covered[cm].all() and owned[vm].all(), tiling
        counts = cov.active_counts(tiling[0], tiling[1], [tiling[2]])
        assert int(counts[0]) == n_active


@pytest.mark.parametrize("cells", [(8, 8, 24), (4, 4, 12)])
def test_beam_keeps_the_dense_path(cells):
    """Port of test_beam_keeps_single_grid: a solid beam has no empty cell,
    so the cover costs what the dense grid costs and stays off, even at a
    threshold that would force it on a sparse mask; its frame calls
    fused_newton without a cover, as before the cover existed."""
    m = meshlib.beam(*cells, dx=DX)
    for threshold in (0.5, 2.0):
        sc = tlat.LatticeScene(m, device="cpu", box_threshold=threshold)
        assert sc.cover is None and sc.box_cost_ratio >= 0.99
    seen = []
    real = lk.fused_newton

    def spy(*args, **kwargs):
        seen.append(kwargs.get("cover"))
        return real(*args, **kwargs)
    lk.fused_newton = spy
    try:
        tlat.step_to_tol(sc, sc.init_state(), tol=1e-4)
    finally:
        lk.fused_newton = real
    assert seen and all(c is None for c in seen)


def test_two_blobs_leave_the_gap_inactive():
    """Port of test_multi_component_cover: two 3^3 blobs 40 cells apart in z.
    Under every tiling a tile whose cells lie in the gap is inactive, and
    the fused Newton plan has such tiles."""
    blob = np.stack(np.meshgrid(np.arange(3), np.arange(3), np.arange(3),
                                indexing="ij"), axis=-1).reshape(-1, 3)
    cells = np.concatenate([blob, blob + np.array([0, 0, 40])])
    m = meshlib.hex_mesh_from_cells(cells, DX, np.zeros(3))
    sc = tlat.LatticeScene(m, device="cpu", use_boxes=False)
    cov = boxes.Cover(sc.cell_mask.numpy())
    assert cov.cells.size == 54
    X, Y, Z = sc.shape
    newton = lk.newton_tiling(X, Y, Z, boxes.PLAN_SMS, cov)[0][1:4]
    for tiling in [newton, (1, 1, Z - 1), (2, 2, 9), (1, 1, 4)]:
        order, n_active = cov.tiles(*tiling)
        in_gap = [j for j, t in enumerate(order) if 3 <= _tile_cells(
            sc.shape, tiling, int(t))[0][2].start
            and _tile_cells(sc.shape, tiling, int(t))[0][2].stop <= 40]
        assert all(j >= n_active for j in in_gap), tiling
        assert in_gap or tiling != newton


def test_shell_engages_at_demo_scale():
    """Port of test_cover_cuts_padded_volume_at_demo_scale: on the 64^3
    shell with 2-cell walls (17.6% of the box's cells) the cover engages at
    the default threshold; the fused Newton plan over it walks well under
    half the tiles."""
    ii, jj, kk = np.meshgrid(*[np.arange(64)] * 3, indexing="ij")
    interior = ((ii >= 2) & (ii < 62) & (jj >= 2) & (jj < 62) & (kk >= 2)
                & (kk < 62))
    cov = boxes.Cover((~interior).astype(np.float32))
    assert cov.cells.size == 46144
    assert cov.cost_ratio(boxes.PLAN_SMS) < 0.5
    plan, _ = lk.newton_tiling(65, 65, 65, boxes.PLAN_SMS, cov)
    _, n_active = cov.tiles(*plan[1:4])
    assert n_active < 0.5 * plan[1] * plan[2] * plan[3]
    assert plan[0] == min(n_active, boxes.PLAN_SMS)


def test_newton_plan_mirror_on_the_main_path_beams():
    """newton_tiling mirrors lat_newton_plan: on an H100 (132 blocks) halo
    tiles at the 2k and 19k beams and exchange tiles at 74k, as the kernel's
    own planner picks them (the card's tests hold the two equal); over a
    cover of a full mask, the dense plan."""
    modes = {(9, 9, 25): 1, (17, 17, 65): 1, (17, 17, 257): 0}
    for shape, halo in modes.items():
        plan, cell_us = lk.newton_tiling(*shape, boxes.PLAN_SMS)
        assert plan[6] == halo and plan[0] <= boxes.PLAN_SMS and cell_us > 0
        full = boxes.Cover(np.ones(tuple(n - 1 for n in shape), np.float32))
        assert lk.newton_tiling(*shape, boxes.PLAN_SMS, full) == (plan,
                                                                 cell_us)
    with pytest.raises(ValueError):
        lk.newton_tiling(2, 2, 2, 1, mode=3)


def test_covered_force_energy_match_jax_and_dense(scenes, displaced):
    """elastic_force within 1e-4 of the JAX box path's and equal to the
    port's dense force up to the sign of zero; elastic_energy within 1e-5
    relative of both."""
    js, sc, dense = scenes
    x = torch.from_numpy(displaced)
    f_ref = np.asarray(jax.jit(lambda xx: js.elastic_force(xx, False))(
        jnp.asarray(displaced)))
    f = sc.elastic_force(x)
    np.testing.assert_allclose(f.numpy(), f_ref, atol=1e-4)
    fd = dense.elastic_force(x)
    assert torch.equal(f, fd)                 # == treats -0 and +0 as equal
    e_ref = float(jax.jit(lambda xx: js.elastic_energy(xx, False))(
        jnp.asarray(displaced)))
    e = float(sc.elastic_energy(x))
    assert e == pytest.approx(e_ref, rel=1e-5)
    assert e == pytest.approx(float(dense.elastic_energy(x)), rel=1e-5)


def test_covered_fused_newton_matches_dense(scenes, displaced):
    """One covered plain Newton iteration against the dense one on the same
    inputs: the residual equal up to the sign of zero, the same PCG count,
    dx and the trial norm within float32 roundoff."""
    _, sc, dense = scenes
    mat = sc.material
    u = torch.from_numpy(displaced) - sc.x0
    rng = np.random.default_rng(5)
    s = torch.from_numpy(rng.standard_normal(tuple(u.shape)).astype(
        np.float32)) * sc.vert_mask[..., None]
    ctrl = mat.control_mag * sc.pin_mask + 30.0 + (1.0 - sc.vert_mask)
    rc = mat.control_mag * sc.pin_mask + 30.0
    args = (u.permute(3, 0, 1, 2).contiguous(),
            s.permute(3, 0, 1, 2).contiguous(), sc.cell_mask, ctrl, rc,
            sc.vert_mask, DX, mat.lame_mu, mat.lame_la, 60, 1e-2)
    dxc, fc, fnc, kc = lk.fused_newton(*args, cover=sc.cover)
    dxd, fd, fnd, kd = lk.fused_newton(*args)
    assert torch.equal(fc, fd)
    assert int(kc) == int(kd) > 2
    scale = float(dxd.abs().max())
    assert float((dxc - dxd).abs().max()) <= 1e-5 * scale
    assert float(fnc) == pytest.approx(float(fnd), rel=1e-4)


def test_covered_frame_matches_jax(scenes, jax_solves):
    """One step_to_tol frame from rest on the covered shell: the JAX box
    path's Newton count, ||f||_inf <= 1e-4, x within 1e-5 of JAX's (the
    JAX test's own tolerance)."""
    _, sc, _ = scenes
    (jx, jk, _), _ = jax_solves
    st, k, fn = tlat.step_to_tol(sc, sc.init_state(), tol=1e-4,
                                 max_newton=10)
    assert k == jk and fn <= 1e-4
    np.testing.assert_allclose(st.x.numpy(), jx, atol=1e-5)


def test_covered_quasistatic_matches_jax(scenes, jax_solves):
    """quasistatic_to_tol from rest on the covered shell: the JAX box path's
    Newton count, at tolerance, x within 1e-5 of JAX's."""
    _, sc, _ = scenes
    _, (jx, jk, _) = jax_solves
    x, k, fn = tlat.quasistatic_to_tol(sc, sc.x0, tol=1e-4, max_newton=100)
    assert k == jk and fn <= 1e-4
    np.testing.assert_allclose(x.numpy(), jx, atol=1e-5)


@pytest.mark.parametrize("entry", ["frame_to_tol", "frame_adaptive_to_tol",
                                   "quasistatic_to_tol"])
def test_entry_points_run_the_cover(entry):
    """LatticeDynamicSim's frames, frame_adaptive under them and
    quasistatic_to_tol pass the scene's cover to every fused_newton, force
    and energy call; the covered frame equals the dense scene's within
    float32 roundoff (x within 1e-6)."""
    m = meshlib.shell(10, 8, 12, thickness=2, dx=DX)
    calls = []
    wrapped = {}
    for name in ("fused_newton", "force_cf", "elastic_energy_lattice"):
        real = getattr(lk, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            calls.append((_name, kwargs.get("cover")))
            return _real(*args, **kwargs)
        wrapped[name] = real
        setattr(lk, name, spy)
    try:
        out = {}
        for use_boxes in (True, False):
            sim = tlat.LatticeDynamicSim(m, device="cpu")
            # forced at this size, as the scenes fixture forces it
            sim.scene = tlat.LatticeScene(m, device="cpu", box_threshold=2.0,
                                          use_boxes=use_boxes)
            sim.state = sim.scene.init_state()
            sc = sim.scene
            assert (sc.cover is not None) == use_boxes
            calls.clear()
            if entry == "quasistatic_to_tol":
                x = tlat.quasistatic_to_tol(sc, sc.x0, tol=1e-4)[0]
            else:
                x = getattr(sim, entry)(tol=1e-4)[0].x
            names = {n for n, _ in calls}
            assert "fused_newton" in names and "force_cf" in names
            assert all((c is sc.cover) for _, c in calls)
            out[use_boxes] = x
    finally:
        for name, real in wrapped.items():
            setattr(lk, name, real)
    np.testing.assert_allclose(out[True].numpy(), out[False].numpy(),
                               atol=1e-6)


def test_cover_plans_cost_only_the_cover():
    """force_plan, energy_plan and newton_tiling over a cover count its
    active tiles and real cells: never more than the dense plan's model,
    and the covered energy walks the real cells."""
    sc = tlat.LatticeScene(_shell(meshlib), device="cpu", use_boxes=False)
    cov = boxes.Cover(sc.cell_mask.numpy())
    X, Y, Z = sc.shape
    sms = boxes.PLAN_SMS
    dense = lk.force_plan(X, Y, Z, sms)
    covered = lk.force_plan(X, Y, Z, sms, cover=cov)

    def cost(plan, cover):
        if plan == lk.FORCE_TWO_PASS:
            return lk.force_cost(plan, sc.shape, sms, n_cells=(
                None if cover is None else cover.cells.size))
        n = None if cover is None else cover.tiles(*plan[1:4])[1]
        return lk.force_cost(plan, sc.shape, sms, n_tiles=n)
    assert cost(covered, cov) <= cost(dense, None)
    for plan in itertools.islice(
            (lk.force_tiling(sc.shape, t) for t in itertools.product(
                (3, 5, 7), (3, 5, 7), (3, 5, 7))), 27):
        if plan is not None:
            assert cost(covered, cov) <= cost(plan, cov) + 1e-9
    assert lk.energy_plan(X, Y, Z, sms, cover=cov) == lk.energy_plan(
        2, 2, cov.cells.size + 1, sms)
    assert lk.newton_tiling(X, Y, Z, sms, cov)[1] <= lk.newton_tiling(
        X, Y, Z, sms)[1]
