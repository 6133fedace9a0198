"""The port's distributed lattice multigrid (parallel/lattice_mg_dist.py) and
LatticeMG's z_multiple hierarchy against the JAX package's (CPU).

JAX's DistLatticeMG runs on a mesh of D virtual CPU devices (its XLA path,
as its own tests run it), the port's on a grid of D CPU entries (the
kernels' plain versions). The level specs and the even-z hierarchies must
equal JAX's; solves are held to the float32 policy of the port's parity
tests (equal Newton counts, ||f||_inf within 1e-3 relative + 5e-6, x
within 1e-4), against JAX and against the port's own LatticeMG with the
same z_multiple on the whole lattice. The 3-level cases cover a sharded
coarse level (D = 2) and a replicated one (D = 4). Each JAX reference is
computed once, in a module fixture.
"""
import numpy as np
import pytest
import jax
import torch

from fem_simulation_tpu import mesh as jmeshlib
from fem_simulation_tpu.parallel import lattice_mg_dist as jmgd
from fem_simulation_tpu.sim import lattice as jl

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.parallel import dist, make_device_mesh
from fem_simulation_tpu_torch.parallel import lattice_mg_dist as mgd
from fem_simulation_tpu_torch.sim import lattice as tl
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


BEAM = (3, 3, 24)
CASES = ((2, 3), (4, 3), (4, 2))      # (slabs, levels)


def assert_fn_close(got, ref, what=""):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= 1e-3 * abs(ref) + 5e-6, (what, got, ref)


def _mesh(D):
    return jax.sharding.Mesh(np.array(jax.devices()[:D]), ("sp",))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's level specs and hierarchies for every case; its quasi-static
    solve at 4 slabs and 3 levels (a replicated coarsest level) and its
    dynamic step at 4 slabs and 2 levels (each solve a compile of ~25-40 s
    of CPU, so one each)."""
    sc = jl.LatticeScene(jmeshlib.beam(*BEAM, dx=0.1))
    out = {}
    for D, nl in CASES:
        mg = jmgd.DistLatticeMG(sc, _mesh(D), n_levels=nl, dt=None)
        out[(D, nl)] = dict(
            specs=[tuple(s) for s in mg.level_specs],
            levels=[{k: np.asarray(getattr(lvl, k)) for k in
                     ("cell_mask", "vert_mask", "ctrl", "mass")}
                    for lvl in mg.levels])
    solve, place = jmgd.make_dist_mg_quasistatic(sc, _mesh(4), n_levels=3)
    xq, kq, fq = solve(place(sc.x0))
    out["quasistatic"] = dict(x=np.asarray(xq), k=int(kq), f=float(fq))
    step, place = jmgd.make_dist_mg_step(sc, _mesh(4), n_levels=2)
    st, k, f = step(place(sc.init_state()))
    out["step"] = dict(x=np.asarray(st.x), k=int(k), f=float(f))
    return out


@pytest.fixture(scope="module")
def scene():
    return tl.LatticeScene(meshlib.beam(*BEAM, dx=0.1), device="cpu")


@pytest.fixture(scope="module")
def dist_solves(scene):
    """solve(D, levels): the port's distributed quasi-static solve from rest
    on D slabs, each case run once in the module: (x, k, fn, its
    DistLatticeMG, the shift exchanges the solve made)."""
    done = {}

    def solve(D, nl):
        if (D, nl) not in done:
            grid = make_device_mesh(D, dp=1, device="cpu")
            run, place = mgd.make_dist_mg_quasistatic(scene, grid, n_levels=nl)
            dist.reset_counts()
            x, k, fn = run(place(scene.x0))
            done[(D, nl)] = (x, k, fn, run.mg, dist.counts["shift"])
        return done[(D, nl)]
    return solve


@pytest.mark.parametrize("case", CASES)
def test_level_specs_and_even_z_hierarchy_equal_jax(jax_ref, scene, case):
    D, nl = case
    grid = make_device_mesh(D, dp=1, device="cpu")
    mg = mgd.DistLatticeMG(scene, grid, n_levels=nl, dt=None)
    ref = jax_ref[case]
    assert mg.level_specs == ref["specs"]
    assert mg.pad_shape[2] % (D * 2 ** (nl - 1)) == 0
    # the whole-lattice LatticeMG builds the same hierarchy
    plain = tmg.LatticeMG(scene, n_levels=nl, dt=None, z_multiple=D)
    for li, (lvl, plvl, rl) in enumerate(zip(mg.levels, plain.levels,
                                             ref["levels"])):
        for k in ("cell_mask", "vert_mask", "ctrl", "mass"):
            got = getattr(lvl, k).numpy()
            assert got.shape == rl[k].shape, (li, k)
            np.testing.assert_allclose(got, rl[k], rtol=1e-6, atol=1e-7,
                                       err_msg=f"level {li} {k}")
            assert torch.equal(getattr(lvl, k), getattr(plvl, k))


@pytest.mark.parametrize("case", CASES)
def test_dist_mg_quasistatic_matches_whole(scene, dist_solves, case):
    """The solve on D slabs against the port's LatticeMG with the same
    z_multiple on the whole lattice."""
    D, nl = case
    x, k, fn, mg, shifts = dist_solves(D, nl)
    assert fn <= 1e-4
    assert mg.calls["matvec"] > 0 and shifts > 0
    plain = tmg.LatticeMG(scene, n_levels=nl, dt=None, z_multiple=D)
    x1, k1, fn1 = tmg.quasistatic_to_tol_mg(scene, plain, scene.x0, tol=1e-4,
                                            max_newton=50)
    assert k1 == k
    assert_fn_close(fn, fn1)
    np.testing.assert_allclose(x.numpy(), x1.numpy(), atol=1e-4)


def test_dist_mg_quasistatic_matches_jax(jax_ref, dist_solves):
    x, k, fn, mg, _ = dist_solves(4, 3)
    assert mg.level_specs[-1] == ()
    ref = jax_ref["quasistatic"]
    assert fn <= 1e-4 and k == ref["k"]
    assert_fn_close(fn, ref["f"])
    np.testing.assert_allclose(x.numpy(), ref["x"], atol=1e-4)


def test_dist_mg_step_matches_jax_and_whole(jax_ref, scene):
    D, nl = 4, 2
    grid = make_device_mesh(D, dp=1, device="cpu")
    step, place = mgd.make_dist_mg_step(scene, grid, n_levels=nl)
    st, k, fn = step(place(scene.init_state()))
    ref = jax_ref["step"]
    assert fn <= 1e-4 and k == ref["k"]
    assert_fn_close(fn, ref["f"])
    np.testing.assert_allclose(st.x.numpy(), ref["x"], atol=1e-4)
    plain = tmg.LatticeMG(scene, n_levels=nl, z_multiple=D)
    st1, k1, fn1 = tmg.step_to_tol_mg(scene, plain, scene.init_state(),
                                      tol=1e-4)
    assert k1 == k
    np.testing.assert_allclose(st.x.numpy(), st1.x.numpy(), atol=1e-4)


@pytest.mark.parametrize("entry", ("step", "quasistatic"))
def test_undivided_z_stays_whole_and_matches_jax(jax_ref, scene, entry):
    """Z = 25 vertex planes divide no slab count: place keeps the input
    whole on the scene's device (the reference's replicated inputs), the
    step and the solve run the whole-state code (WholeState; no place or
    unplace crossing) and return whole fields, held to JAX's make_dist_mg_*
    with its replicated state on the same input."""
    grid = make_device_mesh(4, dp=1, device="cpu")
    assert not mgd._state_sharding(grid, "sp", scene.vert_mask.shape[2])
    if entry == "step":
        run, place = mgd.make_dist_mg_step(scene, grid, n_levels=2)
        given = scene.init_state()
    else:
        run, place = mgd.make_dist_mg_quasistatic(scene, grid, n_levels=3)
        given = scene.x0
    mg = run.mg
    assert not mg.placed
    placed = place(given)
    if entry == "step":
        assert all(a is b for a, b in zip(placed, given))
        x_in = placed.x
    else:
        assert placed is given
        x_in = placed
    assert isinstance(mg.state_ops(x_in), tmg.WholeState)
    out, k, fn = run(placed)
    x = out.x if entry == "step" else out
    assert torch.is_tensor(x) and x.shape == scene.x0.shape
    assert mg.crossings["place"] == mg.crossings["unplace"] == 0
    back = run.unplace(out)
    assert (all(a is b for a, b in zip(back, out)) if entry == "step"
            else back is out)
    ref = jax_ref[entry]
    assert fn <= 1e-4 and k == ref["k"]
    assert_fn_close(fn, ref["f"])
    np.testing.assert_allclose(x.numpy(), ref["x"], atol=1e-4)


@pytest.mark.parametrize("D", (2, 4))
def test_sharded_transfers_equal_whole_level(scene, D):
    """The slab restriction is the whole-level one bit for bit; the slab
    prolongation (z first, as the reference's) within float32 rounding."""
    grid = make_device_mesh(D, dp=1, device="cpu")
    mg = mgd.DistLatticeMG(scene, grid, n_levels=3, dt=None)
    plain = tmg.LatticeMG(scene, n_levels=3, dt=None, z_multiple=D)
    rng = np.random.default_rng(4)
    for li in range(mg.n_levels - 1):
        if not mg.sharded(li):
            continue
        shape = (3,) + tuple(mg.levels[li].vert_mask.shape)
        r = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
        assert torch.equal(mg._restrict(li, r), plain._restrict(li, r))
        cshape = (3,) + tuple(mg.levels[li + 1].vert_mask.shape)
        xc = torch.from_numpy(rng.normal(size=cshape).astype(np.float32))
        np.testing.assert_allclose(mg._prolong(li, xc).numpy(),
                                   plain._prolong(li, xc).numpy(),
                                   rtol=1e-6, atol=1e-6)


def _one_slab_a_group(devices):
    return [(i, i + 1) for i in range(len(devices))]


@pytest.mark.parametrize("D", (2, 4))
def test_slab_field_halo_and_dot_equal_block_lists(monkeypatch, D):
    """SlabField's split / join, extend, fold, neighbour planes and dot
    against the list-of-blocks halo of parallel/lattice_halo.py, bit for
    bit and with the same exchange counts, in one group and in one group a
    slab."""
    from fem_simulation_tpu_torch.parallel import lattice_halo as lh
    from fem_simulation_tpu_torch.parallel import slab_field
    rng = np.random.default_rng(7)
    a = torch.from_numpy(rng.normal(size=(3, 5, 4, 4 * D)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(3, 5, 4, 4 * D)).astype(np.float32))
    blocks = [a[..., d * 4:(d + 1) * 4] for d in range(D)]
    ext_ref = lh.extend(blocks)
    dist.reset_counts()
    lh.fold(lh.extend(blocks))
    counts_ref = dict(dist.counts)
    dot_ref = dist.dot(blocks, [b[..., d * 4:(d + 1) * 4] for d in range(D)])
    for groups in (None, _one_slab_a_group):
        if groups is not None:
            monkeypatch.setattr(slab_field, "slab_groups", groups)
        layout = slab_field.SlabLayout([torch.device("cpu")] * D)
        assert len(layout.groups) == (1 if groups is None else D)
        f = layout.split(a)
        assert torch.equal(f.join("cpu"), a)
        dist.reset_counts()
        ext = f.extend()
        folded = ext.fold()
        assert dist.counts == counts_ref
        for got, ref in zip(ext.slabs(), ext_ref):
            assert torch.equal(got, ref)
        ref = lh.fold([e.clone() for e in ext_ref])
        assert torch.equal(folded.join("cpu"),
                           torch.cat([r[..., 1:-1] for r in ref], -1))
        lo = torch.cat(f.neighbor_plane(+1))
        hi = torch.cat(f.neighbor_plane(-1))
        for d in range(D):
            assert torch.equal(lo[d], ext_ref[d][..., 0])
            assert torch.equal(hi[d], ext_ref[d][..., -1])
        assert torch.equal(f.dot(layout.split(b)), dot_ref)


@pytest.mark.parametrize("D", (2, 4))
def test_dist_mg_grouping_invariant(monkeypatch, scene, dist_solves, D):
    """One slab a device group gives the one-group solve bit for bit."""
    from fem_simulation_tpu_torch.parallel import slab_field
    grid = make_device_mesh(D, dp=1, device="cpu")
    x, k, fn, mg, _ = dist_solves(D, 3)
    assert len(mg.layout.groups) == 1
    monkeypatch.setattr(slab_field, "slab_groups", _one_slab_a_group)
    solve1, place = mgd.make_dist_mg_quasistatic(scene, grid, n_levels=3)
    assert len(solve1.mg.layout.groups) == D
    x1, k1, fn1 = solve1(place(scene.x0))
    assert torch.equal(x1, x) and k1 == k and fn1 == fn


@pytest.mark.parametrize("D", (2, 4))
def test_dist_mg_fields_stay_in_slabs(scene, D):
    """After linearize every field of a sharded level is a slab field on
    its devices; one V-cycle splits its right-hand side once and joins its
    correction once, plus one gather and one scatter into and out of a
    replicated coarsest level (D = 4), whatever nu and coarse_sweeps."""
    from fem_simulation_tpu_torch.parallel.slab_field import SlabField
    grid = make_device_mesh(D, dp=1, device="cpu")
    mg = mgd.DistLatticeMG(scene, grid, n_levels=3, dt=None)
    rng = np.random.default_rng(3)
    du = torch.from_numpy(0.01 * rng.normal(size=tuple(scene.x0.shape))
                          .astype(np.float32)) * scene.vert_mask[..., None]
    ops, _ = mg.newton_ops(mg.pad(scene.x0 + du))
    replicated = [li for li in range(mg.n_levels) if not mg.sharded(li)]
    assert replicated == ([] if D == 2 else [2])
    for li, op in enumerate(ops):
        if not mg.sharded(li):
            assert torch.is_tensor(op.u_cf) and torch.is_tensor(op.d6)
            continue
        X, Y, Z = mg.levels[li].vert_mask.shape
        for name, chans in (("u_cf", (3,)), ("ctrl", ()), ("d6", (6,)),
                            ("vmask", ())):
            f = getattr(op, name)
            assert isinstance(f, SlabField), (li, name)
            for (a, b), part in zip(mg.layout.groups, f.parts):
                assert part.device == mg.devices[a]
                assert part.shape == (b - a,) + chans + (X, Y, Z // D)
                assert part.is_contiguous()
    r = torch.from_numpy(rng.normal(size=(3,) + mg.pad_shape)
                         .astype(np.float32))
    want = dict(split=1, join=1, gather=len(replicated),
                scatter=len(replicated), place=0, unplace=0)
    for nu, sweeps in ((1, 12), (3, 4)):
        mg.nu, mg.coarse_sweeps = nu, sweeps
        before = dict(mg.crossings)
        x = mg.vcycle(ops, r)
        assert torch.is_tensor(x) and x.shape == r.shape
        assert {k: mg.crossings[k] - before[k] for k in before} == want
