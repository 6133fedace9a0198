"""The distributed multigrid's Newton state in z-slabs (the port's
`_state_sharding`, DistLatticeMG.place / unplace) against the JAX package's
sharded-state make_dist_mg_* and the port's whole-state path (CPU).

The scene is the 3x3x23 beam at dx 0.1: Z = 24 vertex planes divide 2 and
4 slabs, so the state is placed; its 3-level hierarchies pad z to 32 at
both, so the state's slab boundaries (Z / D planes) and the fine level's
(Zp / D) differ, and `place` commits the state to the level's. JAX runs on
a mesh of D virtual CPU devices, the port on a grid of D CPU entries (the
kernels' plain versions). The placed solves are held to the distributed
float32 policy: equal Newton counts, ||f||_inf within 1e-3 relative +
5e-6 a solve or frame, x within 1e-4 along the trajectory. Each JAX
reference is computed once, in a module fixture (two compiles).
"""
import numpy as np
import pytest
import jax
import torch

from fem_simulation_tpu import mesh as jmeshlib
from fem_simulation_tpu.parallel import lattice_mg_dist as jmgd
from fem_simulation_tpu.sim import lattice as jl

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.parallel import make_device_mesh
from fem_simulation_tpu_torch.parallel import lattice_mg_dist as mgd
from fem_simulation_tpu_torch.parallel.slab_field import SlabField
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


BEAM = (3, 3, 23)
SLABS = (2, 4)
FRAMES = 3


def assert_fn_close(got, ref, what=""):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= 1e-3 * abs(ref) + 5e-6, (what, got, ref)


def _mesh(D):
    return jax.sharding.Mesh(np.array(jax.devices()[:D]), ("sp",))


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's placed quasi-static solve at 4 slabs and its first FRAMES
    frames of the dynamic step at 2 slabs, both with 3 levels (the two
    hierarchies are the same: z padded to 32 at either slab count)."""
    sc = jl.LatticeScene(jmeshlib.beam(*BEAM, dx=0.1))
    solve, place = jmgd.make_dist_mg_quasistatic(sc, _mesh(4), n_levels=3)
    x0 = place(sc.x0)
    assert len(x0.sharding.device_set) == 4
    xq, kq, fq = solve(x0)
    out = {"quasistatic": dict(x=np.asarray(xq), k=int(kq), f=float(fq))}
    step, place = jmgd.make_dist_mg_step(sc, _mesh(2), n_levels=3)
    st = place(sc.init_state())
    frames = []
    for _ in range(FRAMES):
        st, k, f = step(st)
        frames.append((np.asarray(st.x), int(k), float(f)))
    out["frames"] = frames
    return out


@pytest.fixture(scope="module")
def scene():
    return tl.LatticeScene(meshlib.beam(*BEAM, dx=0.1), device="cpu")


@pytest.fixture(scope="module")
def runs(scene):
    """run(D): the port's placed quasi-static solve from rest and FRAMES
    frames of its placed dynamic step on D slabs, each with the same code
    on the whole state, each case run once in the module."""
    done = {}

    def run(D):
        if D in done:
            return done[D]
        grid = make_device_mesh(D, dp=1, device="cpu")
        solve, place = mgd.make_dist_mg_quasistatic(scene, grid, n_levels=3)
        mg = solve.mg
        xp = place(scene.x0)
        cross0 = dict(mg.crossings)
        xq, kq, fq = solve(xp)
        cross = {k: mg.crossings[k] - cross0[k] for k in cross0}
        quasi = dict(x=solve.unplace(xq), placed=xq, k=kq, f=fq,
                     crossings=cross, whole=solve(scene.x0), mg=mg, xp=xp)
        step, place_s = mgd.make_dist_mg_step(scene, grid, n_levels=3)
        st, stw = place_s(scene.init_state()), scene.init_state()
        frames, whole = [], []
        for _ in range(FRAMES):
            st, k, f = step(st)
            stw, kw, fw = step(stw)
            frames.append((step.unplace(st).x, k, f))
            whole.append((stw.x, kw, fw))
        done[D] = dict(quasi=quasi, frames=frames, whole_frames=whole,
                       state=st, step=step)
        return done[D]
    return run


@pytest.mark.parametrize("D", SLABS)
def test_place_commits_the_state_to_the_fine_level_slabs(scene, runs, D):
    """place puts all four LatState fields, channel-first and padded, in
    the fine level's slabs (whose boundaries differ from Z / D); unplace
    brings them back bit for bit; the step returns the state placed."""
    r = runs(D)
    mg = r["quasi"]["mg"]
    assert mg.placed and mg.pad_shape[2] == 32 and scene.shape[2] == 24
    assert mg.pad_shape[2] // D != scene.shape[2] // D
    step = r["step"]
    before = dict(step.mg.crossings)
    st0 = scene.init_state()
    st0 = st0._replace(v=torch.from_numpy(np.random.default_rng(1).normal(
        size=tuple(scene.x0.shape)).astype(np.float32)))
    placed = step.mg.place(st0)
    assert step.mg.crossings["place"] - before["place"] == 4
    X, Y, Zp = step.mg.pad_shape
    for f, chans in zip(placed, ((3,), (3,), (), (3,))):
        assert isinstance(f, SlabField)
        for (a, b), part in zip(step.mg.layout.groups, f.parts):
            assert part.shape == (b - a,) + chans + (X, Y, Zp // D)
            assert part.is_contiguous()
    back = step.unplace(placed)
    assert step.mg.crossings["unplace"] - before["unplace"] == 4
    for a, b in zip(back, st0):
        assert torch.equal(a, b)
    assert all(isinstance(f, SlabField) for f in r["state"])


@pytest.mark.parametrize("D", SLABS)
def test_placed_quasistatic_matches_jax_and_whole(jax_ref, runs, D):
    q = runs(D)["quasi"]
    assert isinstance(q["placed"], SlabField)
    ref = jax_ref["quasistatic"]
    assert q["f"] <= 1e-4 and q["k"] == ref["k"]
    assert_fn_close(q["f"], ref["f"], "jax")
    np.testing.assert_allclose(q["x"].numpy(), ref["x"], atol=1e-4)
    xw, kw, fw = q["whole"]
    assert torch.is_tensor(xw) and kw == q["k"]
    assert_fn_close(q["f"], fw, "whole")
    np.testing.assert_allclose(q["x"].numpy(), xw.numpy(), atol=1e-4)


@pytest.mark.parametrize("D", SLABS)
def test_placed_step_matches_jax_and_whole(jax_ref, runs, D):
    """FRAMES frames from rest, frame by frame on each trajectory."""
    r = runs(D)
    for i, ((x, k, f), (xj, kj, fj), (xw, kw, fw)) in enumerate(zip(
            r["frames"], jax_ref["frames"], r["whole_frames"])):
        assert f <= 1e-4 and k == kj == kw, (i, k, kj, kw)
        assert_fn_close(f, fj, f"jax frame {i}")
        assert_fn_close(f, fw, f"whole frame {i}")
        np.testing.assert_allclose(x.numpy(), xj, atol=1e-4)
        np.testing.assert_allclose(x.numpy(), xw.numpy(), atol=1e-4)


@pytest.mark.parametrize("D", SLABS)
def test_placed_solve_crosses_no_whole_field(scene, runs, D):
    """A placed solve splits and joins nothing: its outer matvec and every
    V-cycle take slab fields (D = 4 still gathers into and scatters out of
    its replicated coarsest level); a V-cycle and an outer matvec alone
    cross split 0, join 0."""
    q = runs(D)["quasi"]
    mg = q["mg"]
    c = q["crossings"]
    assert c["split"] == c["join"] == 0, c
    assert c["place"] == c["unplace"] == 0, c
    replicated = [li for li in range(mg.n_levels) if not mg.sharded(li)]
    assert replicated == ([] if D == 2 else [2])
    assert (c["gather"] > 0) == bool(replicated)
    rng = np.random.default_rng(3)
    du = torch.from_numpy(0.01 * rng.normal(size=tuple(scene.x0.shape))
                          .astype(np.float32)) * scene.vert_mask[..., None]
    x = mg.place(scene.x0 + du)
    ops, _ = mg.newton_ops(x)
    b = mg.state_ops(x).dyn_force(x, x, 0.0, 1.0)
    assert isinstance(b, SlabField)
    g = len(replicated)
    before = dict(mg.crossings)
    y = mg.vcycle(ops, b)
    assert isinstance(y, SlabField)
    assert {k: mg.crossings[k] - before[k] for k in before} == dict(
        split=0, join=0, gather=g, scatter=g, place=0, unplace=0)
    before = dict(mg.crossings)
    assert isinstance(ops[0].matvec(b), SlabField)
    assert all(mg.crossings[k] == before[k] for k in before)


@pytest.mark.parametrize("D", SLABS)
def test_slab_residual_and_energy_equal_whole(scene, runs, D):
    """SlabState's residual (lat_force a slab, folded, with the slab's
    gravity, control and inertia terms), its ||f||_inf (a pmax, bit-equal
    to the whole max of the same field) and its energies (lat_energy a
    slab over its own cells, one psum) against the scene's on the whole
    lattice, at a seeded state."""
    mg = runs(D)["quasi"]["mg"]
    rng = np.random.default_rng(5)
    vm3 = scene.vert_mask[..., None]

    def field(s):
        return torch.from_numpy((s * rng.normal(size=tuple(
            scene.x0.shape))).astype(np.float32)) * vm3
    x, xt = scene.x0 + field(0.02), scene.x0 + field(0.02)
    xp, xtp = mg.place(x), mg.place(xt)
    so, wo = mg.state_ops(xp), mg.state_ops(x)
    assert isinstance(so, mgd.SlabState) and isinstance(wo, tmg.WholeState)
    f = so.dyn_force(xp, xtp, 30.0, 0.5)
    fw = wo.dyn_force(x, xt, 30.0, 0.5)
    got = mg.unplace(f)
    scale = float(fw.abs().max())
    np.testing.assert_allclose(got.numpy(), fw.numpy(), rtol=0,
                               atol=1e-5 * scale)
    assert float(f.inf_norm()) == float(got.abs().max())
    for name, args in (("total_energy", (0.5,)),
                       ("ie_energy", (None, 30.0, 0.5))):
        a = (xp,) + ((xtp,) + args[1:] if args[0] is None else args)
        b = (x,) + ((xt,) + args[1:] if args[0] is None else args)
        e, ew = getattr(so, name)(*a), getattr(wo, name)(*b)
        assert e.dim() == 0
        np.testing.assert_allclose(float(e), float(ew), rtol=1e-5,
                                   err_msg=name)


def test_placed_line_search_rescue_and_load_steps(monkeypatch, scene, runs):
    """On the slabs' energy: a quasi-static solve from a perturbed start
    whose first full step grows the residual (newton_update's Armijo line
    search runs), and the dynamic rescue's Armijo step on the incremental
    potential; a 2-stage load schedule from rest with the Eisenstat-Walker
    forcing and frame_adaptive_mg; each placed against the whole state on
    the same hierarchy."""
    mg = runs(4)["quasi"]["mg"]
    searches = []
    armijo = tl.armijo_step

    def counted(*a, **k):
        searches.append(isinstance(a[1], SlabField))
        return armijo(*a, **k)
    monkeypatch.setattr(tl, "armijo_step", counted)
    rng = np.random.default_rng(0)
    vm3 = scene.vert_mask[..., None]
    x0 = scene.x0 + torch.from_numpy((0.02 * rng.normal(size=tuple(
        scene.x0.shape))).astype(np.float32)) * vm3
    for start, kw in ((x0, dict()),
                      (scene.x0, dict(load_steps=2, cg_forcing="ew"))):
        searches.clear()
        x, k, f = tmg.quasistatic_to_tol_mg(scene, mg, mg.place(start),
                                            **kw)
        xw, k1, f1 = tmg.quasistatic_to_tol_mg(scene, mg, start, **kw)
        assert isinstance(x, SlabField) and k == k1, (kw, k, k1)
        assert f <= 1e-4
        assert_fn_close(f, f1, kw)
        np.testing.assert_allclose(mg.unplace(x).numpy(), xw.numpy(),
                                   atol=1e-4)
        if not kw:
            assert searches.count(True) == searches.count(False) >= 1
    # the rescue: Armijo on the incremental potential along a seeded
    # direction that is too long
    xt = scene.x0 + torch.from_numpy((0.01 * rng.normal(size=tuple(
        scene.x0.shape))).astype(np.float32)) * vm3
    dx = torch.from_numpy((0.5 * rng.normal(size=tuple(
        scene.x0.shape))).astype(np.float32)) * vm3
    xp, xtp, dxp = mg.place(scene.x0), mg.place(xt), mg.place(dx)
    so, wo = mg.state_ops(xp), mg.state_ops(scene.x0)
    got = armijo(lambda e: so.ie_energy(e, xtp, 30.0, 1.0), xp,
                 so.dyn_force(xp, xtp, 30.0, 1.0), dxp, so.vmask3)
    ref = armijo(lambda e: wo.ie_energy(e, xt, 30.0, 1.0), scene.x0,
                 wo.dyn_force(scene.x0, xt, 30.0, 1.0), dx, wo.vmask3)
    assert not torch.equal(ref, scene.x0 + dx * vm3)
    np.testing.assert_allclose(mg.unplace(got).numpy(), ref.numpy(),
                               atol=1e-6)
    sa, ka, fa, na = tmg.frame_adaptive_mg(scene, mg,
                                           mg.place(scene.init_state()))
    sw, kaw, faw, naw = tmg.frame_adaptive_mg(scene, mg, scene.init_state())
    assert isinstance(sa.x, SlabField) and (ka, na) == (kaw, naw)
    assert_fn_close(fa, faw, "adaptive")
    np.testing.assert_allclose(mg.unplace(sa).x.numpy(), sw.x.numpy(),
                               atol=1e-4)


@pytest.mark.parametrize("D", (1, 2, 4))
def test_state_sharding_rule_equals_jax(D):
    grid = make_device_mesh(D, dp=1, device="cpu")
    want = jax.sharding.PartitionSpec(None, None, "sp", None)
    for z in range(20, 34):
        _, s_v = jmgd._state_sharding(_mesh(D), "sp", z)
        assert mgd._state_sharding(grid, "sp", z) == (s_v.spec == want), z
