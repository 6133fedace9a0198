"""The port's lattice quasi-static solvers, adaptive substepping and lattice
multigrid against the JAX package (CPU).

The same seeded numpy inputs go through the JAX function (its XLA path,
use_pallas=False, as the JAX package's own tests run it) and through the
port on CPU tensors (the kernels' plain versions). Solvers are held to the
float32 policy of the port's parity tests: equal Newton counts (and equal
substep lists), every ||f||_inf within 1e-3 relative + 5e-6 absolute, and
x within 1e-4. Each JAX reference is computed once, in a module fixture.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as meshlib
from fem_simulation_tpu.config import MaterialConfig as JMaterial
from fem_simulation_tpu.ops import ell as jell
from fem_simulation_tpu.ops import stencil as jsten
from fem_simulation_tpu.sim import lattice as jl
from fem_simulation_tpu.sim import lattice_mg as jmg
from fem_simulation_tpu.solvers import cg as jcg

from fem_simulation_tpu_torch.config import DynamicsConfig, MaterialConfig
from fem_simulation_tpu_torch.ops import ell, stencil
from fem_simulation_tpu_torch.sim import lattice as tl
from fem_simulation_tpu_torch.sim import lattice_mg as tmg
from fem_simulation_tpu_torch.solvers import cg as tcg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def assert_fn_close(got, ref, what=""):
    """The float32 policy for residual norms: 1e-3 relative + 5e-6."""
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= 1e-3 * abs(ref) + 5e-6, (what, got, ref)


def assert_x_close(got, ref, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4,
                               err_msg=what)


def assert_rel(got, ref, rtol, what=""):
    got, ref = np.asarray(got), np.asarray(ref)
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (what, err)


def kicked_velocity(x):
    """The violent rigid-rotation kick of tests/test_lattice.py."""
    r = x - x.reshape(-1, 3).mean(0)
    omega = np.array([18.0, 0.0, 6.0], np.float32)
    return np.cross(np.broadcast_to(omega, r.shape), r).astype(np.float32)


def gravity_scale(frame: int) -> float:
    return float(np.cos(np.float32(2.0 * np.pi) * np.float32(frame)
                        / np.float32(16.0)))


@pytest.fixture(scope="module")
def beam7():
    return meshlib.beam(3, 3, 7, dx=0.1)


# -- transfers, forcing, PCG ------------------------------------------------

@pytest.mark.parametrize("fine", [(9, 7, 13), (10, 7, 14)])
def test_transfers_match_jax_and_are_adjoint(fine):
    """prolong_lat / restrict_lat on an odd grid and on one with 2n axes:
    equal to the JAX package's to 1e-6 relative, and <P xc, xf> ==
    <xc, R xf> to 1e-6 relative."""
    rng = np.random.default_rng(3)
    coarse = tuple((n + 1) // 2 for n in fine)
    xc = rng.normal(size=coarse + (3,)).astype(np.float32)
    xf = rng.normal(size=fine + (3,)).astype(np.float32)
    pj = np.asarray(jsten.prolong_lat(jnp.asarray(xc), shape=fine))
    rj = np.asarray(jsten.restrict_lat(jnp.asarray(xf)))
    pt = stencil.prolong_lat(t(xc), shape=fine)
    rt = stencil.restrict_lat(t(xf))
    assert tuple(pt.shape) == pj.shape and tuple(rt.shape) == rj.shape
    assert_rel(pt.numpy(), pj, 1e-6, "prolong")
    assert_rel(rt.numpy(), rj, 1e-6, "restrict")
    a = float(torch.sum(pt.double() * t(xf).double()))
    b = float(torch.sum(t(xc).double() * rt.double()))
    assert abs(a - b) <= 1e-6 * abs(a)


def test_ew_eta_matches_jax():
    """The Eisenstat-Walker forcing term in float32, clamps and the zero /
    infinite old norm included."""
    pairs = [(1e-3, 2e-3), (5e-5, 1e-3), (3e-3, 1e-3), (1e-4, 0.0),
             (2e-4, np.inf), (0.05, 0.06), (7e-4, 9e-4)]
    for new, old in pairs:
        ref = float(jcg.ew_eta(jnp.float32(new), jnp.float32(old)))
        got = tcg.ew_eta(new, old)
        assert isinstance(got, np.float32)
        assert abs(float(got) - ref) <= 1e-7 * ref, (new, old, got, ref)


@pytest.mark.parametrize("flexible", [False, True])
def test_pcg_operator_matches_jax(flexible):
    """Plain and flexible (Polak-Ribiere) PCG on a 30x30 SPD operator with a
    block-Jacobi preconditioner: equal iteration counts, x to 1e-5."""
    rng = np.random.default_rng(7)
    q = rng.normal(size=(30, 30)).astype(np.float32)
    a = (q @ q.T / 30.0 + np.diag(np.linspace(0.1, 3.0, 30))).astype(
        np.float32)
    blocks = np.stack([a[3 * i:3 * i + 3, 3 * i:3 * i + 3]
                       for i in range(10)])
    b = rng.normal(size=(10, 3)).astype(np.float32)

    def jmv(v):
        return (jnp.asarray(a) @ v.reshape(-1)).reshape(10, 3)

    xj, kj = jcg.pcg_operator(
        jmv, lambda r: jell.solve3x3(jnp.asarray(blocks), r),
        jnp.asarray(b), iterations=25, tol=1e-8, return_iters=True,
        flexible=flexible)
    xt, kt = tcg.pcg_operator(
        lambda v: (t(a) @ v.reshape(-1)).reshape(10, 3),
        lambda r: ell.solve3x3(t(blocks), r), t(b), iterations=25,
        tol=1e-8, return_iters=True, flexible=flexible)
    assert kt == int(kj) > 5
    assert_rel(xt.numpy(), np.asarray(xj), 1e-5)


# -- scene operators, hierarchy, linearization ------------------------------

@pytest.mark.parametrize("op", ["hvp", "diag"])
def test_scene_hessian_ops_match_jax(beam7, op):
    """LatticeScene.elastic_hvp_fn / elastic_diag at a perturbed state
    (la = 37): the port's analytic plain versions against the JAX JVP of
    the stencil force and its stencil diagonal, to 1e-5 relative."""
    js = jl.LatticeScene(beam7, material=JMaterial(lame_la=37.0))
    ts = tl.LatticeScene(beam7, material=MaterialConfig(lame_la=37.0),
                         device="cpu")
    rng = np.random.default_rng(5)
    vm = np.asarray(js.vert_mask)[..., None]
    x = np.asarray(js.x0) + 0.02 * rng.normal(size=vm.shape[:3] + (3,)) * vm
    x = x.astype(np.float32)
    p = rng.normal(size=x.shape).astype(np.float32)
    if op == "hvp":
        ref = np.asarray(js.elastic_hvp_fn(jnp.asarray(x), False)(
            jnp.asarray(p)))
        got = ts.elastic_hvp_fn(t(x))(t(p))
    else:
        ref = np.asarray(js.elastic_diag(jnp.asarray(x), False))
        got = ts.elastic_diag(t(x))
    assert tuple(got.shape) == ref.shape
    assert_rel(got.numpy(), ref, 1e-5, op)


@pytest.mark.parametrize("case", ["3x3x7-2", "6x6x16-3"])
@pytest.mark.parametrize("dt", [None, 0.033])
def test_hierarchy_matches_jax(case, dt):
    """LatticeMG's levels: masks equal, ctrl, mass, rest grids and the
    restriction weights to 1e-6 relative, the level dx equal."""
    shape, levels = {"3x3x7-2": ((3, 3, 7, 0.1), 2),
                     "6x6x16-3": ((6, 6, 16, 0.05), 3)}[case]
    m = meshlib.beam(*shape[:3], dx=shape[3])
    jm = jmg.LatticeMG(jl.LatticeScene(m), n_levels=levels, dt=dt,
                       use_pallas=False)
    tm = tmg.LatticeMG(tl.LatticeScene(m, device="cpu"), n_levels=levels,
                       dt=dt)
    assert tm.n_levels == jm.n_levels and tm.pad_shape == jm.pad_shape
    for li, (a, b) in enumerate(zip(tm.levels, jm.levels)):
        np.testing.assert_array_equal(a.cell_mask.numpy(),
                                      np.asarray(b.cell_mask))
        np.testing.assert_array_equal(a.vert_mask.numpy(),
                                      np.asarray(b.vert_mask))
        assert a.dx == b.dx
        assert_rel(a.ctrl.numpy(), b.ctrl, 1e-6, f"ctrl {li}")
        assert_rel(a.mass.numpy(), b.mass, 1e-6, f"mass {li}")
        assert_rel(tm.x0_levels[li].numpy(), jm.x0_levels[li], 1e-6,
                   f"x0 {li}")
        if li < tm.n_levels - 1:
            assert_rel(tm._restrict_w_cf[li][..., None].numpy(),
                       jm._restrict_w(li), 1e-6, f"restrict_w {li}")


@pytest.fixture(scope="module")
def linearized(beam7):
    """A perturbed fine state and a right-hand side on the 2-level
    hierarchy (Chebyshev coarse sweeps), and the JAX package's per-level
    diagonal blocks, lmax and one V-cycle there."""
    js = jl.LatticeScene(beam7)
    mg = jmg.LatticeMG(js, n_levels=2, dt=None, use_pallas=False)
    rng = np.random.default_rng(11)
    shape = mg.pad_shape
    vm = np.zeros(shape + (1,), np.float32)
    vm[:js.shape[0], :js.shape[1], :js.shape[2], 0] = np.asarray(js.vert_mask)
    x0 = np.zeros(shape + (3,), np.float32)
    x0[:js.shape[0], :js.shape[1], :js.shape[2]] = np.asarray(js.x0)
    x = (x0 + 0.02 * rng.normal(size=x0.shape) * vm).astype(np.float32)
    b = (rng.normal(size=x0.shape) * vm).astype(np.float32)

    @jax.jit
    def run(xp, bp):
        ops = mg.linearize(xp)
        return ([op[1] for op in ops], jnp.stack([op[3] for op in ops]),
                mg.vcycle(ops, bp))
    diags, lmax, z = run(jnp.asarray(x), jnp.asarray(b))
    tm = tmg.LatticeMG(tl.LatticeScene(beam7, device="cpu"), n_levels=2,
                       dt=None)
    ops = tm.linearize(t(x))
    # the port's levels are channel-first and hold each block as its upper
    # triangle (xx, xy, xz, yy, yz, zz): the reference in that layout
    d6 = [np.stack([np.asarray(d)[..., r, c] for r, c in
                    ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))])
          for d in diags]
    return ops, tm, t(b).permute(3, 0, 1, 2).contiguous(), (
        d6, np.asarray(lmax), np.moveaxis(np.asarray(z), -1, 0))


def test_linearize_matches_jax(linearized):
    """SPD-projected diagonal blocks of every level and the power-iteration
    lmax (torch's and XLA's sin start vector may differ by an ulp) to 1e-4
    relative."""
    ops, _, _, (diags, lmax, _) = linearized
    for li, op in enumerate(ops):
        assert_rel(op[1].numpy(), diags[li], 1e-4, f"diag {li}")
        assert isinstance(op[3], np.float32)
        assert abs(float(op[3]) - lmax[li]) <= 1e-4 * lmax[li], li


def test_vcycle_matches_jax(linearized):
    """One V-cycle on a seeded right-hand side, to 1e-4 relative."""
    ops, tm, b, (_, _, z) = linearized
    assert_rel(tm.vcycle(ops, b).numpy(), z, 1e-4)


# -- quasi-static solvers ---------------------------------------------------

def scene_of(name):
    """(mesh, pins) of a quasi-static case: the 3x3x7 beam (top pins), or a
    2x2xN cantilever (z-min face pinned: a bend under gravity)."""
    if name == "3x3x7":
        return meshlib.beam(3, 3, 7, dx=0.1), None
    m = meshlib.beam(2, 2, int(name[4:]), dx=0.05)
    return m, np.nonzero(m.ijk[:, 2] == m.ijk[:, 2].min())[0]


# case: (scene, quasistatic_to_tol keywords). "auto" with a 4-Newton stage
# budget: its trace warm-starts, rejects and halves, doubles and caps the
# load increment.
QS_CASES = {
    "single": ("2x2x8", dict(max_newton=50, return_cg=True)),
    "two-stage": ("2x2x8", dict(max_newton=50, load_steps=2)),
    "ew": ("3x3x7", dict(max_newton=50, cg_forcing="ew")),
    "auto": ("2x2x12", dict(max_newton=4, load_steps="auto",
                            return_trace=True)),
}


@pytest.fixture(scope="module")
def qs_jax():
    """quasistatic_to_tol from rest, the cases of a scene in one JAX
    program: {case: (x, k, fn[, cg or trace])}."""
    refs = {}
    for scene in sorted({sc for sc, _ in QS_CASES.values()}):
        m, pins = scene_of(scene)
        js = jl.LatticeScene(m, pins=pins)
        cases = {c: kw for c, (sc, kw) in QS_CASES.items() if sc == scene}
        run = jax.jit(lambda x, js=js, cases=cases: {
            c: jl.quasistatic_to_tol(js, x, tol=TOL, use_pallas=False, **kw)
            for c, kw in cases.items()})
        refs.update({c: [np.asarray(a) for a in v]
                     for c, v in run(js.x0).items()})
    return refs


@pytest.mark.parametrize("case", sorted(QS_CASES))
def test_quasistatic_to_tol_matches_jax(qs_jax, case):
    scene, kw = QS_CASES[case]
    ref = qs_jax[case]
    m, pins = scene_of(scene)
    ts = tl.LatticeScene(m, pins=pins, device="cpu")
    out = tl.quasistatic_to_tol(ts, ts.x0, tol=TOL, **kw)
    x, k, fn = out[:3]
    assert k == int(ref[1]) and fn <= TOL
    assert_fn_close(fn, ref[2])
    assert_x_close(x, ref[0])
    if case == "single":                          # PCG matvec total
        assert out[3] == int(ref[3])
    if case == "auto":
        trace, jtrace = out[3], ref[3]
        rows = ~np.isnan(jtrace[:, 0])
        assert np.array_equal(~np.isnan(trace[:, 0]), rows)
        # every stage's load and Newton count equal; a converged stage's
        # norm to the float32 policy. A failed stage ends on a Newton
        # iterate far from equilibrium (||f|| ~ 1e-2), where the two
        # packages' norms differ by up to ~2e-3 relative (ROADMAP Queue 3):
        # it is held to the decision it feeds, the same on both sides.
        np.testing.assert_array_equal(trace[rows, :2], jtrace[rows, :2])
        prev = jprev = np.float32(np.inf)
        for (gs, _, got), (_, _, want) in zip(trace[rows], jtrace[rows]):
            assert (got <= TOL) == (want <= TOL)
            if want <= TOL:
                assert_fn_close(got, want, "trace")
            warm = got > TOL and got <= np.float32(0.5) * prev
            assert warm == (want > TOL and want <= np.float32(0.5) * jprev)
            prev, jprev = ((got, want) if warm
                           else (np.float32(np.inf),) * 2)
        assert rows.sum() >= 5 and len(set(trace[rows, 0])) >= 2


def test_adaptive_continuation_stall_matches_jax():
    """A stage solver that never converges: every load is rejected after
    one warm retry, dgs halves below 1/256, the continuation stalls and
    reports +inf at the last committed state, with k summed over every
    attempt; the same trace as the JAX package's."""
    def jsolve(x, gs):
        return x + 1.0, jnp.int32(3), jnp.float32(1.0) + 0.0 * gs

    def tsolve(x, gs):
        return x + 1.0, 3, np.float32(1.0)

    jx, jk, jfn, jtr = jl.adaptive_continuation(
        jsolve, jnp.float32(0.0), TOL, 12, return_trace=True)
    x, k, fn, tr = tl.adaptive_continuation(
        tsolve, 0.0, TOL, 12, return_trace=True)
    assert fn == float(jfn) == np.inf
    assert k == int(jk) and x == float(jx) == 0.0
    np.testing.assert_array_equal(tr, np.asarray(jtr))


def test_quasistatic_to_tol_mg_matches_jax(beam7):
    """The verify recipe: LatticeMG(n_levels=2, dt=None, coarse_cg=8) with
    quasistatic_to_tol_mg from rest (flexible outer PCG)."""
    js = jl.LatticeScene(beam7)
    jm = jmg.LatticeMG(js, n_levels=2, dt=None, coarse_cg=8,
                       use_pallas=False)
    xj, kj, fj = jax.jit(lambda x: jmg.quasistatic_to_tol_mg(
        js, jm, x, tol=TOL))(js.x0)
    ts = tl.LatticeScene(beam7, device="cpu")
    tm = tmg.LatticeMG(ts, n_levels=2, dt=None, coarse_cg=8)
    x, k, fn = tmg.quasistatic_to_tol_mg(ts, tm, ts.x0, tol=TOL)
    assert k == int(kj) and fn <= TOL
    assert_fn_close(fn, fj)
    assert_x_close(x, xj)


# -- dynamic multigrid and substepping ----------------------------------------

def test_step_to_tol_mg_baked_dt_matches_jax(beam7):
    """Three excited frames on a hierarchy with dt baked in (the smoother's
    SPD projection off, the mass-shifted regime that option is for; 4
    coarse sweeps)."""
    js = jl.LatticeScene(beam7)
    jm = jmg.LatticeMG(js, n_levels=2, use_pallas=False, spd_smoother=False,
                       coarse_sweeps=4)
    step = jax.jit(lambda s, gs: jmg.step_to_tol_mg(js, jm, s, tol=TOL,
                                                    gravity_scale=gs))
    ts = tl.LatticeScene(beam7, device="cpu")
    tm = tmg.LatticeMG(ts, n_levels=2, spd_smoother=False, coarse_sweeps=4)
    jst, st = js.init_state(), ts.init_state()
    for i in range(3):
        jst, kj, fj = step(jst, jnp.float32(gravity_scale(i)))
        st, k, fn = tmg.step_to_tol_mg(ts, tm, st, tol=TOL,
                                       gravity_scale=gravity_scale(i))
        assert k == int(kj) and fn <= TOL, i
        assert_fn_close(fn, fj, i)
        assert_x_close(st.x, jst.x, i)


@pytest.fixture(scope="module")
def kick_jax():
    """The 3x3x12 beam, its kicked start, and the JAX frame_adaptive /
    frame_adaptive_mg (dt=None hierarchy, 4 coarse sweeps) as one jitted
    program each. Newton budgets: 10 a substep for the lattice (at the JAX
    package's test's 25, the second frame needs 21 in one package and more
    than 25 in the other: ROADMAP Queue 3), 6 with multigrid."""
    m = meshlib.beam(3, 3, 12, dx=0.05)
    js = jl.LatticeScene(m)
    jm = jmg.LatticeMG(js, n_levels=2, dt=None, use_pallas=False,
                       coarse_sweeps=4)
    v = kicked_velocity(np.asarray(js.x0)) * np.asarray(js.vert_mask)[
        ..., None]
    fa = jax.jit(lambda s: jl.frame_adaptive(js, s, tol=TOL, max_newton=10,
                                             use_pallas=False,
                                             max_halvings=4))
    famg = jax.jit(lambda s: jmg.frame_adaptive_mg(js, jm, s, tol=TOL,
                                                   max_newton=6,
                                                   max_halvings=4))
    return m, js, v, fa, famg


def test_step_to_tol_mg_dt_override_matches_jax(kick_jax):
    """step_to_tol_mg on a dt=None hierarchy with dt given: two calm frames
    from rest against the JAX frame_adaptive_mg, which runs exactly that
    step (dt = dyn.dt / 1, damping^(1/1) in float32) when a frame needs no
    substeps."""
    m, js, _, _, famg = kick_jax
    ts = tl.LatticeScene(m, device="cpu")
    tm = tmg.LatticeMG(ts, n_levels=2, dt=None, coarse_sweeps=4)
    dyn = DynamicsConfig()
    jst, st = js.init_state(), ts.init_state()
    for i in range(2):
        jst, kj, fj, nj = famg(jst)
        assert int(nj) == 1
        st, k, fn = tmg.step_to_tol_mg(
            ts, tm, st, tol=TOL, max_newton=6, dt=np.float32(dyn.dt),
            damping=np.float32(dyn.damping))
        assert k == int(kj) and fn <= TOL, i
        assert_fn_close(fn, fj, i)
        assert_x_close(st.x, jst.x, i)
    with pytest.raises(ValueError, match="dt=None"):
        tmg.step_to_tol_mg(ts, tmg.LatticeMG(ts, n_levels=2), st, dt=0.01)


@pytest.mark.parametrize("solver", ["lattice", "mg"])
def test_frame_adaptive_matches_jax(kick_jax, solver):
    """The violent kick: equal substep lists and Newton counts, the states
    within 1e-4, and some frame substepped."""
    m, js, v, fa, famg = kick_jax
    ts = tl.LatticeScene(m, device="cpu")
    jst = js.init_state()._replace(v=jnp.asarray(v))
    st = ts.init_state()._replace(v=t(v))
    if solver == "lattice":
        frames, jframe = 3, fa

        def frame(s):
            return tl.frame_adaptive(ts, s, tol=TOL, max_newton=10,
                                     max_halvings=4)
    else:
        frames, jframe = 2, famg
        tm = tmg.LatticeMG(ts, n_levels=2, dt=None, coarse_sweeps=4)

        def frame(s):
            return tmg.frame_adaptive_mg(ts, tm, s, tol=TOL, max_newton=6,
                                         max_halvings=4)
    subs, jsubs = [], []
    for i in range(frames):
        jst, kj, fj, nj = jframe(jst)
        st, k, fn, n = frame(st)
        subs.append(n)
        jsubs.append(int(nj))
        assert k == int(kj) and fn <= TOL, i
        assert_fn_close(fn, fj, i)
        assert_x_close(st.x, jst.x, i)
    assert subs == jsubs and max(subs) > 1


# -- full multigrid -----------------------------------------------------------

@pytest.mark.parametrize("fine_solver", ["mg", "jacobi"])
def test_quasistatic_fmg_matches_jax(beam7, fine_solver):
    """"mg": the 3x3x7 beam on a 2-level hierarchy (coarse_cg 8, smoother
    projection off). "jacobi": the 2x2x12 cantilever with adaptive load
    continuation on the coarse level (coarse_cg 16). Equal per-level
    Newton counts."""
    if fine_solver == "mg":
        m, pins, kw = beam7, None, dict(coarse_cg=8, spd_smoother=False)
        run_kw = {}
    else:
        (m, pins), kw = scene_of("2x2x12"), dict(coarse_cg=16)
        run_kw = dict(max_newton=100, coarse_max_newton=100,
                      load_steps="auto")
    js = jl.LatticeScene(m, pins=pins)
    jm = jmg.LatticeMG(js, n_levels=2, dt=None, use_pallas=False, **kw)
    xj, kj, fj, ksj = jax.jit(lambda: jmg.quasistatic_fmg(
        js, jm, tol=TOL, fine_solver=fine_solver, return_stats=True,
        **run_kw))()
    ts = tl.LatticeScene(m, pins=pins, device="cpu")
    tm = tmg.LatticeMG(ts, n_levels=2, dt=None, **kw)
    x, k, fn, ks = tmg.quasistatic_fmg(ts, tm, tol=TOL,
                                       fine_solver=fine_solver,
                                       return_stats=True, **run_kw)
    assert ks == tuple(int(a) for a in ksj) and k == int(kj)
    assert fn <= TOL
    assert_fn_close(fn, fj)
    assert_x_close(x, xj)
