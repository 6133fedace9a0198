"""The port's unstructured block-ELL path against the JAX package (CPU):
the quasi-static solvers and the dynamic implicit-Euler frames.

Both packages build the beam(4, 4, 8, dx=0.1) scene with
SolverConfig(n_levels=2) (tests/test_solvers.py) once for the module and
run the same QuasiStaticSim method or dynamic step; the port's kernel
wrappers run their plain torch versions on these CPU tensors.

Quasi-static runs start from one seeded perturbed state (0.01 normal noise
on x0), where ||f||_inf is O(1) and every method has work to do. Tolerance
of the ||f||_inf series: per step |d| <= 1e-3 |f_jax| + 5e-6. The
absolute term is float32 noise: ||f||_inf is a small difference of O(1)
terms, so two runs whose x agree to a few ulps differ in it by up to 4.5e-6
however small ||f|| is; on these runs no step exceeds 1e-3 relative by more
than 1.5e-6 (measured). The energies agree to 1e-4 relative and the final x
to 1e-4.

Dynamic frames step five frames from rest with the reference `step` (one
Newton, CG) and with `step_to_tol` in each of its four linear solves.
Newton counts must be equal and states agree to 1e-4 (x moves by a few ulps
per frame; v = dx / dt carries them times 1/dt = 30).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as jmesh
from fem_simulation_tpu.config import DynamicsConfig as JDyn
from fem_simulation_tpu.config import SolverConfig as JSolverConfig
from fem_simulation_tpu.sim import QuasiStaticSim as JSim
from fem_simulation_tpu.sim import Scene as JScene
from fem_simulation_tpu.sim import dynamic as jdyn

from fem_simulation_tpu_torch import mesh as tmesh
from fem_simulation_tpu_torch.config import DynamicsConfig, SolverConfig
from fem_simulation_tpu_torch.sim import QuasiStaticSim, Scene
from fem_simulation_tpu_torch.sim import dynamic as tdyn
from fem_simulation_tpu_torch.sim import quasistatic as tqs

NOISE = 5e-6
FRAMES = 5
BRANCHES = {"mg_pcg": {}, "assembled_cg": {"use_multigrid": False},
            "matrix_free": {"matrix_free": True}, "fas": {"use_fas": True}}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one torch thread runs them as fast and
    leaves the cores to the JAX compiles of the reference side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    js = JScene(jmesh.beam(4, 4, 8, dx=0.1), solver=JSolverConfig(n_levels=2))
    ts = Scene(tmesh.beam(4, 4, 8, dx=0.1), solver=SolverConfig(n_levels=2),
               device="cpu")
    return js, ts


RUNS = [("newton", 10, {}), ("newton_multigrid", 10, {})] + [
    ("fas", 10, {"variant": v}) for v in range(4)] + [
    ("adam", 20, {}), ("gradient_descent", 5, {})]


@pytest.mark.parametrize("method,steps,kw", RUNS,
                         ids=[r[0] + "".join(f"_v{v}" for v in r[2].values())
                              for r in RUNS])
def test_quasistatic_run_matches_jax(scenes, method, steps, kw):
    """One QuasiStaticSim run in each package from the same seeded
    perturbed state: equal series length, ||f||_inf per step within 1e-3
    relative + 5e-6 (module docstring), energies within 1e-4 relative,
    final x within 1e-4."""
    js, ts = scenes
    jsim, tsim = JSim(js), QuasiStaticSim(ts)
    rng = np.random.default_rng(3)
    x = (np.asarray(js.x0) + 0.01 * rng.standard_normal(js.x0.shape)
         ).astype(np.float32)
    jsim.x, tsim.x = jnp.asarray(x), torch.from_numpy(x.copy())
    jout = getattr(jsim, method)(steps, **kw)
    tout = getattr(tsim, method)(steps, **kw)
    if method in ("adam", "gradient_descent"):
        jf, tf = np.asarray(jout), tout.numpy()
    else:
        (je, jf), (te, tf) = [np.asarray(a) for a in jout], \
            [a.numpy() for a in tout]
        np.testing.assert_allclose(te, je, rtol=1e-4)
    assert tf.shape == jf.shape == (steps,)
    assert np.isfinite(tf).all()
    np.testing.assert_array_less(np.abs(tf - jf), 1e-3 * np.abs(jf) + NOISE)
    np.testing.assert_allclose(tsim.x.numpy(), np.asarray(jsim.x), rtol=0,
                               atol=1e-4)


def test_verify_recipe_converges_on_cpu(scenes):
    """The verify recipe's checks at this size: Newton-MG passes 1e-4 and
    reaches the f32 floor, FAS v3 decays at >= 0.3 decades per cycle until
    the floor (tests/test_solvers.py:80 on the JAX package)."""
    _, ts = scenes
    _, fn = QuasiStaticSim(ts).newton_multigrid(15)
    assert fn[-1] < 1e-4 and fn[-1] < 0.05 * fn[0]
    _, fn = QuasiStaticSim(ts).fas(30, variant=3)
    fn = fn.numpy()
    k = int(np.argmax(fn < 2e-5)) or fn.size
    slope = np.polyfit(np.arange(k), np.log10(fn[:k]), 1)[0]
    assert k >= 5 and slope <= -0.3 and fn[:20].min() <= 1e-4


def test_force_inf_norm_and_mesh_order(scenes):
    """force_inf_norm equals the JAX package's at the rest state to 1e-6
    (the elastic force there is zero up to f32 roundoff, ~4e-7);
    to_mesh_order / from_mesh_order invert each other."""
    js, ts = scenes
    assert QuasiStaticSim(ts).force_inf_norm() == pytest.approx(
        JSim(js).force_inf_norm(), rel=0, abs=1e-6)
    x = np.random.default_rng(1).normal(size=(ts.mesh.n_verts, 3)
                                        ).astype(np.float32)
    canon = ts.from_mesh_order(x)
    np.testing.assert_array_equal(canon.numpy(),
                                  np.asarray(js.from_mesh_order(x)))
    np.testing.assert_array_equal(ts.to_mesh_order(canon), x)


def test_fas_needs_two_levels():
    """A one-level scene refuses FAS with the JAX package's message."""
    ts = Scene(tmesh.beam(2, 2, 3, dx=0.1), solver=SolverConfig(n_levels=1),
               device="cpu")
    with pytest.raises(ValueError, match="FAS needs"):
        tqs.fas_step(ts, ts.params, ts.x0)


# -- dynamic frames ----------------------------------------------------------

@pytest.fixture(scope="module")
def jax_frames(scenes):
    """The JAX package's frames of each branch: [(state, k, fn)]."""
    js, _ = scenes
    out = {}
    for name, kw in BRANCHES.items():
        step = jax.jit(lambda p, s, kw=kw: jdyn.step_to_tol(
            js, p, s, JDyn(), 1e-4, 20, **kw))
        st = jdyn.init_state(js)
        frames = []
        for _ in range(FRAMES):
            st, k, fn = step(js.params, st)
            frames.append((st, int(k), float(fn)))
        out[name] = frames
    return out


def _same_state(got, ref, what):
    got = tdyn.state_to_numpy(got)
    for a, b, name in zip(got, ref, ("x", "v", "drag_mask", "drag_pos")):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-4,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_step_to_tol_frames_match_jax(scenes, jax_frames, branch):
    """Five step_to_tol frames: equal Newton counts, every frame at
    ||f||_inf <= 1e-4 in both, states within 1e-4."""
    _, ts = scenes
    st = tdyn.init_state(ts)
    for i, (jst, jk, jfn) in enumerate(jax_frames[branch]):
        st, k, fn = tdyn.step_to_tol(ts, ts.params, st, DynamicsConfig(),
                                     1e-4, 20, **BRANCHES[branch])
        assert k == jk, f"frame {i}: {k} Newton vs JAX {jk}"
        assert fn <= 1e-4 and jfn <= 1e-4
        _same_state(st, jst, f"frame {i}")


def test_reference_step_frames_match_jax(scenes):
    """Five frames of the reference-parity `step` (predictor + one Newton
    with cg_iterations CG steps), through DynamicSim.frame."""
    js, ts = scenes
    jstep = jax.jit(lambda p, s: jdyn.step(js, p, s, JDyn()))
    jst = jdyn.init_state(js)
    sim = tdyn.DynamicSim(ts)
    for i in range(FRAMES):
        jst = jstep(js.params, jst)
        _same_state(sim.frame(), jst, f"frame {i}")


def test_state_from_numpy_continues_jax_frames(scenes, jax_frames):
    """A JAX DynState after 3 MG-PCG frames, carried over with
    state_from_numpy (exact round trip) and stepped once, lands on the JAX
    package's 4th frame; DynamicSim.frame_to_tol takes the same branch."""
    _, ts = scenes
    frames = jax_frames["mg_pcg"]
    jst = frames[2][0]
    st = tdyn.state_from_numpy(*(np.asarray(a) for a in jst), device="cpu")
    for a, b in zip(tdyn.state_to_numpy(st), jst):
        np.testing.assert_array_equal(a, np.asarray(b))
    sim = tdyn.DynamicSim(ts)
    sim.state = st
    st, k, fn = sim.frame_to_tol()
    jst4, jk, _ = frames[3]
    assert k == jk and fn <= 1e-4
    _same_state(st, jst4, "frame 4")


def test_drag_moves_the_grabbed_vertices(scenes):
    """set_drag pulls the grabbed vertices toward their targets over a few
    frames; clear_drag releases them (the drag mask is zero again)."""
    _, ts = scenes
    sim = tdyn.DynamicSim(ts)
    x0 = sim.state.x.numpy()
    mask = np.zeros(x0.shape[0], np.float32)
    grab = np.argsort(x0[:, 1])[:4]        # the four lowest vertices
    mask[grab] = 1.0
    targets = x0 + np.array([0.0, 0.0, 0.05], np.float32)
    sim.set_drag(mask, targets)
    for _ in range(4):
        st, _, fn = sim.frame_to_tol()
        assert fn <= 1e-4
    moved = st.x.numpy()[grab, 2] - x0[grab, 2]
    assert (moved > 0.01).all(), moved
    sim.clear_drag()
    assert float(sim.state.drag_mask.abs().max()) == 0.0
