"""The port's mass-spring cloth against the JAX package (CPU).

Both packages build the 4x4 and the 8x8 ClothConfig grid with the two
corners of the first row pinned (examples/exp1_cloth.py) once for the
module; the port's SpMV wrapper runs its plain version on these CPU tensors.

Tolerances:
- topology and params: integer tables exactly equal, float tables equal;
- energy, force, Hessian blocks and the assembled ELL Hessian at a seeded
  perturbed state: within 1e-5 of max|ref| (the gathers add in the JAX
  scatter order, so on the CPU they come out equal);
- `step` (5 CG iterations a frame), 10 frames: x within 1e-5;
- `step_to_tol` at tol 1e-4, 5 frames: equal Newton counts, both at
  ||f||_inf <= tol, x within 1e-4, and ||f||_inf within 1e-3 relative +
  5e-6 + the f32 floor of the inertia term, (m / dt^2) 2^-24 max|x| (the
  change half an ulp of x makes to it: 6.7e-5 on the 8x8 grid, 2.2e-4 on
  the 4x4). A pure 1e-3 relative + 5e-6 fails on the 8x8 grid's fifth
  frame (2.64e-5 vs 4.24e-5 with x within 1.1e-8): there m / dt^2 = 1,134
  and one ulp of x moves the residual by 1.4e-4.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu.config import ClothConfig as JClothConfig
from fem_simulation_tpu.ops import spring as jspring
from fem_simulation_tpu.sim import cloth as jcloth
from fem_simulation_tpu.sim.picking import Picker as JPicker

from fem_simulation_tpu_torch.config import ClothConfig
from fem_simulation_tpu_torch.ops import spring as tspring
from fem_simulation_tpu_torch.sim import cloth as tcloth
from fem_simulation_tpu_torch.sim.picking import Picker

RES = (4, 8)
TOL = 1e-4
STEP_FRAMES = 10
TOL_FRAMES = 5


def _pins(res):
    return [0, res]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    out = {}
    for res in RES:
        js = jcloth.ClothScene(JClothConfig(res_x=res, res_y=res),
                               pins=_pins(res))
        ts = tcloth.ClothScene(ClothConfig(res_x=res, res_y=res),
                               pins=_pins(res), device="cpu")
        out[res] = (js, ts)
    return out


@pytest.fixture(scope="module")
def jax_frames(scenes):
    """The JAX package's `step` and `step_to_tol` frames from rest."""
    out = {}
    for res, (js, _) in scenes.items():
        step = jax.jit(lambda p, s, js=js: jcloth.step(js, p, s))
        st = jcloth.init_state(js)
        plain = []
        for _ in range(STEP_FRAMES):
            st = step(js.params, st)
            plain.append(np.asarray(st.x))
        to_tol = jax.jit(lambda p, s, js=js: jcloth.step_to_tol(
            js, p, s, tol=TOL))
        st = jcloth.init_state(js)
        tol_frames = []
        for _ in range(TOL_FRAMES):
            st, k, fn = to_tol(js.params, st)
            tol_frames.append((st, int(k), float(fn)))
        out[res] = (plain, tol_frames)
    return out


def _perturbed(js, seed):
    rng = np.random.default_rng(seed)
    x0 = np.asarray(js.params["x0"])
    return x0 + 0.03 * rng.standard_normal(x0.shape).astype(np.float32)


@pytest.mark.parametrize("res", RES)
def test_scene_tables_match_jax(scenes, res):
    """Every params table of the JAX ClothScene, equal in dtype and value;
    the same counts; the gather tables list every scatter contribution
    once."""
    js, ts = scenes[res]
    assert (ts.n_verts, ts.n_edges, ts.K) == (js.n_verts, js.n_edges, js.K)
    for key, val in js.params.items():
        ref, got = np.asarray(val), ts.params[key].numpy()
        assert got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
    for key, n_contrib in (("f_table", 2 * ts.n_edges),
                           ("h_table", 4 * ts.n_edges)):
        table = ts.params[key].numpy()
        live = np.sort(table[table < n_contrib])
        np.testing.assert_array_equal(live, np.arange(n_contrib))
    assert ts.params["f_table"].shape[0] == 6      # the grid's largest degree


@pytest.mark.parametrize("res", RES)
def test_params_from_numpy_carries_jax_params(scenes, res):
    """params_from_numpy of the JAX params read back with np.asarray is the
    port scene's own params dict."""
    js, ts = scenes[res]
    got = tcloth.params_from_numpy(
        {k: np.asarray(v) for k, v in js.params.items()}, device="cpu")
    assert set(got) == set(ts.params)
    for key, val in ts.params.items():
        assert torch.equal(got[key], val), key


@pytest.mark.parametrize("res", RES)
def test_spring_ops_match_jax(scenes, res):
    """energy, force, hessian_blocks and assemble_hessian_ell at a seeded
    perturbed state: within 1e-5 of max|ref|."""
    js, ts = scenes[res]
    x = _perturbed(js, seed=res)
    jp, tp = js.params, ts.params
    k = js.cfg.k
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    pairs = [
        (jspring.energy(xj, jp["edges"], jp["l0"], k),
         tspring.energy(xt, tp["edges"], tp["l0"], k)),
        (jspring.force(xj, jp["edges"], jp["l0"], k, js.n_verts),
         tspring.force(xt, tp["edges"], tp["l0"], k, tp["f_table"])),
        (jspring.hessian_blocks(xj, jp["edges"], jp["l0"], k),
         tspring.hessian_blocks(xt, tp["edges"], tp["l0"], k)),
        (jspring.assemble_hessian_ell(xj, jp["edges"], jp["l0"], k,
                                      jp["edge_slot"], js.n_verts, js.K),
         tspring.assemble_hessian_ell(xt, tp["edges"], tp["l0"], k,
                                      tp["h_table"], ts.n_verts, ts.K)),
    ]
    for ref, got in pairs:
        ref, got = np.asarray(ref), got.numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * float(np.abs(ref).max()))


def test_spring_force_is_minus_grad(scenes):
    """force == -d energy / dx by torch autograd, at a perturbed state."""
    _, ts = scenes[4]
    tp = ts.params
    x = torch.from_numpy(_perturbed(scenes[4][0], seed=1)).requires_grad_()
    e = tspring.energy(x, tp["edges"], tp["l0"], ts.cfg.k)
    (grad,) = torch.autograd.grad(e, x)
    f = tspring.force(x.detach(), tp["edges"], tp["l0"], ts.cfg.k,
                      tp["f_table"])
    np.testing.assert_allclose(f.numpy(), -grad.numpy(), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("res", RES)
def test_step_frames_match_jax(scenes, jax_frames, res):
    """Ten reference frames (one assembly, 5 CG iterations each): x within
    1e-5 of the JAX frames."""
    _, ts = scenes[res]
    st = tcloth.init_state(ts)
    for i, ref in enumerate(jax_frames[res][0]):
        st = tcloth.step(ts, ts.params, st)
        np.testing.assert_allclose(st.x.numpy(), ref, rtol=0, atol=1e-5,
                                   err_msg=f"frame {i}")


def _f32_floor(ts, x):
    m_dt2 = float(ts.params["mass"].max()) / ts.cfg.dt ** 2
    return m_dt2 * 2.0 ** -24 * float(np.abs(x).max())


@pytest.mark.parametrize("res", RES)
def test_step_to_tol_frames_match_jax(scenes, jax_frames, res):
    """Five frames to ||f||_inf <= 1e-4: equal Newton counts (at least one
    Newton on some frame), both at tol, x within 1e-4, ||f||_inf within
    the module docstring's policy."""
    _, ts = scenes[res]
    st = tcloth.init_state(ts)
    ks = []
    for i, (jst, jk, jfn) in enumerate(jax_frames[res][1]):
        st, k, fn = tcloth.step_to_tol(ts, ts.params, st, tol=TOL)
        x = st.x.numpy()
        assert k == jk, f"frame {i}: Newton {k} vs {jk}"
        assert fn <= TOL and jfn <= TOL * (1 + 1e-6), (i, fn, jfn)
        np.testing.assert_allclose(x, np.asarray(jst.x), rtol=0, atol=1e-4)
        lim = 1e-3 * jfn + 5e-6 + _f32_floor(ts, x)
        assert abs(fn - jfn) <= lim, (i, fn, jfn, lim)
        ks.append(k)
    assert max(ks) >= 1


def test_state_numpy_round_trip_continues_jax(scenes, jax_frames):
    """state_from_numpy of a JAX ClothState continues its frames: the next
    step_to_tol frame matches the JAX one."""
    js, ts = scenes[8]
    frames = jax_frames[8][1]
    jst = frames[2][0]
    st = tcloth.state_from_numpy(*[np.asarray(a) for a in jst],
                                 device="cpu")
    for got, ref in zip(tcloth.state_to_numpy(st), jst):
        np.testing.assert_array_equal(got, np.asarray(ref))
    st, k, fn = tcloth.step_to_tol(ts, ts.params, st, tol=TOL)
    assert k == frames[3][1]
    np.testing.assert_allclose(st.x.numpy(), np.asarray(frames[3][0].x),
                               rtol=0, atol=1e-4)


def test_picker_on_cloth_matches_jax():
    """The Picker on an 8x8 ClothSim: the same selected vertex and the same
    drag mask and targets as the JAX Picker on the JAX ClothSim; ten
    dragged frames stay finite; clear() drops the drag."""
    cfg_j, cfg_t = JClothConfig(res_x=8, res_y=8), ClothConfig(res_x=8,
                                                              res_y=8)
    jsim = jcloth.ClothSim(cfg_j, pins=[0, 8])
    tsim = tcloth.ClothSim(cfg_t, pins=[0, 8], device="cpu")
    np.testing.assert_array_equal(tsim.triangles(), jsim.triangles())
    origin = np.array([0.5, 2.0, 0.5])
    down = np.array([0.0, -1.0, 0.0])
    pj = JPicker(jsim, jsim.triangles(), grab_radius2=0.01)
    pt = Picker(tsim, tsim.triangles(), grab_radius2=0.01)
    assert pj.select(origin, down) and pt.select(origin, down)
    assert pt.select_vertex == pj.select_vertex >= 0
    shifted = origin + np.array([0.1, 0.0, 0.0])
    pj.move_select(shifted, down)
    pt.move_select(shifted, down)
    np.testing.assert_array_equal(tsim.state.drag_mask.numpy(),
                                  np.asarray(jsim.state.drag_mask))
    np.testing.assert_allclose(tsim.state.drag_pos.numpy(),
                               np.asarray(jsim.state.drag_pos), atol=1e-6)
    assert float(tsim.state.drag_mask.sum()) > 0
    for _ in range(10):
        st = tsim.frame()
    assert torch.isfinite(st.x).all()
    pt.clear()
    assert float(tsim.state.drag_mask.sum()) == 0 and pt.select_vertex == -1


def test_cloth_falls_and_pins_hold():
    """ClothSim on the CPU: 30 reference frames, the cloth falls and the
    pinned corners stay near their targets."""
    sim = tcloth.ClothSim(ClothConfig(res_x=8, res_y=8), pins=[0, 8],
                          device="cpu")
    x0 = sim.state.x.numpy().copy()
    for _ in range(30):
        st = sim.frame()
    x = st.x.numpy()
    assert np.isfinite(x).all()
    assert x[:, 1].mean() < x0[:, 1].mean()
    assert np.linalg.norm(x[[0, 8]] - x0[[0, 8]], axis=-1).max() < 0.2
