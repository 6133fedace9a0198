"""The port's interaction, harness and host utilities against the JAX
package (CPU): picking, the A/B harness, adaptive substepping, checkpoints
and pytrees, the debug checks, timing, the camera and the two viewers.

The studies run on the beam(4, 4, 8, dx=0.1) scene with
SolverConfig(n_levels=2) (tests/test_solvers.py); each package's reference
runs once, in a module fixture.

Tolerances:
- the harness's ||f||_inf series start from rest, where the two packages
  differ by up to 2.03e-5 absolute on this beam (measured; the
  SPD projection clamps eigenvalues that are zero up to roundoff in one
  package and not in the other: ROADMAP Queue 3 records 2e-5 from rest):
  per step |d| <= 1e-3 |f_jax| + 3e-5, energies within 1e-4 relative;
- drag_study's linear residuals ||b - A dx||_inf: per entry
  |d| <= 1e-3 |r_jax| + 4 ulp(||b||_inf) (the residual is a float32
  difference of terms the size of b), and the port's own V-cycle beats GS
  and CG at iterations 1-3 (tests/test_solvers.py);
- frame_adaptive on the violent kick of the 3x3x12 beam
  (tests/test_dynamic.py) at max_newton 10, a budget with margin (at 25 the
  two packages decide one frame differently, ROADMAP Queue 3): equal n_sub
  and Newton lists, x within 1e-4.
"""
import base64
import json
import time
import urllib.request

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as jmesh
from fem_simulation_tpu.config import SolverConfig as JSolverConfig
from fem_simulation_tpu.harness import compare as jcompare
from fem_simulation_tpu.render import Camera as JCamera
from fem_simulation_tpu.sim import Scene as JScene
from fem_simulation_tpu.sim import dynamic as jdyn
from fem_simulation_tpu.sim.picking import Picker as JPicker
from fem_simulation_tpu.utils import io as jio

from fem_simulation_tpu_torch import mesh as tmesh
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.harness import compare as tcompare
from fem_simulation_tpu_torch.ops import ell
from fem_simulation_tpu_torch.render import Camera, HeadlessWindow
from fem_simulation_tpu_torch.render.live import LiveViewer
from fem_simulation_tpu_torch.sim import QuasiStaticSim, Scene
from fem_simulation_tpu_torch.sim import dynamic as tdyn
from fem_simulation_tpu_torch.sim import quasistatic as tqs
from fem_simulation_tpu_torch.sim.picking import Picker, ray_triangles
from fem_simulation_tpu_torch.utils import debug, io, profiling, viz

BEAM = dict(nx=4, ny=4, nz=8, dx=0.1)
STUDIES = {"compare": 10, "compare_fas": 10, "solver_study": 10}
DRAG_ITERS = 6
FROM_REST = 3e-5
KICK_FRAMES = 4
KICK_BUDGET = 10


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jscene():
    return JScene(jmesh.beam(**BEAM), solver=JSolverConfig(n_levels=2))


def _tscene():
    return Scene(tmesh.beam(**BEAM), solver=SolverConfig(n_levels=2),
                 device="cpu")


@pytest.fixture(scope="module")
def tscene():
    return _tscene()


@pytest.fixture(scope="module")
def studies():
    """Each harness study in both packages: {name: (jax, port)}."""
    out = {}
    for name, iters in STUDIES.items():
        out[name] = (getattr(jcompare, name)(_jscene, iterations=iters),
                     getattr(tcompare, name)(_tscene, iterations=iters))
    out["drag_study"] = (jcompare.drag_study(_jscene, iterations=DRAG_ITERS),
                         tcompare.drag_study(_tscene, iterations=DRAG_ITERS))
    return out


def _kick(x):
    r = x - x.mean(0)
    omega = np.array([18.0, 0.0, 6.0], np.float32)
    return np.cross(np.broadcast_to(omega, r.shape), r).astype(np.float32)


@pytest.mark.parametrize("name", sorted(STUDIES))
def test_study_series_match_jax(studies, name):
    """compare / compare_fas / solver_study: the same arms, equal series
    lengths, ||f||_inf and energies within the module docstring's policy."""
    ref, got = studies[name]
    assert sorted(got) == sorted(ref)
    for arm in ref:
        for key in ("energy", "f_inf"):
            a, b = np.asarray(ref[arm][key]), got[arm][key]
            assert b.shape == a.shape == (STUDIES[name],), (arm, key)
            assert np.isfinite(b).all()
        np.testing.assert_allclose(got[arm]["energy"], ref[arm]["energy"],
                                   rtol=1e-4, err_msg=arm)
        a, b = np.asarray(ref[arm]["f_inf"]), got[arm]["f_inf"]
        assert np.all(np.abs(a - b) <= 1e-3 * np.abs(a) + FROM_REST), \
            (arm, a.tolist(), b.tolist())


def test_drag_study_matches_jax_and_mg_is_fastest(studies):
    """drag_study: every arm's linear residuals within the policy; on the
    port's series the V-cycle beats GS and CG at iterations 1-3 and its
    first cycle is over 2 decades below one GS sweep."""
    ref, got = studies["drag_study"]
    assert sorted(got) == ["cg", "gs", "mg"]
    floor = 4 * np.spacing(np.float32(ref["gs"][0]))
    for arm in ("gs", "cg", "mg"):
        a, b = np.asarray(ref[arm]), got[arm]
        assert b.shape == a.shape == (DRAG_ITERS + 1,)
        assert np.all(np.abs(a - b) <= 1e-3 * np.abs(a) + floor), \
            (arm, a.tolist(), b.tolist())
    gs, cg, mg = got["gs"], got["cg"], got["mg"]
    assert mg[0] == gs[0] == cg[0]
    for i in (1, 2, 3):
        assert mg[i] < gs[i] and mg[i] < cg[i]
    assert mg[1] < 5e-3 * gs[1]


def test_frame_adaptive_matches_jax():
    """frame_adaptive on the violent kick (matrix-free PCG, one level):
    equal n_sub and Newton lists over 4 frames, substepping engaged, every
    frame at tol, x within 1e-4."""
    shape, dx = (3, 3, 12), 0.05
    js = JScene(jmesh.beam(*shape, dx=dx), solver=JSolverConfig(n_levels=1))
    ts = Scene(tmesh.beam(*shape, dx=dx), solver=SolverConfig(n_levels=1),
               device="cpu")
    x = np.asarray(js.params["levels"][0]["x0"])
    v = _kick(x)
    jst = jdyn.init_state(js)._replace(v=jnp.asarray(v))
    tst = tdyn.state_from_numpy(x, v, np.zeros(x.shape[0]), x, device="cpu")
    kw = dict(tol=1e-4, max_newton=KICK_BUDGET, use_multigrid=False,
              matrix_free=True, max_halvings=4)
    frame = jax.jit(lambda p, s: jdyn.frame_adaptive(js, p, s, **kw))
    ref, got = [], []
    for _ in range(KICK_FRAMES):
        jst, jk, jfn, jn = frame(js.params, jst)
        tst, k, fn, n = tdyn.frame_adaptive(ts, ts.params, tst, **kw)
        ref.append((int(jn), int(jk)))
        got.append((n, k))
        assert fn <= 1e-4 and float(jfn) <= 1e-4
    assert got == ref
    assert max(n for n, _ in got) > 1
    np.testing.assert_allclose(tst.x.numpy(), np.asarray(jst.x), rtol=0,
                               atol=1e-4)


def test_frame_adaptive_without_substeps_is_step_to_tol(tscene):
    """A frame that converges whole is one step_to_tol frame (default
    multigrid PCG): n_sub 1 and the same state."""
    st0 = tdyn.init_state(tscene)
    st, k, fn, n = tdyn.frame_adaptive(tscene, tscene.params, st0)
    ref, kr, fr = tdyn.step_to_tol(tscene, tscene.params, st0,
                                   dt=np.float32(0.033),
                                   damping=np.float32(0.9995))
    assert n == 1 and k == kr and fn == fr
    assert torch.equal(st.x, ref.x)


def test_ray_triangles_and_fem_picker_match_jax(tscene):
    """ray_triangles on the beam's surface, and the Picker on a FEM
    DynamicSim: the same hits, selected vertex, drag mask and targets as
    the JAX Picker; five dragged frames then match the JAX frames to
    1e-4."""
    js = _jscene()
    m = tscene.mesh
    tris = tmesh.surface_triangles(m.hexes)
    c = m.x.mean(axis=0)
    origin, along = c - np.array([10.0, 0, 0]), np.array([1.0, 0, 0])
    hit, t = ray_triangles(origin, along, m.x.astype(np.float64), tris)
    assert hit.sum() >= 2
    jsim, tsim = jdyn.DynamicSim(js), tdyn.DynamicSim(tscene)
    pj = JPicker(jsim, tris, grab_radius2=0.02)
    pt = Picker(tsim, tris, grab_radius2=0.02)
    np.testing.assert_array_equal(pt.tris, pj.tris)
    assert pj.select(origin, along) and pt.select(origin, along)
    assert pt.select_vertex == pj.select_vertex >= 0
    moved = origin + np.array([0, 0.05, 0])
    pj.move_select(moved, along)
    pt.move_select(moved, along)
    np.testing.assert_array_equal(tsim.state.drag_mask.numpy(),
                                  np.asarray(jsim.state.drag_mask))
    np.testing.assert_allclose(tsim.state.drag_pos.numpy(),
                               np.asarray(jsim.state.drag_pos), atol=1e-6)
    assert float(tsim.state.drag_mask.sum()) > 0
    for _ in range(5):
        jsim.frame()
        tsim.frame()
    np.testing.assert_allclose(tsim.state.x.numpy(), np.asarray(jsim.state.x),
                               rtol=0, atol=1e-4)
    pt.clear()
    assert float(tsim.state.drag_mask.sum()) == 0


def test_checkpoint_round_trip_and_resume(tscene, tmp_path):
    """checkpoint_sim / resume_sim of a DynamicSim and of a QuasiStaticSim;
    the resumed DynamicSim continues with the same bits; save_state /
    load_state keep extras."""
    sim = tdyn.DynamicSim(tscene)
    for _ in range(3):
        sim.frame()
    p = str(tmp_path / "ckpt.npz")
    io.checkpoint_sim(p, sim)
    sim2 = io.resume_sim(p, tdyn.DynamicSim(tscene))
    for a, b in zip(sim.state, sim2.state):
        assert torch.equal(a, b)
    assert torch.equal(sim.frame().x, sim2.frame().x)
    qsim = QuasiStaticSim(tscene)
    qsim.newton_multigrid(2)
    io.checkpoint_sim(p, qsim)
    assert torch.equal(io.resume_sim(p, QuasiStaticSim(tscene)).x, qsim.x)
    io.save_state(p, sim.state, extra={"frame": 4})
    st, extra = io.load_state(p, tdyn.DynState, device="cpu")
    assert torch.equal(st.v, sim.state.v) and int(extra["frame"]) == 4


def test_files_cross_between_packages(tscene, tmp_path):
    """A checkpoint and a pytree that the JAX package wrote load in the
    port, and the port's load in the JAX package (the .tree sidecar's
    structure string included)."""
    js = _jscene()
    jsim = jdyn.DynamicSim(js)
    jsim.frame()
    p = str(tmp_path / "jax_ckpt.npz")
    jio.checkpoint_sim(p, jsim)
    sim = io.resume_sim(p, tdyn.DynamicSim(tscene))
    for got, ref in zip(sim.state, jsim.state):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    tree = {"w": np.arange(6.0, dtype=np.float32).reshape(2, 3),
            "layers": [np.ones(4, np.float32),
                       {"b": np.zeros((2, 2), np.float32), "a": None}],
            "pair": (np.float32(2.0), np.full(3, 7, np.int32))}
    like = {"w": torch.zeros(2, 3), "layers": [torch.zeros(4), {
        "b": torch.zeros(2, 2), "a": None}],
        "pair": (torch.zeros(()), torch.zeros(3, dtype=torch.int32))}
    pj = str(tmp_path / "jax_tree.npz")
    jio.save_pytree(pj, jax.tree_util.tree_map(jnp.asarray, tree))
    out = io.load_pytree(pj, like)
    np.testing.assert_array_equal(out["w"].numpy(), tree["w"])
    np.testing.assert_array_equal(out["pair"][1].numpy(), tree["pair"][1])
    assert isinstance(out["pair"], tuple) and out["layers"][1]["a"] is None
    pt = str(tmp_path / "port_tree.npz")
    io.save_pytree(pt, like)
    back = jio.load_pytree(pt, jax.tree_util.tree_map(jnp.asarray, tree))
    np.testing.assert_array_equal(np.asarray(back["layers"][1]["b"]),
                                  np.zeros((2, 2)))
    with open(pj[:-4] + ".tree") as a, open(pt[:-4] + ".tree") as b:
        assert a.read() == b.read()
    bad = dict(like, w=torch.zeros(3, 2))
    with pytest.raises(ValueError):
        io.load_pytree(pt, bad)


def test_metrics_logger(tmp_path):
    csvp, jl = str(tmp_path / "m.csv"), str(tmp_path / "m.jsonl")
    log = io.MetricsLogger(csv_path=csvp, jsonl_path=jl)
    for i in range(3):
        log.log(i, energy=torch.tensor(1.0 / (i + 1)), f_inf=10.0 ** -i)
    log.close()
    assert log.get("energy").shape == (3,)
    with open(csvp) as fh:
        assert fh.read().count("\n") == 4      # header + 3 rows
    with open(jl) as fh:
        assert fh.read().count("\n") == 3


def test_debug_invariants(tscene):
    """check_symmetry, check_spd, check_energy_decrease and check_galerkin
    on the port's Hessians and Newton-MG series (tests/
    test_debug_invariants.py's cases); an asymmetric table raises."""
    rng = np.random.default_rng(0)
    x = tscene.x0 + torch.from_numpy(
        0.01 * rng.standard_normal(tuple(tscene.x0.shape)).astype(np.float32))
    vals = tqs.assemble_fine(tscene, tscene.params, x)
    assert debug.check_symmetry(tscene.level(0), vals) < 1e-4
    bad = vals.clone()
    bad[0, 1, 0, 1] += 1.0
    with pytest.raises(AssertionError, match="asymmetry"):
        debug.check_symmetry(tscene.level(0), bad)
    squeezed = tqs.assemble_fine(tscene, tscene.params, tscene.x0 * 0.7,
                                 include_pins=False)
    assert debug.check_spd(squeezed) < 0
    assert debug.check_spd(ell.spd_project(squeezed, 1e-3)) > -1e-4
    e, _ = QuasiStaticSim(tscene).newton_multigrid(10)
    assert debug.check_energy_decrease(e[2:], rtol=1e-2)
    assert not debug.check_energy_decrease(torch.tensor([1.0, 2.0]))
    chain = tqs.galerkin_chain(tscene, tscene.params, vals, spd=False)
    debug.check_galerkin(tscene, tscene.params, chain[0], chain[1])


def test_profiling_helpers(tmp_path):
    """time_fn (host clock on the CPU), a span, force_sync and a
    torch.profiler trace written to its directory."""
    t = profiling.time_fn(lambda a: a * 2.0, (torch.ones(10),), iters=3,
                          warmup=1)
    assert t >= 0
    with profiling.span("x", always=True):
        profiling.force_sync({"a": [torch.ones(3)], "b": None})
    rec = profiling.records()[-1]
    assert rec.name == "x" and rec.end_ns >= rec.start_ns
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(100).sum()
    assert list((tmp_path / "tr").iterdir())


def test_camera_unproject_matches_jax():
    """Camera view / proj and the pick ray after rotate, pan and zoom are
    the JAX camera's, and the centre pixel looks at the target."""
    cams = [Camera(position=(0, 0, 3), target=(0, 0, 0)),
            JCamera(position=(0, 0, 3), target=(0, 0, 0))]
    o, d = cams[0].unproject(400, 300, 800, 600)
    np.testing.assert_allclose(o, [0, 0, 3], atol=1e-9)
    np.testing.assert_allclose(d, [0, 0, -1], atol=1e-6)
    for cam in cams:
        cam.rotate(0.3, 0.1)
        cam.pan(0.1, 0.1)
        cam.zoom(0.2)
    np.testing.assert_array_equal(cams[0].view(), cams[1].view())
    np.testing.assert_array_equal(cams[0].proj(), cams[1].proj())
    for px in ((0, 0), (123.5, 456.0), (799, 599)):
        for a, b in zip(cams[0].unproject(*px, 800, 600),
                        cams[1].unproject(*px, 800, 600)):
            np.testing.assert_array_equal(a, b)


def test_headless_window_loop_pick_and_gif(tscene, tmp_path):
    """A HeadlessWindow over a DynamicSim: paused frames do not step, the
    captured frames are host copies, a scripted click / drag / release goes
    through the Picker, and the frames render to a GIF and a PNG."""
    sim = tdyn.DynamicSim(tscene)
    tris = tmesh.surface_triangles(tscene.mesh.hexes)
    win = HeadlessWindow(320, 240)
    win.set_frame_source(lambda: (tscene.to_mesh_order(sim.state.x), tris))
    c = tscene.mesh.x.mean(axis=0)
    win.camera = Camera(position=(c[0], c[1], c[2] + 3.0), target=c,
                        aspect=320 / 240)
    pk = Picker(sim, tris, grab_radius2=0.02)
    win.setSelect(pk.select, pk.move_select, pk.clear)
    calls = []

    def render(pause):
        calls.append(pause)
        if not pause:
            sim.frame()

    win.inject_pause_toggle()
    win.loop(render, max_frames=2, capture_every=1)
    win.inject_pause_toggle()
    win.inject_click(160, 120)
    assert pk.select_vertex >= 0
    win.inject_drag(170, 120)
    assert float(sim.state.drag_mask.sum()) > 0
    win.loop(render, max_frames=6, capture_every=2)
    win.inject_release()
    assert float(sim.state.drag_mask.sum()) == 0
    assert calls[:2] == [True, True] and len(win.frames) == 5
    assert all(isinstance(f, np.ndarray) for f in win.frames)
    assert np.isfinite(win.frames[-1]).all()
    win.save_gif(str(tmp_path / "out.gif"), fps=5)
    win.save_png(str(tmp_path / "out.png"))
    assert (tmp_path / "out.gif").stat().st_size > 500
    win.inject_close()
    win.loop(render, max_frames=3)
    assert len(calls) == 8


def test_viz_renders(tscene, tmp_path):
    """render_surface, plot_convergence (tensor series), render_level and
    show write their images."""
    sim = QuasiStaticSim(tscene)
    e, fn = sim.newton_multigrid(3)
    viz.show(tscene, sim, e, fn, str(tmp_path / "run"))
    viz.render_level(tscene, 1, str(tmp_path / "lvl.png"))
    for name in ("run_energy.png", "run_conv.png", "run_mesh.png",
                 "lvl.png"):
        assert (tmp_path / name).stat().st_size > 1000, name


# -- the live viewer ------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.fixture(scope="module")
def viewer(tscene):
    sim = tdyn.DynamicSim(tscene)
    v = LiveViewer(sim, tmesh.surface_triangles(tscene.mesh.hexes),
                   grab_radius2=0.02)
    url = v.start()
    yield v, url, tscene.mesh
    v.stop()
    assert not any(t.is_alive() for t in v._threads)


def test_live_page_mesh_and_state(viewer):
    """/ serves the page, /mesh the triangles, /state the positions; the sim
    thread advances within 60 s."""
    v, url, m = viewer
    with urllib.request.urlopen(url, timeout=30) as r:
        page = r.read().decode()
    assert "canvas" in page and "/pick" in page
    mi = _get(url + "mesh")
    assert mi["n_verts"] == m.n_verts and mi["radius"] > 0
    tris = np.asarray(mi["tris"]).reshape(-1, 3)
    assert tris.min() >= 0 and tris.max() < m.n_verts
    s0 = _get(url + "state")
    x = np.frombuffer(base64.b64decode(s0["x_b64"]), np.float32)
    assert x.shape[0] == 3 * m.n_verts and np.isfinite(x).all()
    deadline = time.monotonic() + 60
    s1 = s0
    while time.monotonic() < deadline and s1["frame"] <= s0["frame"]:
        time.sleep(0.2)
        s1 = _get(url + "state")
    assert s1["frame"] > s0["frame"], "sim thread did not advance"


def test_live_pick_drag_clear_and_pause(viewer):
    """/pick select / move / clear through the server's Camera and Picker,
    under the viewer's lock; /pause toggles."""
    v, url, m = viewer
    mi = _get(url + "mesh")
    c = mi["center"]
    cam = {"position": [c[0], c[1], c[2] + 4 * mi["radius"]],
           "target": c, "up": [0, 1, 0], "fov_deg": 45.0}
    r = _post(url + "pick", {"mode": "select", "sx": 400, "sy": 300,
                             "w": 800, "h": 600, "cam": cam})
    assert r["hit"] and r["vertex"] >= 0
    r2 = _post(url + "pick", {"mode": "move", "sx": 430, "sy": 300,
                              "w": 800, "h": 600, "cam": cam})
    assert r2["hit"]
    with v._lock:
        assert float(v.sim.state.drag_mask.sum()) > 0
    _post(url + "pick", {"mode": "clear"})
    with v._lock:
        assert float(v.sim.state.drag_mask.sum()) == 0
    p0 = _get(url + "state")["paused"]
    assert _post(url + "pause", {})["paused"] == (not p0)
    assert _post(url + "pause", {})["paused"] == p0
