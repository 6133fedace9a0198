"""The torch port's lattice dynamic step against the JAX reference (CPU).

Scenes are built from the same mesh in both packages; trajectories are
stepped with the excited protocol (gravity scaled by cos(2 pi t / 16)) and
compared frame by frame. The JAX side runs its XLA path (use_pallas=False).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as meshlib
from fem_simulation_tpu.sim import lattice as jlat

from fem_simulation_tpu_torch.sim import lattice as tlat

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 8


def gravity_scale(frame: int) -> float:
    """The excited protocol's per-frame gravity scale, in float32."""
    return float(np.cos(np.float32(2.0 * np.pi) * np.float32(frame)
                        / np.float32(16.0)))


@pytest.fixture(scope="module")
def beam():
    return meshlib.beam(3, 3, 8, dx=0.05)


@pytest.fixture(scope="module")
def jax_run(beam):
    """JAX scene and its first N_FRAMES excited frames: [(state, k, fn)]."""
    js = jlat.LatticeScene(beam)
    step = jax.jit(lambda s, gs: jlat.step_to_tol(
        js, s, tol=1e-4, use_pallas=False, gravity_scale=gs))
    st = js.init_state()
    frames = []
    for i in range(N_FRAMES):
        st, k, fn = step(st, jnp.float32(gravity_scale(i)))
        frames.append((st, int(k), float(fn)))
    return js, frames


@pytest.mark.parametrize("pins", [None, "zmin"])
def test_scene_tensors_equal_jax(beam, pins):
    """(e) the port's scene holds exactly the JAX scene's tensors."""
    if pins == "zmin":
        pins = np.nonzero(beam.ijk[:, 2] == beam.ijk[:, 2].min())[0]
    js = jlat.LatticeScene(beam, pins=pins)
    sc = tlat.LatticeScene(beam, pins=pins, device="cpu")
    assert sc.shape == js.shape and js.boxes is None
    assert sc.det == js.det
    for name in ("lat", "cell_mask", "vert_mask", "mass", "x0", "pin_mask",
                 "pin_pos", "g_tab"):
        got = getattr(sc, name).numpy()
        ref = np.asarray(getattr(js, name))
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)


def test_excited_frames_match_jax(beam, jax_run):
    """(f) 8 excited frames: equal per-frame Newton counts, states within
    atol 2e-5 (the bound tests/test_lattice.py holds Pallas to XLA with)."""
    _, frames = jax_run
    sc = tlat.LatticeScene(beam, device="cpu")
    st = sc.init_state()
    ks = []
    for i, (jst, jk, jfn) in enumerate(frames):
        st, k, fn = tlat.step_to_tol(sc, st, tol=1e-4,
                                     gravity_scale=gravity_scale(i))
        ks.append(k)
        assert k == jk, f"frame {i}: {k} Newton vs JAX {jk}"
        assert fn <= 1e-4
        np.testing.assert_allclose(st.x.numpy(), np.asarray(jst.x),
                                   atol=2e-5, err_msg=f"frame {i}")
        np.testing.assert_allclose(st.v.numpy(), np.asarray(jst.v),
                                   atol=2e-5 / 0.033, err_msg=f"frame {i}")
    assert sum(ks) >= N_FRAMES


def test_state_from_numpy_continues_jax_trajectory(beam, jax_run):
    """(h) a JAX state after 3 frames, carried over with state_from_numpy
    and stepped once, lands on the JAX package's 4th frame."""
    _, frames = jax_run
    sc = tlat.LatticeScene(beam, device="cpu")
    jst = frames[2][0]
    st = tlat.state_from_numpy(*(np.asarray(a) for a in jst), device="cpu")
    back = tlat.state_to_numpy(st)
    for a, b in zip(back, jst):
        np.testing.assert_array_equal(a, np.asarray(b))
    st, k, fn = tlat.step_to_tol(sc, st, tol=1e-4,
                                 gravity_scale=gravity_scale(3))
    jst4, jk, _ = frames[3]
    assert k == jk and fn <= 1e-4
    np.testing.assert_allclose(st.x.numpy(), np.asarray(jst4.x), atol=2e-5)


def test_violent_kick_rescue_keeps_frames_finite():
    """(g) port of tests/test_lattice.py:415: a violent rigid-rotation kick
    blows full Newton steps up; the Armijo rescue on the incremental
    potential must engage and keep every frame finite."""
    sc = tlat.LatticeScene(meshlib.beam(3, 3, 12, dx=0.05), device="cpu")
    st = sc.init_state()
    x = st.x.numpy()
    r = x - x.reshape(-1, 3).mean(0)
    omega = np.array([18.0, 0.0, 6.0], np.float32)
    v = np.cross(np.broadcast_to(omega, r.shape), r).astype(np.float32)
    st = st._replace(v=torch.from_numpy(v) * sc.vert_mask[..., None])
    info = {}
    for _ in range(6):
        st, k, fn = tlat.step_to_tol(sc, st, tol=1e-4, max_newton=25,
                                     info=info)
        assert torch.isfinite(st.x).all() and torch.isfinite(st.v).all()
    assert info["rescues"] >= 1


def test_port_imports_no_jax():
    """(i) every module of the port, and chip_smoke.py, import without
    loading jax or any module of the JAX package; a CPU frame runs."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import fem_simulation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,\n"
        "                                               pkg.__name__ + '.')]\n"
        "assert {'fem_simulation_tpu_torch.sim.dynamic',\n"
        "        'fem_simulation_tpu_torch.ops.ell_kernels'} <= set(names)\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "from fem_simulation_tpu_torch import mesh\n"
        "from fem_simulation_tpu_torch.sim.lattice import LatticeDynamicSim\n"
        "sim = LatticeDynamicSim(mesh.beam(2, 2, 4, dx=0.05), device='cpu')\n"
        "st, k, fn = sim.frame_to_tol()\n"
        "assert fn <= 1e-4, fn\n"
        "bad = sorted(m for m in sys.modules if m == 'jax'\n"
        "             or m.startswith('jax.') or m == 'fem_simulation_tpu'\n"
        "             or m.startswith('fem_simulation_tpu.'))\n"
        "assert not bad, bad\n"
        "print('no-jax ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "no-jax ok" in out.stdout


def test_chip_smoke_fails_without_cuda():
    """(j) where no CUDA device is visible, chip_smoke.py exits non-zero
    and prints no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
