"""Parity of the torch port's lattice operators with the JAX reference (CPU).

The same seeded numpy inputs go through the JAX XLA stencil functions
(`use_pallas=False`; the JAX tests hold those equal to the Pallas kernels in
interpret mode) and through the port's public kernel wrappers, which run
their plain torch versions on CPU tensors. mu=250, la=37: the default la=0
would hide every lambda term.
"""
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as meshlib
from fem_simulation_tpu.config import MaterialConfig
from fem_simulation_tpu.ops import ell as jell
from fem_simulation_tpu.ops import stencil as jstencil
from fem_simulation_tpu.sim.lattice import LatticeScene as JScene
from fem_simulation_tpu.solvers import cg as jcg

from fem_simulation_tpu_torch.ops import ell, stencil
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim.lattice import LatticeScene
from fem_simulation_tpu_torch.solvers import cg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MU, LA = 250.0, 37.0
MAT = MaterialConfig(lame_mu=MU, lame_la=LA)
INV_DT = 1.0 / 0.033


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(scope="module")
def scenes():
    m = meshlib.beam(4, 4, 8, dx=0.1)
    return JScene(m, MAT), LatticeScene(m, MAT, device="cpu")


@pytest.fixture(scope="module")
def fields(scenes):
    """Seeded displacement u (masked, 0.03 N(0,1)) and direction p."""
    js, _ = scenes
    rng = np.random.default_rng(7)
    shape = js.x0.shape
    vm = np.asarray(js.vert_mask)[..., None]
    u = (0.03 * rng.standard_normal(shape) * vm).astype(np.float32)
    p = rng.standard_normal(shape).astype(np.float32)
    return u, p


def _jax_ref(op, js, u, p):
    sargs = (js.cell_mask, js.g_tab, js.det, MU, LA)
    uj = jnp.asarray(u)
    if op == "force":
        return np.asarray(jstencil.elastic_force_lattice(uj, *sargs))
    if op == "hvp":
        _, tangent = jax.jvp(
            lambda xx: jstencil.elastic_force_lattice(xx, *sargs),
            (uj,), (jnp.asarray(p),))
        return -np.asarray(tangent)
    return np.asarray(jstencil.elastic_hessian_diag_lattice(uj, *sargs))


def _port(op, sc, u, p):
    cm, dx = sc.cell_mask, sc.mesh.dx
    u_cf = t(u).permute(3, 0, 1, 2).contiguous()
    if op == "force":
        return lk.force_cf(u_cf, cm, dx, MU, LA).permute(1, 2, 3, 0).numpy()
    if op == "hvp":
        p_cf = t(p).permute(3, 0, 1, 2).contiguous()
        return lk.hvp_cf(u_cf, p_cf, cm, dx, MU, LA).permute(1, 2, 3, 0).numpy()
    return lk.hess_diag_lattice(t(u), cm, dx, MU, LA).numpy()


@pytest.mark.parametrize("op", ["force", "hvp", "diag"])
def test_vertex_ops_match_jax(scenes, fields, op):
    """(a) force, analytic HVP and Hessian diagonal == JAX XLA stencil
    (the JAX HVP is the negated JVP of the stencil force)."""
    js, sc = scenes
    u, p = fields
    got = _port(op, sc, u, p)
    ref = _jax_ref(op, js, u, p)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


def test_energy_matches_jax(scenes, fields):
    """(b) total elastic energy, relative 1e-4."""
    js, sc = scenes
    u, _ = fields
    ref = float(jstencil.elastic_energy_lattice(
        jnp.asarray(u), js.cell_mask, js.g_tab, js.det, MU, LA))
    got = float(lk.elastic_energy_lattice(t(u), sc.cell_mask, sc.mesh.dx,
                                          MU, LA))
    assert got == pytest.approx(ref, rel=1e-4)


def test_force_translation_invariance():
    """(b) displacement form: moving the mesh origin ~1000 units changes the
    force and energy only by the state quantization (x = x0 + du rounds du at
    ulp(|origin|) ~ 6e-5); the position form's noise here is ~2e-2."""
    cells = np.array([[i, j, k] for i in range(3) for j in range(3)
                      for k in range(8)])
    rng = np.random.default_rng(21)
    u = 0.02 * rng.normal(size=(4 * 4 * 9, 3)).astype(np.float32)
    outs = []
    for origin in (np.zeros(3), np.array([173.0, -58.0, 940.0])):
        sc = LatticeScene(meshlib.hex_mesh_from_cells(cells, 0.05, origin),
                          device="cpu")
        du = stencil.field_to_lattice(t(u), sc.lat, sc.shape) \
            * sc.vert_mask[..., None]
        f = sc.elastic_force(sc.x0 + du)
        e = sc.elastic_energy(sc.x0 + du)
        outs.append((f.numpy(), float(e)))
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=5e-3)
    assert outs[0][1] == pytest.approx(outs[1][1], rel=1e-2)


def _pcg_problem(js, seed=7):
    """The JAX composition of the unfused lattice Newton step's linear solve
    (tests/test_lattice.py:463): RHS, ctrl, analytic matvec, diagonal."""
    rng = np.random.default_rng(seed)
    x = js.x0 + 0.01 * jnp.asarray(
        rng.standard_normal(js.x0.shape).astype(np.float32)) \
        * js.vert_mask[..., None]
    mat = js.material
    ctrl = (mat.control_mag * js.pin_mask + js.mass * INV_DT * INV_DT
            + (1.0 - js.vert_mask))
    f = js.dyn_force(x, x, INV_DT, use_pallas=False)
    return x, ctrl, f


def test_pcg_operator_matches_jax(scenes):
    """(c) pcg_operator: same k convention and solution, zero-RHS no-op,
    and a tighter tol runs more iterations."""
    js, sc = scenes
    x, ctrl, f = _pcg_problem(js)
    vm3 = js.vert_mask[..., None]
    hvp = js.elastic_hvp_fn(x, False)
    diag = js.elastic_diag(x, False) + ctrl[..., None, None] * jnp.eye(3)

    def jsolve(rhs, tol):
        return jcg.pcg_operator(
            lambda p: (hvp(p) + ctrl[..., None] * p) * vm3,
            lambda r: jell.solve3x3(diag, r) * vm3, rhs,
            iterations=20, tol=tol, return_iters=True)

    u = t(x - js.x0)
    tctrl, tvm3 = t(ctrl), sc.vert_mask[..., None]
    tdiag = lk.hess_diag_lattice(u, sc.cell_mask, sc.mesh.dx, MU, LA) \
        + tctrl[..., None, None] * torch.eye(3)
    u_cf = u.permute(3, 0, 1, 2).contiguous()

    def matvec(p):
        hp = lk.hvp_cf(u_cf, p.permute(3, 0, 1, 2).contiguous(),
                       sc.cell_mask, sc.mesh.dx, MU, LA)
        return (hp.permute(1, 2, 3, 0) + tctrl[..., None] * p) * tvm3

    def tsolve(rhs, tol):
        return cg.pcg_operator(matvec, lambda r: ell.solve3x3(tdiag, r) * tvm3,
                               rhs, iterations=20, tol=tol, return_iters=True)

    dx_ref, k_ref = jsolve(f, 1e-2)
    dx_got, k_got = tsolve(t(f), 1e-2)
    assert k_got == int(k_ref)
    np.testing.assert_allclose(dx_got.numpy(), np.asarray(dx_ref),
                               rtol=1e-4, atol=1e-6)
    dx0, k0 = tsolve(torch.zeros_like(t(f)), 1e-2)
    assert float(dx0.abs().max()) == 0.0 and k0 == 1
    _, k_tight_ref = jsolve(f, 1e-6)
    _, k_tight = tsolve(t(f), 1e-6)
    assert k_tight == int(k_tight_ref) > k_got


def test_fused_pcg_plain_matches_jax(scenes):
    """fused_pcg on CPU tensors (its plain version) == the JAX pcg_operator
    composition that tests/test_lattice.py:463 holds plat.fused_pcg to: same
    k, dx to rtol 1e-4; a zero RHS is a no-op with k == 1; a tighter tol,
    given as a 0-d tensor, runs as many more iterations as JAX's."""
    js, sc = scenes
    x, ctrl, f = _pcg_problem(js)
    vm3 = js.vert_mask[..., None]
    hvp = js.elastic_hvp_fn(x, False)
    diag = js.elastic_diag(x, False) + ctrl[..., None, None] * jnp.eye(3)

    def jsolve(tol):
        return jcg.pcg_operator(
            lambda p: (hvp(p) + ctrl[..., None] * p) * vm3,
            lambda r: jell.solve3x3(diag, r) * vm3, f,
            iterations=20, tol=tol, return_iters=True)

    u_cf = t(x - js.x0).permute(3, 0, 1, 2).contiguous()
    f_cf = t(f).permute(3, 0, 1, 2).contiguous()

    def tsolve(rhs, tol):
        return lk.fused_pcg(u_cf, rhs, sc.cell_mask, t(ctrl), sc.vert_mask,
                            sc.mesh.dx, MU, LA, iterations=20, tol=tol)

    dx_ref, k_ref = jsolve(1e-2)
    dx_got, k_got = tsolve(f_cf, 1e-2)
    assert k_got.dtype == torch.int32 and int(k_got) == int(k_ref) > 2
    np.testing.assert_allclose(dx_got.permute(1, 2, 3, 0).numpy(),
                               np.asarray(dx_ref), rtol=1e-4, atol=1e-6)
    dx0, k0 = tsolve(torch.zeros_like(f_cf), 1e-2)
    assert float(dx0.abs().max()) == 0.0 and int(k0) == 1
    _, k_tight_ref = jsolve(1e-6)
    _, k_tight = tsolve(f_cf, torch.tensor(1e-6))
    assert int(k_tight) == int(k_tight_ref) > int(k_got)


def test_fused_newton_plain_matches_jax_with_drag_over_pin(scenes):
    """(d) fused_newton on CPU tensors == the JAX composition dyn_force +
    elastic_hvp_fn + ctrl + elastic_diag + pcg_operator + trial inf_norm,
    with a drag constraint overlapping the pinned slab: the residual's rc
    SUMS pin and drag, the Hessian shift ctrl takes their MAX."""
    m = meshlib.beam(3, 3, 5, dx=0.1)
    js, sc = JScene(m, MAT), LatticeScene(m, MAT, device="cpu")
    mat = js.material
    rng = np.random.default_rng(11)
    vm = np.asarray(js.vert_mask)
    pin = np.asarray(js.pin_mask)
    x0 = np.asarray(js.x0)
    x = x0 + (0.01 * rng.standard_normal(x0.shape) * vm[..., None])
    x_tilde = x0 + (0.005 * rng.standard_normal(x0.shape) * vm[..., None])
    drag = np.zeros_like(pin)
    drag[:, 1:, :3] = 1.0          # pins are the top two y layers
    assert (drag * pin).sum() > 0 and (drag * (1 - pin)).sum() > 0
    drag_pos = x0 + 0.02 * rng.standard_normal(x0.shape)
    x, x_tilde, drag_pos = (a.astype(np.float32) for a in (x, x_tilde,
                                                             drag_pos))
    gs = 0.7

    # JAX composition
    xj, dmj, dpj = jnp.asarray(x), jnp.asarray(drag), jnp.asarray(drag_pos)
    vm3 = js.vert_mask[..., None]
    ctrl = (mat.control_mag * jnp.maximum(js.pin_mask, dmj)
            + js.mass * INV_DT * INV_DT + (1.0 - js.vert_mask))

    def resid(xx):
        return js.dyn_force(xx, jnp.asarray(x_tilde), INV_DT, drag_mask=dmj,
                            drag_pos=dpj, use_pallas=False, gravity_scale=gs)

    f_ref = resid(xj)
    hvp = js.elastic_hvp_fn(xj, False)
    diag = js.elastic_diag(xj, False) + ctrl[..., None, None] * jnp.eye(3)
    dx_ref, k_ref = jcg.pcg_operator(
        lambda p: (hvp(p) + ctrl[..., None] * p) * vm3,
        lambda r: jell.solve3x3(diag, r) * vm3, f_ref,
        iterations=30, tol=1e-4, return_iters=True)
    fn_ref = float(jell.inf_norm(resid(xj + dx_ref * vm3)))

    # port: the affine split of step_to_tol
    rc = (mat.control_mag * (sc.pin_mask + t(drag))
          + sc.mass * INV_DT * INV_DT)
    s_aff = (mat.control_mag * (sc.pin_mask[..., None] * sc.pin_pos
                                + t(drag)[..., None] * t(drag_pos))
             + (sc.mass * INV_DT * INV_DT)[..., None] * t(x_tilde))
    s_aff[..., 1] += sc.mass * mat.gravity * gs
    s_cf = (s_aff - rc[..., None] * sc.x0).permute(3, 0, 1, 2).contiguous()
    dx_cf, f_cf, fn, k = lk.fused_newton(
        (t(x) - sc.x0).permute(3, 0, 1, 2).contiguous(), s_cf, sc.cell_mask,
        t(ctrl), rc, sc.vert_mask, m.dx, mat.lame_mu, mat.lame_la,
        iterations=30, tol=1e-4)
    assert int(k) == int(k_ref) > 2
    fscale = float(np.abs(np.asarray(f_ref)).max())
    np.testing.assert_allclose(f_cf.permute(1, 2, 3, 0).numpy(),
                               np.asarray(f_ref), rtol=1e-4,
                               atol=1e-5 * fscale)
    np.testing.assert_allclose(dx_cf.permute(1, 2, 3, 0).numpy(),
                               np.asarray(dx_ref), rtol=1e-4, atol=1e-6)
    assert float(fn) == pytest.approx(fn_ref, rel=1e-3, abs=1e-5 * fscale)


@pytest.mark.parametrize("op", ["force", "hvp", "diag", "energy", "newton",
                                "pcg"])
def test_wrappers_take_plain_path_only_on_cpu(scenes, op):
    """Dispatch: tensors on another device type, or on two devices, raise;
    only CPU tensors reach the plain versions."""
    _, sc = scenes
    meta = torch.empty(tuple(sc.x0.shape), device="meta")
    cm_meta = torch.empty(tuple(sc.cell_mask.shape), device="meta")
    f_cf = torch.zeros((3,) + tuple(sc.shape))
    args = {
        "force": lambda cm: lk.force_cf(meta.permute(3, 0, 1, 2), cm, 0.1,
                                        MU, LA),
        "hvp": lambda cm: lk.hvp_cf(f_cf, f_cf, cm, 0.1, MU, LA),
        "diag": lambda cm: lk.hess_diag_lattice(meta, cm, 0.1, MU, LA),
        "energy": lambda cm: lk.elastic_energy_lattice(meta, cm, 0.1, MU, LA),
        "newton": lambda cm: lk.fused_newton(
            f_cf, f_cf, cm, sc.mass, sc.mass, sc.vert_mask, 0.1, MU, LA),
        "pcg": lambda cm: lk.fused_pcg(f_cf, f_cf, cm, sc.mass,
                                       sc.vert_mask, 0.1, MU, LA),
    }[op]
    with pytest.raises(ValueError):
        args(cm_meta)


def test_failed_kernel_build_raises(tmp_path, monkeypatch):
    """A kernel source that does not build (or no nvcc at all) is an error,
    never a silent fallback."""
    from fem_simulation_tpu_torch.ops import _cuda
    for name in _cuda._SOURCES:     # the other sources as they are
        shutil.copy(os.path.join(_cuda._CSRC, name), tmp_path)
    (tmp_path / "lattice_chain.cuh").write_text("#error broken\n")
    (tmp_path / "lattice_kernels.cu").write_text('#include "lattice_chain.cuh"\n')
    monkeypatch.setattr(_cuda, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_cuda, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_lib", None)
    with pytest.raises(RuntimeError):
        _cuda.load()
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())
