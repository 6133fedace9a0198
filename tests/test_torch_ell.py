"""Parity of the port's block-ELL path operators with the JAX package (CPU).

The same seeded numpy inputs go through the JAX functions and through the
port's, on the beam(4, 4, 8, dx=0.1) scene with SolverConfig(n_levels=2)
that tests/test_solvers.py uses. The port's kernel wrappers run their plain
torch versions on these CPU tensors. Each case states its tolerance; float32
sums taken in another order differ by a few ulps of the largest term.
"""
import dataclasses
import os
import shutil

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import hierarchy as jhier
from fem_simulation_tpu import mesh as jmesh
from fem_simulation_tpu.config import SolverConfig as JSolverConfig
from fem_simulation_tpu.ops import elastic as jel
from fem_simulation_tpu.ops import ell as jell
from fem_simulation_tpu.ops import pallas_kernels as jpk
from fem_simulation_tpu.ops import transfer as jtr
from fem_simulation_tpu.sim import Scene as JScene
from fem_simulation_tpu.sim import quasistatic as jqs
from fem_simulation_tpu.solvers import cg as jcg
from fem_simulation_tpu.solvers import smoothers as jsm

from fem_simulation_tpu_torch import hierarchy as thier
from fem_simulation_tpu_torch import mesh as tmesh
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.ops import elastic as tel
from fem_simulation_tpu_torch.ops import ell as tell
from fem_simulation_tpu_torch.ops import ell_kernels as tek
from fem_simulation_tpu_torch.ops import transfer as ttr
from fem_simulation_tpu_torch.sim import quasistatic as tqs
from fem_simulation_tpu_torch.sim.scene import Scene, params_from_numpy
from fem_simulation_tpu_torch.solvers import cg as tcg
from fem_simulation_tpu_torch.solvers import smoothers as tsm

MU, LA = 250.0, 37.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """These tensors are small: one torch thread runs them as fast and
    leaves the cores to the JAX compiles of the reference side."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    return torch.from_numpy(np.array(a))


def close(got, ref, rel, what=""):
    """max|got - ref| <= rel * max|ref| (elementwise, NaN-aware)."""
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    scale = float(np.abs(ref).max()) if ref.size else 0.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.fixture(scope="module")
def scenes():
    js = JScene(jmesh.beam(4, 4, 8, dx=0.1), solver=JSolverConfig(n_levels=2))
    ts = Scene(tmesh.beam(4, 4, 8, dx=0.1), solver=SolverConfig(n_levels=2),
               device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def state(scenes):
    """A seeded perturbed state, the fine Hessian there (JAX) and a vector."""
    js, _ = scenes
    rng = np.random.default_rng(0)
    x = (np.asarray(js.x0) + 0.01 * rng.standard_normal(js.x0.shape)
         ).astype(np.float32)
    vals = np.asarray(jqs.assemble_fine(js, js.params, jnp.asarray(x)))
    v = rng.standard_normal(x.shape).astype(np.float32)
    return x, vals, v


@pytest.mark.parametrize("shape,n_levels", [((4, 4, 8), 2), ((8, 8, 16), None)])
def test_mesh_and_hierarchy_equal_jax(shape, n_levels):
    """The port's own mesh.py and hierarchy.py (numpy only, no C++ helper)
    build exactly the JAX package's mesh, levels and transfers."""
    jm, tm = jmesh.beam(*shape, dx=0.1), tmesh.beam(*shape, dx=0.1)
    for f in ("x", "hexes", "ijk"):
        np.testing.assert_array_equal(getattr(tm, f), getattr(jm, f))
    a = jhier.build_hierarchy(jm, n_levels)
    b = thier.build_hierarchy(tm, n_levels)
    assert a.n_levels == b.n_levels >= 2
    np.testing.assert_array_equal(a.idx2mesh, b.idx2mesh)
    for ga, gb in zip(a.levels + a.transfers, b.levels + b.transfers):
        for fld in dataclasses.fields(ga):
            x, y = getattr(ga, fld.name), getattr(gb, fld.name)
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype, fld.name
                np.testing.assert_array_equal(x, y, err_msg=fld.name)
            else:
                assert x == y, fld.name


def test_scene_tables_equal_jax(scenes):
    """Scene.params: integer tables exactly, float tables to 1e-6 (the rest
    tables come from torch's 3x3 inv and det); params_from_numpy carries the
    JAX pytree over to the same dict."""
    js, ts = scenes
    carried = params_from_numpy(
        {k: [{n: np.asarray(a) for n, a in d.items()} for d in v]
         for k, v in js.params.items()}, device="cpu")
    for kind in ("levels", "transfers"):
        assert len(js.params[kind]) == len(ts.params[kind])
        for jd, td, cd in zip(js.params[kind], ts.params[kind],
                              carried[kind]):
            assert set(td) - {"galerkin_plan"} == set(jd) == \
                set(cd) - {"galerkin_plan"}
            for name, ref in jd.items():
                ref = np.asarray(ref)
                got = td[name].numpy()
                assert got.dtype == ref.dtype, name
                if ref.dtype.kind in "iu":
                    np.testing.assert_array_equal(got, ref, err_msg=name)
                    np.testing.assert_array_equal(cd[name].numpy(), ref)
                else:
                    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6,
                                               err_msg=name)
                    np.testing.assert_array_equal(cd[name].numpy(), ref)


def test_spmv_plain_matches_jax_and_pallas(scenes, state):
    """spmv_plain / spmv_rows_plain (the kernel's plain version) == JAX
    ell.spmv / spmv_rows and the TPU kernel's own function
    (pallas_kernels.spmv in interpret mode), to 1e-6 of max|y|, on the full
    range and every color range; a NaN at a masked slot propagates."""
    js, ts = scenes
    _, vals, v = state
    p = ts.params["levels"][0]
    nbr, mask = p["nbr"], p["mask"]
    full = t(vals) * mask[..., None, None]
    jfull = jnp.asarray(full.numpy())
    jn, jmk, jv = jnp.asarray(nbr.numpy()), jnp.asarray(mask.numpy()), \
        jnp.asarray(v)
    ref = np.asarray(jell.spmv(jfull, jn, jmk, jv))
    close(tek.spmv_plain(full, nbr, mask, t(v)), ref, 1e-6, "spmv")
    close(tell.spmv(full, nbr, mask, t(v)), ref, 1e-6, "ell.spmv")
    pallas = np.asarray(jpk.spmv(jfull, jn, jmk, jv, interpret=True))
    close(tek.spmv_plain(full, nbr, mask, t(v)), pallas, 1e-6, "pallas")
    offs = ts.level(0).color_offsets
    for c in range(len(offs) - 1):
        # JAX's spmv_rows is the row slice of spmv
        r0, r1 = int(offs[c]), int(offs[c + 1])
        close(tell.spmv_rows(full, nbr, mask, t(v), r0, r1), ref[r0:r1],
              1e-6, f"color {c}")
    # a non-finite value at a padded slot is multiplied, not skipped
    row, slot = np.argwhere(mask.numpy() == 0)[0]
    bad = full.clone()
    bad[row, slot] = float("nan")
    got = tek.spmv_plain(bad, nbr, mask, t(v)).numpy()
    ref = np.asarray(jell.spmv(jnp.asarray(bad.numpy()), jn, jmk, jv))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[row]).all()


def test_spmv_wrapper_checks_and_dispatch(scenes, state):
    """The wrapper raises on a wrong dtype, shape, row range or device;
    CPU tensors take the plain version and launch nothing."""
    _, ts = scenes
    _, vals, v = state
    p = ts.params["levels"][0]
    nbr, mask, vv, x = p["nbr"], p["mask"], t(vals), t(v)
    before = tek.launches["spmv"]
    tek.spmv(vv, nbr, mask, x)
    assert tek.launches["spmv"] == before
    with pytest.raises(TypeError):
        tek.spmv(vv, nbr.long(), mask, x)
    with pytest.raises(ValueError):
        tek.spmv(vv, nbr, mask, x[:-1])
    with pytest.raises(ValueError):
        tek.spmv_rows(vv, nbr, mask, x, 3, 2)
    with pytest.raises(ValueError):
        tek.spmv(vv.to("meta"), nbr.to("meta"), mask.to("meta"),
                 x.to("meta"))


ELASTIC_OPS = ["prepare", "lumped_mass", "energy", "force", "force_gather",
               "hvp_gather", "hessian_blocks", "assemble_hessian_ell",
               "assemble_hessian_ell_gather", "hessian_diag",
               "hessian_diag_gather"]


@pytest.mark.parametrize("op", ELASTIC_OPS)
def test_elastic_ops_match_jax(scenes, state, op):
    """ops/elastic.py at mu=250, la=37 on a perturbed state: to 1e-5 of
    max|ref| (energy: relative 1e-5)."""
    js, ts = scenes
    x, _, v = state
    pj, pt = js.params["levels"][0], ts.params["levels"][0]
    lvl = ts.level(0)
    n = lvl.n_verts
    jx, tx = jnp.asarray(x), t(x)
    jc = (pj["hexes"], pj["det"], pj["g"], MU, LA)
    tc = (pt["hexes"], pt["det"], pt["g"], MU, LA)
    gath_j = (pj["vc_idx"], pj["vc_mask"], n)
    gath_t = (pt["vc_idx"], pt["vc_mask"], n)
    if op == "prepare":
        ref = jel.prepare(jnp.asarray(lvl.x0), pj["hexes"])
        got = tel.prepare(t(lvl.x0), pt["hexes"])
        for a, b, name in zip(got, ref, ("det", "g", "vol")):
            close(a, b, 1e-6, name)
        return
    if op == "lumped_mass":
        vol = np.asarray(jel.prepare(jnp.asarray(lvl.x0), pj["hexes"])[2])
        ref = jel.lumped_mass(jnp.asarray(vol), pj["hexes"], n, 1.3)
        close(tel.lumped_mass(t(vol), pt["hexes"], n, 1.3), ref, 1e-6)
        return
    calls = {
        "energy": (lambda: jel.energy(jx, *jc), lambda: tel.energy(tx, *tc)),
        "force": (lambda: jel.force(jx, *jc, n), lambda: tel.force(tx, *tc, n)),
        "force_gather": (lambda: jel.force_gather(jx, *jc, *gath_j),
                         lambda: tel.force_gather(tx, *tc, *gath_t)),
        "hvp_gather": (
            lambda: jel.hvp_gather(jx, jnp.asarray(v), *jc, *gath_j),
            lambda: tel.hvp_gather(tx, t(v), *tc, *gath_t)),
        "hessian_blocks": (lambda: jel.hessian_blocks(jx, *jc),
                           lambda: tel.hessian_blocks(tx, *tc)),
        "assemble_hessian_ell": (
            lambda: jel.assemble_hessian_ell(jx, *jc, pj["hex_slot"], n,
                                             lvl.K),
            lambda: tel.assemble_hessian_ell(tx, *tc, pt["hex_slot"], n,
                                             lvl.K)),
        "assemble_hessian_ell_gather": (
            lambda: jel.assemble_hessian_ell_gather(
                jx, *jc, pj["contrib_idx"], pj["contrib_mask"], n, lvl.K),
            lambda: tel.assemble_hessian_ell_gather(
                tx, *tc, pt["contrib_idx"], pt["contrib_mask"], n, lvl.K)),
        "hessian_diag": (lambda: jel.hessian_diag(jx, *jc, n),
                         lambda: tel.hessian_diag(tx, *tc, n)),
        "hessian_diag_gather": (
            lambda: jel.hessian_diag_gather(jx, *jc, *gath_j),
            lambda: tel.hessian_diag_gather(tx, *tc, *gath_t)),
    }
    jf, tf = calls[op]
    close(tf(), jf(), 1e-5, op)


def test_per_vertex_terms_match_jax(scenes, state):
    """Gravity, pin and inertia terms (energy relative 1e-6, forces 1e-6 of
    max|ref|)."""
    js, ts = scenes
    x, _, v = state
    pj, pt = js.params["levels"][0], ts.params["levels"][0]
    xt = x + 0.01 * v
    jx, tx, jxt, txt = jnp.asarray(x), t(x), jnp.asarray(xt), t(xt)
    n = x.shape[0]
    pairs = [
        (jel.gravity_energy(jx, pj["mass"], -4.9),
         tel.gravity_energy(tx, pt["mass"], -4.9)),
        (jel.gravity_force(pj["mass"], -4.9, n),
         tel.gravity_force(pt["mass"], -4.9, n)),
        (jel.pin_energy(jx, pj["pin_mask"], pj["pin_pos"], 100.0),
         tel.pin_energy(tx, pt["pin_mask"], pt["pin_pos"], 100.0)),
        (jel.pin_force(jx, pj["pin_mask"], pj["pin_pos"], 100.0),
         tel.pin_force(tx, pt["pin_mask"], pt["pin_pos"], 100.0)),
        (jel.inertia_force(jx, jxt, pj["mass"], 30.0),
         tel.inertia_force(tx, txt, pt["mass"], 30.0)),
        (jel.inertia_energy(jx, jxt, pj["mass"], 30.0),
         tel.inertia_energy(tx, txt, pt["mass"], 30.0)),
    ]
    for i, (ref, got) in enumerate(pairs):
        close(got, ref, 1e-6, f"term {i}")


@pytest.fixture(scope="module")
def blocks():
    """Symmetric 3x3 blocks with degenerate ones (zero, isotropic, rank-1)."""
    rng = np.random.default_rng(2)
    A = rng.normal(size=(200, 3, 3))
    A = 0.5 * (A + np.transpose(A, (0, 2, 1)))
    A[0] = 0.0
    A[1] = 2.5 * np.eye(3)
    A[2] = np.outer([1.0, 2.0, -1.0], [1.0, 2.0, -1.0])
    return A.astype(np.float32)


@pytest.mark.parametrize("fn", ["eigh3x3", "spd_project", "spd_project_rel",
                                "eigvals3x3_sym", "spd_shift3x3",
                                "solve3x3"])
def test_block_utilities_match_jax(blocks, fn):
    """ops/ell.py batched 3x3 utilities, to 1e-5 of max|ref| (the same
    cyclic-Jacobi rotations and closed forms, elementwise in float32)."""
    A = blocks
    ja, ta = jnp.asarray(A), t(A)
    if fn == "eigh3x3":
        (wj, vj), (wt, vt) = jell.eigh3x3(ja), tell.eigh3x3(ta)
        close(wt, wj, 1e-5, "w")
        close(vt, vj, 1e-5, "V")
    elif fn == "spd_project":
        close(tell.spd_project(ta, 1e-3), jell.spd_project(ja, 1e-3), 1e-5)
    elif fn == "spd_project_rel":
        close(tell.spd_project(ta, 1e-3, rel_floor=1e-2),
              jell.spd_project(ja, 1e-3, rel_floor=1e-2), 1e-5)
    elif fn == "eigvals3x3_sym":
        for a, b in zip(tell.eigvals3x3_sym(ta), jell.eigvals3x3_sym(ja)):
            close(a, b, 1e-5)
    elif fn == "spd_shift3x3":
        close(tell.spd_shift3x3(ta, rel_floor=1e-3),
              jell.spd_shift3x3(ja, rel_floor=1e-3), 1e-5)
    else:
        spd = A @ np.transpose(A, (0, 2, 1)) + 0.5 * np.eye(3, dtype=A.dtype)
        b = np.random.default_rng(3).normal(size=(200, 3)).astype(np.float32)
        close(tell.solve3x3(t(spd), t(b)),
              jell.solve3x3(jnp.asarray(spd), jnp.asarray(b)), 1e-5)


def test_diag_slot_helpers_match_jax(scenes, state):
    """diag_blocks and add_to_diag: exact (a gather and one add)."""
    js, ts = scenes
    _, vals, v = state
    ds = ts.params["levels"][0]["diag_slot"]
    jds = js.params["levels"][0]["diag_slot"]
    add = np.tile(v[:, :, None], (1, 1, 3))
    np.testing.assert_array_equal(
        tell.diag_blocks(t(vals), ds).numpy(),
        np.asarray(jell.diag_blocks(jnp.asarray(vals), jds)))
    np.testing.assert_array_equal(
        tell.add_to_diag(t(vals), ds, t(add)).numpy(),
        np.asarray(jell.add_to_diag(jnp.asarray(vals), jds,
                                    jnp.asarray(add))))


def test_transfers_match_jax(scenes, state):
    """prolong and restrict to 1e-6 of max|ref|; the Galerkin product with
    the scene's gather plan to 1e-5 of max|ref| (it sums ~10^2 terms per
    coarse entry in another order)."""
    js, ts = scenes
    _, vals, v = state
    tj, tt = js.params["transfers"][0], ts.params["transfers"][0]
    lv1 = ts.level(1)
    vc = np.random.default_rng(4).normal(size=(lv1.n_verts, 3)
                                         ).astype(np.float32)
    close(ttr.prolong(tt["p_idx"], tt["p_w"], t(vc)),
          jtr.prolong(tj["p_idx"], tj["p_w"], jnp.asarray(vc)), 1e-6)
    close(ttr.restrict(tt["r_idx"], tt["r_w"], t(v)),
          jtr.restrict(tj["r_idx"], tj["r_w"], jnp.asarray(v)), 1e-6)
    ref = jtr.galerkin(jnp.asarray(vals), tj["g_src"], tj["g_dst"],
                       tj["g_w"], lv1.n_verts, lv1.K)
    close(ttr.galerkin(t(vals), tt["galerkin_plan"], lv1.n_verts, lv1.K),
          ref, 1e-5)


@pytest.fixture(scope="module")
def system(scenes, state):
    """An SPD fine-level system: the Hessian plus 0.5 I on the diagonal,
    in both packages, and a seeded right-hand side."""
    js, ts = scenes
    _, vals, v = state
    ds = np.asarray(js.params["levels"][0]["diag_slot"])
    eye = np.broadcast_to(0.5 * np.eye(3, dtype=np.float32),
                          (vals.shape[0], 3, 3))
    jv = jell.add_to_diag(jnp.asarray(vals), jnp.asarray(ds),
                          jnp.asarray(eye))
    return (js.make_op(0), jv, jnp.asarray(v)), \
        (ts.make_op(0), tell.add_to_diag(t(vals), t(ds), t(eye)), t(v))


@pytest.mark.parametrize("case", ["jacobi", "jacobi_x0", "gauss_seidel",
                                  "gauss_seidel_x0", "sweep_fwd",
                                  "sweep_bwd", "cg", "cg_x0",
                                  "cg_operator", "cg_operator_x0"])
def test_smoothers_and_cg_match_jax(system, case):
    """Block Jacobi, the colored symmetric Gauss-Seidel (and one sweep of
    it), and CG on the block-ELL operator (the SpMV wrapper's matvec) or an
    abstract operator, from zero or from x0: to 1e-4 of max|x| (CG's
    recurrences carry the roundoff of ~10 matvecs)."""
    (jop, jv, jb), (top, tv, tb) = system
    x0 = 0.1 * np.random.default_rng(6).normal(size=tuple(tb.shape)) \
        .astype(np.float32)
    jx0, tx0 = jnp.asarray(x0), t(x0)
    full_j = jv * jop.mask[..., None, None]
    full_t = tv * top.mask[..., None, None]
    calls = {
        "jacobi": (lambda: jsm.jacobi(jop, jv, jb, iterations=3),
                   lambda: tsm.jacobi(top, tv, tb, iterations=3)),
        "jacobi_x0": (lambda: jsm.jacobi(jop, jv, jb, 2, x0=jx0),
                      lambda: tsm.jacobi(top, tv, tb, 2, x0=tx0)),
        "gauss_seidel": (
            lambda: jax.jit(lambda a, b: jsm.gauss_seidel(jop, a, b, 2))(
                jv, jb),
            lambda: tsm.gauss_seidel(top, tv, tb, 2)),
        "gauss_seidel_x0": (
            lambda: jax.jit(lambda a, b, c: jsm.gauss_seidel(
                jop, a, b, 1, x0=c))(jv, jb, jx0),
            lambda: tsm.gauss_seidel(top, tv, tb, 1, x0=tx0)),
        "sweep_fwd": (
            lambda: jax.jit(lambda a, b: jsm._sweep(
                jop, a, jell.diag_blocks(a, jop.diag_slot), b,
                reverse=False))(jv, jb),
            lambda: tsm._sweep(top, tv, tell.diag_blocks(tv, top.diag_slot),
                               tb, reverse=False)),
        "sweep_bwd": (
            lambda: jax.jit(lambda a, b: jsm._sweep(
                jop, a, jell.diag_blocks(a, jop.diag_slot), b,
                reverse=True))(jv, jb),
            lambda: tsm._sweep(top, tv, tell.diag_blocks(tv, top.diag_slot),
                               tb, reverse=True)),
        "cg": (lambda: jcg.cg(jop, jv, jb, iterations=10, tol=1e-6),
               lambda: tcg.cg(top, tv, tb, iterations=10, tol=1e-6)),
        "cg_x0": (lambda: jcg.cg(jop, jv, jb, 10, 1e-6, x0=jx0),
                  lambda: tcg.cg(top, tv, tb, 10, 1e-6, x0=tx0)),
        "cg_operator": (
            lambda: jcg.cg_operator(
                lambda p: jell.spmv(full_j, jop.nbr, jop.mask, p), jb, 10,
                1e-6),
            lambda: tcg.cg_operator(
                lambda p: tell.spmv(full_t, top.nbr, top.mask, p), tb, 10,
                1e-6)),
        "cg_operator_x0": (
            lambda: jcg.cg_operator(
                lambda p: jell.spmv(full_j, jop.nbr, jop.mask, p), jb, 10,
                1e-6, x0=jx0),
            lambda: tcg.cg_operator(
                lambda p: tell.spmv(full_t, top.nbr, top.mask, p), tb, 10,
                1e-6, x0=tx0)),
    }
    jf, tf = calls[case]
    close(tf(), jf(), 1e-4, case)


def test_cg_zero_rhs_and_budget(system):
    """A zero right-hand side is a no-op (scale_back = 0); a budget of one
    iteration gives the JAX package's one-step iterate (p = r)."""
    (jop, jv, jb), (top, tv, tb) = system
    assert float(tcg.cg(top, tv, torch.zeros_like(tb)).abs().max()) == 0.0
    close(tcg.cg(top, tv, tb, iterations=1),
          jcg.cg(jop, jv, jb, iterations=1), 1e-5)


def test_failed_ell_kernel_build_raises(tmp_path, monkeypatch):
    """A block-ELL kernel source that does not build (or no nvcc at all)
    fails the kernel library's build: an error, never a silent fallback."""
    from fem_simulation_tpu_torch.ops import _cuda
    for name in ("lattice_chain.cuh", "lattice_kernels.cu"):
        shutil.copy(os.path.join(_cuda._CSRC, name), tmp_path)
    (tmp_path / "ell_kernels.cu").write_text("#error broken\n")
    monkeypatch.setattr(_cuda, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_cuda, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_lib", None)
    with pytest.raises(RuntimeError):
        _cuda.load()
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())
