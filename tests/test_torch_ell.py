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
from fem_simulation_tpu_torch.config import ClothConfig, SolverConfig
from fem_simulation_tpu_torch.ops import elastic as tel
from fem_simulation_tpu_torch.ops import ell as tell
from fem_simulation_tpu_torch.ops import ell_kernels as tek
from fem_simulation_tpu_torch.ops import transfer as ttr
from fem_simulation_tpu_torch.sim import cloth as tcloth
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


@pytest.fixture(scope="module", params=["hex", "cloth"])
def spmv_case(request, scenes, state):
    """(values masked, nbr, mask, v, row ranges): the hex beam's fine
    Hessian (K 27, its color ranges), or the 8x8 cloth's frame Hessian at a
    seeded perturbed state (K 7: the lane groups' narrow rows; two row
    ranges), tables from the port's ClothScene."""
    if request.param == "hex":
        _, ts = scenes
        _, vals, v = state
        p = ts.params["levels"][0]
        offs = [int(c) for c in ts.level(0).color_offsets]
        return (t(vals) * p["mask"][..., None, None], p["nbr"], p["mask"], v,
                list(zip(offs[:-1], offs[1:])))
    sc = tcloth.ClothScene(ClothConfig(res_x=8, res_y=8), pins=[0, 8],
                           device="cpu")
    p = sc.params
    rng = np.random.default_rng(8)
    x = p["x0"] + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(p["x0"].shape)).astype(np.float32))
    diag = tcloth._frame_diag(sc, p, tcloth.init_state(sc), 1.0 / sc.cfg.dt)
    vals = tcloth._frame_hessian(sc, p, x, diag)
    assert tuple(vals.shape[:2]) == (81, 7)
    v = rng.standard_normal(tuple(x.shape)).astype(np.float32)
    return (vals * p["mask"][..., None, None], p["nbr"], p["mask"], v,
            [(0, 27), (27, 81)])


def test_spmv_plain_matches_jax_and_pallas(spmv_case):
    """spmv_plain / spmv_rows_plain (the kernel's plain version) == JAX
    ell.spmv / spmv_rows and the TPU kernel's own function
    (pallas_kernels.spmv in interpret mode), to 1e-6 of max|y|, on the full
    range and every row range, at K 27 and at the cloth's K 7; a NaN at a
    masked slot propagates."""
    full, nbr, mask, v, ranges = spmv_case
    jfull = jnp.asarray(full.numpy())
    jn, jmk, jv = jnp.asarray(nbr.numpy()), jnp.asarray(mask.numpy()), \
        jnp.asarray(v)
    ref = np.asarray(jell.spmv(jfull, jn, jmk, jv))
    close(tek.spmv_plain(full, nbr, mask, t(v)), ref, 1e-6, "spmv")
    close(tell.spmv(full, nbr, mask, t(v)), ref, 1e-6, "ell.spmv")
    pallas = np.asarray(jpk.spmv(jfull, jn, jmk, jv, interpret=True))
    close(tek.spmv_plain(full, nbr, mask, t(v)), pallas, 1e-6, "pallas")
    for r0, r1 in ranges:
        # JAX's spmv_rows is the row slice of spmv
        close(tell.spmv_rows(full, nbr, mask, t(v), r0, r1), ref[r0:r1],
              1e-6, f"rows [{r0}, {r1})")
    # a non-finite value at a padded slot is multiplied, not skipped
    row, slot = np.argwhere(mask.numpy() == 0)[0]
    bad = full.clone()
    bad[row, slot] = float("nan")
    got = tek.spmv_plain(bad, nbr, mask, t(v)).numpy()
    ref = np.asarray(jell.spmv(jnp.asarray(bad.numpy()), jn, jmk, jv))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(got[row]).all()


@pytest.mark.parametrize("k,want", [(1, 1), (2, 2), (3, 4), (7, 8), (8, 8),
                                    (9, 16), (27, 32), (32, 32)])
def test_spmv_lanes_fit_the_row(k, want):
    """ell_spmv / ell_outer give a row the smallest power of two of lanes
    >= K (8 at the cloth's K 7, 32 at a hex mesh's 27)."""
    assert tek.lanes(k) == want


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
                                  "gauss_seidel_x0", "gs_plain",
                                  "gs_plain_x0", "sweep_fwd",
                                  "sweep_bwd", "cg", "cg_x0",
                                  "cg_operator", "cg_operator_x0"])
def test_smoothers_and_cg_match_jax(system, case):
    """Block Jacobi, the colored symmetric Gauss-Seidel (and one sweep of
    it; and the kernel's plain version, one in-place pass per color in the
    kernel's passes), and CG on the block-ELL operator (the SpMV wrapper's
    matvec) or an abstract operator, from zero or from x0: to 1e-4 of
    max|x| (CG's recurrences carry the roundoff of ~10 matvecs)."""
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
        "gs_plain": (
            lambda: jax.jit(lambda a, b: jsm.gauss_seidel(jop, a, b, 3))(
                jv, jb),
            lambda: tek.gs_plain(tv, top.nbr, top.mask, top.diag_slot,
                                 top.color_offsets, tb, None, 3)),
        "gs_plain_x0": (
            lambda: jax.jit(lambda a, b, c: jsm.gauss_seidel(
                jop, a, b, 1, x0=c))(jv, jb, jx0),
            lambda: tek.gs_plain(tv, top.nbr, top.mask, top.diag_slot,
                                 top.color_offsets, tb, tx0, 1)),
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
    for name in _cuda._SOURCES:     # the other sources as they are
        shutil.copy(os.path.join(_cuda._CSRC, name), tmp_path)
    (tmp_path / "ell_kernels.cu").write_text("#error broken\n")
    monkeypatch.setattr(_cuda, "_CSRC", str(tmp_path))
    monkeypatch.setattr(_cuda, "_BUILD", str(tmp_path / "build"))
    monkeypatch.setattr(_cuda, "_lib", None)
    with pytest.raises(RuntimeError):
        _cuda.load()
    assert not (tmp_path / "build").exists() or not any(
        p.suffix == ".so" for p in (tmp_path / "build").iterdir())


# -- the fused smoother kernels' plain versions ---------------------------------

@pytest.fixture(scope="module")
def level_systems(scenes, system):
    """{level: (op, values, b)}: the SPD fine system and its Galerkin coarse
    operator (the port's own product) with a seeded right-hand side."""
    _, ts = scenes
    _, (top, tv, tb) = system
    tr = ts.params["transfers"][0]
    lv1 = ts.level(1)
    vc = ttr.galerkin(tv, tr["galerkin_plan"], lv1.n_verts, lv1.K)
    bc = t(np.random.default_rng(8).normal(size=(lv1.n_verts, 3))
           .astype(np.float32))
    return {0: (top, tv, tb), 1: (ts.make_op(1), vc, bc)}


def _with_empty_color(op):
    """The same operator with an empty color class put after the first."""
    offs = op.color_offsets
    return tsm.EllOperator(op.nbr, op.mask, op.diag_slot,
                           offs[:2] + offs[1:])


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("case", ["zero_start", "x0", "three_iterations",
                                  "empty_color", "nan_at_padded_slot"])
def test_one_pass_gs_equals_two_stage(level_systems, level, case):
    """ell_kernels.gs_plain (the kernel's arithmetic: one in-place pass per
    color, every slot but the diagonal's in one sum) == the two-stage
    gauss_seidel_plain to 1e-6 of max|x| on every level: only the order of
    each row's sum differs. A NaN at a padded slot reaches the same rows."""
    op, vals, b = level_systems[level]
    x0, iters = None, 1
    if case == "x0":
        x0 = 0.1 * t(np.random.default_rng(9).normal(size=tuple(b.shape))
                     .astype(np.float32))
    elif case == "three_iterations":
        iters = 3
    elif case == "empty_color":
        op = _with_empty_color(op)
        assert op.n_colors == 9
    elif case == "nan_at_padded_slot":
        row, slot = np.argwhere(op.mask.numpy() == 0)[0]
        vals = vals.clone()
        vals[row, slot] = float("nan")
    x0_before = None if x0 is None else x0.clone()
    ref = tsm.gauss_seidel_plain(op, vals, b, iters, x0=x0).numpy()
    got = tek.gs_plain(vals, op.nbr, op.mask, op.diag_slot, op.color_offsets,
                       b, x0, iters).numpy()
    if x0 is not None:
        np.testing.assert_array_equal(x0.numpy(), x0_before.numpy())
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    if case == "nan_at_padded_slot":
        assert nan[row].all() and not nan.all()
    scale = float(np.abs(ref[~nan]).max())
    assert float(np.abs(got[~nan] - ref[~nan]).max()) <= 1e-6 * scale
    # the wrappers (CPU tensors: plain) agree with the smoother entry point
    np.testing.assert_array_equal(
        tsm.gauss_seidel(op, vals, b, iters, x0=x0).numpy(), ref)
    np.testing.assert_array_equal(
        tek.gs(vals, op.nbr, op.mask, op.diag_slot, op.color_offsets, b, x0,
               iters).numpy(), got)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("case", ["zero_start", "x0"])
def test_skipped_passes_change_no_bits(level_systems, level, case):
    """gs_plain leaves out a color's pass where it would follow the same
    color's (the sweeps' turns): with every color an independent set and a
    row's own slot skipped, that pass would write the bits it reads. The
    full 2 x 8 passes an iteration give the same bits, 3 iterations."""
    op, vals, b = level_systems[level]
    x0 = None if case == "zero_start" else 0.1 * t(
        np.random.default_rng(10).normal(size=tuple(b.shape))
        .astype(np.float32))
    got = tek.gs_plain(vals, op.nbr, op.mask, op.diag_slot, op.color_offsets,
                       b, x0, 3)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    nc, offs = op.n_colors, op.color_offsets
    for _ in range(3):
        for c in list(range(nc - 1, -1, -1)) + list(range(nc)):
            if offs[c + 1] > offs[c]:
                x[offs[c]:offs[c + 1]] = tek._relax_rows_plain(
                    vals, op.nbr, op.mask, op.diag_slot, b, x, offs[c],
                    offs[c + 1])
    assert len(tek.gs_passes(offs, 3)) == 6 * nc - 5 < 6 * nc
    assert torch.equal(got, x)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("case", ["zero_start", "x0", "nan_at_padded_slot"])
def test_relax_all_rows_equals_jacobi(level_systems, level, case):
    """ell_kernels.jacobi_plain (the kernel's row pass over all rows, two
    buffers) == smoothers.jacobi_plain to 1e-6 of max|x|."""
    op, vals, b = level_systems[level]
    x0 = None
    if case == "x0":
        x0 = 0.1 * t(np.random.default_rng(10).normal(size=tuple(b.shape))
                     .astype(np.float32))
    elif case == "nan_at_padded_slot":
        row, slot = np.argwhere(op.mask.numpy() == 0)[0]
        vals = vals.clone()
        vals[row, slot] = float("nan")
    ref = tsm.jacobi_plain(op, vals, b, 2, x0=x0).numpy()
    got = tek.jacobi(vals, op.nbr, op.mask, op.diag_slot, b, x0, 2).numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    scale = float(np.abs(ref[~nan]).max())
    assert float(np.abs(got[~nan] - ref[~nan]).max()) <= 1e-6 * scale
    np.testing.assert_array_equal(tsm.jacobi(op, vals, b, 2, x0=x0).numpy(),
                                  ref)


@pytest.mark.parametrize("smoother", ["gauss_seidel", "jacobi"])
def test_smoothers_take_plain_only_on_cpu(level_systems, smoother,
                                          monkeypatch):
    """On CPU tensors a smoother runs its plain version and launches no
    kernel; tensors on any other device never reach the plain version (a
    meta tensor is refused, a CUDA tensor goes to the kernel wrapper)."""
    op, vals, b = level_systems[0]
    called = []
    plain = getattr(tsm, smoother + "_plain")
    monkeypatch.setattr(tsm, smoother + "_plain",
                        lambda *a, **k: called.append(1) or plain(*a, **k))
    before = dict(tek.launches), dict(tell.cuda_calls)
    getattr(tsm, smoother)(op, vals, b, 1)
    assert called == [1]
    assert (dict(tek.launches), dict(tell.cuda_calls)) == before
    with pytest.raises(ValueError):
        getattr(tsm, smoother)(op, vals.to("meta"), b.to("meta"), 1)
    assert called == [1]


@pytest.mark.parametrize("what", ["dtype", "shape", "offsets", "iterations"])
def test_smoother_wrappers_check_arguments(level_systems, what):
    op, vals, b = level_systems[0]
    args = [vals, op.nbr, op.mask, op.diag_slot, op.color_offsets, b]
    kw = {}
    if what == "dtype":
        args[3] = op.diag_slot.long()
        err = TypeError
    elif what == "shape":
        args[5] = b[:-1]
        err = ValueError
    elif what == "offsets":
        args[4] = op.color_offsets[:-1] + (op.color_offsets[-1] - 1,)
        err = ValueError
    else:
        kw["iterations"] = -1
        err = ValueError
    with pytest.raises(err):
        tek.gs(*args, **kw)
    if what != "offsets":
        with pytest.raises(err):
            tek.jacobi(*(args[:4] + args[5:]), **kw)


def test_ell_operator_refuses_same_color_coupling(scenes):
    """EllOperator checks, once and on the host, that no unmasked
    off-diagonal slot couples two rows of one color class."""
    _, ts = scenes
    for li in range(ts.n_levels):
        p = ts.params["levels"][li]
        offs = ts.level(li).color_offsets
        assert tsm.same_color_couplings(p["nbr"], p["mask"], offs) == 0
        assert ts.make_op(li) is ts.make_op(li)
    p = ts.params["levels"][0]
    offs = ts.level(0).color_offsets
    nbr = p["nbr"].clone()
    row = int(offs[2])                      # first row of color 2
    slot = int(np.argwhere((p["mask"][row].numpy() > 0)
                           & (nbr[row].numpy() != row))[0][0])
    nbr[row, slot] = row + 1                # a row of the same color
    assert offs[3] - offs[2] > 1
    with pytest.raises(ValueError, match="independent"):
        tsm.EllOperator(nbr, p["mask"], p["diag_slot"], offs)
    # the same entry masked out is no coupling
    mask = p["mask"].clone()
    mask[row, slot] = 0.0
    tsm.EllOperator(nbr, mask, p["diag_slot"], offs)
