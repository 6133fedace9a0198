"""The port's unstructured halo path (parallel/halo.py) against the JAX
package's (CPU): the slab partition, the distributed block-ELL SpMV, the
distributed CG and the distributed matrix-free Newton step, on D in {2, 4}
slabs (JAX on a mesh of D virtual CPU devices, the port on a grid of D CPU
entries). The SpMV is held to rtol 1e-4 / atol 1e-5, CG to the JAX
package's own rtol 5e-3 / atol 5e-4, the Newton step to the float32 policy
of the port's parity tests (equal Newton counts, ||f||_inf within 1e-3
relative + 5e-6, x within 1e-4). Each JAX reference is computed once, in a
module fixture.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import hierarchy as jhl
from fem_simulation_tpu import mesh as jmeshlib
from fem_simulation_tpu.config import SolverConfig as JSolver
from fem_simulation_tpu.ops import elastic as jel
from fem_simulation_tpu.ops import ell as jell
from fem_simulation_tpu.parallel import halo as jhalo
from fem_simulation_tpu.sim import Scene as JScene

from fem_simulation_tpu_torch import hierarchy as hl
from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.ops import ell
from fem_simulation_tpu_torch.parallel import dist, make_device_mesh
from fem_simulation_tpu_torch.parallel import halo
from fem_simulation_tpu_torch.sim import dynamic
from fem_simulation_tpu_torch.sim.scene import Scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SLABS = (2, 4)
BEAM, NEWTON_BEAM = (4, 4, 32), (3, 3, 24)


def assert_fn_close(got, ref, what=""):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= 1e-3 * abs(ref) + 5e-6, (what, got, ref)


def _mesh(D):
    return jax.sharding.Mesh(np.array(jax.devices()[:D]), ("sp",))


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's SpMV operands and, per D, its partition, dist SpMV,
    dist CG and dist Newton step."""
    m = jmeshlib.beam(*BEAM, dx=0.1)
    lvl = jhl.build_level_topology(m.x, m.ijk, m.hexes, m.dx)
    det, g, vol = jel.prepare(jnp.asarray(lvl.x0), jnp.asarray(lvl.hexes))
    x = jnp.asarray(lvl.x0) + 0.01
    vals = jel.assemble_hessian_ell_gather(
        x, jnp.asarray(lvl.hexes), det, g, 250.0, 0.0,
        jnp.asarray(lvl.contrib_idx),
        jnp.asarray(lvl.contrib_mask.astype(np.float32)), lvl.n_verts, lvl.K)
    vals = jell.add_to_diag(vals, jnp.asarray(lvl.diag_slot),
                            jnp.broadcast_to(2.0 * jnp.eye(3),
                                             (lvl.n_verts, 3, 3)))
    rng = np.random.default_rng(0)
    xg = rng.normal(size=(lvl.n_verts, 3)).astype(np.float32)
    b = rng.normal(size=(lvl.n_verts, 3)).astype(np.float32)
    out = {"vals": np.array(vals), "x": xg, "b": b}
    nscene = JScene(jmeshlib.beam(*NEWTON_BEAM, dx=0.1),
                    solver=JSolver(n_levels=2))
    for D in SLABS:
        part = jhalo.partition_slabs(lvl, D)
        matvec, scatter, gather = jhalo.make_dist_matvec(part, _mesh(D))
        vl = jnp.asarray(out["vals"][part.own_global])
        y = gather(jax.jit(matvec)(vl, scatter(jnp.asarray(xg))))
        b_sh = scatter(jnp.asarray(b)) * jnp.asarray(part.own_mask)[..., None]
        xs = jax.jit(lambda bb: jhalo.dist_cg(lambda p: matvec(vl, p), bb,
                                               _mesh(D), iterations=40))(b_sh)
        npart = jhalo.partition_slabs(nscene.hier.levels[0], D)
        step = jhalo.make_dist_newton_step(nscene, npart, _mesh(D), tol=1e-4)
        x_sh = jhalo.slab_scatter(npart, nscene.x0)
        x2, _, k, fn = jax.jit(step)(x_sh, jnp.zeros_like(x_sh))
        out[D] = dict(part=part, y=np.asarray(y), cg=np.asarray(gather(xs)),
                      newton_x=jhalo.slab_gather(
                          npart, x2, nscene.hier.levels[0].n_verts),
                      k=int(np.asarray(k).max()),
                      fn=float(np.asarray(fn).max()))
    return out


@pytest.fixture(scope="module")
def lvl():
    m = meshlib.beam(*BEAM, dx=0.1)
    return hl.build_level_topology(m.x, m.ijk, m.hexes, m.dx)


@pytest.mark.parametrize("D", SLABS)
def test_partition_covers_every_vertex_and_equals_jax(jax_ref, lvl, D):
    part = halo.partition_slabs(lvl, D)
    owned = part.own_global[part.own_mask > 0]
    assert np.sort(owned).tolist() == list(range(lvl.n_verts))
    ref = jax_ref[D]["part"]
    for name in ("own_global", "own_mask", "local_nbr", "local_mask",
                 "send_left", "send_right", "recv_left_at", "recv_right_at",
                 "halo_global"):
        np.testing.assert_array_equal(getattr(part, name),
                                      getattr(ref, name), err_msg=name)


@pytest.mark.parametrize("D", SLABS)
def test_dist_spmv_matches_jax_and_single(jax_ref, lvl, D):
    grid = make_device_mesh(D, dp=1, device="cpu")
    part = halo.partition_slabs(lvl, D)
    matvec, scatter, gather = halo.make_dist_matvec(part, grid)
    vals = torch.from_numpy(jax_ref["vals"])
    x = torch.from_numpy(jax_ref["x"])
    vl = [vals[torch.from_numpy(part.own_global[d]).long()]
          for d in range(D)]
    dist.reset_counts()
    got = gather(matvec(vl, scatter(x)))
    # one exchange: a send buffer a slab each way
    assert dist.counts["shift"] == 2 and dist.counts["planes"] == 2 * D
    mask = torch.from_numpy(lvl.nbr_mask.astype(np.float32))
    ref = ell.spmv(vals * mask[..., None, None],
                   torch.from_numpy(lvl.nbr), mask, x)
    for r in (jax_ref[D]["y"], ref.numpy()):
        np.testing.assert_allclose(got.numpy(), r, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D", SLABS)
def test_dist_cg_matches_jax(jax_ref, lvl, D):
    grid = make_device_mesh(D, dp=1, device="cpu")
    part = halo.partition_slabs(lvl, D)
    matvec, scatter, gather = halo.make_dist_matvec(part, grid)
    vals = torch.from_numpy(jax_ref["vals"])
    vl = matvec.prepare([vals[torch.from_numpy(part.own_global[d]).long()]
                         for d in range(D)])
    om = [torch.from_numpy(part.own_mask[d])[:, None] for d in range(D)]
    b_sh = [b * m for b, m in zip(scatter(torch.from_numpy(jax_ref["b"])),
                                  om)]
    x_sh = halo.dist_cg(lambda p: matvec(vl, p), b_sh, grid, iterations=40)
    np.testing.assert_allclose(gather(x_sh).numpy(), jax_ref[D]["cg"],
                               rtol=5e-3, atol=5e-4)


@pytest.mark.parametrize("D", SLABS)
def test_dist_newton_step_matches_jax_and_single(jax_ref, D):
    """One implicit-Euler frame from rest on D slabs: JAX's Newton count,
    exit norm and x; and the single-device matrix-free step_to_tol."""
    sc = Scene(meshlib.beam(*NEWTON_BEAM, dx=0.1),
               solver=SolverConfig(n_levels=2), device="cpu")
    grid = make_device_mesh(D, dp=1, device="cpu")
    part = halo.partition_slabs(sc.hier.levels[0], D)
    step = halo.make_dist_newton_step(sc, part, grid, tol=1e-4)
    x_sh = halo.slab_scatter(part, sc.x0)
    x2, v2, k, fn = step(x_sh, [torch.zeros_like(x) for x in x_sh])
    ref = jax_ref[D]
    assert fn <= 1e-4 and k == ref["k"] >= 1
    assert_fn_close(fn, ref["fn"])
    xg = halo.slab_gather(part, x2, sc.hier.levels[0].n_verts)
    np.testing.assert_allclose(xg, ref["newton_x"], atol=1e-4)
    st, k1, fn1 = dynamic.step_to_tol(sc, sc.params, dynamic.init_state(sc),
                                      tol=1e-4, max_newton=20,
                                      matrix_free=True)
    assert k1 == k
    assert_fn_close(fn, fn1)
    np.testing.assert_allclose(xg, st.x.numpy(), atol=1e-4)
