"""The port's z-slab halo lattice operators and step (parallel/lattice_halo.py)
against the JAX package's (CPU).

The same seeded numpy inputs go through JAX `make_dist_*` on a mesh of D
virtual CPU devices (its XLA path, as the JAX package's own tests run it)
and through the port on a grid of D CPU entries (the kernels' plain
versions), D in {2, 4}. Operators are held to rtol 1e-4 and atol 1e-5 of
the field's largest entry (a fold sums boundary planes in another order;
an HVP entry of a field whose largest is ~400 carries ~3e-5 of float32
rounding) against the JAX ones and against the port's whole-lattice
kernels; the step to the float32 policy of the port's parity
tests: equal Newton counts, ||f||_inf within 1e-3 relative + 5e-6, x within
1e-4. Each JAX reference is computed once, in a module fixture.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as jmeshlib
from fem_simulation_tpu.parallel import lattice_halo as jlh
from fem_simulation_tpu.sim.lattice import LatticeScene as JScene

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.parallel import dist, make_device_mesh
from fem_simulation_tpu_torch.parallel import lattice_halo as lh
from fem_simulation_tpu_torch.sim import lattice as tl


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


BEAM = (4, 4, 33)
DX = 0.1
MU, LA = 250.0, 0.0
SLABS = (2, 4)


def assert_fn_close(got, ref, what=""):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= 1e-3 * abs(ref) + 5e-6, (what, got, ref)


def _fields(shape, vmask):
    rng = np.random.default_rng(0)
    u = (0.02 * rng.normal(size=shape).astype(np.float32)
         * np.asarray(vmask)[..., None])
    p = rng.normal(size=shape).astype(np.float32)
    return u, p


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's operators and one dynamic step at D slabs."""
    sc = JScene(jmeshlib.beam(*BEAM, dx=DX))
    x0 = np.asarray(sc.x0)
    u, p = _fields(x0.shape, sc.vert_mask)
    x = jnp.asarray(x0 + u)
    out = {"x0": x0, "u": u, "p": p}
    for D in SLABS:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:D]), ("sp",))
        sl = jlh.LatticeSlabs(sc, D)
        xb, pb = sl.scatter(x), sl.scatter(jnp.asarray(p))
        f = jax.jit(jlh.make_dist_force(sl, mesh, mu=MU, la=LA))(xb)
        h = jax.jit(jlh.make_dist_hvp(sl, mesh, mu=MU, la=LA))(xb, pb)
        d = jax.jit(jlh.make_dist_diag(sl, mesh, mu=MU, la=LA))(xb)
        step, blockify = jlh.make_dist_step(sl, mesh, tol=1e-4)
        xs, vs, k, fn = jax.jit(step)(blockify(sc.x0),
                                      blockify(jnp.zeros_like(sc.x0)))
        out[D] = dict(force=np.asarray(sl.gather(f)),
                      hvp=np.asarray(sl.gather(h)),
                      diag=np.asarray(sl.gather(d)),
                      x=np.asarray(sl.gather(xs)), k=int(k), fn=float(fn))
    return out


@pytest.fixture(scope="module")
def scene():
    return tl.LatticeScene(meshlib.beam(*BEAM, dx=DX), device="cpu")


def _setup(scene, D):
    grid = make_device_mesh(D, dp=1, device="cpu")
    return grid, lh.LatticeSlabs(scene, D, grid)


def _whole(scene, u, p):
    # the displacement as the slab operators take it from x
    u = (scene.x0 + torch.from_numpy(u)) - scene.x0
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    p_cf = torch.from_numpy(p).permute(3, 0, 1, 2).contiguous()
    cm = scene.cell_mask
    return dict(force=lk.force_cf(u_cf, cm, DX, MU, LA).permute(1, 2, 3, 0),
                hvp=lk.hvp_cf(u_cf, p_cf, cm, DX, MU, LA).permute(1, 2, 3, 0),
                diag=lk.hess_diag_cf(u_cf, cm, DX, MU, LA))


def _dist_ops(scene, grid, sl, x, p):
    xb, pb = sl.scatter(x), sl.scatter(p)
    d6 = sl.gather(lh.make_dist_diag(sl, grid, mu=MU, la=LA)(xb))
    return dict(
        force=sl.gather(lh.make_dist_force(sl, grid, mu=MU, la=LA)(xb)),
        hvp=sl.gather(lh.make_dist_hvp(sl, grid, mu=MU, la=LA)(xb, pb)),
        diag=lk.sym_blocks(d6.permute(3, 0, 1, 2)))


@pytest.mark.parametrize("D", SLABS)
def test_scatter_gather_roundtrip(scene, D):
    grid, sl = _setup(scene, D)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=tuple(scene.x0.shape))
                         .astype(np.float32))
    assert torch.equal(sl.gather(sl.scatter(x)), x)
    m = sl.gather(sl.scatter(scene.vert_mask))
    assert torch.equal(m, scene.vert_mask)
    assert sl.n_own == -(-scene.shape[2] // D)
    for b in sl.scatter(x):
        assert b.shape == (3,) + tuple(scene.shape[:2]) + (sl.n_own + 2,)


@pytest.mark.parametrize("D", SLABS)
def test_slab_operators_match_jax_and_whole_lattice(jax_ref, scene, D):
    """Force, HVP and diagonal on D slabs against JAX make_dist_* and the
    port's whole-lattice kernels."""
    grid, sl = _setup(scene, D)
    u, p = jax_ref["u"], jax_ref["p"]
    got = _dist_ops(scene, grid, sl, scene.x0 + torch.from_numpy(u),
                    torch.from_numpy(p))
    whole = _whole(scene, u, p)
    for name in ("force", "hvp", "diag"):
        for ref in (jax_ref[D][name], whole[name].numpy()):
            np.testing.assert_allclose(got[name].numpy(), ref, rtol=1e-4,
                                       atol=1e-5 * np.abs(ref).max(),
                                       err_msg=name)


def test_one_slab_is_the_whole_lattice(jax_ref, scene):
    """On one slab the operators are the whole-lattice kernels on a lattice
    with an empty plane a side: equal to 1e-6 of the field's largest entry
    (the plain versions' batched products may block a longer z otherwise;
    the kernels on the card are checked for bits in chip_smoke.py)."""
    grid, sl = _setup(scene, 1)
    u, p = jax_ref["u"], jax_ref["p"]
    got = _dist_ops(scene, grid, sl, scene.x0 + torch.from_numpy(u),
                    torch.from_numpy(p))
    whole = _whole(scene, u, p)
    for name in ("force", "hvp", "diag"):
        err = float((got[name] - whole[name]).abs().max())
        assert err <= 1e-6 * float(whole[name].abs().max()), (name, err)


@pytest.mark.parametrize("D", SLABS)
def test_dist_step_matches_jax(jax_ref, scene, D):
    """One frame from rest on D slabs: the JAX make_dist_step's Newton count
    and exit norm, x within 1e-4; and the same code on one slab."""
    grid, sl = _setup(scene, D)
    step, blockify = lh.make_dist_step(sl, grid, tol=1e-4)
    xb, vb, k, fn = step(blockify(scene.x0),
                         blockify(torch.zeros_like(scene.x0)))
    ref = jax_ref[D]
    assert fn <= 1e-4 and k == ref["k"] >= 1
    assert_fn_close(fn, ref["fn"])
    x = sl.gather(xb)
    np.testing.assert_allclose(x.numpy(), ref["x"], atol=1e-4)
    grid1, sl1 = _setup(scene, 1)
    step1, blockify1 = lh.make_dist_step(sl1, grid1, tol=1e-4)
    xb1, _, k1, fn1 = step1(blockify1(scene.x0),
                            blockify1(torch.zeros_like(scene.x0)))
    assert k1 == k
    assert_fn_close(fn, fn1)
    np.testing.assert_allclose(x.numpy(), sl1.gather(xb1).numpy(), atol=1e-4)


@pytest.mark.parametrize("D", SLABS)
def test_matvec_moves_four_planes_a_slab(scene, D):
    """One halo HVP: 4 shifts of one vertex plane a slab (refresh 2, fold
    2), moving 4 (D - 1) planes between slabs; the step's dots are psums."""
    grid, sl = _setup(scene, D)
    hvp = lh.make_dist_hvp(sl, grid, mu=MU, la=LA)
    xb = sl.scatter(scene.x0)
    dist.reset_counts()
    hvp(xb, xb)
    plane = 3 * scene.shape[0] * scene.shape[1] * 4
    # the displacement's refresh and the direction's: 2 + 2, the fold: 2
    assert dist.counts["shift"] == 6
    assert dist.counts["planes"] == 6 * D
    assert dist.counts["bytes"] == 6 * (D - 1) * plane
    ops = lh.SlabOps(sl, grid, "sp", MU, LA)
    u = ops.disp(xb)
    dist.reset_counts()
    ops.hvp(u, xb)
    assert dist.counts["planes"] == 4 * D
    assert dist.counts["bytes"] == 4 * (D - 1) * plane
