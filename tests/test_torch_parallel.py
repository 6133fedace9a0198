"""The port's device grid, collectives and batched step (parallel/dist.py)
and its entry points (entry.py) against the JAX package (CPU).

JAX runs on the 8 virtual CPU devices of tests/conftest.py; the port on
grids of CPU entries. The batched step is held to the JAX package's own
test (rtol 1e-4 / atol 1e-5). Each JAX reference is computed once, in a
module fixture.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from fem_simulation_tpu import mesh as jmeshlib
from fem_simulation_tpu.config import SolverConfig as JSolver
from fem_simulation_tpu.parallel import make_batched_step as jbatched
from fem_simulation_tpu.parallel import make_device_mesh as jgrid
from fem_simulation_tpu.sim import Scene as JScene

from fem_simulation_tpu_torch import entry
from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.parallel import dist
from fem_simulation_tpu_torch.sim import Scene, dynamic


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


@pytest.mark.parametrize("n, dp, shape", [(8, None, (2, 4)), (1, None, (1, 1)),
                                          (6, None, (2, 3)), (5, None, (1, 5)),
                                          (8, 1, (1, 8))])
def test_grid_shapes_match_jax(n, dp, shape):
    g = dist.make_device_mesh(n, dp=dp, device="cpu")
    assert g.devices.shape == shape == jgrid(n, dp=dp).devices.shape
    assert g.axis_names == ("dp", "sp") == jgrid(n, dp=dp).axis_names
    assert g.shape == {"dp": shape[0], "sp": shape[1]}
    assert g.shared == (n > 1)
    assert all(d.type == "cpu" for d in g.devices.reshape(-1))
    with pytest.raises(ValueError):
        dist.make_device_mesh(8, dp=3, device="cpu")


@pytest.mark.parametrize("D", SLABS)
@pytest.mark.parametrize("step", [+1, -1])
def test_shift_planes_is_ppermute(D, step):
    rng = np.random.default_rng(D)
    planes = rng.normal(size=(D, 3, 5, 4)).astype(np.float32)
    perm = ([(i, i + 1) for i in range(D - 1)] if step > 0
            else [(i + 1, i) for i in range(D - 1)])
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:D]), ("sp",))
    ref = shard_map(lambda a: jax.lax.ppermute(a, "sp", perm), mesh=mesh,
                    in_specs=P("sp"), out_specs=P("sp"))(jnp.asarray(planes))
    dist.reset_counts()
    got = dist.shift_planes([torch.from_numpy(p) for p in planes], step)
    out = np.stack([np.zeros_like(planes[0]) if g is None else g.numpy()
                    for g in got])
    np.testing.assert_array_equal(out, np.asarray(ref))
    assert dist.counts == {"shift": 1, "planes": D,
                           "bytes": (D - 1) * planes[0].nbytes,
                           "psum": 0, "pmax": 0}


def test_psum_and_pmax_in_block_order():
    vals = [torch.tensor(v) for v in (1.0, 2.5, -4.0, 1e-8)]
    assert float(dist.psum(vals)) == float(np.float32(
        ((np.float32(1.0) + np.float32(2.5)) + np.float32(-4.0))
        + np.float32(1e-8)))
    assert float(dist.pmax(vals)) == 2.5
    assert np.isnan(float(dist.pmax(vals + [torch.tensor(float("nan"))])))


@pytest.fixture(scope="module")
def batched_ref():
    """JAX make_batched_step on its 2 x 4 mesh, batch 2."""
    scene = JScene(jmeshlib.beam(2, 2, 4, dx=0.1),
                   solver=JSolver(n_levels=2), pad_to=8)
    step_fn, params, state0 = jbatched(scene, jgrid(8), batch=2)
    return np.asarray(step_fn(params, state0).x)


@pytest.mark.parametrize("n", (2, 4))
def test_batched_step_matches_jax_and_single(batched_ref, n):
    """Batch 2 over the dp axis of an n-entry grid: both entries equal, equal
    to JAX's batched step and to the port's single-scene step."""
    scene = Scene(meshlib.beam(2, 2, 4, dx=0.1),
                  solver=SolverConfig(n_levels=2), pad_to=8, device="cpu")
    grid = dist.make_device_mesh(n, device="cpu")
    step_fn, params, state0 = dist.make_batched_step(scene, grid, batch=2)
    assert len(state0) == grid.shape["dp"] == 2
    x = dist.stack_batch(step_fn(params, state0)).x
    assert x.shape == (2,) + tuple(scene.x0.shape)
    assert torch.isfinite(x).all() and torch.equal(x[0], x[1])
    np.testing.assert_allclose(x.numpy(), batched_ref, rtol=1e-4, atol=1e-5)
    ref = dynamic.step(scene, scene.params, dynamic.init_state(scene))
    assert torch.equal(x[0], ref.x)
    with pytest.raises(ValueError):
        dist.make_batched_step(scene, grid, batch=3)


def test_entry_step_on_cpu():
    fn, args = entry.entry(device="cpu")
    st = fn(*args)
    assert st.x.device.type == "cpu" and torch.isfinite(st.x).all()


def test_dryrun_multichip_on_cpu():
    lines = entry.dryrun_multichip(4, device="cpu")
    assert [ln.split(" ok")[0] for ln in lines] == [
        "dryrun_multichip", "dryrun lattice halo", "dryrun dist lattice step",
        "dryrun dist GMG step", "dryrun dist GMG quasistatic",
        "dryrun dist unstructured Newton"]
    assert "mesh=(2, 2)" in lines[0]
