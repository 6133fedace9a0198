"""exp3 in the port against the JAX package (CPU): the GNN models from
carried-over flax weights, the rollout data generator, the first training
step's gradients, and the trainer's other entry points.

Scene: the beam(3, 3, 6, dx=0.1) 2-level scene of tests/test_models.py,
TrainSolverConfig(frames=4, n_iters=2, hidden_channels=16, feat_dim=2).
Tolerances: model outputs within 1e-5 (f32 sums of up to 26 neighbours in
another order, ~1e-7 measured); the first step's gradients within 1e-4 of
each tensor's max |g| (~3e-7 measured); the rollout's x within 1e-5 and
its ||f||_inf under the repo's policy, 1e-3 relative + 5e-6 (an ||f||_inf
near 1e-3 is a small difference of O(1) terms: f32 noise of a few 1e-6;
tests/test_torch_unstructured.py).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as jmesh
from fem_simulation_tpu.config import SolverConfig as JSolverConfig
from fem_simulation_tpu.config import TrainSolverConfig as JTrainSolverConfig
from fem_simulation_tpu.models import gnn as jgnn
from fem_simulation_tpu.models import train_solver as jts
from fem_simulation_tpu.sim import Scene as JScene

from fem_simulation_tpu_torch import mesh as tmesh
from fem_simulation_tpu_torch.config import SolverConfig, TrainSolverConfig
from fem_simulation_tpu_torch.models import gnn as tgnn
from fem_simulation_tpu_torch.models import train_solver as tts
from fem_simulation_tpu_torch.sim import dynamic as tdyn
from fem_simulation_tpu_torch.sim.scene import Scene

CFG = dict(frames=4, n_iters=2, hidden_channels=16, feat_dim=2)
NOISE = 5e-6


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scenes():
    js = JScene(jmesh.beam(3, 3, 6, dx=0.1), solver=JSolverConfig(n_levels=2))
    ts = Scene(tmesh.beam(3, 3, 6, dx=0.1), solver=SolverConfig(n_levels=2),
               device="cpu")
    return js, ts


@pytest.fixture(scope="module")
def jax_ref(scenes):
    """The JAX rollout from seed 0 with its v0, and per model kind the JAX
    trainer's initial weights, a prediction and the first step's MSE loss
    and gradients on frame 1."""
    js, _ = scenes
    xt, xs, res = (np.asarray(a) for a in jts.generate_rollout(
        js, JTrainSolverConfig(**CFG), seed=0))
    v0 = np.asarray(0.1 * jax.random.normal(jax.random.PRNGKey(0),
                                            js.x0.shape, js.x0.dtype))
    out = {"rollout": (xt, xs, res), "v0": v0}
    for ml in (False, True):
        tr = jts.SolverNetTrainer(js, JTrainSolverConfig(**CFG),
                                  multilevel=ml, predict_delta=True)
        p = tr.init(0)

        def loss(p, tr=tr):
            return jnp.mean((tr._forward(p, jnp.asarray(xt[1]))
                             - jnp.asarray(xs[1])) ** 2)
        val, grad = jax.value_and_grad(loss)(p)
        out[ml] = (jax.tree_util.tree_map(np.asarray, p),
                   np.asarray(tr._forward(p, jnp.asarray(xt[1]))),
                   float(val), jax.tree_util.tree_map(np.asarray, grad))
    return out


def _trainer(ts, ml, params):
    tr = tts.SolverNetTrainer(ts, TrainSolverConfig(**CFG), multilevel=ml,
                              predict_delta=True)
    return tr.load_state_dict(tgnn.params_from_flax(params))


def test_graphconv_matches_jax():
    """GraphConv (add and mean) from flax weights on a small graph with a
    vertex of no in-edge."""
    ei = np.array([[0, 1, 2, 2], [1, 2, 0, 1]], np.int32)
    x = np.random.default_rng(0).normal(size=(4, 5)).astype(np.float32)
    for aggr in ("add", "mean"):
        model = jgnn.GraphConv(3, aggr=aggr)
        p = model.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(ei))
        ref = np.asarray(model.apply(p, jnp.asarray(x), jnp.asarray(ei)))
        conv = tgnn.GraphConv(5, 3, aggr=aggr)
        pp = jax.tree_util.tree_map(np.asarray, p)["params"]
        conv.root.weight.data = torch.from_numpy(pp["Dense_0"]["kernel"].T.copy())
        conv.root.bias.data = torch.from_numpy(pp["Dense_0"]["bias"].copy())
        conv.rel.weight.data = torch.from_numpy(pp["Dense_1"]["kernel"].T.copy())
        got = conv(torch.from_numpy(x), tgnn.graph_from_edge_index(ei, 4))
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=0,
                                   atol=1e-5)


def test_edge_index_matches_jax(scenes):
    js, ts = scenes
    lvl = js.level(0)
    ref = np.asarray(jgnn.edge_index_from_topology(lvl.nbr, lvl.nbr_mask))
    got = tgnn.edge_index_from_topology(ts.level(0).nbr, ts.level(0).nbr_mask)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("multilevel", [False, True],
                         ids=["MDN3", "MultiLevel3"])
def test_model_outputs_from_flax_weights(scenes, jax_ref, multilevel):
    """MDN3 / MultiLevel3 with the JAX trainer's initial weights carried by
    params_from_flax: the prediction within 1e-5; every parameter mapped."""
    _, ts = scenes
    params, ref, _, _ = jax_ref[multilevel]
    tr = _trainer(ts, multilevel, params)
    sd = tgnn.params_from_flax(params)
    assert set(sd) == set(tr.model.state_dict())
    xt = torch.from_numpy(jax_ref["rollout"][0][1])
    with torch.no_grad():
        got = tr._forward(xt).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("multilevel", [False, True],
                         ids=["MDN3", "MultiLevel3"])
def test_first_training_step_gradients(scenes, jax_ref, multilevel):
    """The first step's MSE loss within 1e-5 relative and its gradient, per
    parameter tensor, within 1e-4 of that tensor's max |g| (jax.grad)."""
    _, ts = scenes
    params, _, ref_loss, ref_grad = jax_ref[multilevel]
    tr = _trainer(ts, multilevel, params)
    xt, xs, _ = jax_ref["rollout"]
    loss = tr.loss_fn(torch.from_numpy(xt[1]), torch.from_numpy(xs[1]))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(ref_loss, rel=1e-5)
    ref = tgnn.params_from_flax(ref_grad)
    for name, prm in tr.model.named_parameters():
        r = ref[name]
        assert float((prm.grad - r).abs().max()) <= 1e-4 * max(
            float(r.abs().max()), 1e-12), name


def test_rollout_matches_jax(scenes, jax_ref):
    """generate_rollout from JAX's v0: x_tilde and x within 1e-5, the
    frames' ||f||_inf within 1e-3 relative + 5e-6."""
    _, ts = scenes
    xt, xs, res = (a.numpy() for a in tts.generate_rollout(
        ts, TrainSolverConfig(**CFG), v0=jax_ref["v0"]))
    rxt, rxs, rres = jax_ref["rollout"]
    np.testing.assert_allclose(xt, rxt, rtol=0, atol=1e-5)
    np.testing.assert_allclose(xs, rxs, rtol=0, atol=1e-5)
    assert res.shape == rres.shape == (CFG["frames"],)
    np.testing.assert_array_less(np.abs(res - rres), 1e-3 * rres + NOISE)


def test_rollout_from_seed_is_reproducible(scenes):
    """Without v0 the initial velocity comes from a torch.Generator seeded
    with `seed`: two calls agree bit for bit, another seed differs."""
    _, ts = scenes
    cfg = TrainSolverConfig(**dict(CFG, frames=2))
    a = tts.generate_rollout(ts, cfg, seed=4)
    b = tts.generate_rollout(ts, cfg, seed=4)
    c = tts.generate_rollout(ts, cfg, seed=5)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u.numpy(), v.numpy())
    assert not np.array_equal(a[0].numpy(), c[0].numpy())


@pytest.mark.parametrize("loss", ["mse", "residual"])
def test_trainer_entry_points(scenes, loss, tmp_path):
    """train reduces its loss; evaluate_residual, learned_step,
    warmstart_stats and save / load run (the JAX package's
    tests/test_models.py protocol)."""
    _, ts = scenes
    cfg = TrainSolverConfig(**dict(CFG, loss=loss))
    tr = tts.SolverNetTrainer(ts, cfg, predict_delta=True)
    losses = tr.train(iterations=30, seed=0)
    assert losses.shape == (30,) and np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    st = tdyn.init_state(ts)
    assert np.isfinite(tr.evaluate_residual(st.x, st))
    st2 = tr.learned_step(st)
    assert bool(torch.isfinite(st2.x).all())
    stats = tr.warmstart_stats(frames=2, v0=np.zeros((ts.level(0).n_verts, 3),
                                                     np.float32))
    assert stats["k_plain"].shape == stats["k_warm"].shape == (2,)
    assert (stats["fn_plain"] <= 1e-4).all() and (stats["fn_warm"] <= 1e-4).all()
    assert stats["ms_plain"] > 0 and stats["ms_warm"] > 0
    path = str(tmp_path / "net")
    tr.save(path)
    back = tts.SolverNetTrainer(ts, cfg, predict_delta=True).load(path)
    for (n, a), (_, b) in zip(tr.model.state_dict().items(),
                              back.model.state_dict().items()):
        np.testing.assert_array_equal(a.numpy(), b.numpy(), err_msg=n)


def test_train_energy_gcn_lowers_energy(scenes):
    _, ts = scenes
    model, losses = tts.train_energy_gcn(ts, iterations=8, seed=0)
    assert losses.shape == (8,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
