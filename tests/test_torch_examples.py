"""The port's drivers (fem_simulation_tpu_torch/examples/: exp1, exp2, exp3,
the diagnostics, the live viewer and the batched scenes) run end to end on
the CPU at tiny sizes (the full-size runs are for the card:
`python -m fem_simulation_tpu_torch.examples.exp2_scale_run`).

exp2_scale_run ends by requiring the trained bare cycle to beat the
classic one: 60 Adam steps at unroll 4 on the 3x3x8 beam do (the classic
cycle diverges to ~4e8 by cycle 8 there, the trained one stays ~3e6).
"""
import os

import numpy as np
import pytest
import torch

from fem_simulation_tpu_torch.examples import (batched_scenes,
                                               diag_deep_bend, exp1_cloth,
                                               exp1_dynamic, exp1_quasistatic,
                                               exp1_render_loop,
                                               exp2_scale_run,
                                               exp2_train_interp,
                                               exp3_diagnose,
                                               exp3_learned_solver,
                                               exp3_scale_run,
                                               exp3_warmstart_eval,
                                               live_viewer)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_exp2_train_interp(tmp_path):
    hist, cmp = exp2_train_interp.main(
        ["--device", "cpu", "--beam", "2,2,6", "--iterations", "3",
         "--out", str(tmp_path / "e2")])
    assert hist.shape == (3,) and np.isfinite(hist).all()
    assert set(cmp) == {"classic", "trained"}
    assert os.path.exists(tmp_path / "e2_weights.npz")
    assert os.path.exists(tmp_path / "e2_compare.png")


def test_exp2_scale_run(tmp_path):
    tr, cmp = exp2_scale_run.main(
        ["--device", "cpu", "--beam", "3,3,8", "--iterations", "60",
         "--out", str(tmp_path / "e2s")])
    assert cmp["trained"][-1] < cmp["classic"][-1]
    for suffix in ("_weights.npz", "_history.npz", "_compare.png",
                   "_metrics.csv"):
        assert os.path.exists(str(tmp_path / "e2s") + suffix)


def test_exp3_learned_solver(tmp_path):
    losses, res = exp3_learned_solver.main(
        ["--device", "cpu", "--beam", "2,2,4", "--frames", "2",
         "--train-iters", "5", "--rollout-frames", "2",
         "--model-out", str(tmp_path / "m.npz")])
    assert losses.shape == (5,) and res.shape == (2,)
    assert np.isfinite(losses).all() and np.isfinite(res).all()


def test_exp3_scale_warmstart_diagnose(tmp_path):
    """exp3_scale_run trains and saves a net; exp3_warmstart_eval and
    exp3_diagnose load it."""
    losses, solver_resid, net_resid = exp3_scale_run.main(
        ["--device", "cpu", "--beam", "2,2,6", "--frames", "2",
         "--iterations", "5", "--out", str(tmp_path / "e3")])
    assert losses.shape == (5,) and solver_resid <= 1e-4
    assert np.isfinite(net_resid)
    net = str(tmp_path / "e3_net.npz")
    stats = exp3_warmstart_eval.main(
        ["--device", "cpu", "--beam", "2,2,6", "--frames", "2", "--net", net,
         "--out", str(tmp_path / "ws")])
    assert (stats["fn_plain"] <= 1e-4).all()
    md = exp3_diagnose.main(["--device", "cpu", "--beam", "2,2,6", "--net",
                             net, "--out", str(tmp_path / "diag")])
    assert "residual |f|_inf at prediction" in md
    assert os.path.exists(tmp_path / "diag.png")


@pytest.mark.parametrize("solver", ["newton_mg", "fas3", "lattice"])
def test_exp1_quasistatic(tmp_path, solver):
    fn = exp1_quasistatic.main(
        ["--device", "cpu", "--beam", "8,8,8", "--dx", "0.1", "--solver",
         solver, "--iterations", "8", "--out", str(tmp_path / "q")])
    assert np.isfinite(fn).all()
    assert fn[-1] <= 1e-4 if solver == "lattice" else fn[-1] < fn[0]
    for suffix in ("_energy.png", "_conv.png", "_mesh.png", "_level0.png"):
        assert os.path.exists(str(tmp_path / "q") + suffix)


def test_exp1_dynamic(tmp_path):
    sim = exp1_dynamic.main(["--device", "cpu", "--beam", "2,2,4", "--dx",
                             "0.1", "--frames", "4",
                             "--gif", str(tmp_path / "d.gif")])
    assert torch.isfinite(sim.state.x).all()
    assert os.path.exists(tmp_path / "d.gif")


def test_exp1_cloth(tmp_path):
    st = exp1_cloth.main(["--device", "cpu", "--res", "4", "--frames", "5",
                          "--gif", str(tmp_path / "c.gif")])
    assert st.x.shape == (25, 3) and torch.isfinite(st.x).all()
    assert os.path.exists(tmp_path / "c.gif")


def test_exp1_render_loop(tmp_path):
    fns, fn_final = exp1_render_loop.main(
        ["--device", "cpu", "--beam", "2,2,6", "--dx", "0.1", "--frames",
         "6", "--gif", str(tmp_path / "r.gif")])
    assert fns.shape == (6,) and fn_final < fns[0]
    assert os.path.exists(tmp_path / "r.gif")


@pytest.mark.parametrize("solver", ["lattice", "latmg"])
def test_diag_deep_bend(solver):
    x, k, fn, trace = diag_deep_bend.main(
        ["--device", "cpu", "--beam", "2,2,6", "--solver", solver])
    assert fn <= 1e-4 and k >= 1
    stages = trace[~np.isnan(trace[:, 0])]
    assert stages[-1, 0] == 1.0


def test_live_viewer():
    viewer = live_viewer.main(["--device", "cpu", "--beam", "2,2,4",
                               "--dx", "0.1", "--port", "0",
                               "--seconds", "0.5"])
    assert viewer.frame_no >= 1
    assert not any(t.is_alive() for t in viewer._threads)


def test_batched_scenes():
    ms, fns = batched_scenes.main(["--device", "cpu", "--n-devices", "2",
                                   "--batch", "2", "--beam", "2,2,4",
                                   "--dx", "0.1", "--frames", "4"])
    assert fns.max() <= 1.01e-4 and fns.size == 2 * 4
