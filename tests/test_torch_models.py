"""The port's differentiable block-ELL operators and exp2's interpolation
trainer against the JAX package (CPU).

The backward of the SpMV and of the Jacobi smoother (`EllSpmvFn`,
`EllJacobiFn`; on CPU tensors their plain versions `spmv_t_plain`,
`outer_plain`, `jacobi_bwd_plain`, written beside the CUDA kernels) is held
to torch.autograd through the plain forwards in float32, and to finite
differences by torch.autograd.gradcheck in float64.

exp2 runs on the beam(3, 3, 6, dx=0.1) 2-level scene of
tests/test_models.py, from the training protocol's state (x0 with a pinned
vertex moved by 1e-3 (+1, -1, +1)). Tolerances of the port against
jax.grad: the loss within 1e-3 relative and the gradient within 2e-3 of
max |g_jax|. They are float32 noise: the force at that state is a small
difference of O(1) terms and differs between the packages by 1.1e-5 of
max |f|; the cycle's stiff correction amplifies it into the loss, so
the packages differ by 7.7e-5 / 3.5e-4 in the loss and 1.7e-4 / 4.6e-4 of
max |g| in the gradient at unroll 1 / 2 (measured); the JAX package's
jitted loss and its eager one differ by 2.3e-5 at unroll 1. A lost
gradient term (the restriction's in mode P, the coarse Hessian's in
p_hat) moves the gradient by O(max |g|).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as jmesh
from fem_simulation_tpu.config import SolverConfig as JSolverConfig
from fem_simulation_tpu.config import TrainInterpConfig as JTrainInterpConfig
from fem_simulation_tpu.models import train_interp as jti
from fem_simulation_tpu.sim import Scene as JScene

from fem_simulation_tpu_torch import mesh as tmesh
from fem_simulation_tpu_torch.config import SolverConfig, TrainInterpConfig
from fem_simulation_tpu_torch.ops import ell as tell
from fem_simulation_tpu_torch.ops import ell_kernels as tek
from fem_simulation_tpu_torch.ops import lattice_kernels as tlk
from fem_simulation_tpu_torch.models import train_interp as tti
from fem_simulation_tpu_torch.sim import quasistatic as tqs
from fem_simulation_tpu_torch.sim.scene import Scene
from fem_simulation_tpu_torch.solvers import smoothers as tsm

LOSS_RTOL = 1e-3
GRAD_TOL = 2e-3
GRID = [(mode, unroll) for mode in ("P", "p_hat") for unroll in (1, 2)]


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
def start(scenes):
    """The training protocol's state: a pinned vertex moved by 1e-3."""
    js, _ = scenes
    pins = np.nonzero(np.asarray(js.params["levels"][0]["pin_mask"]) > 0)[0]
    x = np.asarray(js.x0).copy()
    x[pins[3]] += np.float32(1e-3) * np.array([1.0, -1.0, 1.0], np.float32)
    return x.astype(np.float32)


@pytest.fixture(scope="module")
def jax_exp2(scenes, start):
    """jax.value_and_grad of the JAX make_loss, per (mode, unroll, loss),
    and the JAX cycle's residual, built once."""
    js, _ = scenes
    out = {}
    for mode, unroll in GRID:
        t = js.params["transfers"][0]
        w0 = t["t_w"] if mode == "P" else t["t_w_norm"]
        for loss in ("l2", "inf"):
            cfg = JTrainInterpConfig(mode=mode, loss=loss, unroll=unroll)
            vg = jax.jit(jax.value_and_grad(jti.make_loss(js, cfg)))
            val, grad = vg(w0, js.params, jnp.asarray(start))
            out[mode, unroll, loss] = (float(val), np.asarray(grad))
        out[mode, "residual"] = np.asarray(jti.two_level_cycle_residual(
            js, js.params, w0, jnp.asarray(start), mode))
    return out


def _system(ts, li, seed=0):
    rng = np.random.default_rng(seed)
    x0 = ts.params["levels"][li]["x0"]
    x = x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(x0.shape)).astype(np.float32))
    vals = (tqs.assemble_fine(ts, ts.params, x) if li == 0
            else tqs.assemble_elastic(ts, ts.params, li, x))
    n = vals.shape[0]
    b = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    x0 = torch.from_numpy(0.1 * rng.standard_normal((n, 3)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((n, 3)).astype(np.float32))
    return ts.make_op(li), vals, b, x0, w


# ---------------------------------------------------------------- the Functions

@pytest.mark.parametrize("level", [0, 1])
def test_transpose_table(scenes, level):
    """The transpose table of each level is (N, K), unpadded (the ELL rows
    pad with slots that point at their own row), lists each column's
    entries in increasing order, and every entry points at its column."""
    _, ts = scenes
    op = ts.make_op(level)
    tt = op.transpose_table()
    n, k = op.nbr.shape
    assert tuple(tt.shape) == (n, k) and tt.dtype == torch.int32
    assert int(tt.min()) >= 0
    flat = op.nbr.reshape(-1).long()
    np.testing.assert_array_equal(flat[tt.long()].numpy(),
                                  np.repeat(np.arange(n), k).reshape(n, k))
    assert bool((tt[:, 1:] > tt[:, :-1]).all())
    assert op.transpose_table() is tt                 # cached


@pytest.mark.parametrize("level", [0, 1])
def test_spmv_backward_matches_autograd_of_plain(scenes, level):
    """EllSpmvFn's plain backward (outer_plain, spmv_t_plain) against
    torch.autograd through spmv_plain, float32: within 1e-5 of max |g|
    (contraction orders differ; measured ~2e-7)."""
    _, ts = scenes
    op, vals, _, _, w = _system(ts, level)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (vals.shape[0], 3)).astype(np.float32))
    V, X = vals.clone().requires_grad_(), x.clone().requires_grad_()
    y = tell.spmv(V, op.nbr, op.mask, X)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y * w).sum(), (V, X))
    V2, X2 = vals.clone().requires_grad_(), x.clone().requires_grad_()
    ref = torch.autograd.grad((tek.spmv_plain(V2, op.nbr, op.mask, X2) * w)
                              .sum(), (V2, X2))
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("iterations", [1, 3])
@pytest.mark.parametrize("with_x0", [False, True])
def test_jacobi_backward_matches_autograd_of_plain(scenes, level, iterations,
                                                   with_x0):
    """EllJacobiFn's plain backward (jacobi_bwd_plain, outer_plain,
    spmv_t_plain) against torch.autograd through jacobi_plain, float32:
    values, b and x0 gradients within 1e-5 of max |g| (measured <= 3.2e-7)."""
    _, ts = scenes
    op, vals, b, x0, w = _system(ts, level, seed=level + 7)
    leaves = [vals.clone().requires_grad_(), b.clone().requires_grad_()]
    start = x0.clone().requires_grad_() if with_x0 else None
    out = tsm.jacobi(op, leaves[0], leaves[1], iterations, x0=start)
    assert out.grad_fn is not None
    got = torch.autograd.grad((out * w).sum(), leaves + (
        [start] if with_x0 else []))
    refs = [vals.clone().requires_grad_(), b.clone().requires_grad_()]
    start2 = x0.clone().requires_grad_() if with_x0 else None
    out2 = tek.jacobi_plain(refs[0], op.nbr, op.mask, op.diag_slot, refs[1],
                            start2, iterations)
    ref = torch.autograd.grad((out2 * w).sum(), refs + (
        [start2] if with_x0 else []))
    np.testing.assert_array_equal(out.detach().numpy(), out2.detach().numpy())
    for g, r in zip(got, ref):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


@pytest.mark.parametrize("start", ["x_t", "zero"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_jacobi_bwd_offdiag_equals_outer_composition(scenes, start,
                                                     accumulate):
    """jacobi_bwd_plain, the plain version of the one-launch Jacobi adjoint,
    gives exactly what the two calls it replaced gave: its lam, gb and
    diagonal slots, then outer_plain(lam, nbr, mask, x_t, skip=diag_slot,
    alpha=-1) into the other slots, storing or accumulating into gb and gv.
    From the zero start it reads no x_t (xt None: the residual is b) and
    equals the composition with x_t = 0."""
    _, ts = scenes
    op, vals, b, x0, w = _system(ts, 1, seed=11)
    rng = np.random.default_rng(31)
    gv0 = torch.from_numpy(rng.standard_normal(tuple(vals.shape)).astype(
        np.float32))
    gb0 = torch.from_numpy(rng.standard_normal(tuple(b.shape)).astype(
        np.float32))
    xt = x0 if start == "x_t" else torch.zeros_like(b)
    args = (vals, op.nbr, op.mask, op.diag_slot, b)
    rows, ds = torch.arange(vals.shape[0]), op.diag_slot.long()
    gv_row, gb_ref = gv0.clone(), gb0.clone()
    lam_ref = tek.jacobi_bwd_plain(*args, xt, w, gb_ref, gv_row, accumulate)
    gv_ref = gv0.clone()
    gv_ref[rows, ds] = gv_row[rows, ds]
    tek.outer_plain(lam_ref, op.nbr, op.mask, xt, skip=op.diag_slot,
                    alpha=-1.0, out=gv_ref, accumulate=accumulate)
    for bwd in (tek.jacobi_bwd_plain, tek.jacobi_bwd):   # CPU: the plain
        gv, gb = gv0.clone(), gb0.clone()
        lam = bwd(*args, None if start == "zero" else xt, w, gb, gv,
                  accumulate)
        for got, ref in ((lam, lam_ref), (gb, gb_ref), (gv, gv_ref)):
            np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("case", ["spmv", "jacobi1", "jacobi3", "jacobi2_x0"])
def test_backward_gradcheck_float64(scenes, case):
    """torch.autograd.gradcheck of the Functions' plain backward in float64
    on the coarse level's Hessian (36 rows, K 27)."""
    _, ts = scenes
    op, vals, b, x0, _ = _system(ts, 1, seed=3)
    tt = op.transpose_table()
    V = vals.double().requires_grad_()
    B = b.double().requires_grad_()
    X0 = x0.double().requires_grad_()
    if case == "spmv":
        fn = lambda v, x: tek.EllSpmvFn.apply(v, x, op.nbr, op.mask, 0,   # noqa: E731
                                              v.shape[0], tt)
        args = (V, X0)
    else:
        its = int(case[6])
        if case.endswith("_x0"):
            fn = lambda v, bb, xx: tek.EllJacobiFn.apply(       # noqa: E731
                v, bb, xx, op.nbr, op.mask, op.diag_slot, its, tt)
            args = (V, B, X0)
        else:
            fn = lambda v, bb: tek.EllJacobiFn.apply(           # noqa: E731
                v, bb, None, op.nbr, op.mask, op.diag_slot, its, tt)
            args = (V, B)
    assert torch.autograd.gradcheck(fn, args, eps=1e-6, atol=1e-5,
                                    rtol=1e-4, fast_mode=True)


@pytest.mark.parametrize("case", ["jacobi2", "jacobi1_x0"])
def test_jacobi_without_table_raises(scenes, case):
    """A Jacobi call whose gradient runs through A^T (two iterations, or a
    start x0 that requires grad) refuses to record without the transpose
    table; one iteration from zero needs none."""
    _, ts = scenes
    op, vals, b, x0, _ = _system(ts, 1, seed=3)
    V = vals.clone().requires_grad_()
    its, start = (2, None) if case == "jacobi2" else (
        1, x0.clone().requires_grad_())
    with pytest.raises(ValueError, match="transpose table"):
        tek.jacobi(V, op.nbr, op.mask, op.diag_slot, b, start, its)
    out = tek.jacobi(V, op.nbr, op.mask, op.diag_slot, b, None, 1)
    assert out.grad_fn is not None


def test_backward_counts_nothing_on_cpu(scenes):
    """On CPU tensors the Functions run the plain versions: no kernel
    launch and no CUDA call is counted."""
    _, ts = scenes
    op, vals, b, x0, w = _system(ts, 1)
    before = dict(tek.launches), dict(tell.cuda_calls)
    V = vals.clone().requires_grad_()
    out = tsm.jacobi(op, V, b, 3, x0=x0.clone().requires_grad_())
    y = tell.spmv(V, op.nbr, op.mask, out)
    (y * w).sum().backward()
    assert V.grad is not None and bool(torch.isfinite(V.grad).all())
    assert (dict(tek.launches), dict(tell.cuda_calls)) == before


def _lattice_calls():
    from fem_simulation_tpu_torch.sim.lattice import LatticeScene
    sc = LatticeScene(tmesh.beam(2, 2, 3, dx=0.1), device="cpu")
    cm = sc.cell_mask
    u = torch.zeros(tuple(sc.x0.shape)).permute(3, 0, 1, 2).contiguous()
    mu, la = 250.0, 37.0
    return {
        "force_cf": lambda v: tlk.force_cf(v, cm, 0.1, mu, la),
        "hvp_cf": lambda v: tlk.hvp_cf(u, v, cm, 0.1, mu, la),
        "hess_diag_cf": lambda v: tlk.hess_diag_cf(v, cm, 0.1, mu, la),
        "elastic_energy_lattice": lambda v: tlk.elastic_energy_lattice(
            v.permute(1, 2, 3, 0).contiguous(), cm, 0.1, mu, la),
    }, u


@pytest.mark.parametrize("what", ["gs", "gauss_seidel", "force_cf", "hvp_cf",
                                  "hess_diag_cf", "elastic_energy_lattice"])
def test_wrappers_without_backward_refuse_grad(scenes, what):
    """A kernel wrapper with no backward raises, on the CPU as on the card,
    when autograd records and an input requires grad (no silent detach);
    under torch.no_grad() it runs."""
    _, ts = scenes
    if what in ("gs", "gauss_seidel"):
        op, vals, b, _, _ = _system(ts, 0)
        if what == "gs":
            call = lambda v: tek.gs(v, op.nbr, op.mask, op.diag_slot,   # noqa: E731
                                    op.color_offsets, b, None, 1)
        else:
            call = lambda v: tsm.gauss_seidel(op, v, b, 1)   # noqa: E731
        arg = vals.clone().requires_grad_()
    else:
        calls, u = _lattice_calls()
        call = calls[what]
        arg = (u + 0.01).requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        call(arg)
    with torch.no_grad():
        out = call(arg)
    assert bool(torch.isfinite(out).all())


# ---------------------------------------------------------------- exp2

@pytest.mark.parametrize("mode", ["P", "p_hat"])
def test_two_level_cycle_matches_jax(scenes, start, jax_exp2, mode):
    """The post-cycle fine residual within 1e-3 of its max |.| (the
    cycle's amplification of f32 noise; module docstring)."""
    _, ts = scenes
    t = ts.params["transfers"][0]
    w0 = t["t_w"] if mode == "P" else t["t_w_norm"]
    got = tti.two_level_cycle_residual(ts, ts.params, w0,
                                       torch.from_numpy(start), mode).numpy()
    ref = jax_exp2[mode, "residual"]
    assert float(np.abs(got - ref).max()) <= LOSS_RTOL * float(
        np.abs(ref).max())


@pytest.mark.parametrize("mode,unroll", GRID)
def test_exp2_l2_loss_and_grad_match_jax(scenes, start, jax_exp2, mode,
                                         unroll):
    """The port's l2 loss and d loss / d w (through EllJacobiFn) against
    jax.grad of the JAX make_loss: loss within 1e-3 relative, gradient
    within 2e-3 of max |g_jax| (module docstring)."""
    _, ts = scenes
    tr = tti.InterpTrainer(ts, TrainInterpConfig(mode=mode, loss="l2",
                                                 unroll=unroll))
    total, data, pen, g = tr.loss_and_grad(tr.w, torch.from_numpy(start))
    ref_val, ref_g = jax_exp2[mode, unroll, "l2"]
    assert abs(float(total) - ref_val) <= LOSS_RTOL * abs(ref_val)
    assert float(total) == pytest.approx(float(data) + float(pen), rel=1e-6)
    assert float(np.abs(g.numpy() - ref_g).max()) <= GRAD_TOL * float(
        np.abs(ref_g).max())


@pytest.mark.parametrize("mode,unroll", GRID)
def test_exp2_inf_loss_matches_jax(scenes, start, jax_exp2, mode, unroll):
    """loss="inf": the loss within 1e-3 relative. Its subgradient touches
    one residual entry, which f32 noise can move where two entries are
    within the noise; held instead through the argmax: the port's and JAX's
    largest |r| after one cycle are one entry where the runner-up trails
    by more than the tolerance."""
    _, ts = scenes
    tr = tti.InterpTrainer(ts, TrainInterpConfig(mode=mode, loss="inf",
                                                 unroll=unroll))
    total, _, _, g = tr.loss_and_grad(tr.w, torch.from_numpy(start))
    ref_val, _ = jax_exp2[mode, unroll, "inf"]
    assert abs(float(total) - ref_val) <= LOSS_RTOL * abs(ref_val)
    assert bool(torch.isfinite(g).all())
    ref_r = np.abs(jax_exp2[mode, "residual"]).reshape(-1)
    top = np.sort(ref_r)[::-1]
    got_r = tti.two_level_cycle_residual(
        ts, ts.params, tr.w, torch.from_numpy(start), mode).abs().reshape(-1)
    if top[0] - top[1] > LOSS_RTOL * top[0]:
        assert int(torch.argmax(got_r)) == int(np.argmax(ref_r))
    else:
        assert float(got_r.max()) == pytest.approx(top[0], rel=LOSS_RTOL)


def test_exp2_training_series_matches_jax(scenes):
    """Three clamped-SGD steps (l2, mode P) from the JAX perturbation
    schedule: the loss series and the trained weights within the loss
    tolerance; the probe series too."""
    js, ts = scenes
    kw = dict(mode="P", loss="l2", lr=1e-6, row_norm_weight=0.1)
    jt = jti.InterpTrainer(js, JTrainInterpConfig(**kw))
    jh = jt.train(3, seed=0)
    tt = tti.InterpTrainer(ts, TrainInterpConfig(**kw))
    th = tt.train(3, seed=0)
    np.testing.assert_allclose(th, jh, rtol=LOSS_RTOL)
    np.testing.assert_allclose(tt.w.numpy(), np.asarray(jt.w), rtol=0,
                               atol=GRAD_TOL)
    np.testing.assert_array_equal(tt.history["probe_steps"],
                                  jt.history["probe_steps"])
    np.testing.assert_allclose(tt.history["probe_resid"],
                               jt.history["probe_resid"], rtol=LOSS_RTOL)


def test_interp_trainer_tables_and_io(scenes, tmp_path):
    """tables_from_weights rebuilds the classic tables bit for bit; the
    penalty's gather equals the JAX scatter-add; save/load round-trips;
    rigid_transfer_error is ~0 for the classic weights; compare runs."""
    js, ts = scenes
    t = ts.params["transfers"][0]
    nf, nc = ts.level(0).n_verts, ts.level(1).n_verts
    p_w, r_w = tti.tables_from_weights(t, t["t_w"], nf, nc,
                                       t["r_idx"].shape[1])
    np.testing.assert_array_equal(p_w.numpy(), t["p_w"].numpy())
    np.testing.assert_array_equal(r_w.numpy(), t["r_w"].numpy())
    for mode, n in (("P", nf), ("p_hat", nc)):
        got = float(tti.row_norm_penalty(t, t["t_w_norm"], n, mode))
        ref = float(jti.row_norm_penalty(js.params["transfers"][0],
                                         js.params["transfers"][0]["t_w_norm"],
                                         n, mode))
        assert got == pytest.approx(ref, rel=1e-6, abs=1e-9)
    tr = tti.InterpTrainer(ts, TrainInterpConfig(mode="p_hat"))
    assert tr.rigid_transfer_error() <= 1e-6
    path = str(tmp_path / "w.npz")
    tr.w = tr.w * 0.5
    tr.save(path)
    back = tti.InterpTrainer(ts, TrainInterpConfig(mode="p_hat")).load(path)
    np.testing.assert_array_equal(back.w.numpy(), tr.w.numpy())
    out = back.compare(iterations=2, smooth=True)
    assert set(out) == {"classic", "trained"}
    assert all(np.isfinite(v).all() and v.shape == (2,) for v in out.values())


@pytest.mark.parametrize("mode", ["P", "p_hat"])
def test_exp2_gradient_matches_autograd_of_plain_smoother(scenes, start,
                                                          mode, monkeypatch):
    """The trainer's gradient through EllJacobiFn's hand-derived backward
    equals torch.autograd through the plain smoother (jacobi_plain) in its
    place, unroll 2: within 1e-5 of max |g|."""
    _, ts = scenes
    cfg = TrainInterpConfig(mode=mode, loss="l2", unroll=2)
    tr = tti.InterpTrainer(ts, cfg)
    x = torch.from_numpy(start)
    _, _, _, g = tr.loss_and_grad(tr.w, x)

    def plain_jacobi(op, values, b, iterations=2, x0=None):
        return tek.jacobi_plain(values, op.nbr, op.mask, op.diag_slot, b, x0,
                                iterations)
    monkeypatch.setattr(tsm, "jacobi", plain_jacobi)
    _, _, _, ref = tr.loss_and_grad(tr.w, x)
    assert float((g - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
