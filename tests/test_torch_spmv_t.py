"""The port's transposed block-ELL products against the JAX package (CPU).

`ell_spmv_t` (A^T g through A's transpose table) is what the gradients of
`ell_kernels.spmv` with respect to x and of `ell_kernels.jacobi` with
respect to b and x0 run on. The JAX package takes the same gradients with
`jax.vjp` of `ops/ell.spmv` and `solvers/smoothers.jacobi`. On CPU tensors
the port's wrappers run their plain versions; these tests hold the port's
gradients to `jax.vjp` on the fine Hessian and the level-1 Galerkin matrix
of the beam(4, 4, 8, dx=0.1) scene with two levels, the same seeded numpy
inputs going to both, within 1e-5 of max |ref| (float32, other sum
orders). They also pin `spmv_t_plan`, the mirror of the C entry's pick of
form and lanes, the wrapper's launch path with a stand-in for the kernel
library (the kernels themselves: tests/test_torch_cuda.py), and the source
patch with which `scripts/spmv_t_forms.py` forces each form.
"""
import contextlib
import importlib.util
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_simulation_tpu.ops import ell as jell
from fem_simulation_tpu.solvers import smoothers as jsm

from fem_simulation_tpu_torch import mesh as tmesh
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.ops import _cuda
from fem_simulation_tpu_torch.ops import ell_kernels as tek
from fem_simulation_tpu_torch.sim import quasistatic as tqs
from fem_simulation_tpu_torch.sim.scene import Scene


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def levels():
    """[(JAX op, port op, values)] of level 0 (the fine Hessian at a seeded
    state) and level 1 (its Galerkin coarse operator); the JAX smoother's
    operator on the port's ELL tables."""
    ts = Scene(tmesh.beam(4, 4, 8, dx=0.1), solver=SolverConfig(n_levels=2),
               device="cpu")
    rng = np.random.default_rng(31)
    x = ts.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(ts.x0.shape)).astype(np.float32))
    chain = tqs.galerkin_chain(ts, ts.params,
                               tqs.assemble_fine(ts, ts.params, x))
    out = []
    for li, vals in enumerate(chain):
        top = ts.make_op(li)
        jop = jsm.EllOperator(*(jnp.asarray(getattr(top, name).numpy())
                                for name in ("nbr", "mask", "diag_slot")),
                              top.color_offsets)
        out.append((jop, top, vals.numpy()))
    return out


def _inputs(n, seed):
    """Seeded (n, 3) float32 arrays: the cotangent g, b and x0."""
    rng = np.random.default_rng(seed)
    return tuple((s * rng.standard_normal((n, 3))).astype(np.float32)
                 for s in (1.0, 1.0, 0.1))


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0
    assert float(np.abs(np.asarray(got) - want).max()) <= 1e-5 * scale


@pytest.mark.parametrize("level", [0, 1])
def test_spmv_gradients_match_jax_vjp(levels, level):
    """The x-gradient of ell_kernels.spmv (EllSpmvFn: A^T g by spmv_t) and
    its values' gradient (outer) against jax.vjp of the JAX ops/ell.spmv."""
    jop, top, vals = levels[level]
    n = vals.shape[0]
    g, x, _ = _inputs(n, 40 + level)
    _, vjp = jax.vjp(lambda v, xx: jell.spmv(v, jop.nbr, jop.mask, xx),
                     jnp.asarray(vals), jnp.asarray(x))
    want_v, want_x = vjp(jnp.asarray(g))
    V = torch.from_numpy(vals).requires_grad_()
    X = torch.from_numpy(x).requires_grad_()
    y = tek.spmv(V, top.nbr, top.mask, X)
    got_v, got_x = torch.autograd.grad(y, (V, X), torch.from_numpy(g))
    _close(got_x, want_x)
    _close(got_v, want_v)


@pytest.mark.parametrize("level", [0, 1])
@pytest.mark.parametrize("case", ["2 from x0", "2 from zero", "1 from x0"])
def test_jacobi_gradients_match_jax_vjp(levels, level, case):
    """The b, x0 and values gradients of ell_kernels.jacobi (EllJacobiFn:
    jacobi_bwd an iteration and -O^T lam by spmv_t, the diagonal slot left
    out, where an earlier iterate or x0 takes a gradient) against jax.vjp
    of the JAX solvers/smoothers.jacobi."""
    jop, top, vals = levels[level]
    n = vals.shape[0]
    g, b, x0 = _inputs(n, 50 + level)
    its = int(case[0])
    from_x0 = case.endswith("x0")
    primals = [jnp.asarray(vals), jnp.asarray(b)] + (
        [jnp.asarray(x0)] if from_x0 else [])
    _, vjp = jax.vjp(lambda v, bb, *xx: jsm.jacobi(
        jop, v, bb, its, x0=xx[0] if xx else None), *primals)
    want = vjp(jnp.asarray(g))
    leaves = [torch.from_numpy(vals).requires_grad_(),
              torch.from_numpy(b).requires_grad_()] + (
        [torch.from_numpy(x0).requires_grad_()] if from_x0 else [])
    out = tek.jacobi(leaves[0], top.nbr, top.mask, top.diag_slot, leaves[1],
                     leaves[2] if from_x0 else None, its,
                     top.transpose_table())
    got = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    assert len(got) == len(want)
    for a, w in zip(got, want):
        _close(a, w)


def _wide_table(n, k, seed=3):
    """A synthetic block-ELL matrix (nbr, mask, values) of n rows whose
    column 0 holds every row's first slot (n entries) and no other, the
    other slots random."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(1, n, size=(n, k)).astype(np.int32)
    nbr[:, 0] = 0
    mask = (rng.random((n, k)) < 0.8).astype(np.float32)
    vals = rng.standard_normal((n, k, 3, 3)).astype(np.float32)
    return nbr, mask, vals


@pytest.mark.parametrize("skip", [False, True])
def test_spmv_t_plain_wide_column(skip):
    """spmv_t_plain on a table of Kt > 32 (a column of 40 entries, the
    others -1 padded) against the dense A^T g (with skip: the slot
    skip[i] of every row left out), within 1e-5 of max |ref|."""
    n, k = 40, 4
    nbr, mask, vals = _wide_table(n, k)
    sk = np.random.default_rng(4).integers(0, k, size=n).astype(np.int32)
    keep = mask.copy()
    if skip:
        keep[np.arange(n), sk] = 0.0
    dense = np.zeros((3 * n, 3 * n))
    for i in range(n):
        for s in range(k):
            j = nbr[i, s]
            dense[3 * i:3 * i + 3, 3 * j:3 * j + 3] += vals[i, s] * keep[i, s]
    g = np.random.default_rng(5).standard_normal((n, 3)).astype(np.float32)
    tt = tek.transpose_table(torch.from_numpy(nbr))
    assert tt.shape[1] == n > 32 and int((tt < 0).sum()) > 0
    got = tek.spmv_t_plain(torch.from_numpy(vals), torch.from_numpy(mask),
                           tt, torch.from_numpy(g),
                           torch.from_numpy(sk) if skip else None,
                           -1.0 if skip else 1.0)
    want = (-1.0 if skip else 1.0) * (dense.T @ g.reshape(-1)).reshape(n, 3)
    _close(got.numpy(), want)


def test_spmv_t_plan_mirror():
    """spmv_t_plan, the mirror of ell_spmv_t_plan, at every shape the
    paths' gradients give ell_spmv_t on a card of 132 SMs: the staged form
    at the hex meshes' Kt 27 (16 lanes, two entries a lane, from the 2k
    fine Hessian's 2,025 columns up; 32 at the 325 of its level 1), the
    lanes form at the cloth's Kt 7 (8 lanes at 64x64, 4 at 128x128), and
    the strided first form at 32 lanes past a warp's width."""
    L, S, T = tek.SPMV_T_LANES, tek.SPMV_T_STAGED, tek.SPMV_T_STRIDED
    got = {(n, kt): tek.spmv_t_plan(n, kt, 132) for n, kt in (
        (4225, 7), (16641, 7), (325, 27), (2025, 27), (2997, 27),
        (18785, 27), (21097, 27), (74273, 27), (40, 40), (100000, 33))}
    assert got == {(4225, 7): (L, 8), (16641, 7): (L, 4), (325, 27): (S, 32),
                   (2025, 27): (S, 16), (2997, 27): (S, 16),
                   (18785, 27): (S, 16), (21097, 27): (S, 16),
                   (74273, 27): (S, 16), (40, 40): (T, 32),
                   (100000, 33): (T, 32)}
    # the edges: a block an SM on 32 lanes (8 columns a block), two on 8
    # (32 columns a block); one lane takes no fewer
    assert tek.spmv_t_plan(1048, 27, 132) == (S, 32)
    assert tek.spmv_t_plan(1049, 27, 132) == (S, 16)
    assert tek.spmv_t_plan(8416, 7, 132) == (L, 8)
    assert tek.spmv_t_plan(8417, 7, 132) == (L, 4)
    assert tek.spmv_t_plan(10 ** 6, 1, 132) == (L, 1)


def _spmv_t_forms_script():
    """scripts/spmv_t_forms.py as a module."""
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "spmv_t_forms.py")
    spec = importlib.util.spec_from_file_location("spmv_t_forms", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_spmv_t_forms_script_forces_each_form():
    """The copies scripts/spmv_t_forms.py builds to time the forms the plan
    does not pick: in ell_kernels.cu's text, spmv_t_form and spmv_t_half
    are each found once and made to return the forced form and answer,
    the rest of the source unchanged."""
    mod = _spmv_t_forms_script()
    with open(os.path.join(os.path.dirname(tek.__file__), os.pardir, "csrc",
                           "ell_kernels.cu")) as fh:
        text = fh.read()
    assert mod.FORCED == ((tek.SPMV_T_LANES, False), (tek.SPMV_T_LANES, True),
                          (tek.SPMV_T_STAGED, False),
                          (tek.SPMV_T_STAGED, True))
    rest = mod.HALF_RULE.sub("", mod.FORM_RULE.sub("", text))
    for form, half in mod.FORCED:
        got = mod.forced_source(text, form, half)
        lines = (f"int spmv_t_form(int) {{ return {form}; }}",
                 "bool spmv_t_half(int, int P, int) { return P >= 2 && "
                 f"{'true' if half else 'false'}; }}")
        assert all(got.count(line) == 1 for line in lines)
        assert got.replace(lines[0], "").replace(lines[1], "") == rest
    with pytest.raises(RuntimeError, match="not once each"):
        mod.forced_source(text.replace("int spmv_t_form(int P)", "int f()"),
                          tek.SPMV_T_LANES, False)


class _FakeLib:
    """Records the wrapper's ell_spmv_t calls."""

    def __init__(self):
        self.calls = []

    def ell_spmv_t(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("skip", [False, True])
def test_wrapper_launches_the_plan(levels, monkeypatch, skip):
    """The launch path of ell_kernels.spmv_t with a stand-in library: one
    C call a call with the shape and no form or lanes (the C entry picks
    them), each launch counted by (rows, form) as the mirror names it on
    the device's SM count."""
    _, top, vals = levels[1]
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "load", lambda: lib)
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    n, k = vals.shape[:2]
    tt = top.transpose_table()
    g = torch.zeros((n, 3))
    sk = top.diag_slot if skip else None
    tek.reset_launches()
    for sms in (132, 1, 132):           # 32 lanes, 16, 32: one form
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda dev, sms=sms: types.SimpleNamespace(
                                multi_processor_count=sms))
        tek.spmv_t(torch.from_numpy(vals), top.mask, tt, g, sk, -1.0)
    assert [c[6:] for c in lib.calls] == [
        (-1.0, n, k, int(tt.shape[1]), 7)] * 3
    assert all((c[3] is None) == (not skip) for c in lib.calls)
    assert tek.launches["spmv_t"] == 3
    assert tek.spmv_t_launches == {(n, "staged"): 3}
    wide = torch.full((n, 33), -1, dtype=torch.int32)
    wide[:, :int(tt.shape[1])] = tt
    tek.spmv_t(torch.from_numpy(vals), top.mask, wide, g, sk, -1.0)
    assert lib.calls[-1][6:] == (-1.0, n, k, 33, 7)
    assert tek.spmv_t_launches == {(n, "staged"): 3, (n, "strided"): 1}
