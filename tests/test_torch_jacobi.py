"""The block-Jacobi smoother's forms against the JAX package (CPU).

`ell_jacobi` runs the first iteration from x0 = None in a zero-start form
that reads no nbr or mask and gathers no x, yet still forms every slot's
product with the zero x, so a non-finite value at any slot propagates as
the JAX smoother's `spmv(values * offdiag, ..., 0)` does. On CPU tensors
the wrappers run their plain versions; these tests hold those to the JAX
package on the level-1 system of the beam(4, 4, 8, dx=0.1) scene with two
levels, and check the wrapper's dispatch of the forms with a stand-in for
the kernel library (the kernels themselves: tests/test_torch_cuda.py).
"""
import contextlib
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_simulation_tpu.solvers import smoothers as jsm

from fem_simulation_tpu_torch import mesh as tmesh
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.ops import _cuda
from fem_simulation_tpu_torch.ops import ell_kernels as tek
from fem_simulation_tpu_torch.sim import quasistatic as tqs
from fem_simulation_tpu_torch.sim.scene import Scene
from fem_simulation_tpu_torch.solvers import smoothers as tsm


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def level1():
    """(JAX op, port op, values, b, x0) on level 1: the port's Galerkin
    coarse operator of the fine Hessian at a seeded state; the JAX
    smoother's operator on the same ELL tables."""
    ts = Scene(tmesh.beam(4, 4, 8, dx=0.1), solver=SolverConfig(n_levels=2),
               device="cpu")
    rng = np.random.default_rng(31)
    x = ts.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(ts.x0.shape)).astype(np.float32))
    vals = tqs.galerkin_chain(ts, ts.params,
                              tqs.assemble_fine(ts, ts.params, x))[1]
    top = ts.make_op(1)
    jop = jsm.EllOperator(*(jnp.asarray(getattr(top, name).numpy())
                            for name in ("nbr", "mask", "diag_slot")),
                          top.color_offsets)
    n = vals.shape[0]
    b = rng.standard_normal((n, 3)).astype(np.float32)
    x0 = (0.1 * rng.standard_normal((n, 3))).astype(np.float32)
    return jop, top, vals.numpy(), b, x0


def _nan_rows(op, vals):
    """values with a NaN at one live off-diagonal slot of one row and at
    one padded slot of another; the two rows."""
    mask = op.mask.numpy()
    ds = op.diag_slot.numpy()
    nbr = op.nbr.numpy()
    live = np.argwhere((mask > 0) & (nbr != np.arange(len(ds))[:, None])
                       & (np.arange(mask.shape[1])[None, :] != ds[:, None]))
    padded = np.argwhere(mask == 0)
    r1, k1 = live[len(live) // 2]
    r2, k2 = next(p for p in padded if p[0] != r1)
    out = vals.copy()
    out[r1, k1, 1, 2] = np.nan
    out[r2, k2, 0, 0] = np.nan
    return out, (int(r1), int(r2))


@pytest.mark.parametrize("case", ["1 from zero", "2 from x0"])
def test_nan_propagates_as_in_jax(level1, case):
    """A NaN at a live off-diagonal slot and at a padded slot: the JAX
    smoother, the port's smoother and ell_kernels.jacobi give NaN in the
    same rows (the two rows' and, from x0 at two iterations, their
    neighbours'); the other rows agree within 1e-6 of max |x|."""
    jop, top, vals, b, x0 = level1
    bad, rows = _nan_rows(top, vals)
    its, start = (1, None) if case == "1 from zero" else (2, x0)
    want = np.asarray(jsm.jacobi(
        jop, jnp.asarray(bad), jnp.asarray(b), its,
        x0=None if start is None else jnp.asarray(start)))
    tstart = None if start is None else torch.from_numpy(start)
    tv, tb = torch.from_numpy(bad), torch.from_numpy(b)
    got = {
        "smoothers.jacobi": tsm.jacobi(top, tv, tb, its, x0=tstart),
        "ell_kernels.jacobi": tek.jacobi(tv, top.nbr, top.mask,
                                         top.diag_slot, tb, tstart, its),
    }
    nan = np.isnan(want).any(axis=1)
    assert nan[list(rows)].all() and not nan.all()
    assert np.isnan(want[nan]).all()
    scale = float(np.abs(want[~nan]).max())
    for name, x in got.items():
        x = x.numpy()
        np.testing.assert_array_equal(np.isnan(x), np.isnan(want), name)
        assert float(np.abs(x[~nan] - want[~nan]).max()) <= 1e-6 * scale, \
            name


@pytest.mark.parametrize("iterations", [1, 2])
def test_autograd_zero_start_same_bits(level1, iterations):
    """EllJacobiFn's forward from x0 = None (the zero start) gives the bits
    of the call without autograd, and its backward gives finite
    gradients."""
    _, top, vals, b, _ = level1
    tv, tb = torch.from_numpy(vals), torch.from_numpy(b)
    args = (top.nbr, top.mask, top.diag_slot)
    with torch.no_grad():
        want = tek.jacobi(tv, *args, tb, None, iterations)
    V, B = tv.clone().requires_grad_(), tb.clone().requires_grad_()
    got = tek.jacobi(V, *args, B, None, iterations, top.transpose_table())
    assert got.grad_fn is not None
    assert torch.equal(got.detach(), want)
    got.sum().backward()
    assert bool(torch.isfinite(V.grad).all() & torch.isfinite(B.grad).all())


class _FakeLib:
    """Records the arguments of every ell_jacobi call of the wrapper."""

    def __init__(self):
        self.calls = []

    def ell_jacobi(self, *args):
        self.calls.append(args)
        return 0


@pytest.mark.parametrize("start", ["zero", "x0"])
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_wrapper_picks_the_form(level1, monkeypatch, start, iterations):
    """The launch path of ell_kernels.jacobi, with a stand-in library: one
    C call with the zero-start flag exactly when x0 is None, one launch an
    iteration counted by (rows, form) (the first from zero in the
    zero-start form), and the result in the buffer the C entry writes last
    (xb for an odd count); the autograd path's step the same."""
    _, top, vals, b, x0 = level1
    lib = _FakeLib()
    monkeypatch.setattr(_cuda, "load", lambda: lib)
    monkeypatch.setattr(_cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=7))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    tv, tb = torch.from_numpy(vals), torch.from_numpy(b)
    tx0 = None if start == "zero" else torch.from_numpy(x0)
    n, k = vals.shape[:2]
    tek.reset_launches()
    out = tek.jacobi(tv, top.nbr, top.mask, top.diag_slot, tb, tx0,
                     iterations)
    (args,) = lib.calls
    assert args[7:] == (n, k, iterations, int(start == "zero"), 7)
    assert out.data_ptr() == args[6 if iterations % 2 else 5]
    if tx0 is not None:
        assert args[5] != tx0.data_ptr()      # x0 is not modified
    zero = int(start == "zero")
    assert tek.launches["jacobi"] == iterations
    want = {(n, "zero start"): zero, (n, "from x"): iterations - zero}
    assert tek.jacobi_launches == {key: c for key, c in want.items() if c}
    lib.calls.clear()
    tek._jacobi_step(tv, top.nbr, top.mask, top.diag_slot, tb, tx0)
    (args,) = lib.calls
    assert args[9:11] == (1, zero)


def test_lanes_a_row():
    """jacobi_lanes, the mirror of the C entries' pick: the most of 32 and
    16 lanes whose grid fits one wave of 132 SMs (8 blocks an SM), else 8,
    at the paths' shapes and at the edges."""
    got = {n: tek.jacobi_lanes(n, 132)
           for n in (325, 2673, 2997, 8448, 8449, 10449, 16896, 16897,
                     18785, 74273)}
    assert got == {325: 32, 2673: 32, 2997: 32, 8448: 32, 8449: 16,
                   10449: 16, 16896: 16, 16897: 8, 18785: 8, 74273: 8}
    assert tek.jacobi_lanes(1, 1) == 32 and tek.jacobi_lanes(257, 1) == 8
