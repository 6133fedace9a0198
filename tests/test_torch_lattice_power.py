"""The lattice multigrid's power iteration and level operator on the CPU:
`power_lmax_cf` and `level_matvec_cf` (their plain versions on CPU
tensors) against the JAX package's `LatticeMG._est_lmax` and level matvec,
and `LatticeMG.linearize`'s bounds, read back in one transfer, against a
power iteration run level by level with one `.item()` each.

The CUDA kernels (`lat_power`, `lat_hvp`) are held to these plain versions
on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`). Inputs are
seeded numpy arrays on a small lattice; every tolerance is stated where it
is checked. The JAX reference is built once, in a module fixture.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as meshlib
from fem_simulation_tpu.sim import lattice as jl
from fem_simulation_tpu.sim import lattice_mg as jmg

from fem_simulation_tpu_torch.ops import ell
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import lattice as tl
from fem_simulation_tpu_torch.sim import lattice_mg as tmg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One torch thread a test process: the tests run in several processes
    at once, and torch's default of a thread a core each makes them contend
    for the cores on these small tensors."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# quasi-static (the hierarchy's pin-only ctrl) and with the inertia term of
# dt 0.033 added per level at linearization
INV_DTS = {"quasi-static": None, "inertia": 1.0 / 0.033}
LEVELS = (0, 1)


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def cf(a):
    """A channel-last numpy field as a channel-first tensor."""
    return t(a).permute(3, 0, 1, 2).contiguous()


@pytest.fixture(scope="module")
def reference():
    """The 3x3x7 beam's 2-level hierarchy (5x5x9 and 3x3x5 padded vertices,
    dt None) at a seeded perturbed state and a seeded direction per level.
    For each case of INV_DTS, the JAX package's linearization there: every
    level's Chebyshev bound by its own _est_lmax on that linearization's
    matvec and blocks, and its level matvec on the direction. The port's
    hierarchy and linearization of the same state."""
    mesh = meshlib.beam(3, 3, 7, dx=0.1)
    js = jl.LatticeScene(mesh)
    mg = jmg.LatticeMG(js, n_levels=2, dt=None, use_pallas=False)
    rng = np.random.default_rng(53)
    shape = mg.pad_shape
    vm = np.zeros(shape + (1,), np.float32)
    vm[:js.shape[0], :js.shape[1], :js.shape[2], 0] = np.asarray(js.vert_mask)
    x0 = np.zeros(shape + (3,), np.float32)
    x0[:js.shape[0], :js.shape[1], :js.shape[2]] = np.asarray(js.x0)
    x = (x0 + 0.02 * rng.normal(size=x0.shape) * vm).astype(np.float32)
    ps = [rng.normal(size=tuple(lvl.vert_mask.shape) + (3,)).astype(
        np.float32) for lvl in mg.levels]
    jax_out = {}
    for case, inv_dt in INV_DTS.items():
        @jax.jit
        def run(xp, p0, p1, inv_dt=inv_dt):
            ops = mg.linearize(xp, inv_dt=inv_dt)
            lmax = jnp.stack([mg._est_lmax(op[0], op[1], op[2]) for op in ops])
            return lmax, [op[0](p) for op, p in zip(ops, (p0, p1))]
        lmax, mv = run(jnp.asarray(x), *(jnp.asarray(p) for p in ps))
        jax_out[case] = (np.asarray(lmax), [np.asarray(m) for m in mv])
    tm = tmg.LatticeMG(tl.LatticeScene(mesh, device="cpu"), n_levels=2,
                       dt=None)
    ops = {case: tm.linearize(t(x), inv_dt=inv_dt)
           for case, inv_dt in INV_DTS.items()}
    return dict(tm=tm, ps=ps, jax=jax_out, ops=ops)


def _level_args(tm, li):
    lvl = tm.levels[li]
    mat = tm.scene.material
    return lvl.cell_mask, lvl.dx, mat.lame_mu, mat.lame_la


@pytest.mark.parametrize("li", LEVELS)
@pytest.mark.parametrize("case", sorted(INV_DTS))
def test_power_lmax_matches_jax(reference, case, li):
    """power_lmax_cf (plain on the CPU) on the port's linearization of
    level li against the JAX _est_lmax on the JAX one, to 1e-4 relative
    (the two linearizations agree to float32 roundoff, and torch's and
    XLA's sin start vectors may differ by an ulp)."""
    tm = reference["tm"]
    op = reference["ops"][case][li]
    cm, dx, mu, la = _level_args(tm, li)
    before = dict(lk.launches)
    got = lk.power_lmax_cf(op.u_cf, op.d6, op.ctrl, op.vmask, cm, dx, mu, la)
    assert lk.launches == before
    assert got.dim() == 0 and got.dtype == torch.float32
    ref = float(reference["jax"][case][0][li])
    assert abs(float(got) - ref) <= 1e-4 * ref, (float(got), ref)


@pytest.mark.parametrize("li", LEVELS)
@pytest.mark.parametrize("case", sorted(INV_DTS))
def test_level_matvec_matches_jax(reference, case, li):
    """level_matvec_cf (plain on the CPU), (H(u) p + ctrl p) vm with the
    inertia term folded into ctrl, against the JAX level matvec as its
    linearize composes it (the inertia term added after the pin-only
    matvec), to 1e-5 of max|ref|: another summation order of the same
    float32 terms, on displacements that agree to roundoff."""
    tm = reference["tm"]
    op = reference["ops"][case][li]
    cm, dx, mu, la = _level_args(tm, li)
    p = cf(reference["ps"][li])
    got = lk.level_matvec_cf(op.u_cf, p, cm, op.ctrl, op.vmask, dx, mu, la)
    assert torch.equal(got, op.matvec(p))
    ref = reference["jax"][case][1][li]
    err = float(np.abs(got.permute(1, 2, 3, 0).numpy() - ref).max())
    assert err <= 1e-5 * float(np.abs(ref).max()), err


def _lmax_item(matvec, d6, vmask, iters=6):
    """A level's bound as LatticeMG._est_lmax computed it before the power
    iteration became a kernel, read back with .item()."""
    shape = tuple(vmask.shape)
    n = shape[0] * shape[1] * shape[2]
    start = torch.sin(torch.arange(n, dtype=torch.float32))
    v = (vmask * start.reshape(shape)).expand((3,) + shape).contiguous()
    lam = None
    for _ in range(iters):
        w = lk.sym_solve_cf(d6, matvec(v)) * vmask
        ww = ell.vdot(w, w)
        lam = torch.sqrt(ww / torch.clamp(ell.vdot(v, v), min=1e-30))
        v = w / torch.clamp(torch.sqrt(ww), min=1e-30)
    return np.float32((lam * 1.1).item())


@pytest.mark.parametrize("case", sorted(INV_DTS))
def test_linearize_lmax_unchanged(reference, case):
    """linearize's bounds, every level's power iteration written to one
    tensor and read back in one transfer, are host float32 values equal bit
    for bit to those of a level-by-level power iteration with one .item()
    each, and newton_ops caches them times 1.2 as before."""
    tm = reference["tm"]
    ops = reference["ops"][case]
    for li, op in enumerate(ops):
        assert isinstance(op.lmax, np.float32)
        cm, dx, mu, la = _level_args(tm, li)

        def matvec(q, op=op):
            return (lk.hvp_cf(op.u_cf, q, cm, dx, mu, la) + op.ctrl * q) \
                * op.vmask
        assert op.lmax == _lmax_item(matvec, op.d6, op.vmask), li
    cache = tmg.LatticeMG.lmax_cache(ops)
    assert cache.dtype == np.float32
    assert np.array_equal(cache, np.array([op.lmax for op in ops],
                                          np.float32) * np.float32(1.2))


def test_power_lmax_writes_its_slot(reference):
    """power_lmax_cf writes 1.1 lambda to out[slot] and returns that 0-d
    view, leaving the other slots alone; a slot outside out raises."""
    tm = reference["tm"]
    op = reference["ops"]["quasi-static"][1]
    cm, dx, mu, la = _level_args(tm, 1)
    out = torch.full((3,), -1.0)
    got = lk.power_lmax_cf(op.u_cf, op.d6, op.ctrl, op.vmask, cm, dx, mu, la,
                           out=out, slot=1)
    assert float(got) == float(op.lmax) and float(out[1]) == float(op.lmax)
    assert out[0] == -1.0 and out[2] == -1.0
    with pytest.raises(ValueError, match="slot"):
        lk.power_lmax_cf(op.u_cf, op.d6, op.ctrl, op.vmask, cm, dx, mu, la,
                         out=out, slot=3)
