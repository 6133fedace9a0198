"""The lattice multigrid's level operators on the CPU: the Chebyshev
smoother (`cheby_smooth_cf`), the shifted SPD-projected diagonal
(`hess_diag_shift_cf`), the 6-channel block solve, the channel-first
transfers and a channel-first V-cycle against the JAX package.

On CPU tensors the wrappers run their plain versions; the CUDA kernels are
held to these on the card (`tests/test_torch_cuda.py`, `chip_smoke.py`).
Inputs are seeded numpy arrays on small lattices; every tolerance is
stated where it is checked. The JAX reference is built once, in a module
fixture.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from fem_simulation_tpu import mesh as meshlib
from fem_simulation_tpu.ops import ell as jell
from fem_simulation_tpu.sim import lattice as jl
from fem_simulation_tpu.sim import lattice_mg as jmg

from fem_simulation_tpu_torch.ops import ell, stencil
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


MU, LA = 250.0, 37.0
UPPER = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def t(a):
    return torch.from_numpy(np.array(a, np.float32))


def rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


@pytest.fixture(scope="module")
def level():
    """Level 0 of a 2-level hierarchy of the 3x3x7 beam (5x5x9 padded
    vertices) at a seeded perturbed state: the displacement, its ctrl, the
    SPD-projected 3x3 blocks composed channel-last and a right-hand
    side."""
    sc = tl.LatticeScene(meshlib.beam(3, 3, 7, dx=0.1), device="cpu")
    mg = tmg.LatticeMG(sc, n_levels=2, dt=None)
    lvl = mg.levels[0]
    rng = np.random.default_rng(23)
    shape = tuple(lvl.vert_mask.shape)
    vm = lvl.vert_mask
    u = t(0.02 * rng.normal(size=(3,) + shape)) * vm
    b = t(rng.normal(size=(3,) + shape)) * vm
    x0 = t(0.1 * rng.normal(size=(3,) + shape)) * vm
    ctrl = lvl.ctrl + lvl.mass * 900.0
    blocks = lk.hess_diag_lattice_plain(u.permute(1, 2, 3, 0), lvl.cell_mask,
                                        lvl.dx, MU, LA)
    blocks = blocks + (ctrl + (1.0 - vm))[..., None, None] * torch.eye(3)
    blocks = ell.spd_project(blocks, eps=1e-6, rel_floor=1e-3)
    return dict(lvl=lvl, u=u, b=b, x0=x0, ctrl=ctrl, blocks=blocks)


def smooth_channel_last(lv, x, degree, lmax):
    """The Chebyshev smoother composed on channel-last fields, independent
    of cheby_smooth_cf_plain: the plain HVP plus ctrl, ell.solve3x3 on the
    3x3 blocks, the host float32 recurrence of the coefficients. Returns
    (x, b - A x), channel-first."""
    lvl, ctrl, blocks = lv["lvl"], lv["ctrl"], lv["blocks"]
    vm3, ctrl3 = lvl.vert_mask[..., None], ctrl[..., None]
    u_cf = lv["u"]
    b = lv["b"].permute(1, 2, 3, 0)

    def matvec(p):
        hp = lk.hvp_cf_plain(u_cf, p.permute(3, 0, 1, 2).contiguous(),
                             lvl.cell_mask, lvl.dx, MU, LA)
        return (hp.permute(1, 2, 3, 0) + ctrl3 * p) * vm3

    f32 = np.float32
    lmin = lmax / f32(4.0)
    theta = f32(0.5) * (lmax + lmin)
    delta = f32(0.5) * (lmax - lmin)
    sigma = theta / delta
    rho = f32(1.0) / sigma
    z = ell.solve3x3(blocks, b if x is None else b - matvec(x)) * vm3
    d = z / float(theta)
    x = d if x is None else x + d
    for _ in range(degree - 1):
        rho_new = f32(1.0) / (f32(2.0) * sigma - rho)
        z = ell.solve3x3(blocks, b - matvec(x)) * vm3
        d = float(rho_new * rho) * d + float(f32(2.0) * rho_new / delta) * z
        x = x + d
        rho = rho_new
    r = b - matvec(x)
    return x.permute(3, 0, 1, 2), r.permute(3, 0, 1, 2)


# case: (start from x0, sweeps, residual)
SMOOTH_CASES = {"from-zero+residual": (False, 2, True),
                "warm": (True, 2, False),
                "coarse-12": (False, 12, False)}


@pytest.mark.parametrize("case", sorted(SMOOTH_CASES))
def test_cheby_plain_matches_channel_last_smooth(level, case):
    """cheby_smooth_cf (its plain version on CPU tensors) against the
    channel-last composition: the same float32 operations on the same
    values in another layout, so to 1e-6 of max|ref| (the layout may move
    torch's summation order in the 3-term contractions). The blocks come in
    as the 6 channels of their upper triangle."""
    warm, sweeps, residual = SMOOTH_CASES[case]
    lv, lvl = level, level["lvl"]
    lmax = np.float32(3.7)
    x = lv["x0"] if warm else None
    x_ref, r_ref = smooth_channel_last(
        lv, None if x is None else x.permute(1, 2, 3, 0), sweeps, lmax)
    coeffs = lk.cheby_coeffs(lmax, sweeps)
    assert len(coeffs) == 2 * sweeps - 1
    before = dict(lk.launches)
    out = lk.cheby_smooth_cf(lv["u"], lv["b"], x, lk.sym_channels(lv["blocks"]),
                             lv["ctrl"], lvl.vert_mask, lvl.cell_mask, lvl.dx,
                             MU, LA, coeffs, want_residual=residual)
    assert lk.launches == before
    got = out[0] if residual else out
    assert tuple(got.shape) == tuple(lv["u"].shape)
    assert rel_err(got, x_ref) <= 1e-6
    if residual:
        assert rel_err(out[1], r_ref) <= 1e-6


@pytest.mark.parametrize("state", ["rest", "perturbed"])
@pytest.mark.parametrize("project", [True, False])
def test_diag_shift_matches_spd_project(level, state, project):
    """hess_diag_shift_cf (plain on CPU) against the stencil diagonal plus
    (ctrl + 1 - vm) I and ell.spd_project(eps 1e-6, rel_floor 1e-3), kept
    as the upper triangle: bit for bit. Projected, every block's
    eigenvalues (float64) lie at or above the floor 1e-3 max|w| + 1e-6, to
    float32 roundoff (1e-5 of max|w|). At rest most blocks have xx == yy
    exactly with xy != 0 (the square cross-section), the sign(0) case."""
    lvl = level["lvl"]
    u = level["u"] if state == "perturbed" else torch.zeros_like(level["u"])
    ctrl = level["ctrl"]
    d6 = lk.hess_diag_shift_cf(u, lvl.cell_mask, ctrl, lvl.vert_mask, lvl.dx,
                               MU, LA, project)
    g, det = stencil.lattice_material_tables(lvl.dx)
    blocks = stencil.elastic_hessian_diag_lattice(
        u.permute(1, 2, 3, 0), lvl.cell_mask, g, det, MU, LA)
    blocks = blocks + (ctrl + (1.0 - lvl.vert_mask))[..., None, None] \
        * torch.eye(3)
    if state == "rest":
        a = blocks.reshape(-1, 3, 3)
        ties = (a[:, 0, 0] == a[:, 1, 1]) & (a[:, 0, 1].abs() > 1e-3)
        assert int(ties.sum()) > 0
    if project:
        blocks = ell.spd_project(blocks, eps=1e-6, rel_floor=1e-3)
    ref = torch.stack([blocks[..., r, c] for r, c in UPPER])
    assert tuple(d6.shape) == (6,) + tuple(lvl.vert_mask.shape)
    assert torch.equal(d6, ref)
    if project:
        w = np.linalg.eigvalsh(lk.sym_blocks(d6).double().numpy())
        wmax = np.abs(w).max(axis=-1)
        assert np.all(w.min(axis=-1) >= 1e-3 * wmax + 1e-6 - 1e-5 * wmax)


def test_spd_project_tie_takes_no_rotation():
    """A block with app == aqq and apq != 0 gets no (p, q) rotation in
    either package (sign(0) = 0): with xz = yz = 0 the cyclic Jacobi never
    moves it, so the projection keeps its diagonal and drops xy. The
    kernel's epilogue copies this (tau > 0) - (tau < 0) rule; a copysign
    would rotate by 45 degrees and keep xy. The other blocks: a generic SPD
    block, an indefinite one (floored) and a tiny off-diagonal."""
    blocks = np.array([[[2.0, 1.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 3.0]],
                       [[4.0, 0.5, 0.2], [0.5, 3.0, 0.1], [0.2, 0.1, 2.0]],
                       [[1.0, 2.0, 0.0], [2.0, -3.0, 0.5], [0.0, 0.5, 1.0]],
                       [[2.0, 1e-31, 0.0], [1e-31, 2.0, 0.0],
                        [0.0, 0.0, 1.0]]], np.float32)
    got = ell.spd_project(t(blocks), eps=1e-6, rel_floor=1e-3).numpy()
    ref = np.asarray(jell.spd_project(jnp.asarray(blocks), eps=1e-6,
                                      rel_floor=1e-3))
    np.testing.assert_array_equal(got[0], np.diag([2.0, 2.0, 3.0]))
    assert rel_err(got, ref) <= 1e-6
    w = np.linalg.eigvalsh(got[2].astype(np.float64))
    assert w.min() >= 1e-3 * np.abs(w).max() + 1e-6 - 1e-6


def test_jacobi_ties_marks_the_sign0_jump():
    """ell.jacobi_ties marks the blocks where a rotation of spd_project
    meets app == aqq exactly with apq != 0, and only those: an ulp off the
    tie the projection rotates and keeps xy (a jump of ~|xy| = 1 here,
    exact to 1e-6), and the mark goes. A generic block and a diagonal one
    (apq = 0) are not marked."""
    tie = np.array([[2.0, 1.0, 0.0], [1.0, 2.0, 0.0], [0.0, 0.0, 3.0]],
                   np.float32)
    near = tie.copy()
    near[0, 0] = np.nextafter(np.float32(2.0), np.float32(3.0))
    blocks = np.stack([tie, near,
                       [[4.0, 0.5, 0.2], [0.5, 3.0, 0.1], [0.2, 0.1, 2.0]],
                       np.diag([2.0, 2.0, 1.0])]).astype(np.float32)
    got = ell.jacobi_ties(t(blocks)).tolist()
    assert got == [True, False, False, False]
    proj = ell.spd_project(t(blocks[:2]), eps=1e-6, rel_floor=1e-3).numpy()
    assert abs(abs(float(proj[0, 0, 1] - proj[1, 0, 1])) - 1.0) <= 1e-6


def test_jacobi_ties_after_a_rotation():
    """A block of the 16x16x256 beam's fine level at a seeded perturbed
    state, in the summation orders of lat_diag_shift and of the plain
    chain (an ulp apart in xx and xz). Neither ties as given; the plain
    one's first (1, 2) rotation meets yy == zz (109.90953, yz 10.68), so
    that rotation is skipped: the kernel's projection returns its SPD
    input (to 1e-6 relative), the plain one moves yz by 9.016 (to 1e-3)."""
    k = [134.17559814453125, 12.877934455871582, -13.707286834716797,
         12.877934455871582, 116.74382019042969, 5.37923526763916,
         -13.707286834716797, 5.37923526763916, 112.8643569946289]
    p = list(k)
    p[0] = 134.1755828857422
    p[2] = p[6] = -13.707287788391113
    blocks = t(np.array([k, p]).reshape(2, 3, 3))
    diag = blocks.diagonal(dim1=-2, dim2=-1)
    assert not bool((diag[:, [0, 0, 1]] == diag[:, [1, 2, 2]]).any())
    assert ell.jacobi_ties(blocks).tolist() == [False, True]
    proj = ell.spd_project(blocks, eps=1e-6, rel_floor=1e-3)
    assert rel_err(proj[0], blocks[0]) <= 1e-6
    assert abs(float(proj[1, 1, 2] - blocks[1, 1, 2]) + 9.016) <= 1e-3


def test_sym_solve_cf_is_solve3x3(level):
    """The 6-channel channel-first block solve gives ell.solve3x3's bits on
    the expanded blocks (the same products in the same order)."""
    d6 = lk.sym_channels(level["blocks"])
    r = level["b"]
    ref = ell.solve3x3(lk.sym_blocks(d6), r.permute(1, 2, 3, 0))
    assert torch.equal(lk.sym_solve_cf(d6, r), ref.permute(3, 0, 1, 2))
    assert torch.equal(lk.sym_blocks(d6), lk.sym_blocks(d6).transpose(-1, -2))


@pytest.mark.parametrize("fine", [(9, 7, 13), (10, 7, 14)])
def test_channel_first_transfers_bit_equal(fine):
    """prolong_lat_cf / restrict_lat_cf: the channel-last transfers' bits,
    on an odd grid and on one with 2n axes."""
    rng = np.random.default_rng(4)
    coarse = tuple((n + 1) // 2 for n in fine)
    xc = t(rng.normal(size=(3,) + coarse))
    xf = t(rng.normal(size=(3,) + fine))
    p_cf = stencil.prolong_lat_cf(xc, shape=fine)
    p_cl = stencil.prolong_lat(xc.permute(1, 2, 3, 0), shape=fine)
    assert torch.equal(p_cf.permute(1, 2, 3, 0), p_cl)
    r_cf = stencil.restrict_lat_cf(xf)
    r_cl = stencil.restrict_lat(xf.permute(1, 2, 3, 0))
    assert r_cf.is_contiguous()
    assert torch.equal(r_cf.permute(1, 2, 3, 0), r_cl)


@pytest.fixture(scope="module")
def vcycle_jax():
    """A 3-level hierarchy of the 3x3x7 beam (5x5x9, 3x3x5, 3x3x3; dt None,
    12 Chebyshev coarse sweeps), linearized at a seeded perturbed state with
    the inertia term of dt 0.033 added per level: the JAX package's V-cycle
    on a seeded right-hand side, and the inputs."""
    mesh = meshlib.beam(3, 3, 7, dx=0.1)
    js = jl.LatticeScene(mesh)
    mg = jmg.LatticeMG(js, n_levels=3, dt=None, use_pallas=False)
    rng = np.random.default_rng(31)
    shape = mg.pad_shape
    vm = np.zeros(shape + (1,), np.float32)
    vm[:js.shape[0], :js.shape[1], :js.shape[2], 0] = np.asarray(js.vert_mask)
    x0 = np.zeros(shape + (3,), np.float32)
    x0[:js.shape[0], :js.shape[1], :js.shape[2]] = np.asarray(js.x0)
    x = (x0 + 0.02 * rng.normal(size=x0.shape) * vm).astype(np.float32)
    b = (rng.normal(size=x0.shape) * vm).astype(np.float32)
    inv_dt = 1.0 / 0.033

    @jax.jit
    def run(xp, bp):
        ops = mg.linearize(xp, inv_dt=inv_dt)
        return jnp.stack([op[3] for op in ops]), mg.vcycle(ops, bp)
    lmax, z = run(jnp.asarray(x), jnp.asarray(b))
    return mesh, x, b, inv_dt, np.asarray(lmax), np.asarray(z)


def test_vcycle_channel_first_matches_jax(vcycle_jax):
    """LatticeMG.vcycle on the channel-first right-hand side, through
    cheby_smooth_cf and hess_diag_shift_cf (their plain versions here) on
    all three levels, with the inertia shift folded into each level's ctrl:
    the Chebyshev bounds and the channel-last JAX V-cycle to 1e-4 of
    max|ref| (float32 roundoff through the smoother's recurrences)."""
    mesh, x, b, inv_dt, lmax, z = vcycle_jax
    tm = tmg.LatticeMG(tl.LatticeScene(mesh, device="cpu"), n_levels=3,
                       dt=None)
    ops = tm.linearize(t(x), inv_dt=inv_dt)
    for li, op in enumerate(ops):
        assert isinstance(op, tmg.LevelOps)
        assert tuple(op.d6.shape) == (6,) + tuple(tm.levels[li].vert_mask.shape)
        assert abs(float(op.lmax) - lmax[li]) <= 1e-4 * lmax[li], li
    before = dict(lk.launches)
    got = tm.vcycle(ops, t(b).permute(3, 0, 1, 2).contiguous())
    assert lk.launches == before
    assert tuple(got.shape) == (3,) + tuple(tm.pad_shape)
    assert rel_err(got.permute(1, 2, 3, 0), z) <= 1e-4
