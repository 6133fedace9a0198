"""The port's CUDA kernels against their plain torch versions, on the card,
and the port's device defaults.

Tests marked `cuda` skip without a CUDA device (a CUDA kernel has no CPU
mode). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.config import SolverConfig
from fem_simulation_tpu_torch.ops import ell
from fem_simulation_tpu_torch.ops import ell_kernels as ek
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import dynamic as tdyn
from fem_simulation_tpu_torch.sim import lattice as tlat
from fem_simulation_tpu_torch.sim import quasistatic as tqs
from fem_simulation_tpu_torch.sim import scene as tscene

MU, LA, DX = 250.0, 37.0, 0.1


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture(scope="module")
def scene():
    _need_cuda()
    return tlat.LatticeScene(meshlib.beam(4, 4, 8, dx=DX), device="cuda")


@pytest.fixture(scope="module")
def fields(scene):
    rng = np.random.default_rng(3)
    shape = tuple(scene.x0.shape)
    u = torch.from_numpy(0.03 * rng.standard_normal(shape).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return u.cuda() * scene.vert_mask[..., None], p.cuda()


@pytest.fixture(scope="module")
def uscene():
    _need_cuda()
    return tscene.Scene(meshlib.beam(4, 4, 8, dx=DX),
                        solver=SolverConfig(n_levels=2), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["force", "hvp", "diag", "energy"])
def test_kernel_matches_plain(scene, fields, op):
    """max|d| <= 1e-4 max|ref| (energy: relative 1e-4); the kernels sum
    per cell over q, then over the incident cells, in another order."""
    u, p = fields
    cm = scene.cell_mask
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    p_cf = p.permute(3, 0, 1, 2).contiguous()
    calls = {
        "force": (lk.force_cf, lk.force_cf_plain, (u_cf, cm)),
        "hvp": (lk.hvp_cf, lk.hvp_cf_plain, (u_cf, p_cf, cm)),
        "diag": (lk.hess_diag_lattice, lk.hess_diag_lattice_plain, (u, cm)),
        "energy": (lk.elastic_energy_lattice, lk.elastic_energy_lattice_plain,
                   (u, cm)),
    }
    kern, plain, args = calls[op]
    before = lk.launches[op]
    got = kern(*args, DX, MU, LA)
    ref = plain(*args, DX, MU, LA)
    torch.cuda.synchronize()
    assert lk.launches[op] == before + 1
    assert got.shape == ref.shape and got.is_cuda
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())


@pytest.mark.cuda
def test_frames_go_through_kernels(scene):
    """Two CUDA frames launch fused_newton once per Newton iteration and
    the force kernel at least once per frame, and match the CPU run."""
    lk.reset_launches()
    st = scene.init_state()
    ks = []
    for _ in range(2):
        st, k, fn = tlat.step_to_tol(scene, st)
        assert fn <= 1e-4
        ks.append(k)
    assert lk.launches["fused_newton"] == sum(ks) > 0
    assert lk.launches["force"] >= 2
    cpu = tlat.LatticeScene(scene.mesh, device="cpu")
    sc = cpu.init_state()
    for k in ks:
        sc, kc, _ = tlat.step_to_tol(cpu, sc)
        assert kc == k
    assert float((sc.x - st.x.cpu()).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_spmv_kernel_matches_plain(uscene):
    """The block-ELL SpMV kernel on the fine Hessian, full range and every
    color range: max|d| <= 1e-5 max|ref| (a fixed warp butterfly sums the
    slots, torch its own contraction order); one launch per call."""
    rng = np.random.default_rng(5)
    op = uscene.make_op(0)
    x = uscene.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(uscene.x0.shape)).astype(np.float32)).cuda()
    vals = tqs.assemble_fine(uscene, uscene.params, x)
    full = (vals * op.mask[..., None, None]).contiguous()
    v = torch.from_numpy(rng.standard_normal(
        tuple(x.shape)).astype(np.float32)).cuda()
    n = full.shape[0]
    ranges = [(0, n)] + [(op.color_offsets[c], op.color_offsets[c + 1])
                         for c in range(op.n_colors)]
    for r0, r1 in ranges:
        before = ek.launches["spmv"]
        got = ek.spmv_rows(full, op.nbr, op.mask, v, r0, r1)
        ref = ek.spmv_rows_plain(full, op.nbr, op.mask, v, r0, r1)
        torch.cuda.synchronize()
        assert ek.launches["spmv"] == before + 1
        assert got.shape == (r1 - r0, 3) and got.is_cuda
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_fused_pcg_kernel_matches_plain(scene):
    """fused_pcg on the card == its plain version: |k - k_plain| <= 1 (the
    dots are summed in another order), dx within 1e-3 of max|dx| at equal
    k; a zero RHS is a no-op with k == 1."""
    rng = np.random.default_rng(7)
    inv_dt = 1.0 / 0.033
    mat = scene.material
    x = scene.x0 + 0.01 * torch.from_numpy(rng.standard_normal(
        tuple(scene.x0.shape)).astype(np.float32)).cuda() \
        * scene.vert_mask[..., None]
    ctrl = (mat.control_mag * scene.pin_mask + scene.mass * inv_dt * inv_dt
            + (1.0 - scene.vert_mask))
    f = scene.dyn_force(x, x, inv_dt)
    u_cf = (x - scene.x0).permute(3, 0, 1, 2).contiguous()
    f_cf = f.permute(3, 0, 1, 2).contiguous()
    args = (u_cf, f_cf, scene.cell_mask, ctrl, scene.vert_mask, DX,
            mat.lame_mu, mat.lame_la, 30, 1e-4)
    before = lk.launches["fused_pcg"]
    dxk, kk = lk.fused_pcg(*args)
    dxp, kp = lk.fused_pcg_plain(*args)
    torch.cuda.synchronize()
    assert lk.launches["fused_pcg"] == before + 1
    assert abs(int(kk) - int(kp)) <= 1 and int(kk) > 2
    tol = 1e-3 if int(kk) == int(kp) else 5e-2
    assert float((dxk - dxp).abs().max()) <= tol * float(dxp.abs().max())
    dx0, k0 = lk.fused_pcg(u_cf, torch.zeros_like(f_cf), *args[2:])
    assert float(dx0.abs().max()) == 0.0 and int(k0) == 1


@pytest.mark.cuda
def test_newton_multigrid_step_launches_spmv(uscene):
    """One Newton-MG step on the card launches the SpMV kernel once for every
    ell.spmv / spmv_rows call, and lands where the CPU run does."""
    ek.reset_launches()
    ell.cuda_calls["spmv"] = 0
    sim = tqs.QuasiStaticSim(uscene)
    _, fn = sim.newton_multigrid(1)
    torch.cuda.synchronize()
    assert ek.launches["spmv"] == ell.cuda_calls["spmv"] > 0
    cpu = tscene.Scene(uscene.mesh, solver=uscene.solver, device="cpu")
    sim_cpu = tqs.QuasiStaticSim(cpu)
    _, fn_cpu = sim_cpu.newton_multigrid(1)
    assert float(fn[0]) == pytest.approx(float(fn_cpu[0]), rel=1e-3)
    assert float((sim.x.cpu() - sim_cpu.x).abs().max()) <= 1e-4


_ENTRY_POINTS = {
    "Scene": lambda m, **kw: tscene.Scene(
        m, solver=SolverConfig(n_levels=2), **kw).x0,
    "LatticeScene": lambda m, **kw: tlat.LatticeScene(m, **kw).x0,
    "LatticeDynamicSim": lambda m, **kw: tlat.LatticeDynamicSim(
        m, **kw).state.x,
    "lattice.state_from_numpy": lambda m, **kw: tlat.state_from_numpy(
        *tlat.state_to_numpy(tlat.LatticeScene(m, device="cpu")
                             .init_state()), **kw).x,
    "dynamic.state_from_numpy": lambda m, **kw: tdyn.state_from_numpy(
        np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(4), np.zeros((4, 3)),
        **kw).x,
}


@pytest.mark.parametrize("entry", sorted(_ENTRY_POINTS))
def test_entry_points_default_to_the_card(entry):
    """With no device given an entry point takes the GPU, and raises where
    there is none; device="cpu" is the only way onto the CPU."""
    m = meshlib.beam(2, 2, 4, dx=0.1)
    make = _ENTRY_POINTS[entry]
    if torch.cuda.is_available():
        assert make(m).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(m)
    assert make(m, device="cpu").device.type == "cpu"
