"""The port's CUDA kernels against their plain torch versions, on the card,
and the port's device defaults.

Tests marked `cuda` skip without a CUDA device (a CUDA kernel has no CPU
mode). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import ctypes

import numpy as np
import pytest
import torch

from fem_simulation_tpu_torch import hierarchy as thl
from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch.config import (ClothConfig, SolverConfig,
                                             TrainInterpConfig)
from fem_simulation_tpu_torch.ops import _cuda, ell
from fem_simulation_tpu_torch.ops import ell_kernels as ek
from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.ops import stencil as tstencil
from fem_simulation_tpu_torch.models import train_interp as tti
from fem_simulation_tpu_torch.parallel import dist as tdist
from fem_simulation_tpu_torch.parallel import halo as thalo
from fem_simulation_tpu_torch.parallel import lattice_halo as tlh
from fem_simulation_tpu_torch.parallel import lattice_mg_dist as tmgd
from fem_simulation_tpu_torch.models import train_solver as tts
from fem_simulation_tpu_torch.sim import cloth as tcloth
from fem_simulation_tpu_torch.sim import dynamic as tdyn
from fem_simulation_tpu_torch.sim import lattice as tlat
from fem_simulation_tpu_torch.sim import lattice_mg as tmg
from fem_simulation_tpu_torch.sim import quasistatic as tqs
from fem_simulation_tpu_torch.sim import scene as tscene
from fem_simulation_tpu_torch.solvers import smoothers as tsm

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


_LATTICES = {
    "beam": lambda: meshlib.beam(4, 4, 8, dx=DX),
    # odd vertex counts: tiles of unequal widths, ragged edges
    "odd": lambda: meshlib.beam(3, 5, 7, dx=DX),
    # a hollow box: masked cells inside the lattice
    "shell": lambda: meshlib.shell(8, 8, 9, thickness=2, dx=DX),
}


@pytest.fixture(scope="module")
def lattices(scene):
    out = {"beam": scene}
    for name in ("odd", "shell"):
        out[name] = tlat.LatticeScene(_LATTICES[name](), device="cuda")
    return out


def _random_fields(sc, seed):
    rng = np.random.default_rng(seed)
    shape = tuple(sc.x0.shape)
    u = torch.from_numpy(0.03 * rng.standard_normal(shape).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return u.cuda() * sc.vert_mask[..., None], p.cuda()


def _calls(sc, u, p):
    cm = sc.cell_mask
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    p_cf = p.permute(3, 0, 1, 2).contiguous()
    return {
        "force": (lk.force_cf, lk.force_cf_plain, (u_cf, cm)),
        "hvp": (lk.hvp_cf, lk.hvp_cf_plain, (u_cf, p_cf, cm)),
        "diag": (lk.hess_diag_lattice, lk.hess_diag_lattice_plain, (u, cm)),
        "energy": (lk.elastic_energy_lattice, lk.elastic_energy_lattice_plain,
                   (u, cm)),
    }


def _kernels_per_call(fn, calls=5):
    """Device kernels a call of fn() launches, by torch.profiler over
    `calls` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(names) / calls, sorted(set(names))


@pytest.mark.cuda
@pytest.mark.parametrize("lattice", sorted(_LATTICES))
@pytest.mark.parametrize("op", ["force", "hvp", "diag", "energy"])
def test_kernel_matches_plain(lattices, op, lattice):
    """max|d| <= 1e-4 max|ref| (energy: relative 1e-4); the kernels sum
    per cell over q, then over the incident cells, in another order. On the
    4x4x8 beam, an odd lattice and a hollow box (masked cells). Force and
    energy: two calls give identical bits, and a call is one kernel (the
    force's plan is one launch on these lattices; the two passes are
    tested in test_force_kernel_every_tiling)."""
    sc = lattices[lattice]
    kern, plain, args = _calls(sc, *_random_fields(sc, 3))[op]
    before = lk.launches[op]
    got = kern(*args, DX, MU, LA)
    again = kern(*args, DX, MU, LA)
    ref = plain(*args, DX, MU, LA)
    torch.cuda.synchronize()
    assert lk.launches[op] == before + 2
    assert got.shape == ref.shape and got.is_cuda
    assert float((got - ref).abs().max()) <= 1e-4 * float(ref.abs().max())
    if op in ("force", "energy"):
        assert torch.equal(got, again)
        per_call, names = _kernels_per_call(lambda: kern(*args, DX, MU, LA))
        assert per_call == 1, names


@pytest.mark.cuda
@pytest.mark.parametrize("lattice", ["beam", "odd"])
def test_force_kernel_every_tiling(lattices, lattice, monkeypatch):
    """lat_force under plans other than its own: halo tilings from one tile
    to tiles of one vertex, and the two passes. Each matches the plain
    version and repeats its bits."""
    sc = lattices[lattice]
    u, _ = _random_fields(sc, 5)
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    ref = lk.force_cf_plain(u_cf, sc.cell_mask, DX, MU, LA)
    scale = float(ref.abs().max())
    key = (str(u.device),) + tuple(sc.shape)
    plans = [lk.force_tiling(sc.shape, tiles)
             for tiles in ((1, 1, 1), (2, 2, 2), (1, 3, 4), tuple(sc.shape),
                           (2, 1, sc.shape[2]))]
    plans = [p for p in plans if p is not None] + [lk.FORCE_TWO_PASS]
    assert len(plans) >= 5
    for plan in plans:
        monkeypatch.setitem(lk._force_plans, key, plan)
        got = lk.force_cf(u_cf, sc.cell_mask, DX, MU, LA)
        again = lk.force_cf(u_cf, sc.cell_mask, DX, MU, LA)
        torch.cuda.synchronize()
        assert float((got - ref).abs().max()) <= 1e-4 * scale, plan
        assert torch.equal(got, again), plan


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 0])
def test_energy_ticket_resets_and_streams(lattices, lanes, monkeypatch):
    """Eight lanes a cell and a thread a cell, each on 7 blocks: 100 energy
    calls back to back give one value (the last block resets its ticket for
    the next call), and so do calls on two other streams, each with its own
    partials and ticket; the value matches the plain version."""
    sc = lattices["shell"]
    monkeypatch.setattr(lk, "energy_plan", lambda *shape: (7, lanes))
    u, _ = _random_fields(sc, 9)
    args = (u, sc.cell_mask, DX, MU, LA)
    first = lk.elastic_energy_lattice(*args)
    runs = [lk.elastic_energy_lattice(*args) for _ in range(100)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, e) for e in runs)
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            outs.append([lk.elastic_energy_lattice(*args) for _ in range(20)])
    torch.cuda.synchronize()
    assert all(torch.equal(first, e) for es in outs for e in es)
    ref = lk.elastic_energy_lattice_plain(*args)
    assert float((first - ref).abs()) <= 1e-4 * float(ref.abs())


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


def _cloth_spmv_system(res, seed):
    """(values masked, nbr, mask, v) of a res x res cloth's frame Hessian
    (K 7) at a seeded perturbed state, on the card."""
    sc = tcloth.ClothScene(ClothConfig(res_x=res, res_y=res), pins=[0, res],
                           device="cuda")
    p = sc.params
    rng = np.random.default_rng(seed)
    x = p["x0"] + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(p["x0"].shape)).astype(np.float32)).cuda()
    diag = tcloth._frame_diag(sc, p, tcloth.init_state(sc), 1.0 / sc.cfg.dt)
    vals = tcloth._frame_hessian(sc, p, x, diag)
    v = torch.from_numpy(rng.standard_normal(tuple(x.shape)).astype(
        np.float32)).cuda()
    return (vals * p["mask"][..., None, None]).contiguous(), p["nbr"], \
        p["mask"], v


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hex K 27", "cloth K 7"])
def test_spmv_lane_groups_match_plain(uscene, case):
    """ell_spmv's lane groups at a hex mesh's K = 27 (32 lanes a row) and
    at the cloth's K = 7 (8 lanes, 4 rows a warp; 33x33 = 1,089 rows, so
    the last warp is part full), over the whole range and two ragged ones:
    within 1e-5 of max |ref| of the plain version, two runs bit-equal."""
    if case.startswith("hex"):
        rng = np.random.default_rng(5)
        op = uscene.make_op(0)
        x = uscene.x0 + torch.from_numpy(0.01 * rng.standard_normal(
            tuple(uscene.x0.shape)).astype(np.float32)).cuda()
        vals = tqs.assemble_fine(uscene, uscene.params, x)
        full = (vals * op.mask[..., None, None]).contiguous()
        nbr, mask = op.nbr, op.mask
        v = torch.from_numpy(rng.standard_normal(
            tuple(x.shape)).astype(np.float32)).cuda()
    else:
        full, nbr, mask, v = _cloth_spmv_system(33, 6)
    n, k = full.shape[:2]
    assert ek.lanes(k) == (32 if k > 16 else 8)
    for r0, r1 in ((0, n), (3, n - 5), (n // 2 + 1, n)):
        before = ek.launches["spmv"]
        got = ek.spmv_rows(full, nbr, mask, v, r0, r1)
        again = ek.spmv_rows(full, nbr, mask, v, r0, r1)
        ref = ek.spmv_rows_plain(full, nbr, mask, v, r0, r1)
        torch.cuda.synchronize()
        assert ek.launches["spmv"] == before + 2
        assert torch.equal(got, again)
        assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["x_t", "zero"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_jacobi_bwd_offdiag_matches_plain(uscene, start, accumulate):
    """ell_jacobi_bwd writing the whole values' gradient row (one launch)
    on every level of the Galerkin chain: lam, gb and gv within 1e-5 of
    max |ref| of jacobi_bwd_plain, two runs bit-equal, and its off-diagonal
    slots bit-equal to the launch it replaces,
    ell_outer(lam, nbr, mask, x_t, skip=diag_slot, alpha=-1) (x_t zero for
    the zero start, which the one launch does not read); storing and
    accumulating."""
    rng = np.random.default_rng(19)
    x = uscene.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(uscene.x0.shape)).astype(np.float32)).cuda()
    chain = tqs.galerkin_chain(uscene, uscene.params,
                               tqs.assemble_fine(uscene, uscene.params, x))
    for li, vals in enumerate(chain):
        op = uscene.make_op(li)
        n = vals.shape[0]
        b, g, xt = (torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).cuda() for _ in range(3))
        if start == "zero":
            xt = torch.zeros_like(b)
        gv0 = torch.from_numpy(rng.standard_normal(tuple(vals.shape)).astype(
            np.float32)).cuda()
        gb0 = torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).cuda()
        args = (vals, op.nbr, op.mask, op.diag_slot, b)

        def merged(fn):
            gv, gb = gv0.clone(), gb0.clone()
            lam = fn(*args, None if start == "zero" else xt, g, gb, gv,
                     accumulate)
            return lam, gb, gv
        (lam, gb, gv), again, ref = merged(ek.jacobi_bwd), \
            merged(ek.jacobi_bwd), merged(ek.jacobi_bwd_plain)
        rows, ds = torch.arange(n, device=b.device), op.diag_slot.long()
        two = gv0.clone()
        two[rows, ds] = gv[rows, ds]
        ek.outer(lam, op.nbr, op.mask, xt, skip=op.diag_slot, alpha=-1.0,
                 out=two, accumulate=accumulate)
        torch.cuda.synchronize()
        assert torch.equal(gv, two), li
        for got, rep, want in zip((lam, gb, gv), again, ref):
            assert torch.equal(got, rep), li
            assert float((got - want).abs().max()) <= 1e-5 * float(
                want.abs().max()), li


@pytest.mark.cuda
def test_jacobi_backward_one_launch_an_iteration(uscene):
    """EllJacobiFn's backward launches one ell_jacobi_bwd an iteration and
    no ell_outer: one iteration from zero (exp2's coarse solve) launches
    exactly one jacobi_bwd and nothing else; three iterations from an x0
    that takes a gradient three jacobi_bwd and three spmv_t."""
    rng = np.random.default_rng(2)
    op = uscene.make_op(1)
    vals = tqs.galerkin_chain(uscene, uscene.params, tqs.assemble_fine(
        uscene, uscene.params, uscene.x0))[1]
    n = vals.shape[0]
    b, x0, w = (torch.from_numpy(rng.standard_normal((n, 3)).astype(
        np.float32)).cuda() for _ in range(3))
    for its, start, want in ((1, None, (1, 0, 0)), (3, x0, (3, 0, 3))):
        V = vals.clone().requires_grad_()
        B = b.clone().requires_grad_()
        X0 = None if start is None else start.clone().requires_grad_()
        out = ek.jacobi(V, op.nbr, op.mask, op.diag_slot, B, X0, its,
                        op.transpose_table())
        ek.reset_launches()
        for name in ell.cuda_calls:
            ell.cuda_calls[name] = 0
        (out * w).sum().backward()
        torch.cuda.synchronize()
        assert ek.launches == ell.cuda_calls
        assert (ek.launches["jacobi_bwd"], ek.launches["outer"],
                ek.launches["spmv_t"]) == want
        assert bool(torch.isfinite(V.grad).all())


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
    """One Newton-MG step on the card (2 levels) launches the SpMV kernel
    twice (the V-cycle's residuals) and the fused Gauss-Seidel kernel three
    times, once for every call made on CUDA tensors, and lands where the CPU
    run does."""
    ek.reset_launches()
    for name in ell.cuda_calls:
        ell.cuda_calls[name] = 0
    sim = tqs.QuasiStaticSim(uscene)
    _, fn = sim.newton_multigrid(1)
    torch.cuda.synchronize()
    assert ek.launches == ell.cuda_calls
    assert ek.launches == {"spmv": 2, "gs": 3, "jacobi": 0, "spmv_t": 0,
                           "outer": 0, "jacobi_bwd": 0}
    cpu = tscene.Scene(uscene.mesh, solver=uscene.solver, device="cpu")
    sim_cpu = tqs.QuasiStaticSim(cpu)
    _, fn_cpu = sim_cpu.newton_multigrid(1)
    assert float(fn[0]) == pytest.approx(float(fn_cpu[0]), rel=1e-3)
    assert float((sim.x.cpu() - sim_cpu.x).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_backward_kernels_match_plain(uscene):
    """ell_spmv_t (with and without the diagonal slot), ell_outer and
    ell_jacobi_bwd on every level of the scene's Galerkin chain against
    their plain versions on the same CUDA tensors, within 1e-5 of max
    |ref|; each launches once a call and repeats its bits."""
    rng = np.random.default_rng(17)
    x = uscene.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(uscene.x0.shape)).astype(np.float32)).cuda()
    chain = tqs.galerkin_chain(uscene, uscene.params,
                               tqs.assemble_fine(uscene, uscene.params, x))
    for li, vals in enumerate(chain):
        op = uscene.make_op(li)
        n = vals.shape[0]
        tt = op.transpose_table()
        g, v = (torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).cuda() for _ in range(2))
        calls = {
            "spmv_t": (lambda: ek.spmv_t(vals, op.mask, tt, g, op.diag_slot,
                                         -1.0),
                       lambda: ek.spmv_t_plain(vals, op.mask, tt, g,
                                               op.diag_slot, -1.0)),
            "outer": (lambda: ek.outer(g, op.nbr, op.mask, v),
                      lambda: ek.outer_plain(g, op.nbr, op.mask, v)),
            "jacobi_bwd": (
                lambda: torch.cat([r.reshape(-1) for r in _bwd(
                    ek.jacobi_bwd, vals, op, g, v)]),
                lambda: torch.cat([r.reshape(-1) for r in _bwd(
                    ek.jacobi_bwd_plain, vals, op, g, v)])),
        }
        for name, (kernel, plain) in calls.items():
            before = ek.launches[name]
            got, again, ref = kernel(), kernel(), plain()
            torch.cuda.synchronize()
            assert ek.launches[name] == before + 2, name
            assert torch.equal(got, again), name
            assert float((got - ref).abs().max()) <= 1e-5 * float(
                ref.abs().max()), (name, li)


def _bwd(fn, vals, op, g, v):
    """jacobi_bwd's outputs (lam, gb, gv's diagonal slots) into zeros."""
    gb, gv = torch.zeros_like(g), torch.zeros_like(vals)
    lam = fn(vals, op.nbr, op.mask, op.diag_slot, v, v, g, gb, gv)
    rows = torch.arange(vals.shape[0], device=vals.device)
    return lam, gb, gv[rows, op.diag_slot.long()]


def _hex_spmv_t_system(sc, level):
    """(values, mask, tt, the diagonal slots) of a beam scene's fine Hessian
    at a seeded state (level 0) or its Galerkin level 1, on the card."""
    rng = np.random.default_rng(5)
    x = sc.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(sc.x0.shape)).astype(np.float32)).cuda()
    chain = tqs.galerkin_chain(sc, sc.params,
                               tqs.assemble_fine(sc, sc.params, x))
    op = sc.make_op(level)
    return chain[level], op.mask, op.transpose_table(), op.diag_slot


def _cloth_spmv_t_system(res):
    """(values, mask, tt, the diagonal slots) of a res x res cloth's frame
    Hessian (K 7; its diagonal slot the live one pointing at its own row)."""
    vals, nbr, mask, _ = _cloth_spmv_system(res, 6)
    own = (nbr == torch.arange(nbr.shape[0], device=nbr.device)[:, None]
           ) & (mask > 0)
    return vals, mask, ek.transpose_table(nbr), \
        own.int().argmax(dim=1).int().contiguous()


def _circulant_spmv_t_system(n, k):
    """(values, mask, tt, skip) of a seeded table whose row i's slot s
    points at (i + s) mod n: every column has k entries (Kt = k), a fifth
    of them masked out; skip a random slot of each row."""
    rng = np.random.default_rng(n + k)
    nbr = (np.arange(n)[:, None] + np.arange(k)[None, :]) % n
    mask = (rng.random((n, k)) < 0.8).astype(np.float32)
    vals = rng.standard_normal((n, k, 3, 3)).astype(np.float32)
    sk = rng.integers(0, k, size=n).astype(np.int32)
    vals, mask, sk, nbr = (torch.from_numpy(a).cuda() for a in (
        vals, mask, sk, nbr.astype(np.int32)))
    return vals, mask, ek.transpose_table(nbr), sk


def _spmv_t_kernels(fn):
    """The ell_spmv_t kernels fn() launches, traced again (up to twice)
    while none shows: a short trace can lose its events."""
    for _ in range(3):
        names = [s for s in _kernels_per_call(fn)[1]
                 if "ell_spmv_t_kernel" in s]
        if names:
            return names
    return []


# every (form, lanes, K constant or not) ell_spmv_t's plan picks on a card
# of 132 SMs, each reached by its shape: the hex meshes' K 27 (staged, 32
# lanes below 1,049 columns, 16 from there), the cloth's K 7 (lanes form, 8
# lanes below 8,417 columns, 4 from there), the other widths (K a runtime
# value) on P = lanes(K) lanes and on P / 2
_SPMV_T_CASES = {
    "hex 225 K 27": lambda u, u2: _hex_spmv_t_system(u, 0),
    "hex 325 K 27": lambda u, u2: _hex_spmv_t_system(u2, 1),
    "hex 2025 K 27": lambda u, u2: _hex_spmv_t_system(u2, 0),
    "cloth 1156 K 7": lambda u, u2: _cloth_spmv_t_system(33),
    "cloth 16641 K 7": lambda u, u2: _cloth_spmv_t_system(128),
    **{f"circulant {n} K {k}": (lambda u, u2, n=n, k=k:
                                _circulant_spmv_t_system(n, k))
       for n, k in ((300, 1), (300, 2), (34000, 2), (300, 3), (17000, 3),
                    (500, 5), (9000, 5), (300, 12), (5000, 12), (500, 20),
                    (2000, 20), (500, 27), (2000, 27))},
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_SPMV_T_CASES))
@pytest.mark.parametrize("skip", [False, True])
def test_spmv_t_plans_match_plain(uscene, uscene2k, case, skip):
    """ell_spmv_t at a shape whose plan picks each of its launches, with
    and without a slot of each row left out (alpha -1): within 1e-5 of
    max |ref| of spmv_t_plain, two runs bit-equal, the kernel of the
    mirror's form and lanes launched (K a template constant at the hex
    meshes' 27 and the cloth's 7) and each launch counted by (rows, form)."""
    vals, mask, tt, sk = _SPMV_T_CASES[case](uscene, uscene2k)
    n, k = vals.shape[:2]
    kt = int(tt.shape[1])
    assert kt == k
    sk, alpha = (sk, -1.0) if skip else (None, 1.0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    form, lanes = ek.spmv_t_plan(n, kt, sms)
    p = ek.lanes(kt)
    kc = k if (p, k) in ((32, 27), (8, 7)) else 0
    g = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (n, 3)).astype(np.float32)).cuda()
    ek.reset_launches()
    got, again = (ek.spmv_t(vals, mask, tt, g, sk, alpha) for _ in range(2))
    ref = ek.spmv_t_plain(vals, mask, tt, g, sk, alpha)
    torch.cuda.synchronize()
    assert ek.spmv_t_launches == {(n, ek.SPMV_T_FORMS[form]): 2}
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    names = _spmv_t_kernels(lambda: ek.spmv_t(vals, mask, tt, g, sk, alpha))
    want = f"ell_spmv_t_kernel<{form}, {lanes}, {p // lanes}, {kc}>"
    assert names and all(want in s for s in names), (want, names)


@pytest.mark.cuda
@pytest.mark.parametrize("skip", [False, True])
def test_spmv_t_wide_column_matches_plain(skip):
    """A transpose table wider than a warp (column 0: every row's first
    slot, 40 entries; the others -1 padded): the plan's strided form within
    1e-5 of max |ref| of spmv_t_plain, two runs bit-equal, counted as
    such."""
    _need_cuda()
    n, k = 40, 4
    rng = np.random.default_rng(3)
    nbr = rng.integers(1, n, size=(n, k)).astype(np.int32)
    nbr[:, 0] = 0
    mask = (rng.random((n, k)) < 0.8).astype(np.float32)
    vals = rng.standard_normal((n, k, 3, 3)).astype(np.float32)
    sk = rng.integers(0, k, size=n).astype(np.int32)
    g = rng.standard_normal((n, 3)).astype(np.float32)
    vals, mask, g, sk, nbr = (torch.from_numpy(a).cuda()
                              for a in (vals, mask, g, sk, nbr))
    tt = ek.transpose_table(nbr)
    assert tt.shape == (n, n) and int((tt < 0).sum()) > 0
    args = (vals, mask, tt, g) + ((sk, -1.0) if skip else ())
    ek.reset_launches()
    got, again = ek.spmv_t(*args), ek.spmv_t(*args)
    ref = ek.spmv_t_plain(*args)
    torch.cuda.synchronize()
    assert ek.spmv_t_launches == {(n, "strided"): 2}
    assert torch.equal(got, again)
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    names = _spmv_t_kernels(lambda: ek.spmv_t(*args))
    assert names and all("ell_spmv_t_kernel<2, 32, 1, 0>" in s
                         for s in names), names


# (N, Kt) of ell_spmv_t's shapes: the cloth's frame Hessians, the 2k
# beam's two levels, the 19k, 21k and 74k fine Hessians, the 21k exp2
# coarse matrix, a table wider than a warp
_SPMV_T_SHAPES = ((4225, 7), (16641, 7), (2025, 27), (325, 27), (18785, 27),
                  (21097, 27), (2997, 27), (74273, 27), (40, 40))


@pytest.mark.cuda
def test_spmv_t_plan_mirror_equals_ell_spmv_t_plan():
    """ell_spmv_t_plan on this card picks what its mirror spmv_t_plan picks
    at every shape the paths' gradients give ell_spmv_t."""
    _need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _cuda.load()
    for n, kt in _SPMV_T_SHAPES:
        plan = (ctypes.c_int * 2)()
        assert lib.ell_spmv_t_plan(n, kt, plan) == 0
        assert (plan[0], plan[1]) == ek.spmv_t_plan(n, kt, sms), (n, kt)


@pytest.mark.cuda
def test_exp2_gradient_on_the_card(uscene):
    """exp2's loss gradient on the card goes through the backward kernels,
    every launch asked for, and equals the CPU's within 1e-3 of max |g|
    (torch's own gather backward adds in another order on the card)."""
    cpu = tscene.Scene(uscene.mesh, solver=uscene.solver, device="cpu")
    pins = np.nonzero(cpu.params["levels"][0]["pin_mask"].numpy() > 0)[0]
    x = cpu.x0.clone()
    x[int(pins[0])] += 1e-3
    # launches (jacobi_bwd, outer, spmv_t): one jacobi_bwd an iteration
    # writes the values' gradient too (no outer); the one iteration from
    # the zero start sends no gradient further (no spmv_t)
    for cfg, want in (
            (TrainInterpConfig(mode="P", loss="l2", unroll=2), (2, 0, 0)),
            (TrainInterpConfig(mode="p_hat", loss="l2"), (1, 0, 0))):
        ek.reset_launches()
        for name in ell.cuda_calls:
            ell.cuda_calls[name] = 0
        tr = tti.InterpTrainer(uscene, cfg)
        total, _, _, g = tr.loss_and_grad(tr.w, x.cuda())
        torch.cuda.synchronize()
        assert ek.launches == ell.cuda_calls
        assert (ek.launches["jacobi_bwd"], ek.launches["outer"],
                ek.launches["spmv_t"]) == want
        trc = tti.InterpTrainer(cpu, cfg)
        total_c, _, _, gc = trc.loss_and_grad(trc.w, x)
        assert float(total) == pytest.approx(float(total_c), rel=1e-3)
        assert float((g.cpu() - gc).abs().max()) <= 1e-3 * float(
            gc.abs().max())


def _level_systems(uscene):
    """(op, values, b, x0) on every level of the scene's Galerkin chain."""
    rng = np.random.default_rng(13)
    x = uscene.x0 + torch.from_numpy(0.01 * rng.standard_normal(
        tuple(uscene.x0.shape)).astype(np.float32)).cuda()
    chain = tqs.galerkin_chain(uscene, uscene.params,
                               tqs.assemble_fine(uscene, uscene.params, x))
    for li, vals in enumerate(chain):
        n = vals.shape[0]
        b = torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).cuda()
        x0 = torch.from_numpy(0.1 * rng.standard_normal((n, 3)).astype(
            np.float32)).cuda()
        yield uscene.make_op(li), vals, b, x0


@pytest.mark.cuda
def test_gs_kernel_matches_plain(uscene):
    """The fused Gauss-Seidel kernel on every level, 1 and 3 iterations,
    from zero and from x0: max|d| <= 1e-5 max|x| against its one-pass plain
    version and against the two-stage smoother (a fixed butterfly sums a
    row's products, torch its own order); two runs bit-identical; x0 is not
    modified; one launch count per call."""
    for op, vals, b, x0 in _level_systems(uscene):
        args = (vals, op.nbr, op.mask, op.diag_slot, op.color_offsets, b)
        for iters in (1, 3):
            for start in (None, x0):
                keep = None if start is None else start.clone()
                before = ek.launches["gs"]
                got = ek.gs(*args, start, iters)
                again = ek.gs(*args, start, iters)
                torch.cuda.synchronize()
                assert ek.launches["gs"] == before + 2
                assert torch.equal(got, again)
                if start is not None:
                    assert torch.equal(start, keep)
                for ref in (ek.gs_plain(*args, start, iters),
                            tsm.gauss_seidel_plain(op, vals, b, iters,
                                                   x0=start)):
                    assert float((got - ref).abs().max()) \
                        <= 1e-5 * float(ref.abs().max())
        # the smoother entry point goes through the kernel
        calls, before = ell.cuda_calls["gs"], ek.launches["gs"]
        got = tsm.gauss_seidel(op, vals, b, 2)
        assert ell.cuda_calls["gs"] == calls + 1
        assert ek.launches["gs"] == before + 1
        assert torch.equal(got, ek.gs(*args, None, 2))


@pytest.fixture(scope="module")
def uscene2k():
    _need_cuda()
    return tscene.Scene(meshlib.beam(8, 8, 24, dx=0.05),
                        solver=SolverConfig(n_levels=2), device="cuda")


@pytest.mark.cuda
def test_gs_every_form_matches_plain(uscene2k, monkeypatch):
    """Every ell_gs form, forced through the plan cache (the coop form; each
    staged form at the blocks the plan's model likes best for it), on both
    levels of the 2k beam: 1 and 3 iterations from zero and from x0 within
    1e-5 max|x| of the plain version, two runs bit-identical, every form
    bit-equal to every other (one pass order, one sum order)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for op, vals, b, x0 in _level_systems(uscene2k):
        n, k = vals.shape[0], vals.shape[1]
        offs = op.color_offsets
        args = (vals, op.nbr, op.mask, op.diag_slot, offs, b)
        for iters in (1, 3):
            best = {}
            for cost, form, blocks in ek.gs_candidates(n, k, offs, sms,
                                                       iters):
                if form not in best or cost < best[form][0]:
                    best[form] = (cost, blocks)
            assert set(best) == set(range(len(ek.GS_FORMS)))
            key = (str(b.device), n, k, tuple(offs), iters)
            for start in (None, x0):
                ref = ek.gs_plain(*args, start, iters)
                outs = []
                for form, (_, blocks) in sorted(best.items()):
                    monkeypatch.setitem(ek._gs_plans, key, (form, blocks))
                    got = ek.gs(*args, start, iters)
                    again = ek.gs(*args, start, iters)
                    torch.cuda.synchronize()
                    assert torch.equal(got, again), ek.GS_FORMS[form]
                    assert float((got - ref).abs().max()) \
                        <= 1e-5 * float(ref.abs().max()), ek.GS_FORMS[form]
                    outs.append(got)
                assert all(torch.equal(outs[0], o) for o in outs[1:])


# (N, K, color offsets) of the main paths' multigrid levels (the 8x8x24,
# 16x16x64 and 16x16x256 beams at dx 0.05; tests/test_torch_gs_plan.py)
_PATH_LEVELS = {
    "2k fine": (2025, 27, (0, 325, 625, 885, 1125, 1385, 1625, 1833, 2025)),
    "2k level 1": (325, 27, (0, 63, 117, 159, 195, 237, 273, 301, 325)),
    "19k fine": (18785, 27, (0, 2673, 5265, 7641, 9945, 12321, 14625,
                             16737, 18785)),
    "19k level 1": (2673, 27, (0, 425, 825, 1165, 1485, 1825, 2145, 2417,
                               2673)),
    "19k level 2": (425, 27, (0, 81, 153, 207, 255, 309, 357, 393, 425)),
    "74k fine": (74273, 27, (0, 10449, 20817, 30105, 39321, 48609, 57825,
                             66081, 74273)),
    "74k level 1": (10449, 27, (0, 1625, 3225, 4525, 5805, 7105, 8385, 9425,
                                10449)),
    "74k level 2": (1625, 27, (0, 297, 585, 783, 975, 1173, 1365, 1497,
                               1625)),
}


@pytest.mark.cuda
def test_gs_plan_mirror_equals_ell_gs_plan():
    """ell_gs_plan on this card picks what its mirror gs_plan picks at
    every level of the main paths, for both calls (1 and 3 iterations):
    every cluster the mirror counts on can be placed."""
    _need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _cuda.load()
    for label, (n, k, offs) in _PATH_LEVELS.items():
        for iters in (1, 3):
            plan = (ctypes.c_int * 3)()
            assert lib.ell_gs_plan(n, k, (ctypes.c_int * len(offs))(*offs),
                                   len(offs) - 1, iters, plan) == 0
            assert (plan[0], plan[1]) == ek.gs_plan(n, k, offs, sms,
                                                    iters), (label, iters)


@pytest.mark.cuda
def test_jacobi_kernel_matches_plain(uscene):
    """The fused Jacobi kernel on every level, 1 to 3 iterations (odd and
    even: the result lies in either buffer), from zero and from x0:
    max|d| <= 1e-5 max|x| against the plain smoother; one launch per
    iteration, counted as such."""
    for op, vals, b, x0 in _level_systems(uscene):
        for iters in (1, 2, 3):
            for start in (None, x0):
                before = ek.launches["jacobi"]
                calls = ell.cuda_calls["jacobi"]
                got = tsm.jacobi(op, vals, b, iters, x0=start)
                torch.cuda.synchronize()
                assert ek.launches["jacobi"] == before + iters
                assert ell.cuda_calls["jacobi"] == calls + iters
                ref = tsm.jacobi_plain(op, vals, b, iters, x0=start)
                assert float((got - ref).abs().max()) \
                    <= 1e-5 * float(ref.abs().max())


def _with_nans(op, vals):
    """vals with a NaN at one live off-diagonal slot of one row and at one
    padded slot of another."""
    mask, ds = op.mask.cpu().numpy(), op.diag_slot.cpu().numpy()
    slots = np.arange(mask.shape[1])[None, :]
    live = np.argwhere((mask > 0) & (slots != ds[:, None]))
    padded = np.argwhere(mask == 0)
    r1, k1 = live[len(live) // 3]
    r2, k2 = next(p for p in padded if p[0] != r1)
    out = vals.clone()
    out[int(r1), int(k1), 2, 1] = float("nan")
    out[int(r2), int(k2), 1, 1] = float("nan")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("values", ["finite", "nan"])
def test_jacobi_forms_match_plain(uscene, values):
    """Each ell_jacobi form (the zero start, 1 iteration from x0 = None;
    from x, 1 iteration from x0) on every level against jacobi_plain:
    the same NaN rows (a NaN at a live and at a padded slot), elsewhere
    within 1e-5 of max |ref|, two runs bit-identical; launches counted by
    (rows, form), at the lanes ell_kernels.jacobi_lanes mirrors."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for op, vals, b, x0 in _level_systems(uscene):
        if values == "nan":
            vals = _with_nans(op, vals)
        n, k = vals.shape[:2]
        args = (vals, op.nbr, op.mask, op.diag_slot, b)
        for start, form in ((None, "zero start"), (x0, "from x")):
            ek.reset_launches()
            got, again = (ek.jacobi(*args, start, 1) for _ in range(2))
            torch.cuda.synchronize()
            assert ek.jacobi_launches == {(n, form): 2}
            lanes = ek.jacobi_lanes(n, sms)
            _, names = _kernels_per_call(lambda: ek.jacobi(*args, start, 1))
            jac = [name for name in names if "ell_jacobi_kernel" in name]
            want = f"ell_jacobi_kernel<{lanes}, {str(start is None).lower()}>"
            assert len(jac) == 1 and want in jac[0], names
            ref = ek.jacobi_plain(*args, start, 1)
            nan = torch.isnan(ref)
            assert torch.equal(torch.isnan(got), nan), form
            assert bool(nan.any()) == (values == "nan"), form
            assert torch.equal(got, again) or values == "nan", form
            assert torch.equal(got[~nan], again[~nan]), form
            scale = float(ref[~nan].abs().max())
            assert float((got - ref)[~nan].abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["no gv", "from x_t", "zero start"])
@pytest.mark.parametrize("accumulate", [False, True])
def test_jacobi_bwd_forms_match_plain(uscene, form, accumulate):
    """ell_jacobi_bwd in each form (no values' gradient; from x_t; the zero
    start) on every level against jacobi_bwd_plain, within 1e-5 of max
    |ref|, two runs bit-equal; the values' gradient also into a view that
    starts 4 bytes past 16-byte alignment (the span's single-float head and
    tail), bit-equal to the aligned one."""
    rng = np.random.default_rng(29)
    for op, vals, b, _ in _level_systems(uscene):
        n = vals.shape[0]
        g, xt = (torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).cuda() for _ in range(2))
        gv0 = torch.from_numpy(rng.standard_normal(tuple(vals.shape)).astype(
            np.float32)).cuda()
        gb0 = torch.from_numpy(rng.standard_normal((n, 3)).astype(
            np.float32)).cuda()
        start = None if form == "zero start" else xt

        def run(fn, shifted=False):
            gb = gb0.clone()
            gv = None
            if form != "no gv":
                store = torch.empty(gv0.numel() + 1, device=gv0.device)
                gv = (store[1:] if shifted else store[:-1]).view(gv0.shape)
                gv.copy_(gv0)
            lam = fn(vals, op.nbr, op.mask, op.diag_slot, b, start, g, gb, gv,
                     accumulate)
            return torch.cat([t.reshape(-1) for t in (lam, gb, gv)
                              if t is not None])
        got, again, shifted = run(ek.jacobi_bwd), run(ek.jacobi_bwd), run(
            ek.jacobi_bwd, True)
        ref = run(ek.jacobi_bwd_plain)
        torch.cuda.synchronize()
        assert torch.equal(got, again) and torch.equal(got, shifted)
        assert float((got - ref).abs().max()) <= 1e-5 * float(
            ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("plan_mode", [0, 1, 2])
def test_fused_newton_kernel_matches_plain(scene, plan_mode, monkeypatch):
    """fused_newton on the card == its plain version with equal k, in the
    tiling the plan picks and in each of its two modes (halo: a block
    computes every cell touching its vertices; exchange: each cell once):
    f within 1e-4 of max|f|, dx within 1e-3 of max|dx|, fn within 1e-3 of
    max|f|; two runs bit-identical."""
    X, Y, Z = scene.shape
    for pcg in (False, True):
        monkeypatch.setitem(
            lk._newton_plans, (str(scene.x0.device), X, Y, Z, pcg),
            lk.ask_newton_plan(_cuda.load(), X, Y, Z, scene.x0.device, pcg,
                               plan_mode))
    rng = np.random.default_rng(17)
    inv_dt = 1.0 / 0.033
    mat = scene.material
    vm3 = scene.vert_mask[..., None]

    def noise(scale):
        return scale * torch.from_numpy(rng.standard_normal(
            tuple(scene.x0.shape)).astype(np.float32)).cuda()

    x = scene.x0 + noise(0.01) * vm3
    x_tilde = scene.x0 + noise(0.005) * vm3
    ctrl = (mat.control_mag * scene.pin_mask + scene.mass * inv_dt * inv_dt
            + (1.0 - scene.vert_mask))
    rc = mat.control_mag * scene.pin_mask + scene.mass * inv_dt * inv_dt
    s_aff = (mat.control_mag * scene.pin_mask[..., None] * scene.pin_pos
             + (scene.mass * inv_dt * inv_dt)[..., None] * x_tilde)
    s_aff[..., 1] += scene.mass * mat.gravity
    s_cf = (s_aff - rc[..., None] * scene.x0).permute(3, 0, 1, 2).contiguous()
    u_cf = (x - scene.x0).permute(3, 0, 1, 2).contiguous()
    args = (u_cf, s_cf, scene.cell_mask, ctrl, rc, scene.vert_mask, DX,
            mat.lame_mu, mat.lame_la, 30, 1e-4)
    before = lk.launches["fused_newton"]
    dxk, fk, fnk, kk = lk.fused_newton(*args)
    dx2, f2, fn2, k2 = lk.fused_newton(*args)
    dxp, fp, fnp, kp = lk.fused_newton_plain(*args)
    torch.cuda.synchronize()
    assert lk.launches["fused_newton"] == before + 2
    assert torch.equal(dxk, dx2) and torch.equal(fk, f2)
    assert float(fnk) == float(fn2) and int(kk) == int(k2)
    assert int(kk) == int(kp) > 2
    fscale = float(fp.abs().max())
    assert float((fk - fp).abs().max()) <= 1e-4 * fscale
    assert float((dxk - dxp).abs().max()) <= 1e-3 * float(dxp.abs().max())
    assert abs(float(fnk) - float(fnp)) <= 1e-3 * fscale
    pargs = (u_cf, fp, scene.cell_mask, ctrl, scene.vert_mask, DX,
             mat.lame_mu, mat.lame_la, 30, 1e-4)
    dk, k1 = lk.fused_pcg(*pargs)
    dp, k0 = lk.fused_pcg_plain(*pargs)
    assert int(k1) == int(k0) > 2
    assert float((dk - dp).abs().max()) <= 1e-3 * float(dp.abs().max())


# lat_diag's and lat_diag_shift's launch forms: the plan's, one launch on
# the best halo tiling, the two passes
DIAG_FORMS = ("plan", "halo tiles", "two passes")


def _diag_form(monkeypatch, shape, device, shift, form):
    """Run lat_diag (shift: lat_diag_shift) on this lattice in `form`."""
    model = lk.DIAG_SHIFT_MODEL if shift else lk.DIAG_MODEL
    sms = lk._sms(device.index)
    plan = {"plan": lambda: lk.diag_plan(*shape, sms, model),
            "halo tiles": lambda: lk.best_force_tiling(*shape, sms, model),
            "two passes": lambda: lk.FORCE_TWO_PASS}[form]()
    monkeypatch.setitem(lk._diag_plans, (str(device), *shape, shift), plan)


@pytest.mark.cuda
def test_hvp_diag_kernels_at_mg_levels(scene, monkeypatch):
    """lat_hvp and lat_diag on every level of a 3-level hierarchy (5x5x9,
    3x3x5 and 3x3x3 vertices, dx doubling from level to level) against
    their plain versions: max|d| <= 1e-4 max|ref| (another summation
    order), two runs bit-identical, one count a call; lat_diag under its
    plan, on halo tiles and in two passes, every form with the two passes'
    bits (the same sums in the same corner order); the channel-last and
    six-channel diagonal entries give the channel-first one's bits."""
    mg = tmg.LatticeMG(scene, n_levels=3, dt=None)
    mat = scene.material
    rng = np.random.default_rng(17)
    for li, lvl in enumerate(mg.levels):
        shape = (3,) + tuple(lvl.vert_mask.shape)
        u = torch.from_numpy(0.03 * rng.standard_normal(shape).astype(
            np.float32)).cuda() * lvl.vert_mask
        p = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).cuda()
        args = (lvl.cell_mask, lvl.dx, mat.lame_mu, mat.lame_la)
        before = dict(lk.launches)
        h = [lk.hvp_cf(u, p, *args) for _ in range(2)]
        h_ref = lk.hvp_cf_plain(u, p, *args)
        d_ref = lk.hess_diag_lattice_plain(u.permute(1, 2, 3, 0), *args)
        torch.cuda.synchronize()
        assert lk.launches["hvp"] == before["hvp"] + 2, li
        assert torch.equal(h[0], h[1]), li
        assert float((h[0] - h_ref).abs().max()) <= 1e-4 * float(
            h_ref.abs().max()), li
        outs = []
        for form in DIAG_FORMS:
            _diag_form(monkeypatch, shape[1:], u.device, False, form)
            before = lk.launches["diag"]
            d = [lk.hess_diag_cf(u, *args) for _ in range(2)]
            d_last = lk.hess_diag_lattice(
                u.permute(1, 2, 3, 0).contiguous(), *args)
            d6 = lk.hess_diag6_cf(u, *args)
            torch.cuda.synchronize()
            assert lk.launches["diag"] == before + 4, (li, form)
            assert torch.equal(d[0], d[1]), (li, form)
            assert torch.equal(d[0], d_last), (li, form)
            assert torch.equal(d6, lk.sym_channels(d[0])), (li, form)
            assert tuple(d[0].shape) == shape[1:] + (3, 3)
            assert float((d[0] - d_ref).abs().max()) <= 1e-4 * float(
                d_ref.abs().max()), (li, form)
            outs.append(d[0])
        assert all(torch.equal(o, outs[-1]) for o in outs), li


@pytest.mark.cuda
def test_hvp_diag_kept_scratch_same_bits(scene):
    """The wrappers' kept scratch and one-gather 3x3 assembly give the bits
    of a launch on freshly allocated buffers with the blocks stacked from
    the six channels, call after call."""
    u, p = _random_fields(scene, 21)
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    p_cf = p.permute(3, 0, 1, 2).contiguous()
    X, Y, Z = scene.shape
    cm = scene.cell_mask
    lib = _cuda.load()
    tail = lk._chain_tail(X, Y, Z, DX, MU, LA, u.device)
    plan = lk._hvp_plan(X, Y, Z, u.device)
    out = torch.empty_like(u_cf)
    cf = torch.empty(24 * cm.numel(), device="cuda")
    assert lib.lat_hvp(u_cf.data_ptr(), p_cf.data_ptr(), cm.data_ptr(), None,
                       None, out.data_ptr(), cf.data_ptr(), *plan[1:],
                       *tail) == 0
    d6 = torch.empty((6, X, Y, Z), device="cuda")
    cd = torch.empty(48 * cm.numel(), device="cuda")
    plan = lk._diag_plan(X, Y, Z, u.device, False)
    assert lib.lat_diag(u_cf.data_ptr(), cm.data_ptr(), None, None,
                        d6.data_ptr(), cd.data_ptr(), 0, 0, *plan[1:],
                        *tail) == 0
    c = d6.permute(1, 2, 3, 0)
    blocks = torch.stack([torch.stack([c[..., 0], c[..., 1], c[..., 2]], -1),
                          torch.stack([c[..., 1], c[..., 3], c[..., 4]], -1),
                          torch.stack([c[..., 2], c[..., 4], c[..., 5]], -1)],
                         -2)
    for _ in range(3):
        assert torch.equal(lk.hvp_cf(u_cf, p_cf, cm, DX, MU, LA), out)
        assert torch.equal(lk.hess_diag_cf(u_cf, cm, DX, MU, LA), blocks)
        assert torch.equal(lk.hess_diag_lattice(u, cm, DX, MU, LA), blocks)
        assert torch.equal(lk.hess_diag6_cf(u_cf, cm, DX, MU, LA), d6)


@pytest.mark.cuda
def test_hess_diag6_returns_a_new_tensor_each_call(scene, monkeypatch):
    """hess_diag6_cf (the slab paths' entry) returns a tensor of its own at
    every call, in each form: two calls at one shape share no storage (the
    four slabs of one shape would alias each other through a kept
    workspace), and hess_diag_cf's kept channels are not among them."""
    u, _ = _random_fields(scene, 23)
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    cm = scene.cell_mask
    for form in DIAG_FORMS:
        _diag_form(monkeypatch, scene.shape, u.device, False, form)
        a = lk.hess_diag6_cf(u_cf, cm, DX, MU, LA)
        b = lk.hess_diag6_cf(u_cf, cm, DX, MU, LA)
        blocks = lk.hess_diag_cf(u_cf, cm, DX, MU, LA)
        ptrs = {t.untyped_storage().data_ptr() for t in (a, b, blocks)}
        assert len(ptrs) == 3, form
        assert torch.equal(a, b) and torch.equal(lk.sym_blocks(a), blocks)
        a.zero_()
        assert torch.equal(lk.sym_blocks(b), blocks), form


_PLAIN = ("force_cf_plain", "hvp_cf_plain", "hess_diag_lattice_plain",
          "elastic_energy_lattice_plain", "fused_newton_plain",
          "cheby_smooth_cf_plain", "hess_diag_shift_cf_plain",
          "level_matvec_cf_plain", "power_lmax_cf_plain")


@pytest.mark.cuda
def test_quasistatic_mg_on_card_matches_cpu(scene, monkeypatch):
    """Three Newton iterations of quasistatic_to_tol_mg (2 levels,
    coarse_cg 8) on the card against the CPU run of the plain versions:
    equal Newton counts, ||f||_inf within 1e-3 relative + 5e-6, x within
    1e-4. The card's run launches lat_hvp and lat_diag_shift and calls no
    plain version."""
    cpu = tlat.LatticeScene(scene.mesh, device="cpu")
    mg_cpu = tmg.LatticeMG(cpu, n_levels=2, dt=None, coarse_cg=8)
    x_cpu, k_cpu, fn_cpu = tmg.quasistatic_to_tol_mg(
        cpu, mg_cpu, cpu.x0, tol=1e-12, max_newton=3)

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")
    for name in _PLAIN:
        monkeypatch.setattr(lk, name, refuse)
    lk.reset_launches()
    mg = tmg.LatticeMG(scene, n_levels=2, dt=None, coarse_cg=8)
    x, k, fn = tmg.quasistatic_to_tol_mg(scene, mg, scene.x0, tol=1e-12,
                                         max_newton=3)
    torch.cuda.synchronize()
    assert k == k_cpu == 3
    assert abs(fn - fn_cpu) <= 1e-3 * fn_cpu + 5e-6
    assert float((x.cpu() - x_cpu).abs().max()) <= 1e-4
    assert lk.launches["hvp"] > 0 and lk.launches["diag_shift"] > 0
    assert lk.launches["cheby"] > 0
    assert lk.launches["fused_newton"] == 0


@pytest.fixture(scope="module")
def mg19():
    """The 3-level hierarchy of the 19k beam (16x16x64 cells at dx 0.05:
    17x17x65, 9x9x33 and 5x5x17 vertices) on the card, quasi-static."""
    _need_cuda()
    sc = tlat.LatticeScene(meshlib.beam(16, 16, 64, dx=0.05), device="cuda")
    return tmg.LatticeMG(sc, n_levels=3, dt=None)


def _level_inputs(lvl, seed):
    """A seeded perturbed displacement, a right-hand side and a start, all
    (3, X, Y, Z) on the card, and the level's ctrl with an inertia term."""
    rng = np.random.default_rng(seed)
    shape = (3,) + tuple(lvl.vert_mask.shape)

    def field(scale):
        return torch.from_numpy((scale * rng.standard_normal(shape)).astype(
            np.float32)).cuda() * lvl.vert_mask
    return field(0.03), field(1.0), field(0.1), lvl.ctrl + lvl.mass * 900.0


@pytest.mark.cuda
def test_cheby_and_diag_shift_at_mg_levels(mg19, monkeypatch):
    """lat_cheby (pre-smooth from zero with its residual, post-smooth from
    a start, 12 coarse sweeps) and lat_diag_shift (under its plan, on halo
    tiles and in two passes) on every level shape of the 19k hierarchy
    against their plain versions: max|d| <= 1e-4 max|ref| (another
    summation order, f32 roundoff through the recurrences); two runs
    bit-identical; one count a call; the forms' bits equal (one order of
    the same sums). The projected blocks are held to the plain chain
    outside the blocks where a Jacobi rotation of either chain meets an
    exact tie (ell.jacobi_ties: there sign(0) = 0 skips the rotation and an
    ulp of input moves the block by up to |apq|); their projection is
    ell.spd_project of the kernel's own shifted blocks everywhere (1e-6)."""
    mat = mg19.scene.material
    mu, la = mat.lame_mu, mat.lame_la
    for li, lvl in enumerate(mg19.levels):
        u, b, x0, ctrl = _level_inputs(lvl, 40 + li)
        args = (lvl.cell_mask, ctrl, lvl.vert_mask, lvl.dx, mu, la)
        ref_raw = lk.hess_diag_shift_cf_plain(u, *args, False)
        ref = lk.hess_diag_shift_cf_plain(u, *args, True)
        outs = []
        for form in DIAG_FORMS:
            _diag_form(monkeypatch, tuple(lvl.vert_mask.shape), u.device,
                       True, form)
            before = lk.launches["diag_shift"]
            raw = [lk.hess_diag_shift_cf(u, *args, False) for _ in range(2)]
            d = [lk.hess_diag_shift_cf(u, *args, True) for _ in range(2)]
            proj = lk.sym_channels(ell.spd_project(
                lk.sym_blocks(raw[0]), eps=1e-6, rel_floor=1e-3))
            tie = ell.jacobi_ties(lk.sym_blocks(raw[0])) | ell.jacobi_ties(
                lk.shifted_diag_blocks_plain(u, *args))
            torch.cuda.synchronize()
            assert lk.launches["diag_shift"] == before + 4
            assert torch.equal(raw[0], raw[1]), (li, form)
            assert torch.equal(d[0], d[1]), (li, form)
            assert float((raw[0] - ref_raw).abs().max()) <= 1e-4 * float(
                ref_raw.abs().max()), (li, form)
            off = (d[0] - ref).abs().amax(0)[~tie]
            assert float(off.max()) <= 1e-4 * float(ref.abs().max()), (
                li, form)
            assert float((d[0] - proj).abs().max()) <= 1e-6 * float(
                proj.abs().max()), (li, form)
            outs.append(d[0])
        assert all(torch.equal(o, outs[-1]) for o in outs), li
        d6 = outs[0]
        cases = {"pre": (None, 2, True), "post": (x0, 2, False),
                 "coarse": (None, 12, False)}
        for name, (x, sweeps, residual) in cases.items():
            call = (u, b, x, d6, ctrl, lvl.vert_mask, lvl.cell_mask, lvl.dx,
                    mu, la, lk.cheby_coeffs(np.float32(2.5), sweeps),
                    residual)
            before = lk.launches["cheby"]
            got = [lk.cheby_smooth_cf(*call) for _ in range(2)]
            ref = lk.cheby_smooth_cf_plain(*call)
            torch.cuda.synchronize()
            assert lk.launches["cheby"] == before + 2
            pairs = zip(got[0], got[1], ref) if residual else [
                (got[0], got[1], ref)]
            for a, again, r in pairs:
                assert torch.equal(a, again), (li, name)
                assert float((a - r).abs().max()) <= 1e-4 * float(
                    r.abs().max()), (li, name)


@pytest.mark.cuda
def test_diag_shift_projection_is_spd_project(mg19, monkeypatch):
    """At rest most blocks of the square beam have xx == yy exactly and
    xy != 0 (in the kernel's own sums too): the fused projection, under
    lat_diag_shift's plan, on halo tiles and in two passes, against
    ell.spd_project of the kernel's unprojected, shifted blocks on the card,
    to 1e-6 of max|ref| (the kernel repeats its float32 operations, each
    rounded alone: a copysign where torch.sign(0) = 0 would differ by
    ~1e-2 there)."""
    mat = mg19.scene.material
    for li, lvl in enumerate(mg19.levels):
        u = torch.zeros((3,) + tuple(lvl.vert_mask.shape), device="cuda")
        args = (lvl.cell_mask, lvl.ctrl, lvl.vert_mask, lvl.dx, mat.lame_mu,
                mat.lame_la)
        for form in DIAG_FORMS:
            _diag_form(monkeypatch, tuple(lvl.vert_mask.shape), u.device,
                       True, form)
            raw = lk.sym_blocks(lk.hess_diag_shift_cf(u, *args, False))
            a = raw.reshape(-1, 3, 3)
            assert int(((a[:, 0, 0] == a[:, 1, 1])
                        & (a[:, 0, 1].abs() > 1e-3)).sum()) > 0, (li, form)
            ref = lk.sym_channels(ell.spd_project(raw, eps=1e-6,
                                                  rel_floor=1e-3))
            got = lk.hess_diag_shift_cf(u, *args, True)
            assert float((got - ref).abs().max()) <= 1e-6 * float(
                ref.abs().max()), (li, form)


@pytest.mark.cuda
def test_power_and_level_hvp_at_mg_levels(mg19):
    """On every level shape of the 19k hierarchy, lat_hvp under its plan
    (one launch on halo tiles, or the two passes) as hvp_cf and as
    level_matvec_cf (the shift and mask in its vertex pass), and lat_power,
    against their plain versions: the products within 1e-4 of max|ref|
    (another summation order), the bound within 1e-4 relative (its dots
    summed as per-block partials); two runs bit-identical; one count a
    call."""
    mat = mg19.scene.material
    mu, la = mat.lame_mu, mat.lame_la
    for li, lvl in enumerate(mg19.levels):
        u, p, _, ctrl = _level_inputs(lvl, 60 + li)
        vm = lvl.vert_mask
        args = (lvl.cell_mask, lvl.dx, mu, la)
        margs = (u, p, lvl.cell_mask, ctrl, vm, lvl.dx, mu, la)
        d6 = lk.hess_diag_shift_cf(u, lvl.cell_mask, ctrl, vm, lvl.dx, mu, la)
        pargs = (u, d6, ctrl, vm, *args)
        before = dict(lk.launches)
        h = [lk.hvp_cf(u, p, *args) for _ in range(2)]
        m = [lk.level_matvec_cf(*margs) for _ in range(2)]
        out = torch.zeros(4, device="cuda")
        lam = [lk.power_lmax_cf(*pargs, out=out, slot=2).clone()
               for _ in range(2)]
        refs = (lk.hvp_cf_plain(u, p, *args),
                lk.level_matvec_cf_plain(*margs),
                lk.power_lmax_cf_plain(*pargs))
        torch.cuda.synchronize()
        assert lk.launches["hvp"] == before["hvp"] + 4, li
        assert lk.launches["power"] == before["power"] + 2, li
        assert float(out[0]) == float(out[1]) == float(out[3]) == 0.0
        for got, ref in zip((h, m, lam), refs):
            assert torch.equal(got[0], got[1]), li
            assert float((got[0] - ref).abs().max()) <= 1e-4 * float(
                ref.abs().max()), li


@pytest.mark.cuda
def test_mg_solve_launches_level_kernels(mg19, monkeypatch):
    """quasistatic_to_tol_mg (3 levels, Chebyshev coarse sweeps) on the
    card with the plain versions refused: every V-cycle launches lat_cheby
    2 * 2 + 1 times, every linearization lat_diag_shift once a level, the
    solve's first linearization lat_power once a level, every outer PCG
    matvec lat_hvp once, and the solve reaches 1e-4."""
    sc = mg19.scene

    def refuse(*args, **kwargs):
        raise AssertionError("a plain version ran on the card's path")
    for name in _PLAIN:
        monkeypatch.setattr(lk, name, refuse)
    vcycles = [0]
    plain_vcycle = mg19.vcycle

    def counted(ops, b, level=0):
        vcycles[0] += level == 0
        return plain_vcycle(ops, b, level)
    monkeypatch.setattr(mg19, "vcycle", counted)
    lk.reset_launches()
    _, k, fn, cg = tmg.quasistatic_to_tol_mg(sc, mg19, sc.x0, tol=1e-4,
                                             max_newton=20, return_cg=True)
    torch.cuda.synchronize()
    assert fn <= 1e-4 and k > 0
    assert lk.launches["cheby"] == 5 * vcycles[0] > 0
    assert lk.launches["diag_shift"] == 3 * k
    assert lk.launches["power"] == 3
    assert lk.launches["hvp"] == cg > 0
    assert lk.launches["diag"] == 0


@pytest.mark.cuda
def test_cheby_rejects_too_many_sweeps(scene):
    """lat_cheby carries its coefficients in its argument struct: a degree
    above lk.CHEBY_MAX_SWEEPS raises, it does not fall back."""
    u = torch.zeros((3,) + tuple(scene.vert_mask.shape), device="cuda")
    d6 = torch.zeros((6,) + tuple(scene.vert_mask.shape), device="cuda")
    d6[[0, 3, 5]] = 1.0
    coeffs = lk.cheby_coeffs(np.float32(2.0), lk.CHEBY_MAX_SWEEPS + 1)
    with pytest.raises(ValueError, match="sweeps"):
        lk.cheby_smooth_cf(u, u, None, d6, scene.vert_mask, scene.vert_mask,
                           scene.cell_mask, DX, MU, LA, coeffs)


@pytest.fixture(scope="module")
def mg2k():
    """The 3-level hierarchy of the 2k beam (8x8x24 cells at dx 0.05:
    9x9x25, 5x5x13 and 3x3x7 vertices) on the card, quasi-static."""
    _need_cuda()
    sc = tlat.LatticeScene(meshlib.beam(8, 8, 24, dx=0.05), device="cuda")
    return tmg.LatticeMG(sc, n_levels=3, dt=None)


# the level shapes of LatticeMG(n_levels=3) on the 2k, 19k and 74k beams
_MG_LEVELS = ((9, 9, 25), (5, 5, 13), (3, 3, 7), (17, 17, 65), (9, 9, 33),
              (5, 5, 17), (17, 17, 257), (9, 9, 129), (5, 5, 65))
# lat_cheby's calls (sweeps, warm, residual) and lat_power's
_LEVEL_CALLS = {"pre": (lk.CHEBY, 2, False, True),
                "post": (lk.CHEBY, 2, True, False),
                "coarse": (lk.CHEBY, 12, False, False),
                "power": (lk.POWER, 6, False, False)}


def _flat(out):
    return torch.cat([t.reshape(-1) for t in out]) if isinstance(
        out, tuple) else out.reshape(-1)


@pytest.mark.cuda
def test_level_kernels_every_form(mg2k, mg19, monkeypatch):
    """lat_cheby's three calls (with the level's Chebyshev bound, the power
    iteration's times 1.2) and lat_power in every form the plan weighs
    (each at the tiles its model likes best, forced through the plan
    cache) at the 2k beam's three levels and the 19k fine level (tiles
    only: 16 blocks do not hold it): within 1e-4 max|ref| of the plain
    version (another summation order), two runs bit-identical, every form
    bit-equal to every other (one arithmetic; the dots summed by plane in
    one order), one count a call under its form."""
    mat = mg2k.scene.material
    mu, la = mat.lame_mu, mat.lame_la
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for li, lvl in enumerate(list(mg2k.levels) + [mg19.levels[0]]):
        u, b, x0, ctrl = _level_inputs(lvl, 80 + li)
        shape = tuple(lvl.vert_mask.shape)
        vm, cm = lvl.vert_mask, lvl.cell_mask
        d6 = lk.hess_diag_shift_cf(u, cm, ctrl, vm, lvl.dx, mu, la)
        pargs = (u, d6, ctrl, vm, cm, lvl.dx, mu, la)
        # the level's Chebyshev bound as LatticeMG takes it
        lmax = np.float32(lk.power_lmax_cf_plain(*pargs).item()) \
            * np.float32(1.2)
        for name, (kernel, sweeps, warm, res) in _LEVEL_CALLS.items():
            if kernel == lk.POWER:
                def kern():
                    return lk.power_lmax_cf(*pargs)

                def plain():
                    return lk.power_lmax_cf_plain(*pargs)
            else:
                call = (u, b, x0 if warm else None, d6, ctrl, vm, cm, lvl.dx,
                        mu, la, lk.cheby_coeffs(lmax, sweeps), res)

                def kern(call=call):
                    return lk.cheby_smooth_cf(*call)

                def plain(call=call):
                    return lk.cheby_smooth_cf_plain(*call)
            ref = _flat(plain())
            best = {}
            for cost, form, tiles in lk.level_candidates(shape, sms, kernel,
                                                         sweeps, warm, res):
                if form not in best or cost < best[form][0]:
                    best[form] = (cost, tiles)
            key = (str(u.device), *shape, kernel, sweeps, warm, res)
            outs = []
            for form, (_, tiles) in sorted(best.items()):
                monkeypatch.setitem(lk._level_plans, key, (form,) + tiles)
                count = ("cheby" if kernel == lk.CHEBY else "power", shape,
                         lk.LEVEL_FORMS[form])
                before = lk.level_launches.get(count, 0)
                got, again = _flat(kern()), _flat(kern())
                torch.cuda.synchronize()
                what = (shape, name, lk.LEVEL_FORMS[form], tiles)
                assert lk.level_launches[count] == before + 2, what
                assert torch.equal(got, again), what
                assert float((got - ref).abs().max()) <= 1e-4 * float(
                    ref.abs().max()), what
                outs.append(got)
            assert all(torch.equal(o, outs[0]) for o in outs[1:]), (shape,
                                                                   name)


@pytest.mark.cuda
def test_level_plan_mirror_equals_lat_level_plan():
    """lat_level_plan on this card picks what its mirror level_plan picks
    for every call at every level of the main paths' hierarchies: every
    cluster the mirror counts on can be placed."""
    _need_cuda()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lib = _cuda.load()
    for shape in _MG_LEVELS:
        for name, (kernel, sweeps, warm, res) in _LEVEL_CALLS.items():
            plan = (ctypes.c_int * 5)()
            assert lib.lat_level_plan(*shape, kernel, sweeps, int(warm),
                                      int(res), plan) == 0
            assert tuple(plan[:4]) == lk.level_plan(shape, sms, kernel,
                                                    sweeps, warm, res), (
                shape, name)


@pytest.mark.cuda
def test_cloth_frames_on_card_match_cpu():
    """Cloth frames on the card: the reference 5-CG frame and step_to_tol
    (tol 2.5e-4, pins [0, res]) on the 16x16 grid launch the SpMV kernel
    once per CG / PCG matvec, repeat their bits, and match the CPU run with
    the plain versions: equal Newton counts, x within 1e-4."""
    _need_cuda()
    cfg, pins = ClothConfig(res_x=16, res_y=16), [0, 16]
    gpu = tcloth.ClothScene(cfg, pins=pins, device="cuda")
    cpu = tcloth.ClothScene(cfg, pins=pins, device="cpu")
    sg = tcloth.step(gpu, gpu.params, tcloth.init_state(gpu))
    sc = tcloth.step(cpu, cpu.params, tcloth.init_state(cpu))
    assert float((sg.x.cpu() - sc.x).abs().max()) <= 1e-5

    def run(scene):
        st, ks = tcloth.init_state(scene), []
        for _ in range(4):
            st, k, fn = tcloth.step_to_tol(scene, scene.params, st,
                                           tol=2.5e-4)
            assert fn <= 2.5e-4
            ks.append(k)
        return st, ks

    ek.reset_launches()
    ell.cuda_calls["spmv"] = 0
    st1, ks1 = run(gpu)
    torch.cuda.synchronize()
    assert ek.launches["spmv"] == ell.cuda_calls["spmv"] > 0
    st2, ks2 = run(gpu)
    assert ks1 == ks2 and torch.equal(st1.x, st2.x)
    st3, ks3 = run(cpu)
    assert ks3 == ks1 and max(ks1) >= 1
    assert float((st1.x.cpu() - st3.x).abs().max()) <= 1e-4


_ENTRY_POINTS = {
    "Scene": lambda m, **kw: tscene.Scene(
        m, solver=SolverConfig(n_levels=2), **kw).x0,
    "LatticeScene": lambda m, **kw: tlat.LatticeScene(m, **kw).x0,
    "LatticeDynamicSim": lambda m, **kw: tlat.LatticeDynamicSim(
        m, **kw).state.x,
    # the hierarchy takes its scene's device
    "LatticeMG": lambda m, **kw: tmg.LatticeMG(
        tlat.LatticeScene(m, **kw), n_levels=2).x0_levels[0],
    "lattice.state_from_numpy": lambda m, **kw: tlat.state_from_numpy(
        *tlat.state_to_numpy(tlat.LatticeScene(m, device="cpu")
                             .init_state()), **kw).x,
    "dynamic.state_from_numpy": lambda m, **kw: tdyn.state_from_numpy(
        np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(4), np.zeros((4, 3)),
        **kw).x,
    # the cloth takes no mesh
    "ClothScene": lambda m, **kw: tcloth.ClothScene(
        ClothConfig(res_x=2, res_y=2), **kw).params["x0"],
    "ClothSim": lambda m, **kw: tcloth.ClothSim(
        ClothConfig(res_x=2, res_y=2), **kw).state.x,
    "cloth.state_from_numpy": lambda m, **kw: tcloth.state_from_numpy(
        np.zeros((4, 3)), np.zeros((4, 3)), np.zeros(4), np.zeros((4, 3)),
        **kw).x,
    # the trainers take their scene's device
    "InterpTrainer": lambda m, **kw: tti.InterpTrainer(tscene.Scene(
        m, solver=SolverConfig(n_levels=2), **kw)).w,
    "SolverNetTrainer": lambda m, **kw: tts.SolverNetTrainer(tscene.Scene(
        m, solver=SolverConfig(n_levels=2), **kw)).graph.table,
}


def _slab_setup(m, **kw):
    sc = tlat.LatticeScene(m, **kw)
    grid = tdist.make_device_mesh(2, dp=1, **kw)
    return sc, grid, tlh.LatticeSlabs(sc, 2, grid)


def _dist_op(build):
    def make(m, **kw):
        sc, grid, slabs = _slab_setup(m, **kw)
        xb = slabs.scatter(sc.x0)
        op = build(slabs, grid)
        return (op(xb, xb) if build is tlh.make_dist_hvp else op(xb))[0]
    return make


def _dist_step(m, **kw):
    sc, grid, slabs = _slab_setup(m, **kw)
    step, blockify = tlh.make_dist_step(slabs, grid)
    return blockify(sc.x0)[0]


def _dist_newton(m, **kw):
    sc = tscene.Scene(m, solver=SolverConfig(n_levels=1), **kw)
    grid = tdist.make_device_mesh(2, dp=1, **kw)
    part = thalo.partition_slabs(sc.hier.levels[0], 2)
    thalo.make_dist_newton_step(sc, part, grid)
    return thalo.slab_scatter(part, sc.x0, grid.line("sp"))[0]


def _stencil_values(m, **kw):
    # the values come from the host, as the hierarchy hands them over
    lvl = thl.build_level_topology(m.x, m.ijk, m.hexes, m.dx)
    vals = np.zeros((lvl.n_verts, lvl.K, 3, 3), np.float32)
    return tstencil.values_to_lattice(vals, lvl.nbr, lvl.nbr_mask, lvl,
                                      tstencil.build_lattice_map(lvl), **kw)


def _batched(m, **kw):
    sc = tscene.Scene(m, solver=SolverConfig(n_levels=2), **kw)
    grid = tdist.make_device_mesh(2, **kw)
    return tdist.make_batched_step(sc, grid, 2)[2][0].x


_ENTRY_POINTS.update({
    # a grid's device is its first entry
    "make_device_mesh": lambda m, **kw: tdist.make_device_mesh(2, **kw),
    "DistLatticeMG": lambda m, **kw: tmgd.DistLatticeMG(
        tlat.LatticeScene(m, **kw), tdist.make_device_mesh(2, dp=1, **kw),
        n_levels=2).x0_levels[0],
    "make_dist_mg_step": lambda m, **kw: tmgd.make_dist_mg_step(
        tlat.LatticeScene(m, **kw), tdist.make_device_mesh(2, dp=1, **kw),
        n_levels=2)[0].mg.x0_levels[0],
    "make_dist_mg_quasistatic": lambda m, **kw: tmgd.make_dist_mg_quasistatic(
        tlat.LatticeScene(m, **kw), tdist.make_device_mesh(2, dp=1, **kw),
        n_levels=2)[0].mg.x0_levels[0],
    "make_dist_force": _dist_op(tlh.make_dist_force),
    "make_dist_hvp": _dist_op(tlh.make_dist_hvp),
    "make_dist_diag": _dist_op(tlh.make_dist_diag),
    "make_dist_step": _dist_step,
    "make_dist_newton_step": _dist_newton,
    "make_batched_step": _batched,
    "stencil.values_to_lattice": _stencil_values,
})


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


@pytest.mark.cuda
@pytest.mark.parametrize("n_slabs", [2, 4])
def test_slab_operators_match_whole_lattice_kernels(n_slabs):
    """lat_force, lat_hvp and lat_diag on z-slabs of the 4x4x33 beam (slabs
    sharing the card), exchanged and folded, against the same kernels on the
    whole lattice: max |d| <= 1e-5 max |ref| (the fold sums boundary planes
    in another order), and every slab a launch."""
    _need_cuda()
    sc = tlat.LatticeScene(meshlib.beam(4, 4, 33, dx=DX), device="cuda")
    grid = tdist.make_device_mesh(n_slabs, dp=1)
    assert grid.shared or torch.cuda.device_count() >= n_slabs
    slabs = tlh.LatticeSlabs(sc, n_slabs, grid)
    u, p = _random_fields(sc, 11)
    x = sc.x0 + u
    xb, pb = slabs.scatter(x), slabs.scatter(p)
    lk.reset_launches()
    got = {
        "force": slabs.gather(tlh.make_dist_force(slabs, grid, mu=MU,
                                                  la=LA)(xb)),
        "hvp": slabs.gather(tlh.make_dist_hvp(slabs, grid, mu=MU,
                                              la=LA)(xb, pb)),
        "diag": lk.sym_blocks(slabs.gather(tlh.make_dist_diag(
            slabs, grid, mu=MU, la=LA)(xb)).permute(3, 0, 1, 2)),
    }
    torch.cuda.synchronize()
    assert lk.launches["force"] == lk.launches["hvp"] == n_slabs
    assert lk.launches["diag"] == n_slabs
    u_cf = (x - sc.x0).permute(3, 0, 1, 2).contiguous()
    p_cf = p.permute(3, 0, 1, 2).contiguous()
    ref = {
        "force": lk.force_cf(u_cf, sc.cell_mask, DX, MU, LA)
        .permute(1, 2, 3, 0),
        "hvp": lk.hvp_cf(u_cf, p_cf, sc.cell_mask, DX, MU, LA)
        .permute(1, 2, 3, 0),
        "diag": lk.hess_diag_cf(u_cf, sc.cell_mask, DX, MU, LA),
    }
    for name in ref:
        err = float((got[name] - ref[name]).abs().max())
        assert err <= 1e-5 * float(ref[name].abs().max()), (name, err)


# -- the low-fill cover (ops/boxes.py) ---------------------------------------

_SHELLS = {"20": (20, 20, 20), "64": (64, 64, 64)}


@pytest.fixture(scope="module")
def shells():
    """{size: (covered scene, dense scene)} of the 2-cell shells on the
    card; the 20^3 cover is forced (box_threshold 2.0), the 64^3 one
    engages at the default."""
    _need_cuda()
    out = {}
    for name, cells in _SHELLS.items():
        m = meshlib.shell(*cells, thickness=2, dx=0.05)
        cov = tlat.LatticeScene(m, device="cuda",
                                box_threshold=2.0 if name == "20" else 0.5)
        assert cov.cover is not None, name
        out[name] = (cov, tlat.LatticeScene(m, device="cuda",
                                            use_boxes=False))
    return out


def _close(got, ref, rtol):
    return float((got - ref).abs().max()) <= rtol * float(ref.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("shell", sorted(_SHELLS))
@pytest.mark.parametrize("mode", ["tiles", "two_pass"])
def test_cover_force_matches_plain_and_dense(shells, shell, mode):
    """lat_force over the cover, on its active tiles and in the two passes
    over its real cells: within 1e-5 of max |ref| of the plain cover
    version, equal to the dense kernel in the same mode up to the sign of
    zero (the same cells, summed in the same corner order), the same bits
    on a rerun, counted as force_cover."""
    sc, dense = shells[shell]
    cov = sc.cover
    sms = lk._sms(sc.x0.device.index)
    u, _ = _random_fields(sc, 31)
    u_cf = u.permute(3, 0, 1, 2).contiguous()
    if mode == "two_pass":
        plan = lk.FORCE_TWO_PASS
    else:
        plan = lk.best_force_tiling(*sc.shape, sms, cover=cov)
    saved = dict(cov.plans)
    key = (str(u.device),) + tuple(sc.shape)
    saved_dense = lk._force_plans.get(key)
    cov.plans[("force", sms)] = plan
    lk._force_plans[key] = plan if mode == "two_pass" else lk.force_tiling(
        sc.shape, plan[1:4])
    try:
        before = dict(lk.launches)
        got = lk.force_cf(u_cf, sc.cell_mask, 0.05, MU, LA, cover=cov)
        again = lk.force_cf(u_cf, sc.cell_mask, 0.05, MU, LA, cover=cov)
        whole = lk.force_cf(u_cf, sc.cell_mask, 0.05, MU, LA)
        torch.cuda.synchronize()
    finally:
        cov.plans.clear()
        cov.plans.update(saved)
        if saved_dense is None:
            lk._force_plans.pop(key, None)
        else:
            lk._force_plans[key] = saved_dense
    assert lk.launches["force_cover"] == before["force_cover"] + 2
    assert lk.launches["force"] == before["force"] + 1
    ref = lk.force_cf_plain(u_cf, sc.cell_mask, 0.05, MU, LA, cover=cov)
    assert _close(got, ref, 1e-5)
    assert torch.equal(got, again)
    assert torch.equal(got, whole)            # == takes -0 as +0


@pytest.mark.cuda
@pytest.mark.parametrize("shell", sorted(_SHELLS))
def test_cover_energy_matches_plain_and_dense(shells, shell):
    """lat_energy over the real cells: within 1e-5 relative of the plain
    cover version and of the dense kernel, the same bits on a rerun,
    counted as energy_cover."""
    sc, _ = shells[shell]
    u, _ = _random_fields(sc, 32)
    before = lk.launches["energy_cover"]
    got = lk.elastic_energy_lattice(u, sc.cell_mask, 0.05, MU, LA,
                                    cover=sc.cover)
    again = lk.elastic_energy_lattice(u, sc.cell_mask, 0.05, MU, LA,
                                      cover=sc.cover)
    whole = lk.elastic_energy_lattice(u, sc.cell_mask, 0.05, MU, LA)
    ref = lk.elastic_energy_lattice_plain(u, sc.cell_mask, 0.05, MU, LA,
                                          cover=sc.cover)
    torch.cuda.synchronize()
    assert lk.launches["energy_cover"] == before + 2
    assert torch.equal(got, again)
    assert _close(got, ref, 1e-5) and _close(got, whole, 1e-5)


def _newton_args(sc, seed):
    rng = np.random.default_rng(seed)
    mat = sc.material
    inv_dt = 1.0 / 0.033
    vm3 = sc.vert_mask[..., None]

    def noise(scale):
        return scale * torch.from_numpy(rng.standard_normal(
            tuple(sc.x0.shape)).astype(np.float32)).cuda()
    x = sc.x0 + noise(0.01) * vm3
    x_tilde = sc.x0 + noise(0.005) * vm3
    ctrl = (mat.control_mag * sc.pin_mask + sc.mass * inv_dt * inv_dt
            + (1.0 - sc.vert_mask))
    rc = mat.control_mag * sc.pin_mask + sc.mass * inv_dt * inv_dt
    s_aff = (mat.control_mag * sc.pin_mask[..., None] * sc.pin_pos
             + (sc.mass * inv_dt * inv_dt)[..., None] * x_tilde)
    s_aff[..., 1] += sc.mass * mat.gravity
    s_cf = (s_aff - rc[..., None] * sc.x0).permute(3, 0, 1, 2).contiguous()
    u_cf = (x - sc.x0).permute(3, 0, 1, 2).contiguous()
    return (u_cf, s_cf, sc.cell_mask, ctrl, rc, sc.vert_mask, 0.05,
            mat.lame_mu, mat.lame_la, 60, 1e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("shell", sorted(_SHELLS))
def test_cover_fused_newton_matches_plain_and_dense(shells, shell):
    """lat_fused_newton over the cover's active tiles (halo tiles at 20^3,
    exchange tiles at 64^3): the residual f within 1e-5 of max |ref| of the
    plain cover version and equal to the dense kernel's up to the sign of
    zero; the same bits on a rerun; counted as fused_newton_cover. Where
    the cover's plan is the dense one (64^3: the same tiles and grid) dx, fn
    and k equal the dense kernel's (the vertex-pass dots are summed a tile
    at a time, whichever block walks the tile). Otherwise the PCG dots sum
    in another order, and as against the plain version (chip_smoke.py phase
    1 holds the dense kernel so): k within one, dx within 1e-3 of max |dx|
    and fn within 1e-3 of max(max |f|, fn) at equal k, 5e-2 at k one
    apart."""
    sc, _ = shells[shell]
    args = _newton_args(sc, 33)
    before = lk.launches["fused_newton_cover"]
    dxk, fk, fnk, kk = lk.fused_newton(*args, cover=sc.cover)
    dx2, f2, fn2, k2 = lk.fused_newton(*args, cover=sc.cover)
    dxd, fd, fnd, kd = lk.fused_newton(*args)
    dxp, fp, fnp, kp = lk.fused_newton_plain(*args, cover=sc.cover)
    torch.cuda.synchronize()
    assert lk.launches["fused_newton_cover"] == before + 2
    assert torch.equal(dxk, dx2) and torch.equal(fk, f2)
    assert float(fnk) == float(fn2) and int(kk) == int(k2)
    assert _close(fk, fp, 1e-5) and torch.equal(fk, fd)
    X, Y, Z = sc.shape
    same_plan = (lk._cover_plan(sc.cover, "newton", sc.x0.device)
                 == lk._newton_plan(_cuda.load(), X, Y, Z, sc.x0.device))
    assert same_plan == (shell == "64")
    if same_plan:
        assert torch.equal(dxk, dxd) and float(fnk) == float(fnd)
        assert int(kk) == int(kd)
    for dx_ref, fn_ref, k_ref in ((dxp, fnp, kp), (dxd, fnd, kd)):
        k_ref = int(k_ref)
        assert abs(int(kk) - k_ref) <= 1 and int(kk) > 2, (int(kk), k_ref)
        rtol = 1e-3 if int(kk) == k_ref else 5e-2
        err = float((dxk - dx_ref).abs().max())
        assert err <= rtol * float(dx_ref.abs().max()), (err, int(kk), k_ref)
        scale = max(float(fp.abs().max()), abs(float(fn_ref)))
        assert abs(float(fnk) - float(fn_ref)) <= rtol * scale, (
            float(fnk), float(fn_ref))


@pytest.mark.cuda
def test_cover_fused_newton_after_a_call_on_every_vertex(shells):
    """The covered kernel's PCG updates skip the vertices with vm = 0; its
    set-up phase rewrites r, z and xacc at every vertex, so state that an
    earlier call left at those vertices of the cover's kept scratch does
    not reach them. On the 64^3 shell a call with vm = 1 everywhere and a
    right-hand side there leaves nonzero dx off the body; the next call,
    on the scene's vertex mask, gives dx, f, fn and k equal to the dense
    kernel's (torch.equal: +-0 equal)."""
    sc, _ = shells["64"]
    args = _newton_args(sc, 34)
    body = sc.vert_mask > 0
    rng = np.random.default_rng(35)
    noise = torch.from_numpy(rng.standard_normal(
        (3,) + tuple(sc.shape)).astype(np.float32)).cuda()
    every = list(args)
    every[1] = args[1] + 0.1 * noise
    every[5] = torch.ones_like(sc.vert_mask)
    dx1, _, _, k1 = lk.fused_newton(*every, cover=sc.cover)
    torch.cuda.synchronize()
    assert int(k1) > 2 and float(dx1[:, ~body].abs().max()) > 0
    got = lk.fused_newton(*args, cover=sc.cover)
    ref = lk.fused_newton(*args)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "f", "fn", "k"), got, ref):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("shell", sorted(_SHELLS))
def test_cover_vertices_count_the_body(shells, shell):
    """A covered fused_newton call adds the vertices of the mask it is
    given and the lattice's to lattice_kernels.cover_vertices (69,246 of
    274,625 on the 64^3 shell's own mask, every vertex with vm = 1); a
    dense call adds nothing."""
    sc, _ = shells[shell]
    args = _newton_args(sc, 36)
    lk.reset_launches()
    lk.fused_newton(*args, cover=sc.cover)
    n = int(np.prod(sc.shape))
    body = int(sc.vert_mask.sum())
    assert lk.cover_vertices == {"walked": body, "lattice": n}
    if shell == "64":
        assert lk.cover_vertices == {"walked": 69246, "lattice": 274625}
    lk.fused_newton(*args)
    every = list(args)
    every[5] = torch.ones_like(sc.vert_mask)
    lk.fused_newton(*every, cover=sc.cover)
    torch.cuda.synchronize()
    assert lk.cover_vertices == {"walked": body + n, "lattice": 2 * n}
    lk.reset_launches()
    assert lk.cover_vertices == {"walked": 0, "lattice": 0}


@pytest.mark.cuda
def test_covered_frames_launch_only_cover_modes(shells):
    """Two frames of the covered 20^3 shell launch fused_newton_cover once a
    Newton iteration and force_cover at least once a frame, and never the
    dense force, energy or Newton kernels; they match the CPU run."""
    sc, _ = shells["20"]
    lk.reset_launches()
    st = sc.init_state()
    ks = []
    for i in range(2):
        st, k, fn = tlat.step_to_tol(sc, st)
        assert fn <= 1e-4
        ks.append(k)
    torch.cuda.synchronize()
    assert lk.launches["fused_newton_cover"] == sum(ks) > 0
    assert lk.launches["force_cover"] >= 2
    for name in ("fused_newton", "force", "energy", "hvp", "diag"):
        assert lk.launches[name] == 0, name
    cpu = tlat.LatticeScene(sc.mesh, device="cpu", box_threshold=2.0)
    assert cpu.cover is not None
    sc_cpu = cpu.init_state()
    for k in ks:
        sc_cpu, kc, _ = tlat.step_to_tol(cpu, sc_cpu)
        assert kc == k
    assert float((sc_cpu.x - st.x.cpu()).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(9, 9, 25), (17, 17, 65), (17, 17, 257),
                                   (21, 21, 21), (65, 65, 65), (3, 5, 7)])
def test_newton_plan_mirror_equals_lat_newton_plan(scene, shape):
    """newton_tiling, which plans over a cover, gives the card's own
    lat_newton_plan for the dense lattice in every mode (the same model,
    one block an SM)."""
    lib = _cuda.load()
    dev = scene.x0.device
    for mode in (0, 1, 2):
        want = lk.ask_newton_plan(lib, *shape, dev, False, mode)
        assert lk.newton_tiling(*shape, lk._sms(dev.index),
                                mode=mode)[0] == want, mode
