"""The port's CUDA kernels against their plain torch versions, on the card.

Marked `cuda`: these skip without a CUDA device (a CUDA kernel has no CPU
mode). On a machine with an H100:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""
import numpy as np
import pytest
import torch

from fem_simulation_tpu import mesh as meshlib

from fem_simulation_tpu_torch.ops import lattice_kernels as lk
from fem_simulation_tpu_torch.sim import lattice as tlat

pytestmark = pytest.mark.cuda
MU, LA, DX = 250.0, 37.0, 0.1


@pytest.fixture(scope="module")
def scene():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tlat.LatticeScene(meshlib.beam(4, 4, 8, dx=DX), device="cuda")


@pytest.fixture(scope="module")
def fields(scene):
    rng = np.random.default_rng(3)
    shape = tuple(scene.x0.shape)
    u = torch.from_numpy(0.03 * rng.standard_normal(shape).astype(np.float32))
    p = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    return u.cuda() * scene.vert_mask[..., None], p.cuda()


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
