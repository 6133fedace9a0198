"""The plain reference at a tiny size: its residual is minus the gradient of
its own potential (a finite difference in float64), its shape gradients
sum to zero, TF32 rounding keeps 10 mantissa bits, and its residual agrees
with the program's plain one on the same body."""
import numpy as np
import pytest
import torch

from fembench import geometry, meshgen, reference

MAT = dict(lame_mu=250.0, lame_la=0.0, gravity=-4.9, density=1.0,
           control_mag=100.0)


def body_model(body, dtype=torch.float64):
    geo = geometry.Geometry(body, MAT)
    return geo, reference.Model(geo, MAT, "cpu", dtype=dtype)


@pytest.mark.parametrize("body", [meshgen.beam(2, 2, 5),
                                  meshgen.shell(5, 5, 5, thickness=2)])
@pytest.mark.parametrize("dynamic", [False, True])
def test_residual_is_minus_the_gradient(body, dynamic):
    geo, m = body_model(body)
    g = torch.Generator().manual_seed(3)
    X = m.X.clone()
    x = X + 0.004 * torch.randn(X.shape, generator=g, dtype=X.dtype)
    xt = X + 0.002 * torch.randn(X.shape, generator=g, dtype=X.dtype)
    kw = dict(x_tilde=xt, inv_dt=1 / 0.033) if dynamic else {}
    f = m.residual(x, **kw)
    for _ in range(3):
        p = torch.randn(X.shape, generator=g, dtype=X.dtype)
        h = 1e-6
        fd = (m.potential(x + h * p, **kw) - m.potential(x - h * p, **kw)) / (
            2 * h)
        assert abs(float(fd) + float(torch.sum(f * p))) <= 1e-7 * max(
            1.0, abs(float(fd)))


def test_shape_gradients_and_rest():
    G = reference.shape_gradients(0.05)
    assert np.abs(G.sum(axis=0)).max() < 1e-12
    geo, m = body_model(meshgen.beam(2, 2, 3))
    # at rest only gravity: f = m g e_y, but for the strain of the float32
    # rest positions against the float64 lattice (~1e-8 relative)
    f = m.residual(m.X)
    assert float(f[:, 0].abs().max()) < 1e-6
    assert torch.allclose(f[:, 1], m.mass * MAT["gravity"], atol=1e-6)
    assert abs(float(m.mass.sum()) - 8 * 2 * 2 * 3 * 0.05 ** 3) < 1e-12


def test_tf32_rounding():
    a = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -12, 12.8,
                      -3.0e-3], dtype=torch.float32)
    r = reference.round_tf32(a)
    bits = r.view(torch.int32)
    assert bool(((bits & 0x1FFF) == 0).all())
    assert float(r[1]) == 1.0 + 2 ** -10
    assert bool(((r - a).abs() <= a.abs() * 2 ** -11).all())


def test_reference_agrees_with_the_programs_plain_residual():
    from fem_simulation_tpu_torch import mesh as pmesh
    from fem_simulation_tpu_torch.config import MaterialConfig
    from fem_simulation_tpu_torch.sim import lattice
    body = meshgen.shell(5, 5, 5, thickness=2)
    geo, m = body_model(body)
    sc = lattice.LatticeScene(pmesh.HexMesh(**body), MaterialConfig(**MAT),
                              device="cpu")
    g = torch.Generator().manual_seed(4)
    vm = sc.vert_mask[..., None]
    x = sc.x0 + 0.003 * torch.randn(sc.x0.shape, generator=g) * vm
    xt = sc.x0 + 0.002 * torch.randn(sc.x0.shape, generator=g) * vm
    fp = m.gather(sc.dyn_force(x, xt, 1 / 0.033))
    fr = m.residual(m.gather(x), m.gather(xt), 1 / 0.033)
    assert float((fp - fr).abs().max()) < 1e-5 * float(fr.abs().max())
