"""The port's host topology builder (native.py, csrc/topology.cpp) and the
lattice stencil SpMV (ops/stencil.values_to_lattice, spmv_stencil) against
the numpy paths and the JAX package (CPU).

Every native entry must give the numpy path's bits (its plain version,
`use_native=False`) and the JAX package's native output; a hierarchy built
with the library must equal the one built without it; a source that does
not compile must raise. The stencil SpMV of a lattice-embedded beam with a
hole must equal the JAX package's and the port's block-ELL SpMV.
"""
import numpy as np
import pytest
import torch

from fem_simulation_tpu import hierarchy as jhl
from fem_simulation_tpu import mesh as jmeshlib
from fem_simulation_tpu import native as jnative
from fem_simulation_tpu.ops import stencil as jstencil

from fem_simulation_tpu_torch import hierarchy as hl
from fem_simulation_tpu_torch import mesh as meshlib
from fem_simulation_tpu_torch import native
from fem_simulation_tpu_torch.ops import ell, stencil

BEAMS = ((3, 4, 5), (8, 8, 24))       # the second is the 2k beam


def _pairs_numpy(hexes):
    rows = np.repeat(hexes, 8, axis=1).reshape(-1)
    cols = np.tile(hexes, (1, 8)).reshape(-1)
    return np.unique(np.stack([rows, cols], axis=1), axis=0)


@pytest.mark.parametrize("beam", BEAMS)
def test_hex_pairs_and_slot_map_equal_numpy_and_jax(beam):
    m = meshlib.beam(*beam, dx=0.05)
    got = native.hex_pairs_unique(m.hexes)
    np.testing.assert_array_equal(got, _pairs_numpy(m.hexes))
    if jnative.available():
        np.testing.assert_array_equal(got, jnative.hex_pairs_unique(m.hexes))
    lvl = hl.build_level_topology(m.x, m.ijk, m.hexes, m.dx,
                                  use_native=False)
    deg = lvl.nbr_mask.sum(axis=1).astype(np.int32)
    slots = native.hex_slot_map(lvl.hexes, lvl.nbr, deg)
    np.testing.assert_array_equal(slots, lvl.hex_slot)
    if jnative.available():
        np.testing.assert_array_equal(
            slots, jnative.hex_slot_map(lvl.hexes, lvl.nbr, deg))


@pytest.mark.parametrize("beam", BEAMS)
def test_galerkin_plan_equals_numpy_and_jax(beam):
    """The native expansion inside build_transfer gives the numpy plan bit
    for bit; the raw expansion equals the JAX package's native one."""
    m = meshlib.beam(*beam, dx=0.05)
    fine = hl.build_level_topology(m.x, m.ijk, m.hexes, m.dx)
    coarse = hl.build_level_topology(*hl.coarsen(fine), fine.dx * 2.0)
    t_nat = hl.build_transfer(fine, coarse)
    t_np = hl.build_transfer(fine, coarse, use_native=False)
    for f in ("g_src", "g_dst", "g_w", "p_idx", "p_w", "r_idx", "r_w"):
        a, b = getattr(t_nat, f), getattr(t_np, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    fi, fk = np.nonzero(fine.nbr_mask)
    fj = fine.nbr[fi, fk]
    src = fi * fine.K + fk
    cdeg = coarse.nbr_mask.sum(axis=1).astype(np.int32)
    args = (fi.astype(np.int32), fj.astype(np.int32), src.astype(np.int32),
            t_np.p_idx, t_np.p_w, coarse.nbr, cdeg, coarse.K)
    got = native.galerkin_plan(*args)
    assert got[0].size == t_np.g_src.size
    if jnative.available():
        for a, b in zip(got, jnative.galerkin_plan(*args)):
            np.testing.assert_array_equal(a, b)


def test_hierarchy_bit_equal_with_and_without_native():
    """build_hierarchy on the 2k beam, 3 levels: every level and transfer
    array equal, and equal to the JAX package's."""
    m = meshlib.beam(8, 8, 24, dx=0.05)
    h_nat = hl.build_hierarchy(m, 3)
    h_np = hl.build_hierarchy(m, 3, use_native=False)
    h_jax = jhl.build_hierarchy(jmeshlib.beam(8, 8, 24, dx=0.05), 3)
    for a, b, c in zip(h_nat.levels, h_np.levels, h_jax.levels):
        for f in ("x0", "ijk", "hexes", "nbr", "nbr_mask", "diag_slot",
                  "hex_slot", "contrib_idx", "contrib_mask"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert np.array_equal(getattr(a, f), getattr(c, f)), f
    for a, b, c in zip(h_nat.transfers, h_np.transfers, h_jax.transfers):
        for f in ("g_src", "g_dst", "g_w", "p_idx", "p_w", "r_idx", "r_w",
                  "t_rows", "t_cols", "t_w"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
            assert np.array_equal(getattr(a, f), getattr(c, f)), f


def _torus(R=1.0, r=0.4, nu=24, nv=16):
    """A closed triangulated torus about the z axis: (verts, tris)."""
    u = np.linspace(0.0, 2.0 * np.pi, nu, endpoint=False)
    v = np.linspace(0.0, 2.0 * np.pi, nv, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    verts = np.stack([(R + r * np.cos(vv)) * np.cos(uu),
                      (R + r * np.cos(vv)) * np.sin(uu),
                      r * np.sin(vv)], -1).reshape(-1, 3)
    i, j = np.meshgrid(np.arange(nu), np.arange(nv), indexing="ij")
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    c = ((i + 1) % nu) * nv + (j + 1) % nv
    d = i * nv + (j + 1) % nv
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([a, c, d], -1).reshape(-1, 3)])
    return verts, tris.astype(np.int64)


def test_points_inside_equals_numpy_and_jax():
    verts, tris = _torus()
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1.6, 1.6, size=(4000, 3)) * np.array([1.0, 1.0, 0.4])
    got = meshlib._points_inside(pts, verts, tris)
    ref = meshlib._points_inside(pts, verts, tris, use_native=False)
    assert 0 < got.sum() < got.size
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, jmeshlib._points_inside(pts, verts, tris, use_native=False))
    if jnative.available():
        np.testing.assert_array_equal(got,
                                      jnative.points_inside(pts, verts, tris))
    # the voxelizer on the torus: the same cells either way
    vox = meshlib.voxelize(verts, tris, 0.1)
    jvox = jmeshlib.voxelize(verts, tris, 0.1)
    np.testing.assert_array_equal(vox.hexes, jvox.hexes)
    np.testing.assert_array_equal(vox.ijk, jvox.ijk)


def test_a_failed_build_raises(monkeypatch, tmp_path):
    bad = tmp_path / "topology.cpp"
    bad.write_text("extern \"C\" int64_t hex_pairs_unique( {\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    with pytest.raises(RuntimeError, match="failed"):
        native.load()
    assert str(bad) not in native._libs
    # and so does a hierarchy that asks for it
    with pytest.raises(RuntimeError):
        hl.build_hierarchy(meshlib.beam(2, 2, 2, dx=0.1), 1)
    # the numpy path needs no library
    hl.build_hierarchy(meshlib.beam(2, 2, 2, dx=0.1), 1, use_native=False)


def _holed_system():
    """A 3 x 3 x 5 block of cells with its centre cell and one corner
    column taken out (so the bounding lattice has empty vertices), its
    block-ELL topology (port and JAX builders) and seeded values and x."""
    cells = np.array([[i, j, k] for i in range(3) for j in range(3)
                      for k in range(5)
                      if not (i == 1 and j == 1 and k == 2)
                      and not (i == 2 and j == 2)])
    m = meshlib.hex_mesh_from_cells(cells, 0.1, np.zeros(3))
    lvl = hl.build_level_topology(m.x, m.ijk, m.hexes, m.dx)
    jm = jmeshlib.hex_mesh_from_cells(cells, 0.1, np.zeros(3))
    jlvl = jhl.build_level_topology(jm.x, jm.ijk, jm.hexes, jm.dx)
    rng = np.random.default_rng(1)
    vals = rng.normal(size=(lvl.n_verts, lvl.K, 3, 3)).astype(np.float32)
    b = rng.normal(size=(lvl.n_verts, 3)).astype(np.float32)
    return lvl, jlvl, vals, b


def test_stencil_spmv_equals_jax_and_ell():
    lvl, jlvl, vals, b = _holed_system()
    mask = lvl.nbr_mask.astype(np.float32)
    lm = stencil.build_lattice_map(lvl)
    assert lm[3] < 1.0                    # the hole leaves a vertex empty
    vl = stencil.values_to_lattice(torch.from_numpy(vals),
                                   torch.from_numpy(lvl.nbr),
                                   torch.from_numpy(mask), lvl, lm)
    assert vl.shape == (27,) + tuple(lm[0]) + (3, 3)
    jlm = jstencil.build_lattice_map(jlvl)
    jvl = jstencil.values_to_lattice(vals, jlvl.nbr, mask, jlvl, jlm)
    np.testing.assert_array_equal(vl.numpy(), np.asarray(jvl))
    lat = torch.from_numpy(lm[1])
    xb = stencil.field_to_lattice(torch.from_numpy(b), lat, lm[0])
    y = stencil.spmv_stencil(vl, xb)
    got = stencil.field_from_lattice(y, lat).numpy()
    jy = jstencil.spmv_stencil(jvl, jstencil.field_to_lattice(
        b, jlm[1], jlm[0]))
    np.testing.assert_allclose(got, np.asarray(jstencil.field_from_lattice(
        jy, jlm[1])), rtol=1e-5, atol=1e-5)
    full = torch.from_numpy(vals) * torch.from_numpy(mask)[..., None, None]
    ref = ell.spmv(full, torch.from_numpy(lvl.nbr), torch.from_numpy(mask),
                   torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # an empty lattice vertex stays zero
    holes = torch.from_numpy(lm[2] < 0)
    assert holes.any() and float(y[holes].abs().max()) == 0.0


def test_stencil_spmv_on_an_explicit_device():
    """values_to_lattice builds on the host and moves to the device asked
    for; spmv_stencil keeps its input's device and dtype."""
    lvl, _, vals, b = _holed_system()
    lm = stencil.build_lattice_map(lvl)
    vl = stencil.values_to_lattice(vals, lvl.nbr, lvl.nbr_mask, lvl, lm,
                                   device="cpu")
    assert vl.device.type == "cpu" and vl.dtype == torch.float32
    xb = stencil.field_to_lattice(torch.from_numpy(b),
                                  torch.from_numpy(lm[1]), lm[0])
    y = stencil.spmv_stencil(vl, xb)
    assert y.shape == xb.shape and y.dtype == xb.dtype
