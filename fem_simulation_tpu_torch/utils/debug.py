"""Debug-mode invariant checks for tests and debug runs (they read back to
the host).

Port of `fem_simulation_tpu/utils/debug.py`:

  - Hessian symmetry: H[i,j] == H[j,i]^T across the ELL table
  - SPD after projection: min eigenvalue >= -tol
  - energy decrease across a solver step
  - Galerkin consistency: A_c x == R (A (P x))
"""
from __future__ import annotations

import numpy as np
import torch

from .viz import to_numpy


def check_symmetry(lvl, values, atol=1e-4) -> float:
    """Max |H[i,j] - H[j,i]^T| over real entries; raises AssertionError
    above atol. Returns the max violation."""
    v = to_numpy(values)
    nbr = np.asarray(lvl.nbr)
    mask = np.asarray(lvl.nbr_mask)
    ii, kk = np.nonzero(mask)
    jj = nbr[ii, kk]
    # mirror slot: position of i in row j
    mirror = np.argmax(nbr[jj] == ii[:, None], axis=1)
    ok = nbr[jj, mirror] == ii
    diff = np.abs(v[ii, kk] - np.transpose(v[jj, mirror], (0, 2, 1)))
    worst = float(diff[ok].max()) if ok.any() else 0.0
    if worst > atol:
        raise AssertionError(f"Hessian asymmetry {worst:.3e} > {atol:.1e}")
    return worst


def check_spd(values, tol=1e-5) -> float:
    """Min eigenvalue across all 3x3 blocks' symmetric parts."""
    v = to_numpy(values).reshape(-1, 3, 3)
    sym = 0.5 * (v + np.transpose(v, (0, 2, 1)))
    return float(np.linalg.eigvalsh(sym).min())


def check_energy_decrease(energies, rtol=1e-3) -> bool:
    """Energy series is (approximately) non-increasing."""
    e = to_numpy(energies)
    increases = np.diff(e) > rtol * np.maximum(np.abs(e[:-1]), 1e-12)
    return not increases.any()


def check_galerkin(scene, params, values_fine, values_coarse, li=0,
                   rtol=1e-3, atol=1e-4, seed=0):
    """A_c x == R (A (P x)) for a seeded random x (Galerkin exactness), on
    the scene's device."""
    from ..ops import ell, transfer
    t = params["transfers"][li]
    opf = scene.make_op(li, params)
    opc = scene.make_op(li + 1, params)
    rng = np.random.default_rng(seed)
    xc = torch.from_numpy(rng.normal(size=(scene.level(li + 1).n_verts, 3))
                          .astype(np.float32)).to(values_coarse.device)
    lhs = ell.spmv(values_coarse * opc.mask[..., None, None], opc.nbr,
                   opc.mask, xc)
    xf = transfer.prolong(t["p_idx"], t["p_w"], xc)
    axf = ell.spmv(values_fine * opf.mask[..., None, None], opf.nbr,
                   opf.mask, xf)
    rhs = transfer.restrict(t["r_idx"], t["r_w"], axf)
    np.testing.assert_allclose(to_numpy(lhs), to_numpy(rhs),
                               rtol=rtol, atol=atol)
