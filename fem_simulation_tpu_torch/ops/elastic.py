"""Batched StVK hexahedral FEM operators (energy / force / Hessian).

Port of `fem_simulation_tpu/ops/elastic.py` with the same signatures and
layouts: positions (N, 3), hexes (H, 8), det (H, 8), shape gradients
g (H, 8, 8, 3), element blocks (H, 8, 8, 3, 3), block-ELL values
(N, K, 3, 3). Everything is float32 (TF32 is off, see the package).

Vertex sums: the simulators use the gather forms (`force_gather`,
`hvp_gather`, `hessian_diag_gather`, `assemble_hessian_ell_gather`), which
sum each vertex's or ELL entry's contributions in a fixed order, so a GPU
run is identical from run to run. The scatter forms (`force`,
`hessian_diag`, `assemble_hessian_ell`, `lumped_mass`) use
`index_put_(accumulate=True)`, which sums duplicates in sorted index order.
"""
from __future__ import annotations

import numpy as np
import torch

from . import take_rows

# Corner sign table, local corner index = 4*di + 2*dj + dk (mesh.CORNER_OFFSETS),
# mapped to reference-element coordinates in {-1, +1}^3.
_SIGNS = np.array(
    [[2 * i - 1, 2 * j - 1, 2 * k - 1]
     for i in range(2) for j in range(2) for k in range(2)],
    dtype=np.float64,
)

# 2x2x2 Gauss points at +-1/sqrt(3) in the same layout.
_QUAD = _SIGNS / np.sqrt(3.0)


def shape_func_grad() -> np.ndarray:
    """S[i, q, d] = dN_i/dxi_d at Gauss point q, N_i(xi) = prod_d (1 + h_id xi_d) / 2."""
    S = np.zeros((8, 8, 3))
    for i in range(8):
        for q in range(8):
            for d in range(3):
                val = _SIGNS[i, d] / 2.0
                for e in range(3):
                    if e != d:
                        val *= (1.0 + _SIGNS[i, e] * _QUAD[q, e]) / 2.0
                S[i, q, d] = val
    return S.astype(np.float32)


def _eye(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def _scatter_rows(idx: torch.Tensor, vals: torch.Tensor, n: int) -> torch.Tensor:
    """out[idx[m]] += vals[m] into n zero rows (duplicates summed in sorted
    index order, deterministic on both devices)."""
    out = torch.zeros((n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                      device=vals.device)
    return out.index_put_((idx.long(),), vals, accumulate=True)


def prepare(x0: torch.Tensor, hexes: torch.Tensor):
    """Rest-state element data: det (H, 8) |dX/dxi| per quad point, material
    shape gradients g (H, 8, 8, 3) with g[e, q, i] = J^{-T}_eq S[i, q], and
    element volumes vol (H,) = sum_q det."""
    S = torch.from_numpy(shape_func_grad()).to(x0.device)
    xe = x0[hexes]                                     # (H, 8, 3)
    J = torch.einsum("hir,iqc->hqrc", xe, S)
    det = torch.linalg.det(J)
    Jinv = torch.linalg.inv(J)                         # (H, 8, 3, 3)
    g = torch.einsum("iqd,hqdc->hqic", S, Jinv)        # g_i = S_i @ J^{-1}
    vol = torch.sum(det, dim=1)
    return det, g, vol


def lumped_mass(vol, hexes, n_verts: int, density: float = 1.0):
    """Lumped vertex mass: each corner gets the full cell volume."""
    contrib = (vol[:, None] * density).expand(hexes.shape).reshape(-1)
    return _scatter_rows(hexes.reshape(-1), contrib, n_verts)


def _deformation(x, hexes, g):
    """F[h, q] = sum_i x_i (g_i)^T  -> (H, 8, 3, 3)."""
    return torch.einsum("hir,hqic->hqrc", take_rows(x, hexes), g)


def _green(F):
    return 0.5 * (F.transpose(-1, -2) @ F - _eye(F))


def energy(x, hexes, det, g, mu, la):
    """Total StVK energy: Psi = mu ||E||_F^2 + la/2 tr(E)^2 per quad point."""
    E = _green(_deformation(x, hexes, g))
    trE = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    psi = mu * torch.sum(E * E, dim=(-2, -1)) + 0.5 * la * trE * trE
    return torch.sum(psi * det)


def _pk1(F, mu, la):
    """P = F (2 mu E + la tr(E) I), with E and M = 2 mu E + la tr(E) I."""
    E = _green(F)
    trE = E.diagonal(dim1=-2, dim2=-1).sum(-1)
    M = 2.0 * mu * E + la * trE[..., None, None] * _eye(F)
    return F @ M, E, M


def _force_corners(x, hexes, det, g, mu, la):
    """(H, 8, 3) corner forces f[h, i] = - sum_q det P g_i."""
    P, _, _ = _pk1(_deformation(x, hexes, g), mu, la)
    return -torch.einsum("hq,hqrc,hqic->hir", det, P, g)


def force(x, hexes, det, g, mu, la, n_verts):
    """Elastic force = -dE/dx, scattered to vertices."""
    f = _force_corners(x, hexes, det, g, mu, la)
    return _scatter_rows(hexes.reshape(-1), f.reshape(-1, 3), n_verts)


def vertex_contrib_map(hexes, n_verts: int):
    """Host-side inverse incidence map: for each vertex, the flat indices of
    its (hex, corner) contributions in an (H*8, ...) per-corner array, as
    (N, 8) int32 + (N, 8) float32 mask (a hex-mesh vertex has <= 8 hexes)."""
    flat = np.asarray(hexes).reshape(-1)
    n = flat.shape[0]
    order = np.argsort(flat, kind="stable")
    sorted_v = flat[order]
    first = np.searchsorted(sorted_v, sorted_v)
    pos = np.arange(n) - first
    assert pos.max() < 8, "hex mesh vertex valence exceeded 8"
    idx = np.zeros((n_verts, 8), np.int32)
    mask = np.zeros((n_verts, 8), np.float32)
    idx[sorted_v, pos] = order.astype(np.int32)
    mask[sorted_v, pos] = 1.0
    return idx, mask


def _corner_gather(fc, cidx, cmask):
    """Sum per-corner contributions (H*8, ...) onto vertices through the
    inverse map, in fixed slot order."""
    extra = (None,) * (fc.dim() - 1)
    return torch.sum(take_rows(fc, cidx) * cmask[(...,) + extra], dim=1)


def force_gather(x, hexes, det, g, mu, la, cidx, cmask, n_verts):
    """`force` with the scatter-add replaced by the vertex_contrib_map gather."""
    f = _force_corners(x, hexes, det, g, mu, la)
    return _corner_gather(f.reshape(-1, 3), cidx, cmask)


def hvp_corners(x, p, hexes, det, g, mu, la):
    """Closed-form StVK Hessian-vector product per element corner (H, 8, 3):
      dF = sum_i p_i g_i^T, dE = (dF^T F + F^T dF) / 2,
      dM = 2 mu dE + la tr(dE) I, dP = dF M + F dM, (H p)_a = sum_q det dP g_a."""
    F = _deformation(x, hexes, g)
    dF = _deformation(p, hexes, g)
    _, _, M = _pk1(F, mu, la)
    dFtF = dF.transpose(-1, -2) @ F
    dE = 0.5 * (dFtF + dFtF.transpose(-1, -2))
    trdE = dE.diagonal(dim1=-2, dim2=-1).sum(-1)
    dM = 2.0 * mu * dE + la * trdE[..., None, None] * _eye(x)
    dP = dF @ M + F @ dM
    return torch.einsum("hq,hqrc,hqic->hir", det, dP, g)


def hvp_gather(x, p, hexes, det, g, mu, la, cidx, cmask, n_verts):
    """H @ p assembled through the vertex_contrib_map."""
    hp = hvp_corners(x, p, hexes, det, g, mu, la)
    return _corner_gather(hp.reshape(-1, 3), cidx, cmask)


def hessian_blocks(x, hexes, det, g, mu, la):
    """Element Hessian blocks (H, 8, 8, 3, 3), H[h, a, b][j, i] =
    d f_a[j] / d x_b[i] of the energy gradient:
      H_ab = sum_q det ((g_a^T M g_b) I + mu u_b u_a^T + mu (g_a.g_b) F F^T
                        + la u_a u_b^T),  u_a = F g_a."""
    F = _deformation(x, hexes, g)
    _, _, M = _pk1(F, mu, la)
    u = torch.einsum("hqrc,hqic->hqir", F, g)           # (H, 8q, 8a, 3)
    s1 = torch.einsum("hqic,hqcd,hqjd->hqij", g, M, g)  # g_a^T M g_b
    gg = torch.einsum("hqic,hqjc->hqij", g, g)          # g_a . g_b
    C = F @ F.transpose(-1, -2)                         # F F^T
    H = torch.einsum("hq,hqab,ji->habji", det, s1, _eye(x))
    H = H + mu * torch.einsum("hq,hqbj,hqai->habji", det, u, u)
    H = H + mu * torch.einsum("hq,hqab,hqji->habji", det, gg, C)
    H = H + la * torch.einsum("hq,hqaj,hqbi->habji", det, u, u)
    return H


def assemble_hessian_ell(x, hexes, det, g, mu, la, hex_slot, n_verts, K,
                         base_values=None):
    """Scatter element Hessians into the block-ELL matrix (N, K, 3, 3)."""
    H = hessian_blocks(x, hexes, det, g, mu, la).reshape(-1, 3, 3)
    vals = _scatter_rows(hex_slot.reshape(-1), H, n_verts * K)
    if base_values is not None:
        vals = vals + base_values.reshape(n_verts * K, 3, 3)
    return vals.reshape(n_verts, K, 3, 3)


def assemble_hessian_ell_gather(x, hexes, det, g, mu, la, contrib_idx,
                                contrib_mask, n_verts, K, base_values=None):
    """Gather-based assembly: each ELL entry sums its (<= C) element-block
    contributions through the precomputed inverse map, in fixed order."""
    H = hessian_blocks(x, hexes, det, g, mu, la).reshape(-1, 3, 3)
    vals = _corner_gather(H, contrib_idx, contrib_mask)
    if base_values is not None:
        vals = vals + base_values.reshape(n_verts * K, 3, 3)
    return vals.reshape(n_verts, K, 3, 3)


def _hessian_diag_corners(x, hexes, det, g, mu, la):
    """(H, 8, 3, 3) per-corner diagonal-block contributions."""
    F = _deformation(x, hexes, g)
    _, _, M = _pk1(F, mu, la)
    u = torch.einsum("hqrc,hqic->hqir", F, g)
    s1 = torch.einsum("hqic,hqcd,hqid->hqi", g, M, g)
    gg = torch.einsum("hqic,hqic->hqi", g, g)
    C = F @ F.transpose(-1, -2)
    Hd = torch.einsum("hq,hqa,ji->haji", det, s1, _eye(x))
    Hd = Hd + (mu + la) * torch.einsum("hq,hqaj,hqai->haji", det, u, u)
    Hd = Hd + mu * torch.einsum("hq,hqa,hqji->haji", det, gg, C)
    return Hd


def hessian_diag(x, hexes, det, g, mu, la, n_verts):
    """Vertex-diagonal 3x3 blocks of the elastic Hessian (a = b slice of
    hessian_blocks), scattered to vertices."""
    Hd = _hessian_diag_corners(x, hexes, det, g, mu, la)
    return _scatter_rows(hexes.reshape(-1), Hd.reshape(-1, 3, 3), n_verts)


def hessian_diag_gather(x, hexes, det, g, mu, la, cidx, cmask, n_verts):
    """hessian_diag assembled through vertex_contrib_map."""
    Hd = _hessian_diag_corners(x, hexes, det, g, mu, la).reshape(-1, 3, 3)
    return _corner_gather(Hd, cidx, cmask)


# -- simple per-vertex energy terms (gravity, pins, inertia) ----------------

def gravity_energy(x, m, g_const):
    return -torch.sum(m * g_const * x[:, 1])


def gravity_force(m, g_const, n_verts, dtype=torch.float32):
    f = torch.zeros((n_verts, 3), dtype=dtype, device=m.device)
    f[:, 1] += m * g_const
    return f


def pin_energy(x, pin_mask, pin_pos, control_mag):
    d = pin_pos - x
    return 0.5 * control_mag * torch.sum(pin_mask * torch.sum(d * d, dim=-1))


def pin_force(x, pin_mask, pin_pos, control_mag):
    """control_mag * (pin_pos - x) on pinned vertices."""
    return control_mag * pin_mask[:, None] * (pin_pos - x)


def inertia_force(x, x_tilde, m, inv_dt):
    """-m/h^2 (x - x_tilde): the implicit-Euler inertia term of the residual
    force (f = -grad E)."""
    return -(m * inv_dt * inv_dt)[:, None] * (x - x_tilde)


def inertia_energy(x, x_tilde, m, inv_dt):
    d = x - x_tilde
    return 0.5 * inv_dt * inv_dt * torch.sum(m * torch.sum(d * d, dim=-1))
