"""Structured-lattice StVK operators in plain torch.

Port of `fem_simulation_tpu/ops/stencil.py`. The elastic operators are
the plain versions the CUDA kernels (`ops/lattice_kernels.py`) are held
against, and what the kernel wrappers run on CPU tensors; the multigrid
transfers (`prolong_lat`, `restrict_lat`) and the 27-point stencil SpMV of
a lattice-embedded block-ELL matrix (`values_to_lattice`, `spmv_stencil`,
the reference's gather-free SpMV, which has no Pallas kernel) are plain
torch on every device.

Layout: vertex fields (X, Y, Z, 3) on the bounding lattice; cell mask
(X-1, Y-1, Z-1), 1.0 on real cells. The elastic operators take an optional
`cells` (a CellList: a cover's real cells, ops/boxes.py): they then compute
the listed cells only, with the same per-cell formulas on the gathered
corner fields, and add each corner's contributions to its vertex in the
same corner order, so the vertex sums equal the dense ones up to the sign
of zero (a dense sum adds +-0 for every empty cell). All operators take
DISPLACEMENTS
u = x - x0 from the rest lattice: F = I + sum_i u_i g_iq^T with the identity
added analytically, so the f32 noise of F does not grow with the coordinate
magnitude (the position form sums eight |x|*(2/dx)-sized terms that cancel).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device_or_cuda
from .elastic import shape_func_grad

_CORNERS = [(i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1)]


def build_lattice_map(lvl):
    """Map a LevelTopology onto its bounding lattice.

    Returns (shape, lat_of_vert (N,3) int32 zero-based, vert_of_lat (X,Y,Z)
    int32 with -1 holes, fill fraction).
    """
    ijk = lvl.ijk
    real = ijk[:, 0] > -(10 ** 5)  # exclude phantom padding rows
    lo = ijk[real].min(axis=0)
    hi = ijk[real].max(axis=0)
    shape = tuple((hi - lo + 1).tolist())
    lat = np.where(real[:, None], ijk - lo, 0).astype(np.int32)
    vert_of_lat = np.full(shape, -1, dtype=np.int32)
    idx = np.nonzero(real)[0]
    vert_of_lat[lat[idx, 0], lat[idx, 1], lat[idx, 2]] = idx
    fill = real.sum() / float(np.prod(shape))
    return shape, lat, vert_of_lat, fill


def field_to_lattice(x: torch.Tensor, lat: torch.Tensor, shape) -> torch.Tensor:
    """Scatter per-vertex rows x (N, C) onto a zero lattice (X, Y, Z, C)."""
    lat = lat.long()
    out = torch.zeros(tuple(shape) + (x.shape[-1],), dtype=x.dtype,
                      device=x.device)
    out[lat[:, 0], lat[:, 1], lat[:, 2]] = x
    return out


def field_from_lattice(x_lat: torch.Tensor, lat: torch.Tensor) -> torch.Tensor:
    lat = lat.long()
    return x_lat[lat[:, 0], lat[:, 1], lat[:, 2]]


def values_to_lattice(values, nbr, mask, lvl, lat_map, device=None):
    """Block-ELL values (N, K, 3, 3) scattered into the stencil tensor
    (27, X, Y, Z, 3, 3): slot (i, k) of a real entry goes to offset
    o = 9 (dx + 1) + 3 (dy + 1) + (dz + 1) of its neighbour at row i's
    lattice vertex. Built on the host; on `device`, else values' device
    when values is a tensor, else the GPU (device_or_cuda)."""
    shape, lat, _, _ = lat_map
    if device is None and torch.is_tensor(values):
        device = values.device
    else:
        device = device_or_cuda(device)

    def host(a):
        return a.detach().cpu().numpy() if torch.is_tensor(a) \
            else np.asarray(a)
    v, nb, mk = host(values), host(nbr), host(mask) > 0
    vals_lat = np.zeros((27,) + tuple(shape) + (3, 3), dtype=np.float32)
    ii, kk = np.nonzero(mk)
    jj = nb[ii, kk]
    off = lvl.ijk[jj] - lvl.ijk[ii] + 1         # in {0,1,2}^3
    o = off[:, 0] * 9 + off[:, 1] * 3 + off[:, 2]
    p = lat[ii]
    vals_lat[o, p[:, 0], p[:, 1], p[:, 2]] = v[ii, kk]
    return torch.from_numpy(vals_lat).to(device)


def spmv_stencil(vals_lat: torch.Tensor, x_lat: torch.Tensor) -> torch.Tensor:
    """y = A x on the lattice: 27 shifted 3x3 multiply-accumulates, no
    gather, in float32 with no tensor-core arithmetic. vals_lat
    (27, X, Y, Z, 3, 3), x_lat (X, Y, Z, 3) -> (X, Y, Z, 3)."""
    X, Y, Z, _ = x_lat.shape
    xp = torch.zeros((X + 2, Y + 2, Z + 2, 3), dtype=x_lat.dtype,
                     device=x_lat.device)
    xp[1:-1, 1:-1, 1:-1] = x_lat
    y = torch.zeros_like(x_lat)
    o = 0
    for di in (0, 1, 2):
        for dj in (0, 1, 2):
            for dk in (0, 1, 2):
                xs = xp[di:di + X, dj:dj + Y, dk:dk + Z]
                y = y + torch.sum(vals_lat[o] * xs[..., None, :], -1)
                o += 1
    return y


def g_table(dx: float) -> np.ndarray:
    """g[i, q, :] = S[i, q, :] * 2/dx in float32 (8, 8, 3)."""
    return shape_func_grad() * np.float32(2.0 / dx)


def lattice_material_tables(dx: float, device="cpu"):
    """On a uniform lattice J = (dx/2) I exactly, so the material shape
    gradients are constant across cells: g = S * 2/dx, det = (dx/2)^3."""
    return torch.from_numpy(g_table(dx)).to(device), (dx / 2.0) ** 3


class CellList(NamedTuple):
    """Listed cells of a lattice: their flat indices into the (X-1, Y-1,
    Z-1) cell grid, and the flat vertex index of each one's 8 corners in
    _CORNERS order; int64 on the fields' device."""
    cells: torch.Tensor      # (n,)
    corners: torch.Tensor    # (8, n)


def cell_list(cells, shape, device) -> CellList:
    """CellList of the flat cell indices `cells` (a numpy int array) on a
    vertex lattice of `shape`."""
    X, Y, Z = shape
    c = torch.as_tensor(np.asarray(cells, np.int64))
    cz = c % (Z - 1)
    t = c // (Z - 1)
    cy, cx = t % (Y - 1), t // (Y - 1)
    corners = torch.stack([((cx + di) * Y + cy + dj) * Z + cz + dk
                           for (di, dj, dk) in _CORNERS])
    return CellList(c.to(device), corners.to(device))


def _cell_slices(x_lat, cells=None):
    """The 8 corner fields of every cell as shifted slices, or of the listed
    cells as (n, 1, 1, C) gathers (the dense formulas run on them as on a
    cell grid of n x 1 x 1)."""
    if cells is not None:
        flat = x_lat.reshape(-1, x_lat.shape[-1])
        return [flat[c].view(-1, 1, 1, flat.shape[-1]) for c in cells.corners]
    X, Y, Z = x_lat.shape[:3]
    return [x_lat[di:di + X - 1, dj:dj + Y - 1, dk:dk + Z - 1]
            for (di, dj, dk) in _CORNERS]


def _cell_values(cell_mask, cells=None):
    """The cell mask over the cells computed: the grid, or (n, 1, 1)."""
    if cells is None:
        return cell_mask
    return cell_mask.reshape(-1)[cells.cells].view(-1, 1, 1)


def _add_to_corner(out, i, val, cells=None):
    """out[vertex at corner i of each computed cell] += val in place; out is
    (X, Y, Z, ...) and val the cells' values (cell grid or (n, 1, 1))."""
    if cells is None:
        di, dj, dk = _CORNERS[i]
        X, Y, Z = out.shape[:3]
        out[di:di + X - 1, dj:dj + Y - 1, dk:dk + Z - 1] += val
        return
    tail = out.shape[3:]
    out.view((-1,) + tail).index_add_(0, cells.corners[i],
                                      val.reshape((-1,) + tail))


def _deformation(u_lat, g, cells=None):
    """F[x, y, z, q, r, d] = I + sum_i u_i[r] g[i, q, d] over the cells."""
    xs = _cell_slices(u_lat, cells)
    F = sum(torch.einsum("xyzr,qd->xyzqrd", xs[i], g[i]) for i in range(8))
    return F + torch.eye(3, dtype=u_lat.dtype, device=u_lat.device)


def _strain_stress(F, mu, la):
    """Green strain E = (F^T F - I)/2 and M = 2 mu E + la tr(E) I."""
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    E = 0.5 * (torch.einsum("...ba,...bc->...ac", F, F) - eye)
    trE = torch.diagonal(E, dim1=-2, dim2=-1).sum(-1)
    M = 2.0 * mu * E + la * trE[..., None, None] * eye
    return E, trE, M


def _gather_corners(cell_field, g, shape, sign_det, cells=None):
    """out[vertex] = sign_det * sum over incident cells and q of
    cell_field[..., q, r, d] g[i, q, d] (cell_field already masked)."""
    X, Y, Z = shape
    out = torch.zeros((X, Y, Z, 3), dtype=cell_field.dtype,
                      device=cell_field.device)
    for i in range(8):
        fi = sign_det * torch.einsum("xyzqrd,qd->xyzr", cell_field, g[i])
        _add_to_corner(out, i, fi, cells)
    return out


def elastic_force_lattice(u_lat, cell_mask, g, det, mu, la, cells=None):
    """Elastic force on the vertex lattice: corner i of every cell gets
    -det * sum_q P(F_q) g_iq with P = F M, masked by the cell mask."""
    F = _deformation(u_lat, g, cells)
    _, _, M = _strain_stress(F, mu, la)
    P = F @ M
    Pm = P * _cell_values(cell_mask, cells)[..., None, None, None]
    return _gather_corners(Pm, g, u_lat.shape[:3], -det, cells)


def elastic_hvp_lattice(u_lat, p_lat, cell_mask, g, det, mu, la, cells=None):
    """Analytic Hessian-vector product (positive-definite convention, the
    negated directional derivative of elastic_force_lattice along p):
      dF = sum_i p_i g_i^T, dE = (dF^T F + F^T dF)/2,
      dP = dF M + F (2 mu dE + la tr(dE) I), (H p)_i = det sum_q dP g_iq."""
    F = _deformation(u_lat, g, cells)
    _, _, M = _strain_stress(F, mu, la)
    ps = _cell_slices(p_lat, cells)
    dF = sum(torch.einsum("xyzr,qd->xyzqrd", ps[i], g[i]) for i in range(8))
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    dE = 0.5 * (torch.einsum("...ba,...bc->...ac", dF, F)
                + torch.einsum("...ba,...bc->...ac", F, dF))
    trdE = torch.diagonal(dE, dim1=-2, dim2=-1).sum(-1)
    dM = 2.0 * mu * dE + la * trdE[..., None, None] * eye
    dP = dF @ M + F @ dM
    dPm = dP * _cell_values(cell_mask, cells)[..., None, None, None]
    return _gather_corners(dPm, g, u_lat.shape[:3], det, cells)


def elastic_energy_lattice(u_lat, cell_mask, g, det, mu, la, cells=None):
    """Total StVK energy sum_cells det * sum_q (mu |E|^2 + la/2 tr(E)^2)."""
    F = _deformation(u_lat, g, cells)
    E, trE, _ = _strain_stress(F, mu, la)
    psi = mu * torch.sum(E * E, dim=(-2, -1)) + 0.5 * la * trE * trE
    return torch.sum(psi * _cell_values(cell_mask, cells)[..., None] * det)


def elastic_hessian_diag_lattice(u_lat, cell_mask, g, det, mu, la,
                                 cells=None):
    """Vertex-diagonal 3x3 Hessian blocks (X, Y, Z, 3, 3): per cell, q and
    corner i with a = g_iq and v = F a,
      D_i = det (a^T M a I + (mu + la) v v^T + mu |a|^2 F F^T)."""
    F = _deformation(u_lat, g, cells)
    _, _, M = _strain_stress(F, mu, la)
    C = torch.einsum("...rc,...sc->...rs", F, F)
    X, Y, Z = u_lat.shape[:3]
    out = torch.zeros((X, Y, Z, 3, 3), dtype=u_lat.dtype, device=u_lat.device)
    eye = torch.eye(3, dtype=u_lat.dtype, device=u_lat.device)
    cm = _cell_values(cell_mask, cells)[..., None, None]
    for i in range(8):
        v = torch.einsum("xyzqrc,qc->xyzqr", F, g[i])
        s1 = torch.einsum("qc,xyzqcd,qd->xyzq", g[i], M, g[i])
        gg_q = torch.einsum("qc,qc->q", g[i], g[i])
        Hd = det * (torch.einsum("xyzq,ji->xyzji", s1, eye)
                    + (mu + la) * torch.einsum("xyzqj,xyzqi->xyzji", v, v)
                    + mu * torch.einsum("q,xyzqji->xyzji", gg_q, C))
        _add_to_corner(out, i, Hd * cm, cells)
    return out


# -- structured multigrid transfers: separable trilinear stencils ----------
# Trilinear prolongation is zero-interleaving followed by a separable
# [1/2, 1, 1/2] convolution per axis; restriction ("hat") is its exact
# adjoint: convolve, then keep every other sample. Shifted slices only, no
# gather or scatter.

def _conv_half(x, axis: int):
    """y = x + 0.5 * (x shifted left + x shifted right) along `axis` (zero
    beyond the ends), summed in the reference's order."""
    n = x.shape[axis]
    y = x.clone()
    y.narrow(axis, 0, n - 1).add_(0.5 * x.narrow(axis, 1, n - 1))
    y.narrow(axis, 1, n - 1).add_(0.5 * x.narrow(axis, 0, n - 1))
    return y


def _prolong(xc, shape, ax0: int):
    """prolong_lat on the spatial axes ax0, ax0 + 1, ax0 + 2 of xc."""
    coarse = tuple(xc.shape[ax0:ax0 + 3])
    if shape is None:
        shape = tuple(2 * n - 1 for n in coarse)
    for n, s in zip(coarse, shape):
        if s not in (2 * n - 1, 2 * n):
            raise ValueError(f"fine shape {tuple(shape)} does not fit "
                             f"coarse {tuple(xc.shape)}")
    full = list(xc.shape)
    full[ax0:ax0 + 3] = shape
    z = torch.zeros(full, dtype=xc.dtype, device=xc.device)
    every_other = [slice(None)] * xc.dim()
    every_other[ax0:ax0 + 3] = [slice(None, None, 2)] * 3
    z[tuple(every_other)] = xc
    for ax in range(ax0, ax0 + 3):
        z = _conv_half(z, ax)
    return z


def _restrict(xf, ax0: int):
    """restrict_lat on the spatial axes ax0, ax0 + 1, ax0 + 2 of xf."""
    y = xf
    for ax in range(ax0, ax0 + 3):
        y = _conv_half(y, ax)
    every_other = [slice(None)] * xf.dim()
    every_other[ax0:ax0 + 3] = [slice(None, None, 2)] * 3
    return y[tuple(every_other)].contiguous()


def prolong_lat(xc, shape=None):
    """Trilinear prolongation (Xc, Yc, Zc, C) -> (2Xc-1, 2Yc-1, 2Zc-1, C).

    shape (3-tuple) sets the fine spatial dims per axis: each is 2n-1 (odd
    grids) or 2n (even grids: the last fine plane interpolates only its one
    coarse neighbour, exact where that plane is padding). restrict_lat is
    the adjoint for either parity."""
    return _prolong(xc, shape, 0)


def restrict_lat(xf):
    """Adjoint of prolong_lat ("hat" restriction): convolve, then subsample;
    (X, Y, Z, C) -> (ceil(X/2), ceil(Y/2), ceil(Z/2), C)."""
    return _restrict(xf, 0)


def prolong_lat_cf(xc, shape=None):
    """prolong_lat of a channel-first field (C, Xc, Yc, Zc) -> (C,) + fine
    shape: the same slice sums in the same order, so the values are
    prolong_lat's bit for bit."""
    return _prolong(xc, shape, 1)


def restrict_lat_cf(xf):
    """restrict_lat of a channel-first field (C, X, Y, Z), bit for bit."""
    return _restrict(xf, 1)
