"""Lattice kernels: public wrappers, their plain torch versions, launch counts.

Port of the entry points of `fem_simulation_tpu/ops/pallas_lattice.py`
(`force_cf`, `hvp_cf`, `hess_diag_lattice`, `elastic_energy_lattice`,
`fused_newton`, `fused_pcg`) with the same signatures and layouts. The Pallas kernels
become the CUDA kernels of `csrc/lattice_kernels.cu`.

Dispatch: a wrapper runs its plain version (`*_plain`) only when its tensors
lie on the CPU. For CUDA tensors it launches the kernel or raises; it never
falls back. Every wrapper adds one to `launches[name]` where it launches its
kernel, and nowhere else.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda, ell, stencil
from ..solvers import cg as cgmod

# Useful f32 FLOPs per active cell per call, counted from the unrolled chains
# (per quad point: force 449, hvp 763, diag 930; x 8 quad points).
FORCE_FLOPS_PER_CELL = 449 * 8
HVP_FLOPS_PER_CELL = 763 * 8
DIAG_FLOPS_PER_CELL = 930 * 8

launches = {"force": 0, "hvp": 0, "diag": 0, "energy": 0, "fused_newton": 0,
            "fused_pcg": 0}

_newton_grids: dict = {}
_tables_cache: dict = {}


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _vertex_grid(x_cf: torch.Tensor, cell_mask: torch.Tensor):
    """(X, Y, Z) after checking the channel-first field and the cell mask."""
    if x_cf.dim() != 4 or x_cf.shape[0] != 3:
        raise ValueError(f"expected a (3, X, Y, Z) field, got {tuple(x_cf.shape)}")
    X, Y, Z = (int(s) for s in x_cf.shape[1:])
    if min(X, Y, Z) < 2:
        raise ValueError(f"lattice {X, Y, Z} has no cells")
    _cuda.require(x_cf, (3, X, Y, Z), "field")
    _cuda.require(cell_mask, (X - 1, Y - 1, Z - 1), "cell_mask")
    return X, Y, Z


def _tables(dx: float, device):
    """(g, det): the (8, 8, 3) float32 shape-gradient table and (dx/2)^3,
    built once per dx and device (cached, so never modify g)."""
    key = (dx, str(device))
    if key not in _tables_cache:
        _tables_cache[key] = stencil.lattice_material_tables(dx, device)
    return _tables_cache[key]


def _chain_tail(X, Y, Z, dx, mu, la, device):
    """The trailing C arguments shared by every kernel: X, Y, Z, the host
    g table (cached, so it outlives the call), det, mu, la, stream."""
    g, det = _tables(dx, "cpu")
    stream = torch.cuda.current_stream(device).cuda_stream
    return (X, Y, Z, g.data_ptr(), float(det), float(mu), float(la), stream)


# -- plain torch versions (channel-first wrappers over ops.stencil) ---------


def force_cf_plain(x_cf, cell_mask, dx: float, mu: float, la: float):
    g, det = _tables(dx, x_cf.device)
    f = stencil.elastic_force_lattice(x_cf.permute(1, 2, 3, 0), cell_mask,
                                      g, det, mu, la)
    return f.permute(3, 0, 1, 2).contiguous()


def hvp_cf_plain(x_cf, p_cf, cell_mask, dx: float, mu: float, la: float):
    g, det = _tables(dx, x_cf.device)
    h = stencil.elastic_hvp_lattice(x_cf.permute(1, 2, 3, 0),
                                    p_cf.permute(1, 2, 3, 0), cell_mask,
                                    g, det, mu, la)
    return h.permute(3, 0, 1, 2).contiguous()


def hess_diag_lattice_plain(x_lat, cell_mask, dx: float, mu: float, la: float):
    g, det = _tables(dx, x_lat.device)
    return stencil.elastic_hessian_diag_lattice(x_lat, cell_mask, g, det,
                                                mu, la)


def elastic_energy_lattice_plain(x_lat, cell_mask, dx: float, mu: float,
                                 la: float):
    g, det = _tables(dx, x_lat.device)
    return stencil.elastic_energy_lattice(x_lat, cell_mask, g, det, mu, la)


def _pcg_plain(u, b, cell_mask, ctrl, vert_mask, g, det, mu, la, iterations,
               tol):
    """Block-Jacobi PCG of (H(u) + diag(ctrl)) dx = b on the lattice, with
    the analytic HVP and the ctrl-shifted vertex diagonal; u, b (X, Y, Z, 3).
    Returns (dx (X, Y, Z, 3), k)."""
    vm3 = vert_mask[..., None]
    eye = torch.eye(3, dtype=u.dtype, device=u.device)
    diag = (stencil.elastic_hessian_diag_lattice(u, cell_mask, g, det, mu, la)
            + ctrl[..., None, None] * eye)

    def matvec(p):
        hp = stencil.elastic_hvp_lattice(u, p, cell_mask, g, det, mu, la)
        return (hp + ctrl[..., None] * p) * vm3

    def minv(r):
        return ell.solve3x3(diag, r) * vm3

    return cgmod.pcg_operator(matvec, minv, b, iterations=iterations,
                              tol=float(tol), return_iters=True)


def fused_pcg_plain(u_cf, f_cf, cell_mask, ctrl, vert_mask, dx: float,
                    mu: float, la: float, iterations: int = 50, tol=1e-5):
    """The fused PCG solve as a composition of the plain operators and
    pcg_operator. Returns (dx_cf, k) with k a 0-d int32 tensor."""
    g, det = _tables(dx, u_cf.device)
    dxl, k = _pcg_plain(u_cf.permute(1, 2, 3, 0), f_cf.permute(1, 2, 3, 0),
                        cell_mask, ctrl, vert_mask, g, det, mu, la,
                        iterations, tol)
    return (dxl.permute(3, 0, 1, 2).contiguous(),
            torch.tensor(k, dtype=torch.int32, device=u_cf.device))


def fused_newton_plain(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask, dx: float,
                       mu: float, la: float, iterations: int = 50, tol=1e-5):
    """The fused Newton iteration as a composition of the plain operators:
    residual, ctrl-shifted block-Jacobi PCG with the analytic HVP, and the
    trial-step residual norm. Returns (dx_cf, f_cf, fn_full, k)."""
    g, det = _tables(dx, u_cf.device)
    u = u_cf.permute(1, 2, 3, 0)
    s = s_cf.permute(1, 2, 3, 0)
    vm3 = vert_mask[..., None]
    rc3 = rc[..., None]

    def resid(uu):
        fe = stencil.elastic_force_lattice(uu, cell_mask, g, det, mu, la)
        return (fe + s - rc3 * uu) * vm3

    f = resid(u)
    dxl, k = _pcg_plain(u, f, cell_mask, ctrl, vert_mask, g, det, mu, la,
                        iterations, tol)
    fn = ell.inf_norm(resid(u + dxl * vm3))
    return (dxl.permute(3, 0, 1, 2).contiguous(),
            f.permute(3, 0, 1, 2).contiguous(), fn,
            torch.tensor(k, dtype=torch.int32, device=u.device))


# -- public wrappers ---------------------------------------------------------

def force_cf(x_cf, cell_mask, dx: float, mu: float, la: float):
    """Elastic force of a displacement field; (3, X, Y, Z) -> (3, X, Y, Z)."""
    if _cuda.on_cpu(x_cf, cell_mask):
        return force_cf_plain(x_cf, cell_mask, dx, mu, la)
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    lib = _cuda.load()
    out = torch.empty_like(x_cf)
    cf = torch.empty((24 * cell_mask.numel(),), dtype=torch.float32,
                     device=x_cf.device)
    tail = _chain_tail(X, Y, Z, dx, mu, la, x_cf.device)
    with torch.cuda.device(x_cf.device):
        err = lib.lat_force(x_cf.data_ptr(), cell_mask.data_ptr(),
                            out.data_ptr(), cf.data_ptr(), *tail)
    launches["force"] += 1
    _cuda.check(err, "lat_force")
    return out


def hvp_cf(x_cf, p_cf, cell_mask, dx: float, mu: float, la: float):
    """Elastic Hessian-vector product (positive-definite convention)."""
    if _cuda.on_cpu(x_cf, p_cf, cell_mask):
        return hvp_cf_plain(x_cf, p_cf, cell_mask, dx, mu, la)
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    _cuda.require(p_cf, x_cf.shape, "p_cf")
    lib = _cuda.load()
    out = torch.empty_like(x_cf)
    cf = torch.empty((24 * cell_mask.numel(),), dtype=torch.float32,
                     device=x_cf.device)
    tail = _chain_tail(X, Y, Z, dx, mu, la, x_cf.device)
    with torch.cuda.device(x_cf.device):
        err = lib.lat_hvp(x_cf.data_ptr(), p_cf.data_ptr(),
                          cell_mask.data_ptr(), out.data_ptr(), cf.data_ptr(),
                          *tail)
    launches["hvp"] += 1
    _cuda.check(err, "lat_hvp")
    return out


def hess_diag_lattice(x_lat, cell_mask, dx: float, mu: float, la: float):
    """Vertex-diagonal Hessian blocks: (X, Y, Z, 3) -> (X, Y, Z, 3, 3)."""
    if _cuda.on_cpu(x_lat, cell_mask):
        return hess_diag_lattice_plain(x_lat, cell_mask, dx, mu, la)
    x_cf = x_lat.permute(3, 0, 1, 2).contiguous()
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    lib = _cuda.load()
    d6 = torch.empty((6, X, Y, Z), dtype=torch.float32, device=x_cf.device)
    cd = torch.empty((48 * cell_mask.numel(),), dtype=torch.float32,
                     device=x_cf.device)
    tail = _chain_tail(X, Y, Z, dx, mu, la, x_cf.device)
    with torch.cuda.device(x_cf.device):
        err = lib.lat_diag(x_cf.data_ptr(), cell_mask.data_ptr(),
                           d6.data_ptr(), cd.data_ptr(), *tail)
    launches["diag"] += 1
    _cuda.check(err, "lat_diag")
    d6 = d6.permute(1, 2, 3, 0)                 # (X, Y, Z, 6)
    rows = [torch.stack([d6[..., 0], d6[..., 1], d6[..., 2]], dim=-1),
            torch.stack([d6[..., 1], d6[..., 3], d6[..., 4]], dim=-1),
            torch.stack([d6[..., 2], d6[..., 4], d6[..., 5]], dim=-1)]
    return torch.stack(rows, dim=-2)            # (X, Y, Z, 3, 3)


def elastic_energy_lattice(x_lat, cell_mask, dx: float, mu: float, la: float):
    """Total StVK elastic energy of a displacement field, a 0-d tensor on
    the field's device."""
    if _cuda.on_cpu(x_lat, cell_mask):
        return elastic_energy_lattice_plain(x_lat, cell_mask, dx, mu, la)
    x_cf = x_lat.permute(3, 0, 1, 2).contiguous()
    X, Y, Z = _vertex_grid(x_cf, cell_mask)
    lib = _cuda.load()
    out = torch.empty((), dtype=torch.float32, device=x_cf.device)
    part = torch.empty((lib.lat_energy_partials(X, Y, Z),),
                       dtype=torch.float32, device=x_cf.device)
    tail = _chain_tail(X, Y, Z, dx, mu, la, x_cf.device)
    with torch.cuda.device(x_cf.device):
        err = lib.lat_energy(x_cf.data_ptr(), cell_mask.data_ptr(), out.data_ptr(),
                             part.data_ptr(), *tail)
    launches["energy"] += 1
    _cuda.check(err, "lat_energy")
    return out


def _newton_grid(lib, X, Y, Z, device, pcg: bool = False) -> int:
    key = (str(device), X, Y, Z, pcg)
    if key not in _newton_grids:
        grid = ctypes.c_int(0)
        with torch.cuda.device(device):
            _cuda.check(lib.lat_newton_grid(X, Y, Z, int(pcg), grid),
                        "lat_newton_grid")
        _newton_grids[key] = grid.value
    return _newton_grids[key]


def fused_newton(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask, dx: float,
                 mu: float, la: float, iterations: int = 50, tol=1e-5):
    """One Newton iteration of the implicit step on the dense lattice:
      f   = (f_el(u) + s - rc u) vm
      dx  = block-Jacobi PCG of (H(u) + diag(ctrl)) dx = f
      fn  = ||f(u + dx vm)||_inf
    u_cf, s_cf: (3, X, Y, Z); ctrl, rc, vert_mask: (X, Y, Z). s includes the
    -rc*x0 shift; rc is the residual's linear coefficient (pin + drag +
    m/dt^2, a SUM) and ctrl the Hessian diagonal shift (max(pin, drag) +
    m/dt^2 + (1 - vm)). Returns (dx_cf, f_cf, fn_full, k) with fn_full a
    0-d float32 and k a 0-d int32 tensor (matvecs executed = k - 1)."""
    if _cuda.on_cpu(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask):
        return fused_newton_plain(u_cf, s_cf, cell_mask, ctrl, rc, vert_mask,
                                  dx, mu, la, iterations, tol)
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    _cuda.require(s_cf, u_cf.shape, "s_cf")
    for name, t in (("ctrl", ctrl), ("rc", rc), ("vert_mask", vert_mask)):
        _cuda.require(t, (X, Y, Z), name)
    lib = _cuda.load()
    dev = u_cf.device
    grid = _newton_grid(lib, X, Y, Z, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dxc = torch.empty_like(u_cf)
    fc = torch.empty_like(u_cf)
    fn = torch.empty((), **f32)
    k = torch.empty((), dtype=torch.int32, device=dev)
    r = torch.empty_like(u_cf)
    p = torch.empty_like(u_cf)
    ap = torch.empty_like(u_cf)
    d6 = torch.empty((6, X, Y, Z), **f32)
    ncell = cell_mask.numel()
    cf = torch.empty((24 * ncell,), **f32)
    cd = torch.empty((48 * ncell,), **f32)
    part = torch.empty((7 * grid,), **f32)
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    ptrs = [t.data_ptr() for t in (u_cf, s_cf, cell_mask, ctrl, rc, vert_mask,
                              dxc, fc, fn, k, r, p, ap, d6, cf, cd, part)]
    with torch.cuda.device(dev):
        err = lib.lat_fused_newton(float(tol), *ptrs, grid, *tail[:-1],
                                   int(iterations), tail[-1])
    launches["fused_newton"] += 1
    _cuda.check(err, "lat_fused_newton")
    return dxc, fc, fn, k


def fused_pcg(u_cf, f_cf, cell_mask, ctrl, vert_mask, dx: float, mu: float,
              la: float, iterations: int = 50, tol=1e-5):
    """One-launch block-Jacobi PCG solve of (H(u) + diag(ctrl)) dx = f on
    the dense lattice (pcg_operator semantics, normalized RHS).
    u_cf, f_cf: (3, X, Y, Z) displacement and right-hand side; ctrl,
    vert_mask: (X, Y, Z); tol a float or a 0-d tensor. Returns (dx_cf, k)
    with k a 0-d int32 tensor (matvecs executed = k - 1); a zero RHS gives
    dx == 0 and k == 1."""
    if _cuda.on_cpu(u_cf, f_cf, cell_mask, ctrl, vert_mask):
        return fused_pcg_plain(u_cf, f_cf, cell_mask, ctrl, vert_mask, dx, mu,
                               la, iterations, tol)
    X, Y, Z = _vertex_grid(u_cf, cell_mask)
    _cuda.require(f_cf, u_cf.shape, "f_cf")
    for name, t in (("ctrl", ctrl), ("vert_mask", vert_mask)):
        _cuda.require(t, (X, Y, Z), name)
    lib = _cuda.load()
    dev = u_cf.device
    grid = _newton_grid(lib, X, Y, Z, dev, pcg=True)
    f32 = dict(dtype=torch.float32, device=dev)
    dxc = torch.empty_like(u_cf)
    k = torch.empty((), dtype=torch.int32, device=dev)
    r = torch.empty_like(u_cf)
    p = torch.empty_like(u_cf)
    ap = torch.empty_like(u_cf)
    d6 = torch.empty((6, X, Y, Z), **f32)
    ncell = cell_mask.numel()
    cf = torch.empty((24 * ncell,), **f32)
    cd = torch.empty((48 * ncell,), **f32)
    part = torch.empty((7 * grid,), **f32)
    tail = _chain_tail(X, Y, Z, dx, mu, la, dev)
    ptrs = [t.data_ptr() for t in (u_cf, f_cf, cell_mask, ctrl, vert_mask,
                                   dxc, k, r, p, ap, d6, cf, cd, part)]
    with torch.cuda.device(dev):
        err = lib.lat_fused_pcg(float(tol), *ptrs, grid, *tail[:-1],
                                int(iterations), tail[-1])
    launches["fused_pcg"] += 1
    _cuda.check(err, "lat_fused_pcg")
    return dxc, k
