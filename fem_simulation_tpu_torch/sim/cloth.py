"""Mass-spring cloth simulation (implicit Euler, single level).

Port of `fem_simulation_tpu/sim/cloth.py`: the same (res_x+1) x (res_y+1)
grid with horizontal, vertical and shear edges, the same block-ELL topology
and (edge -> 4 slots) map, the reference's fixed 5-iteration CG frame
(`step`) and the Newton frame solved to ||f||_inf <= tol (`step_to_tol`).
The Newton loop runs on the host and reads the residual norm once per
iteration; every matvec is the block-ELL SpMV (`ops/ell.spmv`, the
`ell_spmv` kernel on CUDA tensors).

The spring force and Hessian sum their per-edge terms through gather
tables built here once per scene (`ops/spring.gather_table`), in the
reference's scatter order, so a frame repeats its bits on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device_or_cuda
from ..config import ClothConfig
from ..ops import ell, spring
from ..solvers import cg as cgmod


class ClothOperator(NamedTuple):
    """The ELL view the cloth's CG solves need. The grid's one color class
    is no independent set, so the cloth runs no Gauss-Seidel and needs no
    `smoothers.EllOperator`."""
    nbr: torch.Tensor        # (N, K) int32
    mask: torch.Tensor       # (N, K) float32
    diag_slot: torch.Tensor  # (N,) int32


def params_from_numpy(params, device=None):
    """The port's cloth params on `device` (the GPU by default) from a dict
    of numpy arrays with the JAX `ClothScene.params` keys (e.g. that dict
    read back with np.asarray), with the force and Hessian gather tables
    added ("f_table", "h_table")."""
    device = device_or_cuda(device)

    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)

    out = {k: t(v) for k, v in params.items()}
    n, kk = np.asarray(params["nbr"]).shape
    edges = np.asarray(params["edges"])
    out["f_table"] = t(spring.gather_table(
        np.concatenate([edges[:, 0], edges[:, 1]]), n))
    out["h_table"] = t(spring.gather_table(
        np.asarray(params["edge_slot"]).reshape(-1), n * kk))
    return out


class ClothScene:
    """Static topology + params of a cloth grid on `device` (the GPU unless
    another device is given; device="cpu" runs the plain versions)."""

    def __init__(self, cfg: ClothConfig = ClothConfig(), pins=None,
                 device=None):
        self.device = device_or_cuda(device)
        self.cfg = cfg
        rx, ry = cfg.res_x, cfg.res_y
        nvx, nvy = rx + 1, ry + 1
        n = nvx * nvy

        def vid(i, j):
            return i * nvx + j

        edges = []
        # horizontal, vertical, shear
        for i in range(nvy):
            for j in range(rx):
                edges.append((vid(i, j), vid(i, j + 1)))
        for j in range(nvx):
            for i in range(ry):
                edges.append((vid(i, j), vid(i + 1, j)))
        for i in range(ry):
            for j in range(rx):
                edges.append((vid(i, j), vid(i + 1, j + 1)))
        edges = np.asarray(edges, dtype=np.int64)
        e = edges.shape[0]

        # positions: grid in the x-z plane at y = 1 (hanging under gravity)
        ii, jj = np.meshgrid(np.arange(nvy), np.arange(nvx), indexing="ij")
        x0 = np.stack([
            jj.reshape(-1) * cfg.size / rx,
            np.ones(n),
            ii.reshape(-1) * cfg.size / ry,
        ], axis=-1).astype(np.float32)

        # ELL adjacency from edges (+ self)
        pairs = np.concatenate([
            np.stack([edges[:, 0], edges[:, 1]], 1),
            np.stack([edges[:, 1], edges[:, 0]], 1),
            np.stack([np.arange(n), np.arange(n)], 1),
        ])
        pairs = np.unique(pairs, axis=0)
        r, c = pairs[:, 0], pairs[:, 1]
        deg = np.bincount(r, minlength=n)
        K = int(deg.max())
        nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, K))
        mask = np.zeros((n, K), dtype=bool)
        start = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(deg, out=start[1:])
        slot = np.arange(pairs.shape[0]) - start[r]
        nbr[r, slot] = c.astype(np.int32)
        mask[r, slot] = True
        diag_slot = slot[r == c].astype(np.int32)

        def find_slot(rr, cc):
            return np.argmax(nbr[rr] == np.asarray(cc, np.int32)[:, None],
                             axis=1)

        i0, i1 = edges[:, 0], edges[:, 1]
        edge_slot = np.stack([
            i0 * K + find_slot(i0, i0),
            i0 * K + find_slot(i0, i1),
            i1 * K + find_slot(i1, i0),
            i1 * K + find_slot(i1, i1),
        ], axis=1).astype(np.int32)

        self.n_verts = n
        self.n_edges = e
        self.K = K
        pin_mask = np.zeros(n, dtype=np.float32)
        if pins is not None:
            pin_mask[np.asarray(pins, dtype=np.int64)] = 1.0

        l0 = np.linalg.norm(x0[edges[:, 0]] - x0[edges[:, 1]], axis=-1)
        # lumped mass: uniform
        mass = np.full(n, 1.0 / n, dtype=np.float32)

        self.params = params_from_numpy(dict(
            x0=x0,
            edges=edges.astype(np.int32),
            l0=l0.astype(np.float32),
            mass=mass,
            nbr=nbr,
            mask=mask.astype(np.float32),
            diag_slot=diag_slot,
            edge_slot=edge_slot,
            pin_mask=pin_mask,
            pin_pos=x0,
        ), self.device)

    def make_op(self, params=None) -> ClothOperator:
        p = params or self.params
        return ClothOperator(p["nbr"], p["mask"], p["diag_slot"])


class ClothState(NamedTuple):
    x: torch.Tensor          # (N, 3)
    v: torch.Tensor          # (N, 3)
    drag_mask: torch.Tensor  # (N,) 1.0 where grabbed
    drag_pos: torch.Tensor   # (N, 3) grab targets


def init_state(scene: ClothScene) -> ClothState:
    x0 = scene.params["x0"]
    return ClothState(x=x0, v=torch.zeros_like(x0),
                      drag_mask=torch.zeros(x0.shape[0], dtype=x0.dtype,
                                            device=x0.device),
                      drag_pos=x0)


def state_from_numpy(x, v, drag_mask, drag_pos, device=None) -> ClothState:
    """A ClothState on `device` (the GPU by default) from numpy arrays (e.g.
    a JAX ClothState read back with np.asarray)."""
    device = device_or_cuda(device)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(device)
    return ClothState(x=t(x), v=t(v), drag_mask=t(drag_mask),
                      drag_pos=t(drag_pos))


def state_to_numpy(st: ClothState):
    """(x, v, drag_mask, drag_pos) as float32 numpy arrays."""
    return tuple(a.detach().cpu().numpy() for a in st)


def _frame_diag(scene: ClothScene, params, st: ClothState, inv_dt):
    """m/h^2 + pin/drag control, as (N, 3, 3) diagonal blocks."""
    ctrl = (params["mass"] * inv_dt * inv_dt
            + scene.cfg.control_mag * torch.maximum(params["pin_mask"],
                                                    st.drag_mask))
    return ctrl[:, None, None] * torch.eye(3, dtype=st.x.dtype,
                                           device=st.x.device)


def _frame_force(scene: ClothScene, params, st: ClothState, xx, x_tilde,
                 inv_dt, gravity):
    """Implicit-step residual: spring + gravity + pin/drag penalty +
    inertia."""
    cfg = scene.cfg
    f = spring.force(xx, params["edges"], params["l0"], cfg.k,
                     params["f_table"])
    f = torch.stack([f[:, 0], f[:, 1] + params["mass"] * gravity, f[:, 2]],
                    dim=1)
    f = f + cfg.control_mag * params["pin_mask"][:, None] \
        * (params["pin_pos"] - xx)
    f = f + cfg.control_mag * st.drag_mask[:, None] * (st.drag_pos - xx)
    return f - (params["mass"] * inv_dt * inv_dt)[:, None] * (xx - x_tilde)


def _frame_hessian(scene: ClothScene, params, xx, diag_ctrl):
    vals = spring.assemble_hessian_ell(xx, params["edges"], params["l0"],
                                       scene.cfg.k, params["h_table"],
                                       scene.n_verts, scene.K)
    return ell.add_to_diag(vals, params["diag_slot"], diag_ctrl)


def step(scene: ClothScene, params, st: ClothState,
         gravity: float = -9.8 / 2.0) -> ClothState:
    """One cloth frame as the reference runs it: predictor, one assembly,
    5 CG iterations, velocity update."""
    cfg = scene.cfg
    inv_dt = 1.0 / cfg.dt
    x_old = st.x
    v = st.v * cfg.damping
    x = st.x + v * cfg.dt
    x_tilde = x

    vals = _frame_hessian(scene, params, x,
                          _frame_diag(scene, params, st, inv_dt))
    f = _frame_force(scene, params, st, x, x_tilde, inv_dt, gravity)
    dx = cgmod.cg(scene.make_op(params), vals, f, iterations=5, tol=1e-5)
    x = x + dx
    v = (x - x_old) * inv_dt
    return st._replace(x=x, v=v)


def step_to_tol(scene: ClothScene, params, st: ClothState,
                tol: float = 1e-4, max_newton: int = 20,
                cg_iterations: int = 30, gravity: float = -9.8 / 2.0):
    """One cloth frame solved to ||f||_inf <= tol: Newton, re-assembling the
    position-dependent spring Hessian every iteration, each linear solve a
    block-Jacobi PCG (relative tolerance 1e-2). Returns
    (state, newton_iters, final ||f||_inf as a float)."""
    cfg = scene.cfg
    inv_dt = 1.0 / cfg.dt
    x_old = st.x
    v = st.v * cfg.damping
    x = st.x + v * cfg.dt
    x_tilde = x
    op = scene.make_op(params)
    diag_ctrl = _frame_diag(scene, params, st, inv_dt)
    rows = torch.arange(scene.n_verts, device=x.device)
    slots = params["diag_slot"].long()

    def resid(xx):
        return _frame_force(scene, params, st, xx, x_tilde, inv_dt, gravity)

    def newton_iteration(xx):
        vals = _frame_hessian(scene, params, xx, diag_ctrl)
        f = resid(xx)
        full = vals * op.mask[..., None, None]
        diag = vals[rows, slots]
        dx = cgmod.pcg_operator(
            lambda p: ell.spmv(full, op.nbr, op.mask, p),
            lambda r: ell.solve3x3(diag, r), f,
            iterations=cg_iterations, tol=1e-2)
        return xx + dx

    cond = cgmod.newton_cond(tol, max_newton)
    fn = np.float32(ell.inf_norm(resid(x)).item())
    fmin = fn
    k = 0
    while cond((x, k, fn, fmin)):
        x = newton_iteration(x)
        fn = np.float32(ell.inf_norm(resid(x)).item())
        k += 1
        fmin = np.minimum(fmin, fn)
    v = (x - x_old) * inv_dt
    return st._replace(x=x, v=v), k, cgmod.newton_exit_norm(fn, fmin)


class ClothSim:
    """User-facing cloth simulator on `device` (the GPU by default)."""

    def __init__(self, cfg: ClothConfig = ClothConfig(), pins=None,
                 device=None):
        self.scene = ClothScene(cfg, pins=pins, device=device)
        self.state = init_state(self.scene)

    def frame(self) -> ClothState:
        self.state = step(self.scene, self.scene.params, self.state)
        return self.state

    def set_drag(self, mask, targets):
        dev, dt = self.state.x.device, self.state.x.dtype
        self.state = self.state._replace(
            drag_mask=torch.as_tensor(mask, dtype=dt, device=dev),
            drag_pos=torch.as_tensor(targets, dtype=dt, device=dev))

    def clear_drag(self):
        self.state = self.state._replace(
            drag_mask=torch.zeros_like(self.state.drag_mask))

    def triangles(self):
        """Render/pick triangles of the cloth grid (2 per quad)."""
        rx, ry = self.scene.cfg.res_x, self.scene.cfg.res_y
        tris = []
        for i in range(ry):
            for j in range(rx):
                a = i * (rx + 1) + j
                b = a + 1
                c = a + (rx + 1)
                d = c + 1
                tris += [[a, b, c], [b, d, c]]
        return np.asarray(tris, np.int32)
