"""Scene: the multigrid FEM scene of the unstructured path (params + topology).

Port of `fem_simulation_tpu/sim/scene.py`. The JAX params pytree becomes a
plain dict of tensors on the scene's device with the same keys:
{"levels": [per-level dict], "transfers": [per-transfer dict]}. The rest
tables (det, g, mass) are computed once on the CPU in float32 and moved to
the device, so every device starts from the same numbers. Each transfer
also holds "galerkin_plan", the gather plan of `ops.transfer.galerkin`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import device_or_cuda
from .. import hierarchy as hl
from .. import mesh as meshlib
from ..config import MaterialConfig, SolverConfig
from ..ops import elastic, transfer
from ..solvers.smoothers import EllOperator

_TRANSFER_KEYS = ("p_idx", "p_w", "p_w_norm", "r_idx", "r_w", "r_w_norm",
                  "g_src", "g_dst", "g_w", "t_w", "t_w_norm", "t_fine_slot",
                  "t_coarse_slot", "t_rows", "t_cols")


def default_pins(mesh: meshlib.HexMesh) -> np.ndarray:
    """Pin the top slab: y >= ymax - dx - 1e-5."""
    y = mesh.x[:, 1]
    return np.nonzero(y >= y.max() - mesh.dx - 1e-5)[0].astype(np.int32)


def params_from_numpy(params, device=None):
    """The port's params dict on `device` (the GPU by default) from a params
    pytree of numpy arrays (e.g. the JAX `Scene.params` read back with
    np.asarray), with every transfer's Galerkin gather plan added."""
    device = device_or_cuda(device)

    def t(a):
        return torch.from_numpy(np.array(a, order="C")).to(device)

    out = {"levels": [{k: t(v) for k, v in lvl.items()}
                      for lvl in params["levels"]],
           "transfers": []}
    for tr in params["transfers"]:
        d = {k: t(v) for k, v in tr.items()}
        d["galerkin_plan"] = [
            tuple(t(a) for a in tier) for tier in transfer.galerkin_plan(
                np.asarray(tr["g_src"]), np.asarray(tr["g_dst"]),
                np.asarray(tr["g_w"]))]
        out["transfers"].append(d)
    return out


class Scene:
    """The static topology + parameter dict for one mesh on `device` (the GPU
    unless another device is given; device="cpu" runs the plain versions).

    Canonical vertex order everywhere is the color-sorted order; use
    `to_mesh_order` / `from_mesh_order` at the I/O boundary.
    """

    def __init__(self, mesh: meshlib.HexMesh,
                 material: MaterialConfig = MaterialConfig(),
                 solver: SolverConfig = SolverConfig(),
                 pins=None, pad_to: int = 1, device=None):
        self.device = device_or_cuda(device)
        self.mesh = mesh
        self.material = material
        self.solver = solver
        self.hier = hl.build_hierarchy(mesh, solver.n_levels, solver.max_levels,
                                       pad_to=pad_to)
        self.n_levels = self.hier.n_levels

        if pins is None or len(pins) == 0:
            pins = default_pins(mesh)
        pins = np.asarray(pins, dtype=np.int64)
        pin_mask = np.zeros(mesh.n_verts, dtype=np.float32)
        pin_mask[pins] = 1.0
        # canonical order (+ phantom padding rows, never pinned)
        pin_mask = pin_mask[self.hier.idx2mesh]
        n0 = self.hier.levels[0].n_verts
        if n0 > pin_mask.size:
            pin_mask = np.concatenate(
                [pin_mask, np.zeros(n0 - pin_mask.size, np.float32)])

        params = {"levels": [], "transfers": []}
        for li, lvl in enumerate(self.hier.levels):
            # rest tables on the CPU in float32
            x0 = torch.from_numpy(lvl.x0)
            hexes = torch.from_numpy(lvl.hexes)
            det, g, vol = elastic.prepare(x0, hexes)
            mass = elastic.lumped_mass(vol, hexes, lvl.n_verts,
                                       material.density)
            vc_idx, vc_mask = elastic.vertex_contrib_map(lvl.hexes, lvl.n_verts)
            p = dict(
                x0=lvl.x0, hexes=lvl.hexes, det=det.numpy(), g=g.numpy(),
                mass=mass.numpy(), vc_idx=vc_idx, vc_mask=vc_mask,
                hex_slot=lvl.hex_slot.reshape(-1),
                contrib_idx=lvl.contrib_idx,
                contrib_mask=lvl.contrib_mask.astype(np.float32),
                nbr=lvl.nbr, mask=lvl.nbr_mask.astype(np.float32),
                diag_slot=lvl.diag_slot,
            )
            if li == 0:
                p["pin_mask"] = pin_mask
                p["pin_pos"] = lvl.x0   # rest positions are the pin targets
            params["levels"].append(p)

        for ti, tr in enumerate(self.hier.transfers):
            t = {k: getattr(tr, k) for k in _TRANSFER_KEYS}
            # Coarse-diagonal pin compensation for re-discretized (FAS)
            # coarse operators: control_mag * sum_{v pinned} P[v, c]^2 at
            # coarse vertex c, level 0 -> 1 only.
            if ti == 0:
                nc = self.hier.levels[1].n_verts
                fd = np.zeros(nc, dtype=np.float32)
                w2 = tr.p_w ** 2 * pin_mask[:, None]
                np.add.at(fd, tr.p_idx.reshape(-1), w2.reshape(-1))
                t["fix_diag"] = fd * np.float32(material.control_mag)
            params["transfers"].append(t)
        self.params = params_from_numpy(params, self.device)

    # -- static helpers -----------------------------------------------------
    def level(self, li: int) -> hl.LevelTopology:
        return self.hier.levels[li]

    def make_op(self, li: int, params=None) -> EllOperator:
        """The ELL operator view of level li."""
        p = (params or self.params)["levels"][li]
        return EllOperator(p["nbr"], p["mask"], p["diag_slot"],
                           self.hier.levels[li].color_offsets)

    # -- I/O order conversion ----------------------------------------------
    def to_mesh_order(self, x):
        """Canonical (possibly padded) -> original mesh vertex order (numpy)."""
        n = self.hier.idx2mesh.size
        xa = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
        out = np.zeros((n,) + xa.shape[1:], dtype=xa.dtype)
        out[self.hier.idx2mesh] = xa[:n]
        return out

    def from_mesh_order(self, x):
        """Original mesh order -> canonical order (zero-filled padding), a
        tensor on the scene's device."""
        xa = np.asarray(x)[self.hier.idx2mesh]
        n0 = self.hier.levels[0].n_verts
        if n0 > xa.shape[0]:
            xa = np.concatenate(
                [xa, np.zeros((n0 - xa.shape[0],) + xa.shape[1:], xa.dtype)])
        return torch.from_numpy(np.ascontiguousarray(xa)).to(self.device)

    @property
    def x0(self):
        return self.params["levels"][0]["x0"]
