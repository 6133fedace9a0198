"""Mouse picking and dragging: host-side ray selection feeding drag
constraints.

Port of `fem_simulation_tpu/sim/picking.py`. Ray-triangle intersection is a
small numpy computation on the host (selection is a UI event, not a hot
path). It produces the (drag_mask, drag_pos) pair that `DynamicSim` and
`ClothSim` take through `set_drag`. The simulator's positions are read back
with one `.cpu()` copy per call.
"""
from __future__ import annotations

import numpy as np


def ray_triangles(origin: np.ndarray, direction: np.ndarray,
                  x: np.ndarray, tris: np.ndarray):
    """Moller-Trumbore over all triangles; returns (hit_mask, t) per
    triangle."""
    v0 = x[tris[:, 0]]
    e1 = x[tris[:, 1]] - v0
    e2 = x[tris[:, 2]] - v0
    p = np.cross(np.broadcast_to(direction, e1.shape), e2)
    det = np.einsum("td,td->t", e1, p)
    ok = np.abs(det) > 1e-12
    inv = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)
    tv = origin[None, :] - v0
    u = np.einsum("td,td->t", tv, p) * inv
    q = np.cross(tv, e1)
    v = (q @ direction) * inv
    t = np.einsum("td,td->t", q, e2) * inv
    hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > 1e-8)
    return hit, t


class Picker:
    """Stateful drag controller for a DynamicSim or a ClothSim.

    select(): pick the vertex of the closest hit triangle nearest the ray.
    move_select(): move the grab targets of every free vertex within
    sqrt(grab_radius2) of it along the view ray, the drag vector clamped to
    max_drag.
    """

    def __init__(self, sim, tris_mesh_order: np.ndarray,
                 grab_radius2: float = 0.002, max_drag: float = 0.5):
        self.sim = sim
        self.scene = sim.scene
        if hasattr(self.scene, "hier"):     # FEM scene: remap to canonical ids
            self.tris = self.scene.hier.mesh2idx[tris_mesh_order]
            pin = self.scene.params["levels"][0]["pin_mask"]
        else:                                # cloth: identity ordering
            self.tris = np.asarray(tris_mesh_order)
            pin = self.scene.params["pin_mask"]
        self._pin = pin.detach().cpu().numpy()
        self.grab_radius2 = grab_radius2
        self.max_drag = max_drag
        self.select_vertex = -1

    def _x(self):
        return self.sim.state.x.detach().cpu().numpy()

    def select(self, origin, direction) -> bool:
        origin = np.asarray(origin, dtype=np.float64)
        direction = np.asarray(direction, dtype=np.float64)
        direction = direction / np.linalg.norm(direction)
        x = self._x()
        hit, t = ray_triangles(origin, direction, x, self.tris)
        if not hit.any():
            self.select_vertex = -1
            return False
        best = np.argmin(np.where(hit, t, np.inf))
        tri = self.tris[best]
        # nearest corner of the hit triangle by point-line distance
        pts = x[tri]
        d = pts - origin[None, :]
        along = d @ direction
        perp2 = np.einsum("ij,ij->i", d, d) - along ** 2
        self.select_vertex = int(tri[np.argmin(perp2)])
        return True

    def move_select(self, origin, direction):
        if self.select_vertex < 0:
            return
        origin = np.asarray(origin, dtype=np.float64)
        direction = np.asarray(direction, dtype=np.float64)
        direction = direction / np.linalg.norm(direction)
        x = self._x()
        sel = x[self.select_vertex]
        target = origin + float((sel - origin) @ direction) * direction
        drag = target - sel
        n = float(np.linalg.norm(drag))
        if n > self.max_drag:
            drag = drag * (self.max_drag / n)
        d2 = np.einsum("ij,ij->i", x - sel[None, :], x - sel[None, :])
        mask = ((d2 < self.grab_radius2) & (self._pin == 0)).astype(np.float32)
        targets = x + drag[None, :]
        self.sim.set_drag(mask, targets)

    def clear(self):
        self.select_vertex = -1
        self.sim.clear_drag()
