"""What the benchmark derives from a body's arrays by itself, in numpy.

The lattice a body lies on (each vertex at ijk - min ijk), the vertices
pinned by the configuration (the top slab: rest y >= max y - dx - 1e-5,
the two highest vertex layers), the lumped masses (each vertex gets
density * dx^3 from every real cell it is a corner of) and the free
vertices (real and not pinned). The traffic generator draws its noise on
the free vertices, and the plain reference builds its model from these
arrays; neither takes anything the program derived.
"""
from __future__ import annotations

import numpy as np


class Geometry:
    def __init__(self, body: dict, material: dict):
        ijk = np.asarray(body["ijk"], np.int64)
        lo = ijk.min(axis=0)
        self.lat = ijk - lo                                   # (N, 3)
        self.shape = tuple(int(n) for n in ijk.max(axis=0) - lo + 1)
        self.x0 = np.asarray(body["x"], np.float32)           # (N, 3)
        self.hexes = np.asarray(body["hexes"], np.int64)      # (H, 8)
        self.dx = float(body["dx"])
        n = self.x0.shape[0]
        y = self.x0[:, 1].astype(np.float64)
        self.pinned = y >= y.max() - self.dx - 1e-5           # (N,)
        incident = np.bincount(self.hexes.ravel(), minlength=n)
        self.mass = float(material["density"]) * self.dx ** 3 * incident
        self.n_verts = n
        self.n_cells = self.hexes.shape[0]

    def to_lattice(self, a: np.ndarray) -> np.ndarray:
        """Per-vertex rows (N, C) scattered onto a zero lattice
        (X, Y, Z, C)."""
        out = np.zeros(self.shape + a.shape[1:], dtype=a.dtype)
        out[self.lat[:, 0], self.lat[:, 1], self.lat[:, 2]] = a
        return out

    def rest_lattice(self) -> np.ndarray:
        """The rest positions on the lattice (X, Y, Z, 3), zero off the
        body."""
        return self.to_lattice(self.x0)

    def free_lattice(self) -> np.ndarray:
        """(X, Y, Z) float32: 1 at the real vertices that are not pinned."""
        free = (~self.pinned).astype(np.float32)[:, None]
        return self.to_lattice(free)[..., 0]

    def real_lattice(self) -> np.ndarray:
        """(X, Y, Z) float32: 1 at the body's vertices."""
        return self.to_lattice(np.ones((self.n_verts, 1), np.float32))[..., 0]
