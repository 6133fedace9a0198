"""The benchmark's voxel bodies: procedural beams and hollow boxes.

A frozen copy of `fem_simulation_tpu_torch/mesh.py` (`beam`, `shell`,
`hex_mesh_from_cells`, `CORNER_OFFSETS`) as it stood when the benchmark was
defined, so that a later change to the program cannot change the bodies the
benchmark measures. The benchmark makes the arrays here and hands the same
ones to the program (as its `HexMesh`) and to the plain reference.

Bodies are plain dicts of numpy arrays:
  x      (N, 3) float32 rest positions, origin + ijk * dx
  hexes  (H, 8) int32 corner vertex ids, local corner 4*di + 2*dj + dk
  ijk    (N, 3) int64 lattice coordinates
  dx     lattice spacing
  origin (3,) float64
"""
from __future__ import annotations

import numpy as np

CORNER_OFFSETS = np.array(
    [[i, j, k] for i in range(2) for j in range(2) for k in range(2)],
    dtype=np.int64)


def hex_mesh_from_cells(cells, dx: float, origin) -> dict:
    """The body of the integer lattice cells (C, 3)."""
    cells = np.asarray(cells, dtype=np.int64)
    corners = cells[:, None, :] + CORNER_OFFSETS[None, :, :]
    uniq, inv = np.unique(corners.reshape(-1, 3), axis=0, return_inverse=True)
    origin = np.asarray(origin, dtype=np.float64)
    return dict(x=(origin[None, :] + uniq * dx).astype(np.float32),
                hexes=inv.reshape(-1, 8).astype(np.int32), ijk=uniq,
                dx=float(dx), origin=origin)


def beam(nx: int, ny: int, nz: int, dx: float = 0.05,
         origin=(0.0, 0.0, 0.0)) -> dict:
    """A solid beam of nx * ny * nz voxels."""
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    return hex_mesh_from_cells(cells, dx, origin)


def shell(nx: int, ny: int, nz: int, thickness: int = 2, dx: float = 0.05,
          origin=(0.0, 0.0, 0.0)) -> dict:
    """A hollow box: an nx * ny * nz voxel block with its interior carved
    out, walls `thickness` cells thick."""
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    t = thickness
    interior = ((ii >= t) & (ii < nx - t) & (jj >= t) & (jj < ny - t)
                & (kk >= t) & (kk < nz - t))
    cells = np.stack([ii, jj, kk], axis=-1)[~interior]
    return hex_mesh_from_cells(cells, dx, origin)


GENERATORS = {"beam": beam, "shell": shell}


def body(spec: dict) -> dict:
    """The body a configuration's "mesh" entry names: {"generator": "beam"
    or "shell", "cells": [nx, ny, nz], "dx": ..., "thickness": (shell)}."""
    kw = {"dx": float(spec["dx"])}
    if "thickness" in spec:
        kw["thickness"] = int(spec["thickness"])
    cells = (int(n) for n in spec["cells"])
    return GENERATORS[spec["generator"]](*cells, **kw)
