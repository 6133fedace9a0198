"""Cover of a sparse voxel mask by active tiles: the low-fill lattice path.

Counterpart of `fem_simulation_tpu/ops/boxes.py`. The JAX package covers
the real cells of a sparse mask (shells, thin plates, multi-part scenes)
with tight boxes and runs every elastic op box by box, so that its cost
follows the cell count and not the volume of the bounding box. Its cost
model is the padded volume under the TPU's (8, 128) tile quantum, and each
box is axis-permuted to put its longest extent on the 128 lanes.

This card's kernels already cut the lattice into tiles of vertices
(`tile_of` in `csrc/lattice_kernels.cu`, `tile_axis` in
`ops/lattice_kernels.py`). So the cover here is two lists, built once on
the host from the static cell mask:

* the real cells, sorted: the two-pass cell passes and the energy walk
  compute these only;
* for a tiling, the active tiles, sorted: those whose vertices touch a real
  cell (the cells a halo tile computes). The one-launch kernels walk these
  only. Every real vertex lies in an active tile, and an inactive tile's
  vertices get zero. The fused Newton kernel's PCG updates walk the body's
  vertices too (`vm` != 0), not the whole lattice.

Each op stays one launch, as on the dense grid: no launch per box. The
result is what the box path computes: a partition of the real cells, then
vertex sums over each vertex's incident cells. The force and the Newton
residual equal the dense kernels' up to the sign of zero; the energy, and
the fused Newton kernel's dots where its plan over the cover is not the
dense plan, sum in another float order.

The launch plans are made over the cover (`ops/lattice_kernels`:
`newton_tiling`, `force_plan`, `energy_plan` with `cover=`) and cached
here, on the cover, per SM count.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import lattice_kernels as lk
from . import stencil

# SMs of the card the engage rule is modelled for where a scene has no CUDA
# device (an H100 SXM): a CPU scene engages the cover as the card would.
PLAN_SMS = 132


class Cover:
    """The active-tile cover of a cell mask (X-1, Y-1, Z-1) on the host.

    `cells`: the real cells' flat indices, sorted (int32). `shape`: the
    vertex lattice. `key`: a digest of the mask, naming the cover's kept
    workspaces. `plans`: launch plans over the cover, keyed (kernel, SMs);
    a test or a measurement puts another plan under a key to run it."""

    def __init__(self, cell_mask):
        cm = np.asarray(cell_mask) > 0
        self.shape = tuple(int(n) + 1 for n in cm.shape)
        self.cells = np.flatnonzero(cm).astype(np.int32)
        self.grid_cells = int(cm.size)
        self.key = hashlib.sha1(np.packbits(cm).tobytes()
                                + str(cm.shape).encode()).hexdigest()[:16]
        # sat[a, b, c]: real cells in [0, a) x [0, b) x [0, c)
        sat = np.zeros(tuple(n + 1 for n in cm.shape), np.int64)
        sat[1:, 1:, 1:] = cm.cumsum(0).cumsum(1).cumsum(2)
        self._sat = sat
        self.plans: dict = {}
        self._orders: dict = {}
        self._tensors: dict = {}
        self._walked = None

    @property
    def sparse(self) -> bool:
        """True when some cell of the bounding lattice is empty."""
        return self.cells.size < self.grid_cells

    def _ranges(self, axis: int, nt: int):
        """(c0, c1): the halo cell range [c0, c1) of each of nt tiles along
        `axis` (lattice_kernels.tile_axis)."""
        rows = [lk.tile_axis(self.shape[axis], nt, it) for it in range(nt)]
        c0 = np.array([r[2] for r in rows], np.int64)
        return c0, c0 + np.array([r[3] for r in rows], np.int64)

    def _box_counts(self, ntx: int, nty: int):
        """counts[ix, iy, z]: real cells of tile column (ix, iy)'s halo
        cells in x and y, over cells [0, z) in z."""
        S = self._sat
        x0, x1 = self._ranges(0, ntx)
        y0, y1 = self._ranges(1, nty)
        return (S[x1][:, y1] - S[x0][:, y1] - S[x1][:, y0] + S[x0][:, y0])

    def active_counts(self, ntx: int, nty: int, ntzs) -> np.ndarray:
        """Active tiles of each tiling (ntx, nty, ntz) for ntz in ntzs."""
        ntzs = list(ntzs)
        cols = self._box_counts(ntx, nty)
        z0, z1 = zip(*(self._ranges(2, nt) for nt in ntzs))
        lo, hi = np.concatenate(z0), np.concatenate(z1)
        per_range = ((cols[:, :, hi] - cols[:, :, lo]) > 0).sum(axis=(0, 1))
        starts = np.cumsum([0] + ntzs[:-1])
        return np.add.reduceat(per_range, starts)

    def tiles(self, ntx: int, nty: int, ntz: int):
        """(order, n_active): every tile index (ix * nty + iy) * ntz + iz
        of the tiling, the active ones first, each part sorted (int32);
        made once per tiling."""
        key = (ntx, nty, ntz)
        if key not in self._orders:
            cols = self._box_counts(ntx, nty)
            z0, z1 = self._ranges(2, ntz)
            active = (cols[:, :, z1] - cols[:, :, z0] > 0).reshape(-1)
            order = np.concatenate([np.flatnonzero(active),
                                    np.flatnonzero(~active)])
            self._orders[key] = (order.astype(np.int32), int(active.sum()))
        return self._orders[key]

    def cost_ratio(self, sms: int) -> float:
        """The fused Newton kernel's modelled cell-pass time under its
        covered plan over that under the dense plan, on a card of `sms`
        SMs (lattice_kernels.newton_tiling): the engage rule of the JAX
        package (sim/lattice.py:113-119) in this card's terms. As the JAX
        padded volume counts the cells a box computes and no fixed cost,
        the model's grid barriers, the same on both sides, are left out."""
        X, Y, Z = self.shape
        _, dense = lk.newton_tiling(X, Y, Z, sms)
        _, covered = lk.newton_tiling(X, Y, Z, sms, cover=self)
        return covered / dense

    def walked(self, vert_mask, count=None) -> int:
        """The vertices with vert_mask != 0: those the fused Newton kernel's
        PCG updates walk under this cover. Kept for the last mask counted,
        so that the scene's, given once with its `count`, costs nothing
        after; another mask costs one sync."""
        kept = self._walked
        if (kept is None or kept[0] is not vert_mask
                or kept[1] != vert_mask._version):
            n = (int(torch.count_nonzero(vert_mask)) if count is None
                 else int(count))
            self._walked = kept = (vert_mask, vert_mask._version, n)
        return kept[2]

    def tensor(self, name: str, device, make):
        """make() as an int32 tensor on `device`, made once per name and
        device."""
        key = (name, str(device))
        if key not in self._tensors:
            self._tensors[key] = torch.from_numpy(
                np.ascontiguousarray(make(), np.int32)).to(device)
        return self._tensors[key]

    def cell_list(self, device) -> stencil.CellList:
        """The real cells as a stencil.CellList on `device` (the plain
        versions' form), made once per device."""
        key = ("cell_list", str(device))
        if key not in self._tensors:
            self._tensors[key] = stencil.cell_list(self.cells, self.shape,
                                                   device)
        return self._tensors[key]
