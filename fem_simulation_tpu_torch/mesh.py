"""Mesh ingestion: OBJ loading, voxelization into hex meshes, surface extraction.

The port's own copy of `fem_simulation_tpu/mesh.py` (numpy only; the port
imports nothing of the JAX package). Voxelization is a vectorized numpy
ray-parity test (host-side, init-only), and the hex corner convention is
local corner index = 4*di + 2*dj + dk for offset (di,dj,dk) in {0,1}^3
(matching the trilinear shape-function table layout). The JAX package's
optional C++ inside test is left out: its output equals the numpy path.
"""
from __future__ import annotations

import dataclasses
import numpy as np

# Local corner offsets, index = 4*di + 2*dj + dk.
CORNER_OFFSETS = np.array(
    [[i, j, k] for i in range(2) for j in range(2) for k in range(2)], dtype=np.int64
)

# The six quad faces of a hex in local corner indices, oriented outward.
# Face normal axes: -x, +x, -y, +y, -z, +z.
_HEX_FACES = np.array(
    [
        [0, 1, 3, 2],  # -x
        [4, 6, 7, 5],  # +x
        [0, 4, 5, 1],  # -y
        [2, 3, 7, 6],  # +y
        [0, 2, 6, 4],  # -z
        [1, 5, 7, 3],  # +z
    ],
    dtype=np.int64,
)


@dataclasses.dataclass
class HexMesh:
    """A voxel hex mesh on an axis-aligned lattice.

    Attributes:
      x: (N, 3) float32 vertex rest positions.
      hexes: (H, 8) int32 corner vertex ids, local index = 4*di+2*dj+dk.
      ijk: (N, 3) int64 lattice coordinates of each vertex (x = origin + ijk*dx).
      dx: lattice spacing.
      origin: (3,) float lattice origin (min corner of bounding box).
    """
    x: np.ndarray
    hexes: np.ndarray
    ijk: np.ndarray
    dx: float
    origin: np.ndarray

    @property
    def n_verts(self) -> int:
        return self.x.shape[0]

    @property
    def n_hexes(self) -> int:
        return self.hexes.shape[0]


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Minimal OBJ reader: returns (verts (V,3) float64, tris (T,3) int64).

    Polygons with >3 vertices are fan-triangulated. Parsing is vectorized
    (batch str->array conversions, faces grouped by polygon arity) — the
    naive per-line/per-token loop cost 6.8 s on the reference's 97k-face
    horse.obj, ~25x the voxelization itself."""
    v_rows, f_rows, f_nv = [], [], []
    with open(path, "r") as fh:
        for line in fh:
            head = line[:2]
            if head == "v ":
                v_rows.append(line[2:])
            elif head == "f ":
                f_rows.append(line[2:].split())
                f_nv.append(len(v_rows))   # negatives are relative to the
                #                            vertices defined SO FAR
    vtok = " ".join(v_rows).split()
    if len(vtok) == 3 * len(v_rows):
        verts = np.asarray(vtok, dtype=np.float64).reshape(-1, 3)
    else:  # rare 'v x y z w' rows: per-row fallback
        verts = np.asarray([r.split()[:3] for r in v_rows], dtype=np.float64)
    if not f_rows:
        return verts, np.zeros((0, 3), dtype=np.int64)
    counts = np.fromiter((len(r) for r in f_rows), np.int64, len(f_rows))
    flat = [tok.split("/", 1)[0] if "/" in tok else tok
            for row in f_rows for tok in row]
    ints = np.asarray(flat, dtype=np.int64)
    nv_tok = np.repeat(np.asarray(f_nv, dtype=np.int64), counts)
    ints = np.where(ints > 0, ints - 1, nv_tok + ints)
    offs = np.concatenate([[0], np.cumsum(counts)[:-1]])
    tris = []
    for n in np.unique(counts):  # fan-triangulate, grouped by arity
        sel = np.nonzero(counts == n)[0]
        mat = ints[offs[sel, None] + np.arange(n)[None, :]]
        for t in range(1, int(n) - 1):
            tris.append(np.stack([mat[:, 0], mat[:, t], mat[:, t + 1]], 1))
    return verts, np.concatenate(tris).astype(np.int64)


def _points_inside(points: np.ndarray, verts: np.ndarray, tris: np.ndarray,
                   chunk: int = 4096) -> np.ndarray:
    """Ray-parity inside test for many points against a triangle mesh.

    Casts a ray along +x from each point and counts crossings (watertight-ish;
    equivalent in spirit to pyvista's enclosed-point selection used by
    pv.voxelize), vectorized over (points x tris) in chunks.
    """
    v0 = verts[tris[:, 0]]
    v1 = verts[tris[:, 1]]
    v2 = verts[tris[:, 2]]
    e1 = v1 - v0
    e2 = v2 - v0
    # Slightly off-axis ray direction avoids grazing shared edges/diagonals
    # of the quad faces (which would double-count crossings).
    d = np.array([1.0, 5.7721566e-4, 3.1415927e-4])
    d /= np.linalg.norm(d)
    # Constant direction: precompute pvec = d x e2 per tri.
    pvec = np.cross(np.broadcast_to(d, e1.shape), e2)
    det = np.einsum("td,td->t", e1, pvec)
    ok = np.abs(det) > 1e-12
    inv_det = np.where(ok, 1.0 / np.where(ok, det, 1.0), 0.0)

    # Bin points by their (y, z) cell and prefilter triangles per bin by
    # yz-bounding-box overlap: the ray is (almost) +x, so only triangles
    # whose yz extent covers the point can be hit. Cuts the brute-force
    # O(points x tris) cost by ~the bin count.
    tri_lo = np.minimum(np.minimum(v0, v1), v2)[:, 1:]   # (T, 2) yz mins
    tri_hi = np.maximum(np.maximum(v0, v1), v2)[:, 1:]
    margin = 1e-3 * (tri_hi.max(0) - tri_lo.min(0) + 1e-12)
    n_bins = 16
    lo_yz = points[:, 1:].min(axis=0) - margin
    hi_yz = points[:, 1:].max(axis=0) + margin
    span = np.maximum(hi_yz - lo_yz, 1e-12)
    pbin = np.clip(((points[:, 1:] - lo_yz) / span * n_bins).astype(np.int64),
                   0, n_bins - 1)
    pkey = pbin[:, 0] * n_bins + pbin[:, 1]

    inside = np.zeros(points.shape[0], dtype=bool)
    for by in range(n_bins):
        for bz in range(n_bins):
            sel = np.nonzero(pkey == by * n_bins + bz)[0]
            if sel.size == 0:
                continue
            cell_lo = lo_yz + np.array([by, bz]) / n_bins * span - margin
            cell_hi = lo_yz + np.array([by + 1, bz + 1]) / n_bins * span + margin
            tsel = np.nonzero((tri_lo[:, 0] <= cell_hi[0])
                              & (tri_hi[:, 0] >= cell_lo[0])
                              & (tri_lo[:, 1] <= cell_hi[1])
                              & (tri_hi[:, 1] >= cell_lo[1]) & ok)[0]
            if tsel.size == 0:
                continue
            v0s, e1s, e2s = v0[tsel], e1[tsel], e2[tsel]
            pvs, ids = pvec[tsel], inv_det[tsel]
            for s in range(0, sel.size, chunk):
                idx = sel[s:s + chunk]
                p = points[idx]
                tvec = p[:, None, :] - v0s[None, :, :]
                u = np.einsum("ptd,td->pt", tvec, pvs) * ids
                qvec = np.cross(tvec, e1s[None, :, :])
                vv = (qvec @ d) * ids
                tt = np.einsum("ptd,td->pt", qvec, e2s) * ids
                hit = (u >= 0) & (vv >= 0) & (u + vv <= 1) & (tt > 1e-10)
                inside[idx] = (hit.sum(axis=1) % 2) == 1
    return inside


def voxelize(verts: np.ndarray, tris: np.ndarray, dx: float) -> HexMesh:
    """Voxelize a triangle surface into a hex lattice at spacing dx.

    Selects lattice cells whose centers fall inside the surface (the same
    criterion as pv.voxelize with check_surface=False, reference object.py:30).
    """
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    origin = lo
    n_cells = np.maximum(np.ceil((hi - lo) / dx).astype(np.int64), 1)
    ii, jj, kk = np.meshgrid(*[np.arange(n) for n in n_cells], indexing="ij")
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    centers = origin + (cells + 0.5) * dx
    keep = _points_inside(centers, verts, tris)
    return hex_mesh_from_cells(cells[keep], dx, origin)


def hex_mesh_from_cells(cells: np.ndarray, dx: float, origin: np.ndarray) -> HexMesh:
    """Build a HexMesh from integer lattice cell coordinates (C, 3)."""
    cells = np.asarray(cells, dtype=np.int64)
    corners = cells[:, None, :] + CORNER_OFFSETS[None, :, :]     # (C, 8, 3)
    flat = corners.reshape(-1, 3)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    hexes = inv.reshape(-1, 8).astype(np.int32)
    x = (origin[None, :] + uniq * dx).astype(np.float32)
    return HexMesh(x=x, hexes=hexes, ijk=uniq, dx=float(dx),
                   origin=np.asarray(origin, dtype=np.float64))


def beam(nx: int, ny: int, nz: int, dx: float = 0.05,
         origin=(0.0, 0.0, 0.0)) -> HexMesh:
    """Procedural solid beam of nx*ny*nz voxels (bundled-mesh replacement)."""
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz), indexing="ij")
    cells = np.stack([ii, jj, kk], axis=-1).reshape(-1, 3)
    return hex_mesh_from_cells(cells, dx, np.asarray(origin, dtype=np.float64))


def shell(nx: int, ny: int, nz: int, thickness: int = 2,
          dx: float = 0.05, origin=(0.0, 0.0, 0.0)) -> HexMesh:
    """Procedural hollow box: an nx*ny*nz voxel block with the interior
    carved out, leaving walls ``thickness`` cells thick. The canonical
    low-bbox-fill stress shape for the box-cover lattice path
    (ops/boxes.py): fill ~ 6*t/min_extent."""
    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    t = thickness
    interior = ((ii >= t) & (ii < nx - t) & (jj >= t) & (jj < ny - t)
                & (kk >= t) & (kk < nz - t))
    cells = np.stack([ii, jj, kk], axis=-1)[~interior]
    return hex_mesh_from_cells(cells, dx, np.asarray(origin, dtype=np.float64))


def load_hex_mesh(scene_mesh_path: str | None, dx: float,
                  beam_shape=(8, 8, 24), normalize: bool = False) -> HexMesh:
    """Load-or-generate entry point used by sims and benchmarks.

    normalize=True rescales the surface so its largest extent is 1 before
    voxelizing — arbitrary OBJs come in wildly different units, and the
    default material constants (BASELINE.md) assume unit-scale meshes like
    the reference's bundled assets.
    """
    if scene_mesh_path is None:
        return beam(*beam_shape, dx=dx)
    v, t = load_obj(scene_mesh_path)
    if normalize:
        v = (v - v.min(axis=0)) / float((v.max(axis=0) - v.min(axis=0)).max())
    return voxelize(v, t, dx)


def surface_triangles(hexes: np.ndarray) -> np.ndarray:
    """Extract boundary faces as triangles for rendering/picking.

    A face is boundary iff it appears exactly once across all hexes (the
    reference's dict-hashing, object.py:47-79). Returns (F, 3) int32 with
    outward orientation.
    """
    faces = hexes[:, _HEX_FACES]                     # (H, 6, 4)
    flat = faces.reshape(-1, 4)
    key = np.sort(flat, axis=1)
    _, inv, counts = np.unique(key, axis=0, return_inverse=True, return_counts=True)
    boundary = flat[counts[inv] == 1]
    tris = np.concatenate([boundary[:, [0, 1, 2]], boundary[:, [0, 2, 3]]], axis=0)
    return tris.astype(np.int32)
