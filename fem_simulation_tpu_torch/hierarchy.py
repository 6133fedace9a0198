"""Multigrid hierarchy + static sparsity topology (host-side, init-only).

The port's own copy of `fem_simulation_tpu/hierarchy.py`. The hex-pair
stencil, the hex -> ELL slot map and the Galerkin plan's expansion run in
the host library of `native.py` (csrc/topology.cpp) by default, as the
JAX package's do in its own; `use_native=False` takes the numpy path, the
plain version, whose bits the library's output equals. A library that
fails to build or load raises. Redesign of the reference's ``Object.__init__``
preprocessing (object.py:116-697):

* 8-coloring by lattice parity (reference cpu_function.py:15-20, object.py:147-158)
  — but here the canonical vertex order IS the color-sorted order, so the solver
  never touches a permutation (the reference gathers through vertex2index /
  index2vertex in every kernel).
* Coarsening by integer lattice halving (reference hashes cell centers,
  object.py:181-243). Trilinear transfer weights 1 / .5 / .25 / .125 fall out of
  a per-axis product rule instead of the 4-way case split (object.py:283-412).
* Sparse matrices live in **block-ELL** layout: every hex-lattice vertex has at
  most 27 neighbors, so A is a dense (N, K<=27, 3, 3) tensor plus an (N, K)
  neighbor table. SpMV = gather + einsum + sum: no scatter, static shapes,
  VPU-friendly. This replaces the reference's BSR + L/D/U triplet machinery
  (sparse.py, object.py:449-697) — L/D/U are masks over the same ELL table.
* The Galerkin coarse product A_c = R A P is precomputed as a flat
  gather-multiply-scatter *plan* (src entry, dst entry, weight), replacing
  bsr_mm + spd + block_values_reorder (object.py:1258-1264).

Everything here runs once per scene on the host in numpy; the outputs are
static-shape arrays handed to jitted device code.
"""
from __future__ import annotations

import dataclasses
import numpy as np

from . import native
from .mesh import HexMesh, CORNER_OFFSETS


# ---------------------------------------------------------------------------
# Coloring
# ---------------------------------------------------------------------------

def color_of(ijk: np.ndarray) -> np.ndarray:
    """8-coloring by lattice parity: color = 4*(i%2) + 2*(j%2) + (k%2).

    Two vertices sharing a hex always differ in parity in at least one axis,
    so each color class is an independent set of the FEM adjacency graph
    (the property colored Gauss-Seidel relies on, reference object.py:886-929).
    """
    p = ijk & 1
    return (p[:, 0] * 4 + p[:, 1] * 2 + p[:, 2]).astype(np.int32)


def color_sort(ijk: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return (perm, color_offsets): perm[new] = old, sorted by (color, i, j, k)."""
    col = color_of(ijk)
    order = np.lexsort((ijk[:, 2], ijk[:, 1], ijk[:, 0], col))
    counts = np.bincount(col, minlength=8)
    offsets = np.zeros(9, dtype=np.int64)
    offsets[1:] = np.cumsum(counts)
    return order, offsets


# ---------------------------------------------------------------------------
# Per-level topology
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LevelTopology:
    """Static mesh + sparsity data for one multigrid level (canonical order).

    The canonical vertex order is color-sorted: color c occupies the contiguous
    index range [color_offsets[c], color_offsets[c+1]).
    """
    n_verts: int
    n_hexes: int
    x0: np.ndarray            # (N, 3) float32 rest positions
    ijk: np.ndarray           # (N, 3) int64 lattice coords (level units)
    hexes: np.ndarray         # (H, 8) int32
    color_offsets: np.ndarray  # (9,) int64, static
    K: int                    # ELL width (max vertex degree incl. self)
    nbr: np.ndarray           # (N, K) int32 neighbor ids, cols sorted ascending; pad = self
    nbr_mask: np.ndarray      # (N, K) bool, False on padding
    diag_slot: np.ndarray     # (N,) int32 slot k with nbr[i, k] == i
    hex_slot: np.ndarray      # (H, 8, 8) int32 flat scatter index row*K + slot
    dx: float
    # Inverse of hex_slot: per flat ELL entry, the (hex*64+a*8+b) element-block
    # contributions (padded). Lets assembly be a gather+sum instead of a
    # scatter-add — deterministic and TPU-friendly.
    contrib_idx: np.ndarray = None   # (N*K, C) int32 into H*64
    contrib_mask: np.ndarray = None  # (N*K, C) bool


def _slot_of(nbr: np.ndarray, rows: np.ndarray, cols: np.ndarray,
             chunk: int = 1 << 20) -> np.ndarray:
    """First slot k with nbr[rows[m], k] == cols[m], for every m; computed
    in chunks so the (chunk, K) comparison table stays small."""
    s = np.empty(rows.size, np.int64)
    for c0 in range(0, rows.size, chunk):
        sl = slice(c0, c0 + chunk)
        s[sl] = np.argmax(nbr[rows[sl]] == cols[sl, None].astype(nbr.dtype),
                          axis=1)
    return s


def build_level_topology(x0: np.ndarray, ijk: np.ndarray, hexes: np.ndarray,
                         dx: float, use_native: bool = True) -> LevelTopology:
    """Color-sort vertices and build the block-ELL sparsity of the FEM matrix
    (the pair stencil and the slot map by native.py unless use_native is
    False)."""
    perm, offsets = color_sort(ijk)           # perm[new] = old
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.size)          # inv[old] = new
    x0 = np.ascontiguousarray(x0[perm]).astype(np.float32)
    ijk = ijk[perm]
    hexes = inv[hexes.astype(np.int64)].astype(np.int32)

    n = x0.shape[0]
    h = hexes.shape[0]

    # All vertex-pair couplings within each hex (the matrix stencil).
    if use_native:
        pairs = native.hex_pairs_unique(hexes)
    else:
        rows = np.repeat(hexes, 8, axis=1).reshape(-1)    # (H*64,) r = hex[a]
        cols = np.tile(hexes, (1, 8)).reshape(-1)         # (H*64,) c = hex[b]
        pairs = np.unique(np.stack([rows, cols], axis=1), axis=0)
    r, c = pairs[:, 0].astype(np.int64), pairs[:, 1].astype(np.int64)

    deg = np.bincount(r, minlength=n)
    K = int(deg.max())
    nbr = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, K))
    mask = np.zeros((n, K), dtype=bool)
    # pairs are sorted by (r, c); slot = running index within each row.
    row_start = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(deg, out=row_start[1:])
    slot = np.arange(pairs.shape[0]) - row_start[r]
    nbr[r, slot] = c.astype(np.int32)
    mask[r, slot] = True
    diag_slot = slot[r == c].astype(np.int32)

    # hex -> ELL slot map for Hessian scatter: entry (h, a, b) goes to
    # flat index row*K + slot where row = hexes[h,a], col = hexes[h,b].
    if use_native:
        hex_slot = native.hex_slot_map(hexes, nbr, deg.astype(np.int32))
    else:
        flat_r = rows.astype(np.int64)
        # Per-row first-match: nbr rows are ascending on the real prefix
        # and the diagonal always exists, so argmax== finds the right slot.
        s = _slot_of(nbr, flat_r, cols)
        hex_slot = (flat_r * K + s).reshape(h, 8, 8).astype(np.int32)

    # Invert hex_slot: group element blocks by destination ELL entry.
    flat = hex_slot.reshape(-1).astype(np.int64)        # (H*64,)
    order2 = np.argsort(flat, kind="stable")
    sorted_dst = flat[order2]
    counts = np.bincount(sorted_dst, minlength=n * K)
    C = int(counts.max()) if counts.size else 0
    starts = np.zeros(n * K + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(flat.size) - starts[sorted_dst]
    contrib_idx = np.zeros((n * K, C), dtype=np.int32)
    contrib_mask = np.zeros((n * K, C), dtype=bool)
    contrib_idx[sorted_dst, pos] = order2.astype(np.int32)
    contrib_mask[sorted_dst, pos] = True

    topo = LevelTopology(
        n_verts=n, n_hexes=h, x0=x0, ijk=ijk, hexes=hexes,
        color_offsets=offsets, K=K, nbr=nbr, nbr_mask=mask,
        diag_slot=diag_slot, hex_slot=hex_slot, dx=dx,
        contrib_idx=contrib_idx, contrib_mask=contrib_mask,
    )
    return topo


def pad_level(topo: LevelTopology, pad_to: int) -> LevelTopology:
    """Append phantom vertices so n_verts % pad_to == 0.

    Phantom rows have empty matrix rows (mask 0), self-neighbors, zero mass —
    solvers leave them identically zero. Colors are untouched (phantoms sit
    past color_offsets[-1], so GS never visits them). Used for TPU tile
    alignment and for sharding the vertex axis across a device mesh.
    """
    n = topo.n_verts
    n_new = ((n + pad_to - 1) // pad_to) * pad_to
    if n_new == n:
        return topo
    pad = n_new - n
    ids = np.arange(n, n_new, dtype=np.int32)
    return dataclasses.replace(
        topo,
        n_verts=n_new,
        x0=np.concatenate([topo.x0, np.zeros((pad, 3), np.float32)]),
        ijk=np.concatenate([topo.ijk, np.full((pad, 3), -(10 ** 6), topo.ijk.dtype)]),
        nbr=np.concatenate([topo.nbr, np.tile(ids[:, None], (1, topo.K))]),
        nbr_mask=np.concatenate([topo.nbr_mask, np.zeros((pad, topo.K), bool)]),
        diag_slot=np.concatenate([topo.diag_slot, np.zeros(pad, np.int32)]),
        contrib_idx=np.concatenate(
            [topo.contrib_idx,
             np.zeros((pad * topo.K, topo.contrib_idx.shape[1]), np.int32)]),
        contrib_mask=np.concatenate(
            [topo.contrib_mask,
             np.zeros((pad * topo.K, topo.contrib_mask.shape[1]), bool)]),
    )


def pad_transfer(tr: Transfer, nf_new: int, nc_new: int,
                 fine_K: int) -> Transfer:
    """Extend transfer tables for padded fine (nf_new) / coarse (nc_new) sizes.

    Note: g_src/g_dst flat indices stay valid because padding appends whole
    rows at the end of the row-major (N, K) layouts.
    """
    def pad_rows(a, n_new, fill=0):
        if a.shape[0] == n_new:
            return a
        pad = np.full((n_new - a.shape[0],) + a.shape[1:], fill, a.dtype)
        return np.concatenate([a, pad])

    return dataclasses.replace(
        tr,
        p_idx=pad_rows(tr.p_idx, nf_new), p_w=pad_rows(tr.p_w, nf_new),
        p_w_norm=pad_rows(tr.p_w_norm, nf_new),
        r_idx=pad_rows(tr.r_idx, nc_new), r_w=pad_rows(tr.r_w, nc_new),
        r_w_norm=pad_rows(tr.r_w_norm, nc_new),
    )


# ---------------------------------------------------------------------------
# Transfer operators
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Transfer:
    """Trilinear transfer between a fine level and the next-coarser level.

    P (prolongation, fine<-coarse) stored row-wise on fine vertices:
      p_idx (Nf, 8), p_w (Nf, 8) unnormalized trilinear weights ("hat"),
      p_w_norm normalized by coarse-row sums (the Liu-style normalization the
      reference applies to Ut/Us, object.py:417-425).
    R (restriction, coarse<-fine) is P^T stored row-wise on coarse vertices:
      r_idx (Nc, Kr), r_w, r_w_norm.
    Galerkin plan for A_c = P^T A P with unnormalized weights
    (reference object.py:1259 uses Ut_hat .. Us_hat):
      g_src (M,) flat fine ELL entry, g_dst (M,) flat coarse ELL entry, g_w (M,).
    """
    p_idx: np.ndarray
    p_w: np.ndarray
    p_w_norm: np.ndarray
    r_idx: np.ndarray
    r_w: np.ndarray
    r_w_norm: np.ndarray
    Kr: int
    g_src: np.ndarray
    g_dst: np.ndarray
    g_w: np.ndarray
    # trainable-interpolation support (exp2): one scalar weight per triplet,
    # with scatter maps into the P-table (Nf*8 flat) and R-table (Nc*Kr flat).
    t_w: np.ndarray = None        # (M,) classic trilinear weights (hat)
    t_w_norm: np.ndarray = None   # (M,) coarse-row-normalized weights
    t_fine_slot: np.ndarray = None   # (M,) flat index into p_w
    t_coarse_slot: np.ndarray = None  # (M,) flat index into r_w
    t_rows: np.ndarray = None     # (M,) fine vertex of each triplet
    t_cols: np.ndarray = None     # (M,) coarse vertex of each triplet


def _prolongation_triplets(fine: LevelTopology, coarse: LevelTopology):
    """Triplets (fine_row, coarse_col, w) of trilinear interpolation.

    Per-axis rule on fine lattice coords f: if f even the single coarse coord
    f/2 contributes weight 1; if f odd, (f-1)/2 and (f+1)/2 contribute 1/2 each.
    The tensor product reproduces the reference's corner/edge/face/center
    weights 1, .5, .25, .125 (object.py:283-412).
    """
    f = fine.ijk                                    # (Nf, 3), fine units
    # Coarse vertex lookup: packed lattice key -> coarse id via searchsorted
    # (vectorized; replaces the per-vertex dict probes the reference's nested
    # loops imply, object.py:283-412).
    B = np.int64(1) << 19  # 20-bit fields: keys stay within int64
    def pack(c):
        c = c.astype(np.int64)
        return ((c[:, 0] + B) << 40) | ((c[:, 1] + B) << 20) | (c[:, 2] + B)

    ckeys = pack(coarse.ijk)
    order_c = np.argsort(ckeys)
    ckeys_sorted = ckeys[order_c]

    rows, cols, ws = [], [], []
    even = (f & 1) == 0                             # (Nf, 3)
    half = (f - (f & 1)) // 2
    for da in range(2):
        for db in range(2):
            for dc in range(2):
                d = np.array([da, db, dc])
                coarse_coord = half + d * (f & 1)
                w = np.where(even, np.where(d == 0, 1.0, 0.0), 0.5)
                wprod = w.prod(axis=1)
                sel = wprod > 0
                kk = pack(coarse_coord[sel])
                pos = np.searchsorted(ckeys_sorted, kk)
                assert (ckeys_sorted[pos] == kk).all(), \
                    "coarse contributor must exist"
                rows.append(np.nonzero(sel)[0])
                cols.append(order_c[pos])
                ws.append(wprod[sel])
    rows = np.concatenate(rows)
    cols = np.concatenate(cols)
    ws = np.concatenate(ws)
    return rows, cols, ws


def build_transfer(fine: LevelTopology, coarse: LevelTopology,
                   use_native: bool = True) -> Transfer:
    """The transfer operators between two levels and their Galerkin plan
    (expanded by native.py unless use_native is False)."""
    rows, cols, ws = _prolongation_triplets(fine, coarse)
    nf, nc = fine.n_verts, coarse.n_verts

    # Coarse-row sums for normalization (reference norm[], object.py:417-420).
    norm = np.zeros(nc)
    np.add.at(norm, cols, ws)
    ws_norm = ws / norm[cols]

    # P rows (fine side): <=8 per fine vertex.
    order = np.lexsort((cols, rows))
    r_sorted, c_sorted, w_sorted, wn_sorted = rows[order], cols[order], ws[order], ws_norm[order]
    pdeg = np.bincount(r_sorted, minlength=nf)
    Kp = int(pdeg.max())
    assert Kp <= 8
    p_idx = np.zeros((nf, 8), dtype=np.int32)
    p_w = np.zeros((nf, 8), dtype=np.float32)
    p_w_norm = np.zeros((nf, 8), dtype=np.float32)
    start = np.zeros(nf + 1, dtype=np.int64)
    np.cumsum(pdeg, out=start[1:])
    slot = np.arange(r_sorted.size) - start[r_sorted]
    p_idx[r_sorted, slot] = c_sorted.astype(np.int32)
    p_w[r_sorted, slot] = w_sorted.astype(np.float32)
    p_w_norm[r_sorted, slot] = wn_sorted.astype(np.float32)
    p_slot_of_entry = np.empty(rows.size, dtype=np.int64)
    p_slot_of_entry[order] = r_sorted * 8 + slot   # flat P-entry id per triplet

    # R rows (coarse side) = transpose.
    order_t = np.lexsort((rows, cols))
    rt, ct = cols[order_t], rows[order_t]
    wt, wnt = ws[order_t], ws_norm[order_t]
    rdeg = np.bincount(rt, minlength=nc)
    Kr = int(rdeg.max())
    r_idx = np.zeros((nc, Kr), dtype=np.int32)
    r_w = np.zeros((nc, Kr), dtype=np.float32)
    r_w_norm = np.zeros((nc, Kr), dtype=np.float32)
    startc = np.zeros(nc + 1, dtype=np.int64)
    np.cumsum(rdeg, out=startc[1:])
    slotc = np.arange(rt.size) - startc[rt]
    r_idx[rt, slotc] = ct.astype(np.int32)
    r_w[rt, slotc] = wt.astype(np.float32)
    r_w_norm[rt, slotc] = wnt.astype(np.float32)
    r_slot_of_entry = np.empty(rows.size, dtype=np.int64)
    r_slot_of_entry[order_t] = rt * Kr + slotc   # flat R-entry id per triplet

    # ---- Galerkin plan: A_c[I, J] += wI * wJ * A[i, j] over fine ELL entries.
    # Fine real entries:
    fi, fk = np.nonzero(fine.nbr_mask)
    fj = fine.nbr[fi, fk].astype(np.int64)
    src_flat = fi * fine.K + fk

    # Expand: for each fine entry e=(i,j), all (a,b) contributor slot pairs
    # with nonzero weight product.
    if use_native:
        cdeg = coarse.nbr_mask.sum(axis=1).astype(np.int32)
        g_src, g_dst, g_w = native.galerkin_plan(
            fi.astype(np.int32), fj.astype(np.int32),
            src_flat.astype(np.int32), p_idx, p_w, coarse.nbr, cdeg,
            coarse.K)
        g_src, g_dst = g_src.astype(np.int64), g_dst.astype(np.int64)
    else:
        # One (E*64,) f32 weight array, then gather only the selected
        # entries (zero weights are padding).
        wi = p_w[fi].astype(np.float32)    # (E, 8)
        wj = p_w[fj].astype(np.float32)
        W = (wi[:, :, None] * wj[:, None, :]).reshape(-1)   # (E*64,)
        sel = np.nonzero(W > 0)[0]
        e = sel >> 6
        a = (sel >> 3) & 7
        b = sel & 7
        g_src = src_flat[e]
        g_w = W[sel]
        gI = p_idx[fi[e], a].astype(np.int64)
        gJ = p_idx[fj[e], b].astype(np.int64)
        # Destination flat coarse ELL entry: slot of column J within row I.
        cnbr = coarse.nbr
        s = _slot_of(cnbr, gI, gJ)
        ok = cnbr[gI, s] == gJ
        assert ok.all(), \
            "Galerkin destination must exist in the coarse stencil"
        g_dst = (gI * coarse.K + s).astype(np.int64)

    # Sort the plan by destination for a cache-friendlier scatter.
    po = np.argsort(g_dst, kind="stable")
    return Transfer(
        p_idx=p_idx, p_w=p_w, p_w_norm=p_w_norm,
        r_idx=r_idx, r_w=r_w, r_w_norm=r_w_norm, Kr=Kr,
        g_src=g_src[po].astype(np.int32), g_dst=g_dst[po].astype(np.int32),
        g_w=g_w[po],
        t_w=ws.astype(np.float32),
        t_w_norm=ws_norm.astype(np.float32),
        t_fine_slot=p_slot_of_entry.astype(np.int32),
        t_coarse_slot=r_slot_of_entry.astype(np.int32),
        t_rows=rows.astype(np.int32), t_cols=cols.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# Hierarchy
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Hierarchy:
    """Full multigrid hierarchy: levels[0] is the fine grid."""
    levels: list            # [LevelTopology]
    transfers: list         # [Transfer], len = n_levels - 1
    mesh2idx: np.ndarray    # (N,) mesh vertex id -> canonical fine index
    idx2mesh: np.ndarray    # (N,) canonical fine index -> mesh vertex id

    @property
    def n_levels(self) -> int:
        return len(self.levels)


def derive_n_levels(mesh: HexMesh, max_levels: int = 8) -> int:
    """Reference formula: floor(log2(min bbox extent / dx)) - 1 (object.py:139-143)."""
    extent = mesh.x.max(axis=0) - mesh.x.min(axis=0)
    mn = float(extent.min())
    n = int(np.floor(np.log2(max(mn / mesh.dx, 2.0)))) - 1
    return int(np.clip(n, 1, max_levels))


def coarsen(level: LevelTopology) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One step of lattice coarsening. Returns (x0, ijk, hexes) in coarse units."""
    cell_min = level.ijk[level.hexes[:, 0].astype(np.int64)]     # (H, 3) min corner
    coarse_cells = np.unique(cell_min // 2, axis=0)
    corners = coarse_cells[:, None, :] + CORNER_OFFSETS[None, :, :]
    flat = corners.reshape(-1, 3)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    hexes = inv.reshape(-1, 8).astype(np.int32)
    # Coarse rest positions from the lattice (reference object.py:228-233).
    # level.x0 = origin + ijk*dx, so coarse x = origin + uniq * (2*dx).
    origin = level.x0[0] - level.ijk[0] * level.dx
    x0 = (origin[None, :] + uniq * (2.0 * level.dx)).astype(np.float32)
    return x0, uniq, hexes


def build_hierarchy(mesh: HexMesh, n_levels: int | None = None,
                    max_levels: int = 3, pad_to: int = 1,
                    use_native: bool = True) -> Hierarchy:
    if n_levels is None:
        n_levels = min(derive_n_levels(mesh), max_levels)
    n_levels = max(1, n_levels)

    lvl0 = build_level_topology(mesh.x, mesh.ijk, mesh.hexes, mesh.dx,
                                use_native)
    # Recover the mesh->canonical permutation for I/O.
    perm, _ = color_sort(mesh.ijk)
    idx2mesh = perm.astype(np.int32)
    mesh2idx = np.empty_like(idx2mesh)
    mesh2idx[perm] = np.arange(perm.size, dtype=np.int32)

    levels = [lvl0]
    transfers = []
    for _ in range(n_levels - 1):
        x0, ijk, hexes = coarsen(levels[-1])
        nxt = build_level_topology(x0, ijk, hexes, levels[-1].dx * 2.0,
                                   use_native)
        transfers.append(build_transfer(levels[-1], nxt, use_native))
        levels.append(nxt)

    if pad_to > 1:
        levels = [pad_level(l, pad_to) for l in levels]
        transfers = [
            pad_transfer(t, levels[i].n_verts, levels[i + 1].n_verts,
                         levels[i].K)
            for i, t in enumerate(transfers)
        ]
    return Hierarchy(levels=levels, transfers=transfers,
                     mesh2idx=mesh2idx, idx2mesh=idx2mesh)
