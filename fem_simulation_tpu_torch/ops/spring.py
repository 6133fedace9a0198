"""Mass-spring cloth: energy, force and Hessian (plain torch, no kernel).

Port of `fem_simulation_tpu/ops/spring.py`. Per edge (i, j) with
d = x_i - x_j, |d| = l and rest length l0:

    E = k/2 (l - l0)^2,   f_i = k (l0/l - 1) d = -f_j,
    H = (k - k l0/l) I + (k l0 / l^3) d d^T   in blocks [+H, -H; -H, +H].

The reference scatters the per-edge terms onto vertices and ELL slots with
`.at[].add`. Here every sum is a gather through a table built once on the
host (`gather_table`): for each target row, the flat indices of its
contributions in the reference's scatter order, padded with the index of an
appended zero row. `gather_sum` adds them in that order, one column at a
time, so the result repeats its bits on every device (a CUDA `index_add_`
adds in whatever order its atomics land).
"""
from __future__ import annotations

import numpy as np
import torch


def gather_table(targets, n: int) -> np.ndarray:
    """(D, n) int32: column r lists the positions m with targets[m] == r in
    increasing m (the order a sequential scatter adds them), padded with
    len(targets), the index of the zero row `gather_sum` appends; D is the
    largest count (at least 1)."""
    targets = np.asarray(targets, dtype=np.int64).reshape(-1)
    m = targets.shape[0]
    order = np.argsort(targets, kind="stable")
    sorted_t = targets[order]
    pos = np.arange(m) - np.searchsorted(sorted_t, sorted_t)
    depth = int(pos.max()) + 1 if m else 1
    table = np.full((depth, n), m, dtype=np.int32)
    table[pos, sorted_t] = order.astype(np.int32)
    return table


def gather_sum(contrib, table):
    """out[r] = sum over the table's column r of contrib[m], added first to
    last; contrib (M, ...), table (D, n) from gather_table(..., n)."""
    src = torch.cat([contrib, torch.zeros_like(contrib[:1])])
    out = src[table[0]]
    for j in range(1, table.shape[0]):
        out = out + src[table[j]]
    return out


def _edge_vectors(x, edges):
    return x[edges[:, 0]] - x[edges[:, 1]]


def rest_lengths(x, edges):
    return torch.linalg.vector_norm(_edge_vectors(x, edges), dim=-1)


def energy(x, edges, l0, k):
    dl = torch.linalg.vector_norm(_edge_vectors(x, edges), dim=-1) - l0
    return 0.5 * k * torch.sum(dl * dl)


def force(x, edges, l0, k, f_table):
    """Spring force -dE/dx, (N, 3): +f_e onto edges[:, 0], -f_e onto
    edges[:, 1]; f_table = gather_table(concat(edges[:, 0], edges[:, 1]), N)."""
    d = _edge_vectors(x, edges)
    ln = torch.linalg.vector_norm(d, dim=-1)
    f = (k * (l0 / ln - 1.0))[:, None] * d
    return gather_sum(torch.cat([f, -f]), f_table)


def hessian_blocks(x, edges, l0, k):
    """Per-edge 3x3 Hessian block H (the (i, i) block; (i, j) is -H)."""
    d = _edge_vectors(x, edges)
    ln = torch.linalg.vector_norm(d, dim=-1)
    a = k * l0 / ln
    b = a / (ln * ln)
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return ((k - a)[:, None, None] * eye
            + b[:, None, None] * d[:, None, :] * d[:, :, None])


def assemble_hessian_ell(x, edges, l0, k, h_table, n_verts: int, K: int):
    """The spring Hessian in block-ELL, (N, K, 3, 3): edge e adds
    (+H, -H, -H, +H) to its slots (i,i), (i,j), (j,i), (j,j);
    h_table = gather_table(edge_slot.reshape(-1), N * K)."""
    H = hessian_blocks(x, edges, l0, k)
    contrib = torch.stack([H, -H, -H, H], dim=1).reshape(-1, 3, 3)
    return gather_sum(contrib, h_table).reshape(n_verts, K, 3, 3)
