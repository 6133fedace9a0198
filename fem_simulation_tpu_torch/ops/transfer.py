"""Multigrid transfer operators: restriction, prolongation, Galerkin product.

Port of `fem_simulation_tpu/ops/transfer.py`. Interpolation blocks are
scalar multiples of I, so the tables are scalar weights applied as weighted
gathers. The Galerkin product sums its plan by gather through an inverse
plan built once on the host (`galerkin_plan`), not by a scatter-add: the
sum of each coarse entry runs in a fixed order, so a GPU run is identical
from run to run.
"""
from __future__ import annotations

import numpy as np
import torch


def prolong(p_idx, p_w, xc):
    """x_f = P @ x_c : weighted gather (fine rows <= 8 wide)."""
    return torch.einsum("fk,fkc->fc", p_w, xc[p_idx])


def restrict(r_idx, r_w, xf):
    """x_c = R @ x_f = P^T x_f : weighted gather on coarse rows."""
    return torch.einsum("ck,ckd->cd", r_w, xf[r_idx])


# entries per gather of the Galerkin plan: a tier holds, for every coarse
# entry with more than t * TIER fine terms, its terms [t * TIER, (t+1) * TIER)
TIER = 64


def galerkin_plan(g_src, g_dst, g_w):
    """Inverse of the Galerkin plan, for a gather-only product.

    The plan's entries m add g_w[m] * A_f.flat[g_src[m]] into
    A_c.flat[g_dst[m]]. Entries are grouped by destination (in plan order
    within a group) and cut into tiers of TIER, padded with weight 0.
    Returns a list of numpy tuples (dst (D,) int64, src (D, TIER) int64,
    w (D, TIER) f32). A scene builds it once per transfer.
    """
    g_src = np.asarray(g_src, np.int64)
    g_dst = np.asarray(g_dst, np.int64)
    g_w = np.asarray(g_w, np.float32)
    order = np.argsort(g_dst, kind="stable")
    dst_sorted = g_dst[order]
    uniq, first, counts = np.unique(dst_sorted, return_index=True,
                                    return_counts=True)
    rank = np.arange(order.size) - np.repeat(first, counts)
    group = np.repeat(np.arange(uniq.size), counts)
    tiers = []
    for t in range(int(-(-counts.max() // TIER)) if counts.size else 0):
        live = np.nonzero(counts > t * TIER)[0]           # groups in tier t
        slot = np.full(uniq.size, -1, np.int64)
        slot[live] = np.arange(live.size)
        sel = (rank >= t * TIER) & (rank < (t + 1) * TIER)
        rows, cols = slot[group[sel]], rank[sel] - t * TIER
        src = np.zeros((live.size, TIER), np.int64)
        w = np.zeros((live.size, TIER), np.float32)
        src[rows, cols] = g_src[order[sel]]
        w[rows, cols] = g_w[order[sel]]
        tiers.append((uniq[live], src, w))
    return tiers


def galerkin(values_fine, plan, n_coarse: int, Kc: int):
    """A_c = P^T A P (n_coarse, Kc, 3, 3) from the fine block-ELL values.

    The JAX package's (g_src, g_dst, g_w) arguments become `plan`, their
    `galerkin_plan` with its arrays as tensors on the values' device (the
    scene's transfer entry "galerkin_plan"). Each tier is one gather, a
    weighted sum over its TIER terms and an add into its destinations."""
    flat = values_fine.reshape(-1, 3, 3)
    out = torch.zeros((n_coarse * Kc, 3, 3), dtype=values_fine.dtype,
                      device=values_fine.device)
    for dst, src, w in plan:
        out[dst] += torch.sum(flat[src] * w[..., None, None], dim=1)
    return out.reshape(n_coarse, Kc, 3, 3)
