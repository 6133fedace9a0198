"""Jacobi and 8-color symmetric Gauss-Seidel smoothers on block-ELL operators.

Port of `fem_simulation_tpu/solvers/smoothers.py`. Color classes are
contiguous index ranges of the canonical order, so the per-color update is a
row-range SpMV (`ell.spmv_rows`) over a masked view of one ELL tensor, and
the diagonal "division" is the exact adjugate solve (`ell.solve3x3`).

One GS iteration = backward sweep then forward sweep:
x_bwd = (D+U)^{-1} (b - L x_prev), x_fwd = (D+L)^{-1} (b - U x_bwd).
Every SpMV goes through the block-ELL kernel wrapper: per GS iteration two
full SpMVs and one row SpMV per non-empty color per sweep.
"""
from __future__ import annotations

import torch

from ..ops import ell


class EllOperator:
    """The ELL topology masks of one level (values vary per assembly and are
    passed to each call)."""

    def __init__(self, nbr, mask, diag_slot, color_offsets):
        self.nbr = nbr                      # (N, K) int32
        self.mask = mask                    # (N, K) float
        row = torch.arange(nbr.shape[0], dtype=nbr.dtype,
                           device=nbr.device)[:, None]
        self.lower = mask * (nbr < row)     # strictly below diagonal
        self.upper = mask * (nbr > row)
        self.offdiag = self.lower + self.upper
        self.diag_slot = diag_slot
        self.color_offsets = tuple(int(c) for c in color_offsets)

    @property
    def n_colors(self):
        return len(self.color_offsets) - 1


def jacobi(op: EllOperator, values, b, iterations: int = 2, x0=None):
    """Block Jacobi from x0 (zero by default): x <- D^{-1} (b - (L+U) x)."""
    D = ell.diag_blocks(values, op.diag_slot)
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iterations):
        r = b - ell.spmv(values * op.offdiag[..., None, None], op.nbr,
                         op.mask, x)
        x = ell.solve3x3(D, r)
    return x


def _sweep(op: EllOperator, values, D, b_eff, reverse: bool):
    """One colored sweep: colors in sequence, each color's rows at once.

    b_eff already excludes the other triangle's coupling; within the sweep
    the same-triangle coupling to already-solved colors is subtracted."""
    tri_mask = op.lower if not reverse else op.upper
    vals_tri = values * tri_mask[..., None, None]
    x = torch.zeros_like(b_eff)
    colors = range(op.n_colors)
    if reverse:
        colors = reversed(list(colors))
    for c in colors:
        r0, r1 = op.color_offsets[c], op.color_offsets[c + 1]
        if r1 == r0:
            continue
        rhs = b_eff[r0:r1] - ell.spmv_rows(vals_tri, op.nbr, op.mask, x,
                                           r0, r1)
        x[r0:r1] = ell.solve3x3(D[r0:r1], rhs)
    return x


def gauss_seidel(op: EllOperator, values, b, iterations: int = 1, x0=None):
    """Colored symmetric GS: per iteration a backward sweep using L x_prev,
    then a forward sweep using U x_bwd, from x0 (zero by default)."""
    D = ell.diag_blocks(values, op.diag_slot)
    vals_low = values * op.lower[..., None, None]
    vals_up = values * op.upper[..., None, None]
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iterations):
        b_bwd = b - ell.spmv(vals_low, op.nbr, op.mask, x)
        x = _sweep(op, values, D, b_bwd, reverse=True)
        b_fwd = b - ell.spmv(vals_up, op.nbr, op.mask, x)
        x = _sweep(op, values, D, b_fwd, reverse=False)
    return x
