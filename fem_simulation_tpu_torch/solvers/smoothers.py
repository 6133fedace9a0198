"""Jacobi and 8-color symmetric Gauss-Seidel smoothers on block-ELL operators.

Port of `fem_simulation_tpu/solvers/smoothers.py`. Color classes are
contiguous index ranges of the canonical order and each is an independent
set of the matrix graph.

One GS iteration = backward sweep then forward sweep:
x_bwd = (D+U)^{-1} (b - L x_prev), x_fwd = (D+L)^{-1} (b - U x_bwd).

On CUDA tensors `gauss_seidel` and `jacobi` are one kernel call each
(`ops/ell_kernels.py`: `ell_gs`, one launch in the form its plan picks for
the level; `ell_jacobi`, one launch per iteration), all iterations inside:
the
row product, the exact 3x3 adjugate solve and the update fused, the lower /
upper selection made by the in-place color order, no masked copy of the
values. On CPU tensors they run `gauss_seidel_plain` / `jacobi_plain`, the
JAX package's composition: per GS iteration two full SpMVs over masked
copies of the values and, per color and sweep, a row SpMV
(`ell.spmv_rows`), an `ell.solve3x3` and a slice update.

`jacobi` is differentiable on both devices: when autograd records it goes
through `ell_kernels.EllJacobiFn` (its forward and backward kernels on
CUDA tensors, their plain versions on CPU tensors). `gauss_seidel` has no
backward and raises when asked for one.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops import _cuda, ell, ell_kernels


def same_color_couplings(nbr, mask, color_offsets) -> int:
    """How many unmasked off-diagonal slots couple a row to a row of its own
    color class (0 for a proper coloring), counted on the host."""
    nbr = nbr.detach().cpu().numpy()
    live = mask.detach().cpu().numpy() > 0
    ends = np.asarray(color_offsets[1:], dtype=np.int64)
    row = np.arange(nbr.shape[0], dtype=np.int64)
    row_color = np.searchsorted(ends, row, side="right")
    nbr_color = np.searchsorted(ends, nbr.astype(np.int64), side="right")
    return int(np.count_nonzero(live & (nbr != row[:, None])
                                & (nbr_color == row_color[:, None])))


class EllOperator:
    """The ELL topology of one level (values vary per assembly and are
    passed to each call). Raises unless every color class is an independent
    set: the in-place Gauss-Seidel kernel relies on it."""

    def __init__(self, nbr, mask, diag_slot, color_offsets):
        self.nbr = nbr                      # (N, K) int32
        self.mask = mask                    # (N, K) float
        self.diag_slot = diag_slot
        self.color_offsets = tuple(int(c) for c in color_offsets)
        bad = same_color_couplings(nbr, mask, self.color_offsets)
        if bad:
            raise ValueError(
                f"{bad} unmasked off-diagonal entries couple two rows of one "
                "color class: the colors are not independent sets")
        self._triangles = None
        self._transpose = None

    def _masks(self):
        """(lower, upper, offdiag) 0/1 masks of the plain versions, built
        at first use."""
        if self._triangles is None:
            row = torch.arange(self.nbr.shape[0], dtype=self.nbr.dtype,
                               device=self.nbr.device)[:, None]
            lower = self.mask * (self.nbr < row)     # strictly below diagonal
            upper = self.mask * (self.nbr > row)
            self._triangles = (lower, upper, lower + upper)
        return self._triangles

    def transpose_table(self):
        """The transpose table of the operator's ELL graph
        (`ell_kernels.transpose_table`): built on the host at first use,
        then cached."""
        if self._transpose is None:
            self._transpose = ell_kernels.transpose_table(self.nbr)
        return self._transpose

    @property
    def lower(self):
        return self._masks()[0]

    @property
    def upper(self):
        return self._masks()[1]

    @property
    def offdiag(self):
        return self._masks()[2]

    @property
    def n_colors(self):
        return len(self.color_offsets) - 1


def jacobi_plain(op: EllOperator, values, b, iterations: int = 2, x0=None):
    D = ell.diag_blocks(values, op.diag_slot)
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iterations):
        r = b - ell.spmv(values * op.offdiag[..., None, None], op.nbr,
                         op.mask, x)
        x = ell.solve3x3(D, r)
    return x


def jacobi(op: EllOperator, values, b, iterations: int = 2, x0=None):
    """Block Jacobi from x0 (zero by default): x <- D^{-1} (b - (L+U) x).
    Differentiable in values, b and x0: when autograd records, through
    `ell_kernels.EllJacobiFn` on either device."""
    on_cpu = _cuda.on_cpu(values, b)
    if on_cpu and not _cuda.records_grad(values, b, x0):
        return jacobi_plain(op, values, b, iterations, x0)
    if not on_cpu:
        ell.cuda_calls["jacobi"] += max(int(iterations), 0)
    tt = None
    if (_cuda.records_grad(values, b, x0)
            and ell_kernels.needs_table(iterations, x0)):
        tt = op.transpose_table()
    return ell_kernels.jacobi(values, op.nbr, op.mask, op.diag_slot, b, x0,
                              iterations, tt)


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


def gauss_seidel_plain(op: EllOperator, values, b, iterations: int = 1,
                       x0=None):
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


def gauss_seidel(op: EllOperator, values, b, iterations: int = 1, x0=None):
    """Colored symmetric GS: per iteration a backward sweep using L x_prev,
    then a forward sweep using U x_bwd, from x0 (zero by default). No
    backward: raises when autograd records and an input requires grad."""
    _cuda.refuse_grad("smoothers.gauss_seidel", values, b, x0)
    if _cuda.on_cpu(values, b):
        return gauss_seidel_plain(op, values, b, iterations, x0)
    ell.cuda_calls["gs"] += int(iterations) > 0
    return ell_kernels.gs(values, op.nbr, op.mask, op.diag_slot,
                          op.color_offsets, b, x0, iterations)
