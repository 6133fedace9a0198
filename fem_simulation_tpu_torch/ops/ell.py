"""Batched 3x3 block algebra of the lattice step (port of the parts of
`fem_simulation_tpu/ops/ell.py` the main path uses)."""
from __future__ import annotations

import torch


def solve3x3(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Batched exact 3x3 solve via the adjugate. A: (..., 3, 3), b: (..., 3)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a10, a11, a12 = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    a20, a21, a22 = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00 = a11 * a22 - a12 * a21
    c01 = a12 * a20 - a10 * a22
    c02 = a10 * a21 - a11 * a20
    det = a00 * c00 + a01 * c01 + a02 * c02
    c10 = a02 * a21 - a01 * a22
    c11 = a00 * a22 - a02 * a20
    c12 = a01 * a20 - a00 * a21
    c20 = a01 * a12 - a02 * a11
    c21 = a02 * a10 - a00 * a12
    c22 = a00 * a11 - a01 * a10
    inv_det = det / (det * det + eps)
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) * inv_det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) * inv_det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return torch.stack([x0, x1, x2], dim=-1)


def inf_norm(x: torch.Tensor) -> torch.Tensor:
    """max |component| as a 0-d tensor (NaN propagates, as jnp.max does)."""
    return torch.max(torch.abs(x))


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)
