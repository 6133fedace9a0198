"""Block-ELL sparse linear algebra (3x3 blocks) and batched 3x3 utilities.

Port of `fem_simulation_tpu/ops/ell.py`. A hex-lattice FEM matrix has at
most 27 block entries per row, so it is a dense (N, K, 3, 3) value tensor
plus an (N, K) neighbor table and an (N, K) 0/1 mask. `spmv` and
`spmv_rows` go through the block-ELL SpMV kernel wrapper
(`ops/ell_kernels.py`): the CUDA kernel for CUDA tensors, its plain torch
version for CPU tensors.
"""
from __future__ import annotations

import torch

from . import ell_kernels

# spmv + spmv_rows calls made on CUDA tensors, counted apart from the
# kernel's own launch count (ell_kernels.launches) so that a run can check
# that every such call launched the kernel
cuda_calls = {"spmv": 0}


def spmv(values, nbr, mask, x):
    """y = A @ x with A in block-ELL form: values (N, K, 3, 3), nbr (N, K)
    int32, mask (N, K) 0/1 float, x (N, 3)."""
    if values.is_cuda:
        cuda_calls["spmv"] += 1
    return ell_kernels.spmv(values, nbr, mask, x)


def spmv_rows(values, nbr, mask, x, r0: int, r1: int):
    """Row-sliced SpMV y[r0:r1] = (A @ x)[r0:r1] (a color class of the
    canonical order is a contiguous row range)."""
    if values.is_cuda:
        cuda_calls["spmv"] += 1
    return ell_kernels.spmv_rows(values, nbr, mask, x, r0, r1)


def diag_blocks(values, diag_slot):
    """Extract (N, 3, 3) diagonal blocks."""
    n = values.shape[0]
    return values[torch.arange(n, device=values.device), diag_slot.long()]


def add_to_diag(values, diag_slot, blocks):
    """values[i, diag_slot[i]] += blocks[i] (a new tensor)."""
    n = values.shape[0]
    out = values.clone()
    out[torch.arange(n, device=values.device), diag_slot.long()] += blocks
    return out


def solve3x3(A, b, eps: float = 1e-12):
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


def _jacobi_rotation(A, V, p: int, q: int):
    """One cyclic-Jacobi rotation zeroing A[p, q] (batched, elementwise;
    returns new tensors)."""
    r = 3 - p - q                       # the untouched index
    apq = A[..., p, q]
    app = A[..., p, p]
    aqq = A[..., q, q]
    tiny = torch.abs(apq) < 1e-30
    tau = (aqq - app) / (2.0 * torch.where(tiny, torch.full_like(apq, 1e-30),
                                           apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tiny, torch.zeros_like(t), t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    s = t * c
    arp = A[..., r, p]
    arq = A[..., r, q]
    A = A.clone()
    A[..., p, p] = app - t * apq
    A[..., q, q] = aqq + t * apq
    A[..., p, q] = 0.0
    A[..., q, p] = 0.0
    arp_n = c * arp - s * arq
    arq_n = s * arp + c * arq
    A[..., r, p] = arp_n
    A[..., p, r] = arp_n
    A[..., r, q] = arq_n
    A[..., q, r] = arq_n
    vp = V[..., :, p]
    vq = V[..., :, q]
    V = V.clone()
    V[..., :, p] = c[..., None] * vp - s[..., None] * vq
    V[..., :, q] = s[..., None] * vp + c[..., None] * vq
    return A, V


def eigh3x3(A, sweeps: int = 6):
    """Batched symmetric 3x3 eigendecomposition by cyclic Jacobi; returns
    (w, V) with A ~= V diag(w) V^T."""
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape).clone()
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            A, V = _jacobi_rotation(A, V, p, q)
    w = A.diagonal(dim1=-2, dim2=-1)
    return w, V


def spd_project(values, eps: float, rel_floor: float = 0.0):
    """Clamp negative eigenvalues of each 3x3 block to +eps (rel_floor > 0
    floors every eigenvalue at rel_floor * max|eigenvalue| + eps instead)."""
    shape = values.shape
    A = values.reshape(-1, 3, 3)
    A = 0.5 * (A + A.transpose(-1, -2))
    w, V = eigh3x3(A)
    if rel_floor > 0.0:
        wmax = torch.max(torch.abs(w), dim=-1, keepdim=True).values
        w = torch.maximum(w, rel_floor * wmax + eps)
    else:
        w = torch.where(w < 0.0, torch.full_like(w, eps), w)
    out = sum(w[:, j, None, None] * V[:, :, None, j] * V[:, None, :, j]
              for j in range(3))
    return out.reshape(shape)


def eigvals3x3_sym(A):
    """Closed-form eigenvalues of symmetric 3x3 blocks (trigonometric
    method): (..., 3, 3) -> (lmin, lmax)."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2, min=0.0) / 6.0)
    ps = torch.where(p > 1e-30, p, torch.ones_like(p))
    detb = (b00 * (b11 * b22 - a12 * a12)
            - a01 * (a01 * b22 - a12 * a02)
            + a02 * (a01 * a12 - b11 * a02))
    r = torch.clamp(detb / (2.0 * ps * ps * ps), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    lmax = q + 2.0 * p * torch.cos(phi)
    lmin = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    return lmin, lmax


def spd_shift3x3(A, rel_floor: float = 1e-3, eps: float = 1e-6):
    """Shift each symmetric 3x3 block by max(0, floor - lmin) * I so its
    spectrum sits above floor = rel_floor * |lmax| + eps."""
    lmin, lmax = eigvals3x3_sym(A)
    shift = torch.clamp(rel_floor * torch.abs(lmax) + eps - lmin, min=0.0)
    return A + shift[..., None, None] * torch.eye(3, dtype=A.dtype,
                                                   device=A.device)


def inf_norm(x: torch.Tensor) -> torch.Tensor:
    """max |component| as a 0-d tensor (NaN propagates, as jnp.max does)."""
    return torch.max(torch.abs(x))


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b)
