"""Block-ELL kernels: the public wrappers, their plain torch versions, counts.

`spmv` / `spmv_rows` port `fem_simulation_tpu/ops/pallas_kernels.py`
(`spmv`, the lanes-layout Pallas kernel) in the (N, K, 3, 3) ELL layout of
`ops/ell.py`, which a GPU can gather from directly: `ell_spmv` in
`csrc/ell_kernels.cu`. `gs` and `jacobi` are the smoothers of
`solvers/smoothers.py` fused around the same row pass (`ell_gs`,
`ell_jacobi`): row product, 3x3 adjugate solve and update in one kernel,
all iterations in one call.

Dispatch: a wrapper checks its arguments' dtypes, shapes and contiguity,
then runs its plain version (`*_plain`) only when its tensors lie on the
CPU. For CUDA tensors it launches the kernel or raises; it never falls back.
`launches[name]` counts kernel launches (`spmv`: one per call with a
non-empty row range; `gs`: one cooperative launch per call with iterations
> 0; `jacobi`: one per iteration); `ops.ell.cuda_calls` counts, one layer up,
the launches that the calls made on CUDA tensors ask for, so a run can check
that every call launched.
"""
from __future__ import annotations

import ctypes

import torch

from . import _cuda

launches = {"spmv": 0, "gs": 0, "jacobi": 0}

def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def spmv_rows_plain(values, nbr, mask, x, r0: int, r1: int):
    """y[r0:r1] of A @ x: gather, multiply by the mask, contract."""
    xg = x[nbr[r0:r1]] * mask[r0:r1, :, None]            # (R, K, 3)
    return torch.einsum("nkji,nki->nj", values[r0:r1], xg)


def spmv_plain(values, nbr, mask, x):
    return spmv_rows_plain(values, nbr, mask, x, 0, values.shape[0])


def _check(values, nbr, mask, x):
    if values.dim() != 4 or tuple(values.shape[2:]) != (3, 3):
        raise ValueError(f"values: expected (N, K, 3, 3), got {tuple(values.shape)}")
    n, k = int(values.shape[0]), int(values.shape[1])
    if k > 32:
        raise ValueError(f"ELL width {k} > 32: the kernel takes one lane per slot")
    _cuda.require(values, (n, k, 3, 3), "values")
    _cuda.require(nbr, (n, k), "nbr", dtype=torch.int32)
    _cuda.require(mask, (n, k), "mask")
    _cuda.require(x, (n, 3), "x")
    return n, k


def spmv_rows(values, nbr, mask, x, r0: int, r1: int):
    """y = (A @ x)[r0:r1], (r1 - r0, 3), for A in block-ELL form."""
    n, k = _check(values, nbr, mask, x)
    r0, r1 = int(r0), int(r1)
    if not 0 <= r0 <= r1 <= n:
        raise ValueError(f"row range [{r0}, {r1}) outside [0, {n})")
    if _cuda.on_cpu(values, nbr, mask, x):
        return spmv_rows_plain(values, nbr, mask, x, r0, r1)
    y = torch.empty((r1 - r0, 3), dtype=torch.float32, device=x.device)
    if r1 == r0:
        return y
    lib = _cuda.load()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        err = lib.ell_spmv(values.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                           x.data_ptr(), y.data_ptr(), r0, r1, k, stream)
    launches["spmv"] += 1
    _cuda.check(err, "ell_spmv")
    return y


def spmv(values, nbr, mask, x):
    """y = A @ x, (N, 3), for A in block-ELL form: values (N, K, 3, 3),
    nbr (N, K) int32, mask (N, K) 0/1 float32, x (N, 3)."""
    return spmv_rows(values, nbr, mask, x, 0, values.shape[0])


# -- fused smoothers -----------------------------------------------------------

def _relax_rows_plain(values, nbr, mask, diag_slot, b, x, r0: int, r1: int):
    """Rows [r0, r1) of D^{-1} (b - sum over every slot but the diagonal's of
    A_ik (x[nbr_ik] mask_ik)): the kernels' row pass, step by step."""
    from . import ell
    rows = torch.arange(r0, r1, device=values.device)
    slots = torch.arange(mask.shape[1], device=values.device)
    ds = diag_slot[r0:r1].long()
    off = slots[None, :] != ds[:, None]                   # (R, K)
    vals = torch.where(off[..., None, None], values[r0:r1],
                       torch.zeros_like(values[r0:r1]))
    xg = x[nbr[r0:r1].long()] * mask[r0:r1, :, None]
    s = torch.einsum("nkji,nki->nj", vals, xg)
    return ell.solve3x3(values[rows, ds], b[r0:r1] - s)


def gs_plain(values, nbr, mask, diag_slot, color_offsets, b, x0=None,
             iterations: int = 1):
    """The kernel's plain version: colored symmetric Gauss-Seidel as ONE
    in-place pass per color (colors last to first, then first to last)."""
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    nc = len(color_offsets) - 1
    order = list(range(nc - 1, -1, -1)) + list(range(nc))
    for _ in range(iterations):
        for c in order:
            r0, r1 = int(color_offsets[c]), int(color_offsets[c + 1])
            if r1 > r0:
                x[r0:r1] = _relax_rows_plain(values, nbr, mask, diag_slot, b,
                                             x, r0, r1)
    return x


def jacobi_plain(values, nbr, mask, diag_slot, b, x0=None,
                 iterations: int = 2):
    """The kernel's plain version: every row relaxed against the previous
    iterate."""
    x = torch.zeros_like(b) if x0 is None else x0
    for _ in range(iterations):
        x = _relax_rows_plain(values, nbr, mask, diag_slot, b, x, 0,
                              values.shape[0])
    return x


def _check_smoother(values, nbr, mask, diag_slot, b, x0):
    n, k = _check(values, nbr, mask, b)
    _cuda.require(diag_slot, (n,), "diag_slot", dtype=torch.int32)
    if x0 is not None:
        _cuda.require(x0, (n, 3), "x0")
    return n, k


def gs(values, nbr, mask, diag_slot, color_offsets, b, x0=None,
       iterations: int = 1):
    """`iterations` colored symmetric Gauss-Seidel iterations of A x = b from
    x0 (zero by default; not modified), (N, 3). A in block-ELL form, its
    diagonal blocks at diag_slot (N,) int32; color c is the row range
    [color_offsets[c], color_offsets[c + 1]) and must be an independent set
    (`solvers.smoothers.EllOperator` checks it)."""
    tensors = (values, nbr, mask, diag_slot, b) + (() if x0 is None else (x0,))
    n, k = _check_smoother(values, nbr, mask, diag_slot, b, x0)
    offs = [int(c) for c in color_offsets]
    nc = len(offs) - 1
    if not 1 <= nc <= 16 or offs[0] != 0 or offs[-1] != n or any(
            offs[c] > offs[c + 1] for c in range(nc)):
        raise ValueError(f"color_offsets {offs} do not partition [0, {n})")
    iterations = int(iterations)
    if iterations < 0:
        raise ValueError(f"iterations {iterations} < 0")
    if _cuda.on_cpu(*tensors):
        return gs_plain(values, nbr, mask, diag_slot, offs, b, x0, iterations)
    x = torch.zeros_like(b) if x0 is None else x0.clone()
    if iterations == 0:
        return x
    lib = _cuda.load()
    stream = torch.cuda.current_stream(b.device).cuda_stream
    with torch.cuda.device(b.device):
        err = lib.ell_gs(values.data_ptr(), nbr.data_ptr(), mask.data_ptr(),
                         diag_slot.data_ptr(), (ctypes.c_int * (nc + 1))(*offs),
                         nc, b.data_ptr(), x.data_ptr(), n, k, iterations,
                         stream)
    launches["gs"] += 1
    _cuda.check(err, "ell_gs")
    return x


def jacobi(values, nbr, mask, diag_slot, b, x0=None, iterations: int = 2):
    """`iterations` block-Jacobi iterations x <- D^{-1} (b - (L + U) x) from
    x0 (zero by default; not modified), (N, 3)."""
    tensors = (values, nbr, mask, diag_slot, b) + (() if x0 is None else (x0,))
    n, k = _check_smoother(values, nbr, mask, diag_slot, b, x0)
    iterations = int(iterations)
    if iterations < 0:
        raise ValueError(f"iterations {iterations} < 0")
    if _cuda.on_cpu(*tensors):
        return jacobi_plain(values, nbr, mask, diag_slot, b, x0, iterations)
    xa = torch.zeros_like(b) if x0 is None else x0.clone()
    if iterations == 0:
        return xa
    xb = torch.empty_like(xa)
    lib = _cuda.load()
    stream = torch.cuda.current_stream(b.device).cuda_stream
    with torch.cuda.device(b.device):
        err = lib.ell_jacobi(values.data_ptr(), nbr.data_ptr(),
                             mask.data_ptr(), diag_slot.data_ptr(),
                             b.data_ptr(), xa.data_ptr(), xb.data_ptr(), n, k,
                             iterations, stream)
    launches["jacobi"] += iterations       # one launch per iteration
    _cuda.check(err, "ell_jacobi")
    return xb if iterations % 2 else xa
