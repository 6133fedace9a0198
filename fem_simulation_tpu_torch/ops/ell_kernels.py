"""Block-ELL SpMV: the public wrappers, their plain torch versions, counts.

Port of `fem_simulation_tpu/ops/pallas_kernels.py` (`spmv`, the lanes-layout
Pallas kernel) in the (N, K, 3, 3) ELL layout of `ops/ell.py`, which a GPU
can gather from directly. The kernel is `ell_spmv` in `csrc/ell_kernels.cu`.

Dispatch: a wrapper checks its arguments' dtypes, shapes and contiguity,
then runs its plain version (`*_plain`) only when its tensors lie on the
CPU. For CUDA tensors it launches the kernel or raises; it never falls back.
`launches["spmv"]` counts the kernel launches (one per call with a
non-empty row range); `ops.ell.cuda_calls` counts the calls made on CUDA
tensors one layer up, so a run can check that every call launched.
"""
from __future__ import annotations

import torch

from . import _cuda

launches = {"spmv": 0}


def reset_launches() -> None:
    launches["spmv"] = 0


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
