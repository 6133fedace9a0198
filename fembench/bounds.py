"""The least time a kernel call could take on the card: the table of peaks and
the operations and bytes of the lattice kernels.

Frozen copies, as they stood when the benchmark was defined, of
`fem_simulation_tpu_torch/ops/lattice_kernels.py`'s FLOP counts per cell
and per vertex (the chains unrolled: force 449, hvp 763, diag 930 a Gauss
point) and of `chip_smoke.py`'s `bound` and `lattice_bounds` / `shell_bounds`
(fused_newton). A kernel's roofline share is the sum of
these bounds over its launches in a trace, over the sum of their device
times: every input read once and every output written once, the FLOPs of
the real cells and vertices, whatever the kernel reads again.
"""
from __future__ import annotations

FORCE_FLOPS_PER_CELL = 449 * 8
HVP_FLOPS_PER_CELL = 763 * 8
DIAG_FLOPS_PER_CELL = 930 * 8

# Published peaks (dense, no sparsity) by the name torch.cuda.get_device_name
# gives: (HBM bytes/s, float32 FLOP/s outside the tensor cores). The SXM
# H100 at its 700 W limit.
PEAKS = {"NVIDIA H100 80GB HBM3": (3.35e12, 67e12)}


def peaks(device_name: str):
    """(bytes/s, FLOP/s) of this card, or None when the table lacks it."""
    return PEAKS.get(device_name)


def bound_s(n_bytes: float, flops: float, peak) -> float:
    """The larger of bytes over the memory rate and float32 FLOPs over the
    float32 rate, in seconds."""
    bytes_per_s, flop_per_s = peak
    return max(n_bytes / bytes_per_s, flops / flop_per_s)


def fused_newton_work(verts: float, cells: float, k: int):
    """(bytes, FLOPs) of one lat_fused_newton launch on a body of `verts`
    real vertices and `cells` real cells whose PCG ran k - 1 HVPs: u and s
    (fields), ctrl, rc and the vertex mask in, the cell mask in, dx and f
    out, the norm and k out; two force chains, the diagonal and the HVPs
    of the real cells. On a dense body (every lattice vertex and cell
    real) this is chip_smoke.lattice_bounds' fused_newton, on a covered one
    its shell_bounds'."""
    field = 3 * verts * 4
    n_bytes = 4 * field + 3 * verts * 4 + 4 * cells + 8
    flops = cells * (2 * FORCE_FLOPS_PER_CELL + DIAG_FLOPS_PER_CELL
                     + (k - 1) * HVP_FLOPS_PER_CELL)
    return n_bytes, flops

