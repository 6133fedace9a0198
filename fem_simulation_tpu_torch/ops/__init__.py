"""Lattice operators: plain torch versions and the CUDA kernel wrappers."""
from __future__ import annotations

import torch


def take_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] for an integer index tensor into x's first dimension, by
    torch.index_select: the same gather forward; its backward adds through
    index_add_, which on CUDA adds with atomics, so a gradient through it
    need not repeat its bits there (PERF.md gives the spread). x[idx]'s
    backward sums in a fixed order but sorts the indices, which on the
    port's padded gather tables dominated an exp2 training step on an
    H100."""
    return torch.index_select(x, 0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(x.shape[1:]))
