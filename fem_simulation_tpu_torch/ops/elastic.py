"""Trilinear hex shape-function gradients at the 2x2x2 Gauss points.

Port of the numpy part of `fem_simulation_tpu/ops/elastic.py` (that module
imports jax, so it is not reused). The table is exact in float64 and
returned as float32, as in the reference.
"""
from __future__ import annotations

import numpy as np

# Corner sign table, local corner index = 4*di + 2*dj + dk (mesh.CORNER_OFFSETS),
# mapped to reference-element coordinates in {-1, +1}^3.
_SIGNS = np.array(
    [[2 * i - 1, 2 * j - 1, 2 * k - 1]
     for i in range(2) for j in range(2) for k in range(2)],
    dtype=np.float64,
)

# 2x2x2 Gauss points at +-1/sqrt(3) in the same layout.
_QUAD = _SIGNS / np.sqrt(3.0)


def shape_func_grad() -> np.ndarray:
    """S[i, q, d] = dN_i/dxi_d at Gauss point q, N_i(xi) = prod_d (1 + h_id xi_d) / 2."""
    S = np.zeros((8, 8, 3))
    for i in range(8):
        for q in range(8):
            for d in range(3):
                val = _SIGNS[i, d] / 2.0
                for e in range(3):
                    if e != d:
                        val *= (1.0 + _SIGNS[i, e] * _QUAD[q, e]) / 2.0
                S[i, q, d] = val
    return S.astype(np.float32)
