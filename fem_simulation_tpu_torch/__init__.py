"""PyTorch/CUDA port of the structured-lattice dynamic step.

The JAX package `fem_simulation_tpu` is the reference this port is held
against. The port reuses its numpy-only modules as they are
(`fem_simulation_tpu.mesh`, `.hierarchy`, `.config`: that package has no
top-level `__init__`, so importing them loads no jax) and rewrites every
module that imports jax in torch. The lattice kernels are hand-written CUDA
C++ for sm_90a (`csrc/`); on CPU tensors each kernel wrapper runs its plain
torch version instead (`ops/lattice_kernels.py`).

Everything is float32. Reduced-precision matmuls destroy the F^T F - I
cancellation of the Green strain and stall Newton near 1e-2, so TF32 is
switched off here, at import, for both matmul and cuDNN.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def require_cuda() -> torch.device:
    """The CUDA device, or RuntimeError when this process has none."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the lattice kernels need "
                           "an NVIDIA GPU (built for sm_90a)")
    return torch.device("cuda")
