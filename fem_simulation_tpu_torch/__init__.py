"""PyTorch/CUDA port of fem_simulation_tpu.

The JAX package `fem_simulation_tpu` is the reference this port is held
against; the port imports nothing of it (not even its numpy-only modules:
`mesh.py`, `hierarchy.py` and `config.py` have their own copies here). Two
slices are ported: the structured-lattice dynamic step (`sim/lattice.py`)
and the unstructured block-ELL path (`sim/scene.py`, `sim/quasistatic.py`,
`sim/dynamic.py`). The TPU kernels become hand-written CUDA C++ for sm_90a
(`csrc/`); on CPU tensors each kernel wrapper runs its plain torch version
instead (`ops/lattice_kernels.py`, `ops/ell_kernels.py`).

Entry points that take a `device` run on the GPU unless the caller passes
another device (`device="cpu"`, as the CPU tests do): with no device given
they take `require_cuda()`, which raises where there is no GPU.

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
        raise RuntimeError("CUDA is not available: the port's kernels need "
                           "an NVIDIA GPU (built for sm_90a); pass "
                           "device='cpu' for the plain torch versions")
    return torch.device("cuda")


def device_or_cuda(device=None) -> torch.device:
    """`device` as a torch.device; the GPU (require_cuda) when it is None."""
    return require_cuda() if device is None else torch.device(device)
