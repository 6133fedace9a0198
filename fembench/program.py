"""Where the harness meets the program under test, fem_simulation_tpu_torch:
its scene built from the benchmark's own body and configuration.

The program's package is imported here, inside the functions, so that the
harness and the reference load without it (a checkout that holds only the
benchmark must fail at set-up, not at import).
"""
from __future__ import annotations

import torch


def lattice_scene(body: dict, config: dict, device):
    """The program's LatticeScene of `body` (the benchmark's arrays, as the
    program's HexMesh) under the configuration's material, top slab pinned."""
    from fem_simulation_tpu_torch import mesh as pmesh
    from fem_simulation_tpu_torch.config import MaterialConfig
    from fem_simulation_tpu_torch.sim import lattice
    mesh = pmesh.HexMesh(x=body["x"], hexes=body["hexes"], ijk=body["ijk"],
                         dx=body["dx"], origin=body["origin"])
    return lattice.LatticeScene(mesh, MaterialConfig(**config["material"]),
                                device=device)


def field(a, device) -> torch.Tensor:
    """A numpy lattice field as a float32 tensor on `device`."""
    return torch.from_numpy(a).to(device=device, dtype=torch.float32)
