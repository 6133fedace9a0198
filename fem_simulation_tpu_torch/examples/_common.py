"""What the drivers share: the repo's results directory, the beam scene."""
from __future__ import annotations

import os

from .. import mesh as meshlib
from ..config import SolverConfig
from ..sim.scene import Scene

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = os.path.join(ROOT, "results")


def beam_shape(text: str):
    """"16,16,72" -> (16, 16, 72)."""
    return tuple(int(s) for s in text.split(","))


def beam_scene(shape, dx: float = 0.05, device=None) -> Scene:
    """The 2-level unstructured Scene of a beam (the GPU by default)."""
    return Scene(meshlib.beam(*shape, dx=dx),
                 solver=SolverConfig(n_levels=2), device=device)


def out_path(out, name: str) -> str:
    """`out`, or results/<name> in the repo."""
    if out:
        return out
    os.makedirs(RESULTS, exist_ok=True)
    return os.path.join(RESULTS, name)
