"""Simulators: the structured lattice (lattice.py) and the unstructured
block-ELL path (scene.py, quasistatic.py, dynamic.py)."""
from .scene import Scene  # noqa: F401
from .quasistatic import QuasiStaticSim  # noqa: F401
