"""Multi-device stepping: the device grid and the distributed solvers.

Port of `fem_simulation_tpu/parallel/`: `dist` (the grid, the collectives,
the batched step), `lattice_halo` (the z-slab halo lattice step), `halo`
(the unstructured halo matvec, CG and Newton step) and `lattice_mg_dist`
(the distributed lattice multigrid)."""
from .dist import (DeviceGrid, make_batched_step,  # noqa: F401
                   make_device_mesh)
from .lattice_mg_dist import (DistLatticeMG,  # noqa: F401
                              make_dist_mg_quasistatic, make_dist_mg_step)
