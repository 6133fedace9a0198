"""scene_build_s (s): the program's scene set-up, LatticeScene.__init__
from build_level_topology to the low-fill cover: the duration of the
lattice.scene spans of the process (sim/lattice.py, recorded whether
tracing is on or not; one in a run of a cell) from utils/profiling.py's
records. None without a CUDA device or where the program records no such
span. Moves setup_s: the scene is built inside the set-up."""

import sys

PROFILING = "fem_simulation_tpu_torch.utils.profiling"


def read(run):
    records = getattr(sys.modules.get(PROFILING), "records", None)
    if not run.dev or records is None:
        return None
    spans = [r.end_ns - r.start_ns for r in records()
             if r.name == "lattice.scene"]
    return sum(spans) * 1e-9 if spans else None
