"""host_syncs_per_frame (syncs/frame): the blocking device-to-host reads of
the frame driver, sim/lattice.py's step_to_tol, a frame, over the first
traced stretch: the program's counter lattice.counts["syncs"] over
lattice.counts["frames"], both read as each frame ends (the hook on
solvers/cg.py:newton_exit_norm, which step_to_tol calls once a frame) and
differenced between the stretch's first frame and its last, so whole frames
only. None without a CUDA device or where the program keeps no such
counters. Moves frame_ms: at each read the card idles while the host waits,
then launches again."""

import sys

HOOKS = (("fem_simulation_tpu_torch.solvers.cg", "newton_exit_norm"),)
LATTICE = "fem_simulation_tpu_torch.sim.lattice"


def record(box, args, kwargs, out):
    counts = getattr(sys.modules.get(LATTICE), "counts", None)
    if counts is not None:
        box.append(dict(counts))


def read(run):
    ends = run.store.get("host_syncs_per_frame", [])
    if not run.dev or len(ends) < 2:
        return None
    frames = ends[-1]["frames"] - ends[0]["frames"]
    if frames <= 0:
        return None
    return (ends[-1]["syncs"] - ends[0]["syncs"]) / frames
