"""frame_dispatch_us (us): the host's time in a frame apart from its waits
on the card, over the first traced stretch: the duration of each of the
program's lattice.frame spans (sim/lattice.py:step_to_tol, one a frame)
less the lattice.readback spans inside it (its blocking reads), averaged
over the stretch's frames. The spans come from utils/profiling.py's
records, a frame's spans by the frame's request id, the frames those whose
number lattice.counts["frames"] held as they ended (the hook on
solvers/cg.py:newton_exit_norm, which step_to_tol calls once a frame), so
whole frames only. The profiler runs in that stretch: its record_function
ranges, its CUDA activity and the readers' hooks are in the time. None
without a CUDA device or where the program records no such spans. Moves
frame_ms: time the host spends launching and computing while the card
waits or runs ahead."""

import sys

HOOKS = (("fem_simulation_tpu_torch.solvers.cg", "newton_exit_norm"),)
LATTICE = "fem_simulation_tpu_torch.sim.lattice"
PROFILING = "fem_simulation_tpu_torch.utils.profiling"


def record(box, args, kwargs, out):
    counts = getattr(sys.modules.get(LATTICE), "counts", None)
    if counts is not None:
        box.append(counts["frames"])


def read(run):
    frames = set(run.store.get("frame_dispatch_us", []))
    records = getattr(sys.modules.get(PROFILING), "records", None)
    if not run.dev or not frames or records is None:
        return None
    whole, waits = {}, {}
    for r in records():
        if r.request not in frames:
            continue
        if r.name == "lattice.frame":
            whole[r.request] = r.end_ns - r.start_ns
        elif r.name == "lattice.readback":
            waits[r.request] = waits.get(r.request, 0) + r.end_ns - r.start_ns
    if not whole:
        return None
    run.note(f"frame_dispatch_us: {len(whole)} frames, a frame "
             f"{sum(whole.values()) / len(whole) * 1e-3:.1f} us of which "
             f"reads {sum(waits.values()) / len(whole) * 1e-3:.1f} us")
    return sum(whole[i] - waits.get(i, 0) for i in whole) / len(whole) * 1e-3
