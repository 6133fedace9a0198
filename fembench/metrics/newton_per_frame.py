"""newton_per_frame (newton/frame): the Newton iterations that
sim/lattice.py:step_to_tol returned, summed over the window's frames, over
the frames. Moves frame_ms: each iteration is one lat_fused_newton launch
and one host sync."""


def read(run):
    if not run.requests:
        return None
    return sum(k for k, _, _ in run.requests) / len(run.requests)
