"""device_idle.frames (%): 100 (1 - busy / window) over the first traced
stretch of the frames (torch.profiler, the device alone): busy is the union
of the device events' intervals, window the stretch's host wall time from
its first call to its last synchronize. Moves frame_ms: the share of a
frame the host keeps the card waiting."""


def read(run):
    if not run.dev or run.stretch_s <= 0.0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.stretch_s)
