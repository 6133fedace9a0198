"""frame_ms_p95 (ms): the 95th percentile of the window's frame times, each
frame timed on the host clock from its call to its own synchronize, over
all the window's frames. Moves frame_ms (the tail of its frames)."""

import numpy as np


def read(run):
    if not run.requests:
        return None
    return float(np.percentile([ms for _, _, ms in run.requests], 95))
