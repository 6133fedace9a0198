"""Reductions of a torch.profiler trace: device busy time, the operations
that took most of it, kernel spans by name, and the idle gaps with what
the host was doing in them.

The busy-time union copies the arithmetic of
`scripts/lattice_frame_times.py --profile` and
`scripts/profile_torch_lattice_mg.py`: every device event (kernels, copies,
fills) is an interval, and the device is busy on their union. Times are in
the profiler's microseconds.
"""
from __future__ import annotations

import bisect

import torch

# host events searched back from a gap for one still open
_LOOK_BACK = 4096


def events(prof):
    """(device events, host events) of a finished profile, each a list of
    (name, start_us, end_us) sorted by start. A record_function range also
    shows on the device's timeline as a user annotation over the work it
    launched: that is no device work, and is left out."""
    evs = list(prof.events())
    ranges = {e.name for e in evs if getattr(e, "is_user_annotation", False)
              and e.device_type == torch.autograd.DeviceType.CPU}
    dev, host = [], []
    for e in evs:
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if not (getattr(e, "is_user_annotation", False)
                    or e.name in ranges):
                dev.append(span)
        elif e.device_type == torch.autograd.DeviceType.CPU:
            host.append(span)
    dev.sort(key=lambda s: s[1])
    host.sort(key=lambda s: s[1])
    return dev, host


def busy_segments(dev):
    """The union of the device events as disjoint (start, end), in order."""
    out = []
    for _, s, e in sorted(dev, key=lambda d: d[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(seg) for seg in out]


def busy_us(dev) -> float:
    return sum(e - s for s, e in busy_segments(dev))


def spans(dev, name_part: str):
    """Durations (us) of the device events whose name holds name_part, in
    launch order."""
    return [e - s for name, s, e in dev if name_part in name]


def top_ops(dev, n: int = 10):
    """[[name, seconds], ...]: the n device operations with the most device
    time, largest first."""
    tot = {}
    for name, s, e in dev:
        tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(dev, host, t0: float, t1: float, n: int = 10):
    """[[what the host was doing, seconds], ...]: the device's idle time in
    [t0, t1], each gap named by the innermost host event open at its middle
    (or "host: between torch ops"), summed by name, the n largest first."""
    gaps, cur = [], t0
    for s, e in busy_segments(dev):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
        if cur >= t1:
            break
    if cur < t1:
        gaps.append((cur, t1))
    starts = [hs for _, hs, _ in host]
    tot = {}
    for s, e in gaps:
        if e <= s:
            continue
        mid = 0.5 * (s + e)
        # nested host events: the innermost open one started last; look
        # back from the last start before the middle
        label = "host: between torch ops"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - _LOOK_BACK, -1), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        tot[label] = tot.get(label, 0.0) + (e - s) * 1e-6
    return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
