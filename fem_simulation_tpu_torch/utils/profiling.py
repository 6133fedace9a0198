"""Profiling and timing helpers.

Port of `fem_simulation_tpu/utils/profiling.py` (without the JAX-only
compile cache): `force_sync` waits for the device, `wall_timer` records
host time, `trace` records a `torch.profiler` trace, and `time_fn` times a
call with CUDA events when it runs on the card.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def _tensors(tree):
    if torch.is_tensor(tree):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def force_sync(tree):
    """Wait until every CUDA tensor of a nested dict / list / tuple is
    computed: one torch.cuda.synchronize per device it uses."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def wall_timer(label: str = "", sink: dict | None = None):
    t0 = time.perf_counter()
    yield
    dt = time.perf_counter() - t0
    if sink is not None:
        sink.setdefault(label, []).append(dt)


@contextlib.contextmanager
def trace(log_dir: str = "torch_trace"):
    """torch.profiler trace of the block (the CPU, and the card where there
    is one), written as a Chrome trace into log_dir; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def time_fn(fn, args, iters: int = 10, warmup: int = 2) -> float:
    """Median seconds per call of fn(*args): CUDA events around each call
    when an argument or the result lies on the card, the host clock after
    force_sync otherwise."""
    on_card = any(t.is_cuda for t in _tensors(args))
    for _ in range(warmup):
        out = fn(*args)
        on_card = on_card or any(t.is_cuda for t in _tensors(out))
        force_sync(out)
    times = []
    for _ in range(iters):
        if on_card:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(*args)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) * 1e-3)
        else:
            t0 = time.perf_counter()
            force_sync(fn(*args))
            times.append(time.perf_counter() - t0)
    return float(np.median(times))
