"""Profiling, timing and tracing helpers.

Port of `fem_simulation_tpu/utils/profiling.py` (without the JAX-only
compile cache): `force_sync` waits for the device, `trace` records a
`torch.profiler` trace, and `time_fn` times a call with CUDA events when it
runs on the card.

Spans: `span(name)` times a block of the program on the host's monotonic
ns clock. A record holds the span's name, start and end, the id of the span
it opened inside (-1 at the top) and a request id: the one given to the
outermost span of a request (a frame's number), inherited by every span
inside it. Records are kept in memory, the newest `MAX_RECORDS`
(`records()`, `reset()`).

Tracing is on while a torch profiler session is active, and from
`enable()` to `disable()`. Off, a span site tests a flag and enters a
shared no-op context; it builds nothing and records nothing. On, each span
is also a `record_function` range while the profiler runs, so it shows on
the profiler's timeline. The range is opened through its own binding
(`torch.autograd._record_function_with_args_enter`): under a profiler
`torch.profiler.record_function` costs several times as much, its enter and
exit being dispatched ops that the profiler records. A span given
`always=True` (a scene's set-up, once a process) is recorded whether
tracing is on or not.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd import profiler as _torch_profiler

# the newest span records kept
MAX_RECORDS = 1 << 16


class Record(NamedTuple):
    id: int
    name: str
    start_ns: int       # time.monotonic_ns()
    end_ns: int
    parent: int         # the id of the span it opened in, -1 at the top
    request: int        # the request it belongs to, -1 outside any


_records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count()
_open = threading.local()      # .stack: this thread's open spans
_enabled = False
_range_enter = torch.autograd._record_function_with_args_enter
_range_exit = torch.autograd._record_function_with_args_exit


def enable() -> None:
    """Turn tracing on until disable(), with or without a profiler."""
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def tracing() -> bool:
    """Whether spans are recorded: after enable(), or while a torch
    profiler session is active."""
    return _enabled or _torch_profiler._is_profiler_enabled


def records() -> list:
    """The kept span records, in the order they closed."""
    return list(_records)


def reset() -> None:
    """Forget the kept records (open spans still record when they close)."""
    _records.clear()


class _Span:
    __slots__ = ("name", "request", "id", "parent", "start", "range")

    def __init__(self, name: str, request):
        self.name, self.request = name, request

    def __enter__(self):
        stack = getattr(_open, "stack", None)
        if stack is None:
            stack = _open.stack = []
        outer = stack[-1] if stack else None
        self.id = next(_ids)
        self.parent = outer.id if outer is not None else -1
        if self.request is None:
            self.request = outer.request if outer is not None else -1
        stack.append(self)
        self.range = (_range_enter(self.name)
                      if _torch_profiler._is_profiler_enabled else None)
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        if self.range is not None:
            _range_exit(self.range)
        _open.stack.pop()
        _records.append(Record(self.id, self.name, self.start, end,
                               self.parent, self.request))
        return False


_OFF = contextlib.nullcontext()


def span(name: str, request: int | None = None, always: bool = False):
    """A context manager timing its block as the span `name`. `request`
    starts a request (a frame's number); without it the span takes the
    request of the span it opens in. Off (tracing() false, always false) it
    is a shared no-op."""
    if always or _enabled or _torch_profiler._is_profiler_enabled:
        return _Span(name, request)
    return _OFF


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
def trace(log_dir: str = "torch_trace"):
    """torch.profiler trace of the block (the CPU, and the card where there
    is one), written as a Chrome trace into log_dir; yields the profiler.
    The spans opened in the block are ranges of the trace."""
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
