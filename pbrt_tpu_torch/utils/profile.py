"""Profiling hooks: named scopes, trace capture and per-stage timing.

Port of pbrt_tpu/utils/profile.py on torch.profiler. Reference analogue:
the per-kernel GPU launch statistics the reference keeps for every
wavefront kernel (pbrt-v4 src/pbrt/gpu/util.cpp:128-175, cudaEvent timers
per kernel, printed by --stats). Here (a) `scope` names a region in a
captured trace (a `torch.profiler.record_function` range, plus an NVTX
range when CUDA is in use), (b) `capture()` records a torch.profiler trace
of CPU and CUDA activity and exports it as a Chrome trace (chrome://tracing,
Perfetto), and (c) `timed_breakdown` times stages on the host when a full
trace is overkill.

Usage:
    with profile.capture("traces/render"):
        with profile.scope("cli/render"):
            render(...)

    @profile.scope("accel/closest")  # or: with profile.scope("..."):
    def closest(...): ...

With no capture running, a scope costs a record_function call (and an
NVTX push and pop on a CUDA process): microseconds. No hot path carries
one, as in the reference.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


class scope(contextlib.ContextDecorator):
    """A named trace range; a context manager and a decorator, nestable."""

    def __init__(self, name: str):
        self.name = name
        self._ranges = []

    def __enter__(self):
        rf = torch.profiler.record_function(self.name)
        rf.__enter__()
        nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
        if nvtx:
            torch.cuda.nvtx.range_push(self.name)
        self._ranges.append((rf, nvtx))
        return self

    def __exit__(self, *exc):
        rf, nvtx = self._ranges.pop()
        if nvtx:
            torch.cuda.nvtx.range_pop()
        rf.__exit__(*exc)
        return False


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def capture(logdir: str):
    """Record a torch.profiler trace of the enclosed block (CPU activity,
    and CUDA activity when a card is present) and export it as a Chrome
    trace to <logdir>/trace.json. Yields the profiler (key_averages())."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


def sync(x) -> float:
    """Wait for x's device, then read its sum back to the host."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)
    return float(x.sum())


def timed_breakdown(stages, warmup: int = 1, iters: int = 3):
    """Time a dict of {name: thunk} stages; each thunk returns a tensor
    that is sync()'d. Returns {name: seconds} (best of iters)."""
    out = {}
    for name, thunk in stages.items():
        for _ in range(warmup):
            sync(thunk())
        best = float("inf")
        for _ in range(iters):
            t0 = time.perf_counter()
            sync(thunk())
            best = min(best, time.perf_counter() - t0)
        out[name] = best
    return out
