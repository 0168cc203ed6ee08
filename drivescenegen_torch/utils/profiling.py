"""Profiling and tracing (the port's counterpart of
drivescenegen_tpu/utils/profiling.py): torch.profiler traces of the host
and the card, written as Chrome traces (chrome://tracing, Perfetto), named
regions, and a wall-clock timer.

The JAX module's enable_compilation_cache has no counterpart: nothing here
is compiled by XLA (the kernels' nvcc builds are cached by ops/build.py).
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(log_dir: str | None):
    """Profile the enclosed block (the CPU, and CUDA when a card is there)
    and write it to <log_dir>/trace_<pid>.json; a no-op when log_dir is
    empty."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named region in the trace timeline."""
    with torch.profiler.record_function(name):
        yield


class Timer:
    """Wall-clock block timer: with Timer() as t: ...; t.seconds"""

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        return False
