"""Profiling and tracing (the port's counterpart of
drivescenegen_tpu/utils/profiling.py): torch.profiler traces of the host
and the card, written as Chrome traces (chrome://tracing, Perfetto), and
the program's named spans.

A span is a record_function range, opened only while a profiler records
(`trace` below, or any torch.profiler / Kineto session with user-scope
ranges): it then lands in that session's trace beside the kernels, on the
same clock. With no profiler it is a shared null context, one C check a
span. Span names are fixed, one a kind of work:

  sampler.step     diffusion/samplers.py: one step of every sampler (the
                   denoiser call, the step's noise draw, the update); it
                   encloses the denoiser call and opens nothing inside it
  quantize.copy    scripts/generation.py quantize: the wait for the batch
                   and the device-to-host copy
  quantize.host    the same: the numpy clip, scale, round and cast
  train.step       training/trainer.py: one train step, whole
  train.forward    add_noise, the model's training arm, the MSE
  train.backward   loss.backward()
  train.update     the all-reduce, global norm, clip, lr, optimizer, EMA
  feed.next_batch  scripts/train.py: the feed's batch for a step

The JAX module's enable_compilation_cache has no counterpart: nothing here
is compiled by XLA (the kernels' nvcc builds are cached by ops/build.py).
"""

from __future__ import annotations

import contextlib
import os

import torch

_OFF = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


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


def annotate(name: str):
    """The span `name`: a record_function range while a profiler records,
    else the shared null context."""
    if _recording():
        return torch.profiler.record_function(name)
    return _OFF
