"""The six readers of the program's own spans (sampler.step, quantize.copy,
quantize.host, train.forward, train.backward) on small synthetic
torch.profiler chrome traces, and the span counts they demand, as the
port opens them in the harness's traced part on the CPU."""

import json
import os
import tempfile

import pytest

from benchmark import harness, trace_summary
from conftest import tiny_cell

WINDOW = ("bench.window", 0, 10000)


def summarize(tmp_path, spans, kernels=(), copies=()):
    """The Summary of a chrome trace: `spans` (name, start, end) as user
    annotations, `kernels` (name, launch ts, start, dur) with their
    launches, `copies` (start, dur) device-to-host copies, in us."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": a, "dur": b - a}
              for n, a, b in spans]
    for i, (name, launch, start, dur) in enumerate(kernels):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 2, "args": {"correlation": 100 + i}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
                       "args": {"correlation": 100 + i}})
    for i, (start, dur) in enumerate(copies):
        events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": start,
                       "dur": dur, "args": {"correlation": 900 + i}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return trace_summary.summarize(trace_summary.load(str(path)), "bench.window")


def read(metric, summary, batches=2, **profiled):
    return harness.metric_module(metric).read({
        "trace": summary, "profiled": profiled, "host": {},
        "cell": {"params": {"profiled_batches": batches}}})


def sampling_spans(drop=None):
    """Two batches of two steps, at 0 and 5000 us: each step a
    "sampler.step" of 1400 us holding a "dispatch"; then "quantize" holding
    "quantize.copy" and "quantize.host". `drop` leaves out the first span
    of that name."""
    spans = [WINDOW]
    for o in (0, 5000):
        spans += [("sampler", o, o + 3000),
                  ("sampler.step", o, o + 1400), ("dispatch", o + 100, o + 1000),
                  ("sampler.step", o + 1500, o + 2900), ("dispatch", o + 1600, o + 2500),
                  ("quantize", o + 3000, o + 4500), ("quantize.copy", o + 3010, o + 3300),
                  ("quantize.host", o + 3300, o + 4400)]
    if drop is not None:
        spans.remove(next(s for s in spans if s[0] == drop))
    return spans


def sampling_trace(tmp_path, drop=None):
    kernels, copies = [], []
    for o in (0, 5000):
        kernels += [("conv", o + 150, o + 200, 1000),  # forward 1: 200-1200
                    ("ddim_update", o + 1100, o + 1200, 100),  # in its step, no dispatch
                    ("conv", o + 1650, o + 1400, 1200),  # forward 2: 1400-2600
                    ("ddim_update", o + 2600, o + 2600, 100)]
        copies.append((o + 3150, 50))  # the batch to the host: 3150-3200
    return summarize(tmp_path, sampling_spans(drop), kernels, copies)


@pytest.mark.parametrize("suffix", ["sample", "bulk"])
def test_step_host_ms_is_the_mean_step_span(tmp_path, suffix):
    s = sampling_trace(tmp_path)
    assert read(f"step_host_ms.{suffix}", s, forwards=4) == pytest.approx(1.4)
    # the step spans enclose the harness's dispatch spans, which stay
    # innermost for the forward's kernels
    assert read(f"forward_device_ms.{suffix}", s, forwards=4) == pytest.approx(1.1)


@pytest.mark.parametrize("suffix", ["sample", "bulk"])
def test_quantize_idle_ms_sums_the_gaps_in_the_copy_and_host_spans(tmp_path, suffix):
    s = sampling_trace(tmp_path)
    # Gaps: 0-200 (dispatch), 1300-1400 (sampler.step), 2700-3150 (middle
    # 2925: sampler), 3200-5200 (middle 4200: quantize.host), 6300-6400,
    # 7700-8150 as in batch 0, 8200-10000 (middle 9100: quantize.host).
    by = dict(s.idle_by_span())
    assert by["quantize.host"] == pytest.approx(3800e-6)
    assert read(f"quantize_idle_ms.{suffix}", s) == pytest.approx(3.8 / 2)


@pytest.mark.parametrize("metric,drop", [("step_host_ms.sample", "sampler.step"),
                                         ("step_host_ms.bulk", "sampler.step"),
                                         ("quantize_idle_ms.sample", "quantize.host"),
                                         ("quantize_idle_ms.sample", "quantize.copy"),
                                         ("quantize_idle_ms.bulk", "quantize.host")])
def test_sampling_readers_are_silent_when_a_span_is_missing(tmp_path, metric, drop):
    assert read(metric, sampling_trace(tmp_path, drop=drop), forwards=4) is None


def test_readers_are_silent_on_a_trace_without_the_programs_spans(tmp_path):
    """The parent's program opens none of these spans: each reader returns
    None there, and raises nothing."""
    spans = [s for s in sampling_spans() if "." not in s[0] or s[0] == "bench.window"]
    s = summarize(tmp_path, spans, [("conv", 150, 200, 1000)], [(3150, 50)])
    for metric in ("step_host_ms.sample", "quantize_idle_ms.sample", "forward_device_ms.train",
                   "backward_device_ms.train"):
        assert read(metric, s, forwards=4, steps=1) is None
    # and a step count that does not match
    assert read("step_host_ms.sample", sampling_trace(tmp_path), forwards=5) is None


def test_idle_in_the_bare_quantize_span_does_not_count(tmp_path):
    spans = [WINDOW, ("quantize", 0, 1000), ("quantize.copy", 100, 200),
             ("quantize.host", 200, 600)]
    kernels = [("k", 1, 0, 150), ("cat", 610, 550, 100), ("k", 800, 850, 9150)]
    s = summarize(tmp_path, spans, kernels)
    # gaps 150-550 (middle 350: quantize.host) and 650-850 (middle 750:
    # the harness's quantize alone)
    assert dict(s.idle_by_span()) == pytest.approx({"quantize.host": 400e-6,
                                                    "quantize": 200e-6})
    assert read("quantize_idle_ms.sample", s, batches=1) == pytest.approx(0.4)


def train_trace(tmp_path, forwards=1):
    spans = [WINDOW, ("train_step", 0, 1950), ("train.step", 2, 1900),
             ("train.backward", 500, 1200), ("train.update", 1200, 1800),
             ("Optimizer.step#AdamW.step", 1300, 1700)]
    spans += [("train.forward", 10 + 20 * i, 490) for i in range(forwards)]
    kernels = [("normalize", 5, 5, 10),  # in train.step alone
               ("conv_fwd", 20, 20, 300), ("silu", 40, 320, 100),  # forward: 400
               ("conv_bwd", 600, 600, 400),  # backward: 400
               ("norm", 1250, 1250, 20), ("adam", 1400, 1400, 50)]  # update, optimizer
    return summarize(tmp_path, spans, kernels)


def test_train_readers_read_the_kernels_innermost_in_their_span(tmp_path):
    s = train_trace(tmp_path)
    assert read("forward_device_ms.train", s, steps=1) == pytest.approx(0.4)
    assert read("backward_device_ms.train", s, steps=1) == pytest.approx(0.4)
    # two steps' worth expected, one span of each found: silent
    assert read("forward_device_ms.train", s, steps=2) is None
    assert read("backward_device_ms.train", s, steps=2) is None


def test_train_readers_are_silent_when_a_step_has_two_spans(tmp_path):
    s = train_trace(tmp_path, forwards=2)
    assert read("forward_device_ms.train", s, steps=1) is None
    assert read("backward_device_ms.train", s, steps=1) == pytest.approx(0.4)


def profiled_spans(name):
    """The host spans of cell `name`'s traced part, run at a tiny size on
    the CPU under a profiler session as the harness starts it, and what
    the part returned."""
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)
    from torch.autograd import _disable_profiler, _enable_profiler, _prepare_profiler

    spec, cell, config = tiny_cell(name)
    run = harness.traffic_module(cell["kind"]).Cell(cell, config, 3_000_000_019, "cpu")
    run.setup()
    acts = {ProfilerActivity.CPU}
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                         _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts, {RecordScope.USER_SCOPE})
    run.spans.on = True
    try:
        with run.spans(harness.WINDOW_SPAN):
            out = run.profiled()
    finally:
        run.spans.on = False
        result = _disable_profiler()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        result.save(path)
        summary = trace_summary.summarize(trace_summary.load(path), harness.WINDOW_SPAN)
    finally:
        os.unlink(path)
    return cell, out, summary


@pytest.mark.parametrize("name", ["dsg_ref_unet256.ddim50_b8", "dsg_cond128.cfg_ddim50_b32"])
def test_a_sampling_cells_traced_part_opens_the_spans_its_readers_count(name):
    cell, out, s = profiled_spans(name)
    assert s.span_count("sampler.step") == out["forwards"] == s.span_count("dispatch")
    batches = cell["params"]["profiled_batches"]
    assert s.span_count("quantize.copy") == s.span_count("quantize.host") == batches
    # no program span inside a denoiser call
    calls = [sp for sp in s.spans if sp[0] == "dispatch"]
    assert not [p for p in s.spans if "." in p[0] for c in calls
                if c[1] <= p[1] and p[2] <= c[2]]
    reading = {"trace": s, "profiled": out, "host": {}, "cell": cell}
    assert harness.metric_module("step_host_ms.sample").read(reading) > 0


def test_the_train_cells_traced_part_opens_one_span_of_each_phase_a_step():
    cell, out, s = profiled_spans("dsg_ref_unet256.train_b14")
    for span in ("train.step", "train.forward", "train.backward", "train.update"):
        assert s.span_count(span) == out["steps"], span
