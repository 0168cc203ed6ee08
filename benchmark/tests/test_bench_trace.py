"""The trace reader and each per-layer metric's arithmetic, on a small
synthetic torch.profiler chrome trace; the traced part's retry rule."""

import json

import pytest

from benchmark import counts, harness, trace_summary

CONV = "void (anonymous namespace)::silu_conv3x3_kernel<128>(CUtensorMap_st)"
GLUE = "void at::native::elementwise_kernel<128, 4, at::native::CUDAFunctor_add>(int)"
ADAM = "void at::native::multi_tensor_apply_kernel<Adam>(int)"
FWD, BWD = "void flash_attention_d8_kernel<true>(Args)", "void flash_attention_bwd_d8_kernel(Args)"


def trace_file(tmp_path, kernels, spans):
    """A chrome trace: `kernels` (name, launch ts, start, dur) with their
    launches, `spans` (name, ts, dur) as user annotations."""
    events = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": ts, "dur": d, "pid": 1,
               "tid": 1} for n, ts, d in spans]
    for i, (name, launch, start, dur) in enumerate(kernels):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 2, "args": {"correlation": 100 + i}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": start, "dur": dur,
                       "args": {"correlation": 100 + i}})
    events.append({"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 950, "dur": 20,
                   "args": {"correlation": 999}})
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


@pytest.fixture
def summary(tmp_path):
    # window 0-1000 us; two "dispatch" spans inside "sampler"; a "quantize".
    spans = [("bench.window", 0, 1000), ("sampler", 10, 800), ("dispatch", 20, 200),
             ("dispatch", 400, 200), ("quantize", 900, 90), ("dispatch", 1500, 10)]
    kernels = [(CONV, 30, 100, 50), (GLUE, 40, 150, 100),  # busy 100-250
               (CONV, 410, 300, 50), (GLUE, 420, 340, 10),  # 300-350
               ("ddim_update", 700, 700, 100)]  # launched in the sampler, not a dispatch
    return trace_summary.summarize(trace_summary.load(trace_file(tmp_path, kernels, spans)),
                                   "bench.window")


def test_busy_union_gaps_and_spans(summary):
    assert summary.window_s == pytest.approx(1e-3)
    # 100-250, 300-350, 700-800, 950-970
    assert summary.busy_s == pytest.approx(320e-6)
    assert summary.span_count("dispatch") == 2  # the one outside the window is dropped
    assert [k.span for k in summary.kernels()] == ["dispatch"] * 4 + ["sampler"]
    assert len(summary.kernels("silu_conv3x3_kernel")) == 2
    idle = dict(summary.idle_by_span())
    # gaps 0-100, 250-300, 350-700, 800-950, 970-1000, each labelled by the
    # innermost span open at its middle
    assert sum(idle.values()) == pytest.approx(680e-6)
    assert idle["quantize"] == pytest.approx(30e-6)  # 970-1000, middle 985 in quantize
    assert summary.top_ops(1)[0][0] == GLUE


def reading(summary, **profiled):
    cfg = harness.load_json(harness.HERE / "configs" / "dsg_ref_unet256.json")
    return {"config": cfg, "cell": {}, "trace": summary, "profiled": profiled,
            "host": {"dispatch_s": [0.010, 0.014], "wall_s": 2.0, "forwards": 100,
                     "steps": 10, "forward_flops": 1e12}}


def test_sampling_metrics(summary):
    r = reading(summary, forwards=2, rows_per_forward=8)
    read = {m: harness.metric_module(m).read(r) for m in
            ("dispatch_ms.sample", "forward_device_ms.sample", "mfu.sample", "idle_share.sample")}
    assert read["dispatch_ms.sample"] == pytest.approx(12.0)
    assert read["forward_device_ms.sample"] == pytest.approx((50 + 100 + 50 + 10) / 1e3 / 2)
    assert read["mfu.sample"] == pytest.approx(100 * 1e12 * 100 / 2.0 / counts.PEAK_FLOPS)
    assert read["idle_share.sample"] == pytest.approx(68.0)
    # the conv roofline is silent unless every launch of the forwards is there
    assert harness.metric_module("conv_roofline.sample").read(r) is None


def test_conv_roofline(tmp_path):
    cfg = harness.load_json(harness.HERE / "configs" / "dsg_ref_unet256.json")["model"]
    bound, n = counts.conv3x3_forward_bound_s(cfg, 8)
    kernels = [(CONV, 1 + i, 10 + 10 * i, 10) for i in range(n)]
    s = trace_summary.summarize(trace_summary.load(
        trace_file(tmp_path, kernels, [("bench.window", 0, 1000)])), "bench.window")
    value = harness.metric_module("conv_roofline.sample").read(
        reading(s, forwards=1, rows_per_forward=8))
    assert value == pytest.approx(100 * bound / (n * 10e-6))


def test_train_metrics(tmp_path):
    kernels = [(FWD, 1, 10, 300), (GLUE, 2, 400, 100), (ADAM, 3, 600, 50), (BWD, 4, 700, 200)]
    s = trace_summary.summarize(trace_summary.load(trace_file(
        tmp_path, kernels, [("bench.window", 0, 1000), ("train_step", 0, 900)])), "bench.window")
    r = reading(s, steps=1, batch=14)
    assert harness.metric_module("glue_device_ms.train").read(r) == pytest.approx(0.1)
    attn = harness.metric_module("attn_roofline.train").read(r)
    bound = (counts.attention_fwd_bound_s(14, 64, 1024, 8, True)
             + counts.attention_bwd_bound_s(14, 64, 1024, 8))
    assert attn == pytest.approx(100 * bound / 500e-6)
    assert harness.metric_module("mfu.train").read(r) == pytest.approx(
        100 * 3 * 1e12 * 10 / 2.0 / counts.PEAK_FLOPS)
    # two steps' worth expected, one of each found: silent
    assert harness.metric_module("attn_roofline.train").read(reading(s, steps=2, batch=14)) is None


def test_traced_part_fails_when_no_device_event_is_recorded(capsys):
    calls = []
    with pytest.raises(RuntimeError, match="no device event"):
        harness.profile_part(lambda: calls.append(1), harness.Spans(), "cpu")
    assert len(calls) == harness.PROFILE_TRIES
    assert "recorded no device event" in capsys.readouterr().err
