"""The port's spans (drivescenegen_torch/utils/profiling.py) on the CPU at a
tiny config: `annotate` off and on, the sampler's, quantize's and the train
step's spans under a Kineto session that records user-scope ranges only,
as benchmark/harness.py's profiled part enables it, and the train CLI's
--profile_steps trace."""

import contextlib
import glob
import json

import numpy as np
import pytest
import torch
import yaml
from PIL import Image
from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState, RecordScope,
                                _ExperimentalConfig)
from torch.autograd import _disable_profiler, _enable_profiler, _prepare_profiler

from drivescenegen_torch.config import DiffusionConfig, ModelConfig, TrainConfig
from drivescenegen_torch.diffusion import (ddim_sample, ddpm_sample, dpmpp_2m_sample,
                                           dpmpp_2m_sde_sample, make_schedule)
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.scripts import train
from drivescenegen_torch.scripts.generation import quantize
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
from drivescenegen_torch.utils import profiling

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=4, attention_head_dim=8, dtype="float32")
PROGRAM_SPANS = ("sampler.step", "quantize.copy", "quantize.host", "train.step",
                 "train.forward", "train.backward", "train.update", "feed.next_batch")
SAMPLERS = {  # name -> (sampler, steps, sampler's extra arguments)
    "ddim": (ddim_sample, 3, {}),
    "ddim_eta": (ddim_sample, 3, {"eta": 1.0}),
    "ddpm": (ddpm_sample, 3, {}),
    "dpm": (dpmpp_2m_sample, 4, {}),
    "sde": (dpmpp_2m_sde_sample, 3, {}),
}


@contextlib.contextmanager
def user_spans():
    """A Kineto session on the CPU recording user-scope ranges only. The
    list it yields holds, after the block, (name, start ns, end ns) of
    every range, by start."""
    acts = {ProfilerActivity.CPU}
    config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                            _ExperimentalConfig())
    _prepare_profiler(config, acts)
    _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
    spans = []
    try:
        yield spans
    finally:
        result = _disable_profiler()
    spans.extend(sorted(((e.name(), e.start_ns(), e.end_ns()) for e in result.events()),
                        key=lambda s: s[1]))


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_annotate_off_is_the_shared_null_context(monkeypatch):
    def refuse(name):
        raise AssertionError("a record_function was built with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first, second = profiling.annotate("sampler.step"), profiling.annotate("train.step")
    assert first is second and isinstance(first, contextlib.nullcontext)
    with first, second:  # reusable and nestable
        pass


def test_annotate_on_records_a_user_span():
    with user_spans() as spans:
        with profiling.annotate("train.step"):
            with profiling.annotate("train.forward"):
                pass
    assert [s[0] for s in spans] == ["train.step", "train.forward"]
    assert inside(spans[1], spans[0])
    # the session is over: the null context again
    assert isinstance(profiling.annotate("train.step"), contextlib.nullcontext)


@pytest.fixture(scope="module")
def tiny_model():
    torch.manual_seed(0)
    return UNet2D(ModelConfig(**TINY), device="cpu").eval()


@pytest.mark.parametrize("sampler", sorted(SAMPLERS))
def test_a_sample_opens_one_step_span_a_step_and_none_inside_the_denoiser(sampler, tiny_model):
    fn, steps, kw = SAMPLERS[sampler]
    schedule = make_schedule(DiffusionConfig(), device="cpu")
    shape = (2, 16, 16, 3)

    def dispatch(x, t):  # as benchmark/traffic/sample.py wraps each denoiser call
        with torch.profiler.record_function("dispatch"):
            return tiny_model(x, t)

    def run():
        g = torch.Generator().manual_seed(3)
        with torch.no_grad():
            return fn(dispatch, schedule, shape, g, num_inference_steps=steps, **kw)

    plain = run()
    with user_spans() as spans:
        traced = run()
    assert torch.equal(plain, traced)  # the spans change nothing
    step_spans, calls = named(spans, "sampler.step"), named(spans, "dispatch")
    assert len(step_spans) == steps and len(calls) == steps
    # each denoiser call lies in its step's span, and no program span in a call
    assert all(inside(c, s) for c, s in zip(calls, step_spans))
    program = [s for s in spans if s[0] in PROGRAM_SPANS]
    assert not [p for p in program for c in calls if p[1] >= c[1] and p[2] <= c[2]]


def test_quantize_copies_then_computes_on_the_host_bit_for_bit():
    x = torch.tensor([-1.5, -1.0, -0.5, -1 / 255, 0.0, 1 / 255, 0.25, 0.5, 1.0, 1.5])
    x = torch.cat([x, torch.linspace(-1.0, 1.0, 1001)]).reshape(1, 1, -1, 1)
    want = np.round(np.clip(x.numpy() / 2 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)
    with user_spans() as spans:
        got = quantize(x)
    assert got.dtype == np.uint8 and np.array_equal(got, want)
    assert [s[0] for s in spans] == ["quantize.copy", "quantize.host"]
    assert spans[0][2] <= spans[1][1]
    assert np.array_equal(quantize(x.double()), want)  # and off, from another dtype


def _tiny_train_step():
    torch.manual_seed(0)
    tcfg = TrainConfig(batch_size=2, ema_decay=0.99)
    model = UNet2D(ModelConfig(**TINY), device="cpu", for_training=True)
    optimizer, lr = create_optimizer(tcfg, 10, model.parameters())
    state = init_train_state(model, optimizer, ema=True)
    step = make_train_step(make_schedule(DiffusionConfig(), device="cpu"), lr, tcfg)
    batch = torch.randint(0, 256, (2, 16, 16, 3), dtype=torch.uint8)
    return state, step, batch


def test_a_train_step_opens_forward_backward_update_in_order_inside_its_span():
    state, step, batch = _tiny_train_step()
    with user_spans() as spans:
        state, metrics = step(state, batch)
    assert state.step == 1 and torch.isfinite(metrics["loss"])
    (whole,) = named(spans, "train.step")
    phases = [s for s in spans if s[0] in ("train.forward", "train.backward", "train.update")]
    assert [s[0] for s in phases] == ["train.forward", "train.backward", "train.update"]
    assert all(inside(p, whole) for p in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    # torch.optim's own range nests in the update
    (opt_step,) = [s for s in spans if s[0].startswith("Optimizer.step#")]
    assert inside(opt_step, phases[2])


def test_a_traced_train_step_updates_as_an_untraced_one():
    state_a, step_a, batch = _tiny_train_step()
    state_b, step_b, _ = _tiny_train_step()
    step_a(state_a, batch)
    with user_spans():
        step_b(state_b, batch)
    for (n, a), b in zip(state_a.model.named_parameters(), state_b.model.parameters()):
        assert torch.equal(a, b), n
    for k, v in state_a.ema_params.items():
        assert torch.equal(v, state_b.ema_params[k]), k


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(7)
    for i in range(16):  # one epoch of 4 steps: no eval sample inside the trace
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return str(d / "*.png")


@pytest.mark.parametrize("device_data", ["on", "off"])
def test_the_cli_trace_holds_the_feed_and_step_spans(corpus, tmp_path, device_data):
    """--profile_steps 2 traces steps 2 and 3: each opens one feed and one
    step span; no span is named by its step number."""
    out = tmp_path / "out"
    cfg = {"model": dict(TINY, block_out_channels=[8, 16]),
           "train": dict(batch_size=4, ema_decay=0.0, log_every=1, eval_inference_steps=2,
                         dataset_glob=corpus, output_dir=str(out), device_data=device_data)}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    train.main(["--cfg_file", str(path), "--max_steps", "4", "--device", "cpu",
                "--profile_steps", "2"])
    (trace,) = glob.glob(str(out / "trace" / "*.json"))
    events = [e for e in json.load(open(trace))["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    counts = {n: sum(e["name"] == n for e in events) for n in PROGRAM_SPANS}
    assert counts == {"sampler.step": 0, "quantize.copy": 0, "quantize.host": 0,
                      "train.step": 2, "train.forward": 2, "train.backward": 2,
                      "train.update": 2, "feed.next_batch": 2}
    assert not [e["name"] for e in events if e["name"].startswith("train_step")]
