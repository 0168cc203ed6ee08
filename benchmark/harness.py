"""One run of one cell: set-up, the measured window, the traced part, the
check that decides `correct`, and the result line.

Everything of a cell is found by name: BENCHMARK.json at the repository's
root names its metrics, workloads/<cell>.json its configuration, traffic
kind and parameters, configs/<config>.json the model, traffic/<kind>.py
the code that drives that kind, metrics/<metric>.py the reader of each
per-layer metric. run.py is the command line around run_cell.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "drivescenegen_tpu")
WINDOW_SPAN = "bench.window"
PROFILE_TRIES = 3


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    """The module in file `path` (names may hold dots), imported afresh."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bench_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell_files(name: str) -> tuple:
    """(workload dict, config dict) of the cell `name`."""
    cell = load_json(HERE / "workloads" / f"{name}.json")
    return cell, load_json(HERE / "configs" / f"{cell['config']}.json")


def traffic_module(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py", f"benchmark_traffic_{kind}")


def metric_module(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"benchmark_metric_{name}")


def metrics_of(spec: dict, section: str, cell: str) -> List[dict]:
    """The entries of BENCHMARK.json's `section` that the cell reports."""
    return [m for m in spec[section] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is a JAX package's or the JAX
    port source's, compared whole (drivescenegen_torch is not
    drivescenegen_tpu)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown"
    except (OSError, subprocess.TimeoutExpired, IndexError):
        return "unknown"


class Spans:
    """Host spans of the traced part: record_function ranges, which the
    profiler keeps as user annotations. Outside a traced part it records
    nothing and costs one check a span."""

    def __init__(self):
        self.on = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(name):
            yield


def profile_part(part: Callable[[], dict], spans: Spans, device) -> tuple:
    """Run `part` under torch.profiler, recording device work and
    user-scope record_function ranges only (the harness's spans, and
    torch.optim's "Optimizer.step#..." ones): no PyTorch operator events,
    which would slow the host. Returns (its result, trace_summary.Summary).
    A session that recorded no device event is run again, up to
    PROFILE_TRIES sessions; then it raises: a traced run reports no 0."""
    import torch
    from torch._C._profiler import (ProfilerActivity, ProfilerConfig, ProfilerState,
                                    RecordScope, _ExperimentalConfig)
    from torch.autograd import _disable_profiler, _enable_profiler, _prepare_profiler

    from benchmark import trace_summary

    on_card = torch.device(device).type == "cuda"
    acts = {ProfilerActivity.CPU, ProfilerActivity.CUDA} if on_card else {ProfilerActivity.CPU}

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    for attempt in range(PROFILE_TRIES):
        config = ProfilerConfig(ProfilerState.KINETO, False, False, False, False, False,
                                _ExperimentalConfig())
        _prepare_profiler(config, acts)
        sync()
        _enable_profiler(config, acts, {RecordScope.USER_SCOPE})
        spans.on = True
        try:
            with spans(WINDOW_SPAN):
                out = part()
                sync()
        finally:
            spans.on = False
            result = _disable_profiler()
        fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
        os.close(fd)
        try:
            result.save(path)
            summary = trace_summary.summarize(trace_summary.load(path), WINDOW_SPAN)
        finally:
            os.unlink(path)
        if any(op.cat == "kernel" for op in summary.ops):
            return out, summary
        print(f"profiler: session {attempt + 1} of {PROFILE_TRIES} recorded no device event",
              file=sys.stderr)
    raise RuntimeError("the profiler recorded no device event: the traced metrics are not "
                       "measured")


def run_cell(spec: dict, name: str, cell: dict, config: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: Optional[float] = None) -> dict:
    """One run of cell `name` on `device` (the harness's own tests run it
    on the CPU at a tiny size); returns the result line's object."""
    import torch

    t_start = time.perf_counter() if t_start is None else t_start
    kind = traffic_module(cell["kind"])
    run = kind.Cell(cell, config, seed, device)
    run.setup()
    setup_s = time.perf_counter() - t_start
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    stamps = [("setup", setup_s)]
    metrics: Dict[str, dict] = {}
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu", "count": 1}
    breakdown = None
    if not trace:
        e2e = dict(run.window(seconds, host_spans=False), setup_s=setup_s)
        for m in metrics_of(spec, "end_to_end", name):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    else:
        host = run.window(seconds, host_spans=True)
        stamps.append(("window", time.perf_counter() - t_start))
        profiled, summary = profile_part(run.profiled, run.spans, device)
        reading = {"config": config, "cell": cell, "host": host, "profiled": profiled,
                   "trace": summary}
        for m in metrics_of(spec, "per_layer", name):
            value = metric_module(m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
        breakdown = {"device_ops": summary.top_ops(10), "idle_gaps": summary.idle_by_span(10)}
    stamps.append(("measured", time.perf_counter() - t_start))
    device_info["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(device)
                                           if on_card else 0)
    run.release()
    checks = run.check()
    stamps.append(("checked", time.perf_counter() - t_start))
    print("timing (s from start): " + ", ".join(f"{k} {v:.2f}" for k, v in stamps),
          file=sys.stderr, flush=True)
    correct = run.failed == 0 and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": bool(correct), "attempted": int(run.attempted), "failed": int(run.failed),
           "metrics": metrics, "device": device_info}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks  # last: the numbers compared, each beside its limit
    return out
