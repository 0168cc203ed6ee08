#!/usr/bin/env python3
"""Tensor and data parallelism of the PyTorch port over NCCL on four NVIDIA
GPUs of one host, through the train CLI as a user runs it.

    python3 chip_tp4.py        # from the repository root, four CUDA cards

chip_smoke.py checks the port on one card, where two ranks can only share
it over gloo. This script runs config-3's model (default widths, the
kernels, config-3's train section) at its per-chip batch of 14 on a
seeded synthetic corpus, TRAIN_STEPS steps each, under torch.distributed.run
with NCCL, one GPU a rank:

  tp1     one process, batch 14               (the reference of tp2, tp4)
  tp2     mesh 1 x 2 on 2 GPUs, batch 14
  tp4     mesh 1 x 4 on 4 GPUs, batch 14
  dp2     mesh 2 x 1 on 2 GPUs, batch 28      (the reference of dp2xtp2)
  dp2xtp2 mesh 2 x 2 on 4 GPUs, batch 28

Every run draws the same weights, batch order and noise (the seeds), so
each step's loss and grad_norm of a parallel run are held to its
reference's under chip_smoke.py's phase 7 gates, and its last checkpoint's
params to its reference's within what AdamW's updates allow. Per run: the
median samples/s of the steps after the traced ones (the CLI's log, host
clock, each log line a sync), the NCCL kernels' device ms a step on rank 0
(torch.profiler over steps 2-4, --profile_steps 3) and the kernel launches
rank 0 logged. The last lines are one JSON object of the numbers, the
cards' nvidia-smi line and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import chip_smoke as smoke

TRAIN_STEPS, PROFILE_STEPS, CORPUS = 12, 3, 224
RUNS = [("tp1", 1, 1, 1), ("tp2", 2, 1, 2), ("tp4", 4, 1, 4), ("dp2", 2, 2, 1),
        ("dp2xtp2", 4, 2, 2)]  # name, processes, data, model
REFERENCE = {"tp2": "tp1", "tp4": "tp1", "dp2xtp2": "dp2"}


def nccl_ms(trace_dir: str, steps: int) -> float:
    """Device ms a step of the NCCL kernels in rank 0's Chrome trace."""
    (path,) = glob.glob(os.path.join(trace_dir, "trace_*.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    us = sum(e.get("dur", 0) for e in events
             if e.get("cat") == "kernel" and "nccl" in e.get("name", "").lower())
    return us / 1e3 / steps


def run(here: str, work: str, name: str, nproc: int, data: int, model: int, corpus: str) -> dict:
    from drivescenegen_torch.config import Config, MeshConfig, ModelConfig, TrainConfig, save_config

    out_dir = os.path.join(work, name)
    cfg = Config(model=ModelConfig(attention_impl="flash"), mesh=MeshConfig(data=data, model=model))
    cfg.train = dataclasses.replace(TrainConfig(**smoke.CONFIG3_TRAIN), batch_size=14 * data,
                                    device_data="on", log_every=1, eval_inference_steps=10,
                                    dataset_glob=corpus, output_dir=out_dir)
    cfg_path = os.path.join(work, f"{name}.yaml")
    save_config(cfg, cfg_path)
    t0 = time.perf_counter()
    log = smoke.run_module(here, "drivescenegen_torch.scripts.train",
                           ["--cfg_file", cfg_path, "--max_steps", str(TRAIN_STEPS),
                            "--profile_steps", str(PROFILE_STEPS)], nproc=nproc, timeout=900)
    wall = time.perf_counter() - t0
    want = f"mesh: {{'data': {data}, 'model': {model}}} on cuda:0 (torch.distributed)"
    smoke.check(want in log, f"{name}: the train CLI did not log {want!r}:\n{log[-3000:]}")
    records = [json.loads(ln) for ln in open(os.path.join(out_dir, "logs", "metrics.jsonl"))]
    smoke.check(len(records) == TRAIN_STEPS, f"{name}: {len(records)} log lines")
    after = [r["samples_per_sec"] for r in records[PROFILE_STEPS + 1:]]
    return dict(name=name, processes=nproc, mesh=dict(data=data, model=model),
                batch=14 * data, wall_s=wall, loss=[r["loss"] for r in records],
                grad_norm=[r["grad_norm"] for r in records], lr=[r["lr"] for r in records],
                samples_per_s=statistics.median(after), samples_per_s_runs=after,
                nccl_ms_per_step=nccl_ms(os.path.join(out_dir, "trace"), PROFILE_STEPS),
                launches=smoke.logged_launches(log), out_dir=out_dir)


def held(res: dict, ref: dict) -> dict:
    """res against its reference: each step's loss and grad_norm under
    phase 7's gates, the last checkpoint's params within 3 x the sum of
    the lrs (AdamW moves an element by at most about its lr a step, so two
    runs whose gradients differ in rounding stay within twice that)."""
    import torch

    rel_loss = max(abs(a - b) / abs(b) for a, b in zip(res["loss"], ref["loss"]))
    rel_gnorm = max(abs(a - b) / abs(b) for a, b in zip(res["grad_norm"], ref["grad_norm"]))
    smoke.check(rel_loss <= smoke.TRAIN_LOSS_TOL, f"{res['name']}: loss rel {rel_loss}")
    smoke.check(rel_gnorm <= smoke.TRAIN_GNORM_TOL, f"{res['name']}: grad_norm rel {rel_gnorm}")
    ck = [torch.load(os.path.join(r["out_dir"], "checkpoints", f"step_{TRAIN_STEPS:08d}.pt"),
                     map_location="cpu") for r in (res, ref)]
    smoke.check(ck[0]["params"].keys() == ck[1]["params"].keys() and all(
        ck[0]["params"][k].shape == v.shape for k, v in ck[1]["params"].items()),
        f"{res['name']}: its checkpoint does not hold the whole model")
    diff = max((ck[0]["params"][k] - v).abs().max().item() for k, v in ck[1]["params"].items())
    bound = 3 * sum(ref["lr"])
    smoke.check(diff <= bound, f"{res['name']}: params {diff} from {ref['name']}'s (bound {bound})")
    return dict(loss_rel=rel_loss, grad_norm_rel=rel_gnorm, params_max_abs=diff,
                params_bound=bound)


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 4:
        print("chip_tp4: needs four CUDA devices", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from drivescenegen_torch.ops import build

    smi = smoke.smi_line()
    print(smi, f"x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s")
    work = tempfile.mkdtemp(prefix="chip_tp4_")
    try:
        os.makedirs(os.path.join(work, "corpus"))
        corpus = smoke.synthetic_corpus(os.path.join(work, "corpus"), CORPUS, 256, seed=20261017)
        results, checks = {}, {}
        for name, nproc, data, model in RUNS:
            r = results[name] = run(here, work, name, nproc, data, model, corpus)
            print(f"{name}: mesh {r['mesh']} on {nproc} GPU(s), batch {r['batch']}: "
                  f"{r['samples_per_s']:.2f} samples/s (median of steps {PROFILE_STEPS + 2}-"
                  f"{TRAIN_STEPS}; the CLI's log, host clock), NCCL kernels "
                  f"{r['nccl_ms_per_step']:.3f} ms a step on rank 0 (torch.profiler, steps 2-"
                  f"{PROFILE_STEPS + 1}), {r['wall_s']:.1f} s wall; rank 0's launches "
                  f"{r['launches']}; losses {', '.join(f'{x:.4f}' for x in r['loss'])}",
                  flush=True)
            if name in REFERENCE:
                c = checks[name] = held(r, results[REFERENCE[name]])
                print(f"{name} against {REFERENCE[name]}: loss rel {c['loss_rel']:.2e} (tol "
                      f"{smoke.TRAIN_LOSS_TOL}), grad_norm rel {c['grad_norm_rel']:.2e} (tol "
                      f"{smoke.TRAIN_GNORM_TOL}) over {TRAIN_STEPS} steps; step {TRAIN_STEPS}'s "
                      f"params max |delta| {c['params_max_abs']:.3g} (bound "
                      f"{c['params_bound']:.3g})", flush=True)
        for r in results.values():
            del r["out_dir"]
        print(json.dumps({"tp4": {"runs": results, "held": checks, "card": smi}}))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except smoke.SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
