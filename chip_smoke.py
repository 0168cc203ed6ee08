#!/usr/bin/env python3
"""Smoke run of the PyTorch port (drivescenegen_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printed as it runs; any failure exits non-zero:
  1. device    the card's name and power limit; TF32 off for the
               references; protobuf's version
  2. build     nvcc builds csrc/*.cu from the checkout (all at once), with
               ptxas's register/spill report; cuobjdump's SASS of each CUDA
               library must hold what its source states on its line
               "// SASS must hold:" (HGMMA and UTMALDG, wgmma fed by TMA,
               for the conv and the head-dim-64 attention; 16-byte loads
               and the arrival counter's atomic, LDG.E.128.CONSTANT and
               ATOMG, for the GroupNorm stats; the two mma.sync shapes,
               ldmatrix .trans, cp.async and MUFU.EX2 for the head-dim-8
               attention forward; the two mma.sync shapes, ldmatrix .trans,
               movmatrix and MUFU.EX2 for the head-dim-8 backward)
  3. kernels   every kernel on the sampling path against its plain PyTorch
               version, at every shape the full-width UNet gives it
               (batch 8, 256x256; models/unet2d.py conv3x3_shapes,
               gn_mul_add_shapes and mid_attention_shape) and at ragged
               shapes: error against a stated tolerance, kernel time, plain
               time, library time where one PyTorch call computes the same
               function, and the least time the card could take (bytes at
               3.35 TB/s or bf16 operations at 989 TFLOP/s, whichever is
               larger); a call bound by bytes whose inputs and outputs fit
               in twice the L2 is timed over rotated copies of its inputs,
               so that it reads device memory and not the cache (its warm
               time printed beside); for the GroupNorm stats also the variance clamp, two
               calls and two CUDA-graph replays bit-identical, and one
               device kernel per call; the head-dim-8 attention at the
               shape of DriveSceneGen's own model as the import CLI
               configures it ([8, 64, 1024, 8], views of a fused qkv) and
               at ragged shapes, two runs bit-identical, timed beside
               plain, SDPA (the kernels it ran named) and the bound (the
               exponentials at MUFU.EX2's 16 a clock an SM at the top SM
               clock nvidia-smi reports printed beside it, outside the
               bound: the FMA pipe can compute exp2 too), its lse output
               against plain at a ragged shape
  4. forward   the full-width UNet2D (default widths, seeded random weights)
               with kernels against the same model with plain versions
  5. sampling  DDIM-50, batch 8, 256x256, eta 0: the launch counts of one
               run, which show the path went through every kernel, then
               scenes/s as the median of three runs and the device's idle
               share; then the host's cost of one call of each kernel
               wrapper (enqueue only, at a tiny shape)
  6. cli       the generation CLI on a model directory written from the
               same weights (config.yaml + params.npz)
  7. train     the training path at full width (batch 14, default
               TrainConfig, EMA on): the attention backward (pre-pass, one
               main pass, dQ pass) against its plain version at
               [14, 8, 1024, 64] and at a ragged shape, each launch against
               its own plain version, the forward's o and lse against
               theirs, two runs bit-identical, times against the
               bound, the plain version and SDPA's backward, and TFLOP/s on
               the five products; one train step with kernels against one with
               plain versions on the same weights, batch, noise and t, the
               kernel step calling the f32 GroupNorm composition at none of
               its 45 GN+SiLU sites (stats, apply and GN backward kernels
               launched 45 times each, in every train step of phases 7, 10,
               14 and 17); the launch counts and ms of a run of steps,
               samples/s, the
               device's idle share and peak memory; then the train CLI as a
               user runs it, on a seeded synthetic PNG corpus: ~30 steps,
               a resume, and a params.npz the generation CLI samples from
  8. dpm       DPM-Solver++(2M) (20 steps) and its SDE variant (25) at batch
               8, 256x256: launch counts of one run, output finite and in
               [-1, 1], scenes/s as the median of three runs; for these and
               DDIM-50, the largest and mean |delta| against a plain run on
               the same x_T and noise (the mean gated), and between the
               plain bf16 run and a plain run with f32 activations
  9. config-5  the map-conditioned model (128x128, in 1, out 1, cond 2,
               the default widths): every forward kernel against its plain
               version at every shape of a batch-16 forward (guidance
               doubles batch 8), timed; the guided forward (g = 3) with
               kernels against plain; guided DDIM-50 at batch 8: launch
               counts and one batch-16 forward per step, scenes/s; at g = 1
               one batch-8 forward per step
  10. cond     the attention's forward with lse and its three backward
               launches at the config-5 train shape [32, 8, 256, 64], each
               against its plain version as in phase 7, two runs
               bit-identical; the config-5 conditional train step (batch
               32, cond_dropout 0.1, EMA 0.999) with kernels against plain
               on the same batch, noise, t and keep mask, under phase 7's
               gates; then ms per step
  11. cli      on a seeded synthetic 128x128 corpus: the conditional train
               CLI (20 steps), then the generation CLI from its export
               with --cond_dir --guidance 3 for --sampler dpm and sde; a
               model outside the kernels' limits (config-1's model
               section) refused at construction on the card, trained
               there by the train CLI with --plain and sampled from its
               export by the generation CLI with --plain
  12. stage 2  the lane mask -> skeleton -> bit-pack pass on the card
               against the same pass on the CPU, bit for bit, on the
               fixture rasters (tests/fixtures/torch_stage2/, padded to
               8), phase 5's DDIM-50 batch and the mask's tie-break and
               float64-boundary constructions; its device ms per batch,
               device kernels per batch, and no host sync; the native
               graph library built and loaded; the vectorization CLI
               (--n_workers 2) on the fixture against the JAX package's
               record expected.npz (graphs equal, lanes and agents within
               1e-6) and the host's s per image; the end-to-end CLI at
               full width (phase 6's model directory, DDIM-50, batch 8,
               24 scenes, 2 workers): launch counts, stats, first-batch s,
               sampling and end-to-end scenes/s beside phase 5's, PNGs
               pixel-equal to the generation CLI's (--seed 5
               --num_batches 3); then --resume: 3/3 batches resumed, no
               kernel launched, the same counts
  13. front end  64 rich synthetic scenes through the preprocess CLI,
               and from a TFRecord shard of them through the native and
               the Python reader (pickles byte-identical; both readers on
               tests/fixtures/womd_mini.tfrecord); rasterize_scenario at
               RasterConfig's size on the card against the CPU for every
               scene in four variants (agents at t=1 and t=10,
               with_agent=False, occupancy): max |delta| <= 1e-5, uint8
               levels and flipped box-edge pixels counted and gated, two
               card runs bit-identical, device ms and kernels per scene
               (torch.profiler), wall ms both ways; the same on 8 dense
               scenes that reach the 512-polyline and 128-agent buckets;
               for both sets the buckets reached, the longest per-pixel
               run of the splat's sum, and the box-edge pixels that
               cos/sin on the card would flip; the rasterization CLI
               (2 workers) on the card and with --device cpu, PNGs held
               to each other; GT export, the vectorization CLI on the
               card's rasters and compute_map_metrics (round trip), JSON
               keys and finite values; the demo with --plain
  14. scale    config-3's training at its per-chip batch of 14 on one rank:
               1024 synthetic scenes preprocessed (four CLI processes) and
               rasterized with their 180-degree rotations by the CLI on the
               card with --save_sidecar (2048 rasters of 256x256, a corpus
               cut from ~70k); the sidecar against the PNGs' decode (equal,
               and the time of each); array_to_device GB/s; one train step
               over a one-rank NCCL process group against the step with
               none on the same weights, batch and draws (bit-identical,
               or within phase 7's gates, said which), ms per step of each
               and the gradient all_reduce's device ms; samples/s, the
               device's idle share and the tail's host-to-device MB a step
               in the hybrid, resident and streamed modes (in turns, each
               twice), the device
               budget holding the share of the corpus config-3's 6 of
               13.8 GB holds; a full-width step with dropout 0.1, kernels
               against plain on the same masks, under phase 7's gates;
               the train CLI under torchrun (1 rank, NCCL, device_data
               auto over the budget: hybrid) from the sidecar, --init_from
               phase 7's run, --profile_steps 3 with a trace that names the
               attention kernels; --supervise 1 whose child this script
               kills after its first checkpoint, resumed to rc 0; the
               generation CLI under torchrun, byte-equal to phase 6's PNGs

  15. tp       tensor parallelism: the attention forward (o, lse) and the
               backward's three launches at the heads one rank runs at tp =
               2 and 4 ([14, 4, 1024, 64], [14, 2, 1024, 64]), each against
               its plain version, two backward runs bit-identical, timed
               beside the bound and SDPA; config-3's train step at model 2
               on two ranks on the card over gloo (NCCL refuses two ranks
               on one device), started by torch.distributed.run, on phase
               7's weights, batch and draws with the kernels, against the
               one-process step under phase 7's gates, the gathered params
               and EMA after two steps, each rank's launches, ms a step
               (gloo staged through host memory: not a TP speed) and peak
               memory; the tp = 2 checkpoint resumed at tp = 1, its next
               step against the tp = 2 run's, and the tp = 2 params.npz
               through the generation CLI
  16. modules  the last modules' device paths: a diffusers UNet2DModel
               checkpoint at the default widths (seeded random weights
               under diffusers' names, .bin) through the import CLI at
               head dim 64, its params.npz equal to the checkpoint, its
               forward with kernels against plain under phase 4's gate,
               then DDIM-10 at batch 8 through the generation CLI with
               every forward kernel launched; the same weights at
               diffusers' default head dim 8, DriveSceneGen's own model:
               the CLI's line names no --plain, UNet2D builds on the card
               with the kernels (its training arm too, with no --plain:
               phase 17 trains it), its forward against plain under phase
               4's gate
               and as a CUDA graph, DDIM-50 at batch 8 timed as in phase
               5, then through the generation CLI DDIM-50 and the
               reference's DDPM-750 at batch 8 with launch counts gated
               (2200 / 2250 / 50 / 50 and 33000 / 33750 / 750 / 750) and a
               --plain DDIM-50, scenes/s of each; eval_cond_agents on
               config-5's model (configs/config5_cond_128n.yaml, random
               weights) over 16
               GT rasters from the rasterizer on the card, g 1 and 3,
               DDIM-50 at batch 8, launch counts gated, its JSON printed
               (random weights: precision and recall not gated); MFU of
               phase 4's graph forward and phase 5's DDIM-50 by
               utils/flops.py, and its roofline; validate_waymo
               --rasterize on the card against the CPU (the WOMD fixture
               exits 1 in both, as in the JAX package: its lane lies
               outside the raster; a synthetic shard exits 0)
  17. train8   DriveSceneGen's own model (phase 16b's import, head dim 8)
               trained on the card: the forward with lse at the train
               shape [14, 64, 1024, 8] (o and lse against plain; its time
               without lse at phase 3's shape beside it); the head-dim-8
               backward (csrc/flash_attention_bwd_d8.cu, one launch) at
               that shape, at the heads of tp 2 and 4 and at two ragged
               shapes, each output against plain, two runs bit-identical,
               timed beside its bound (the products'), plain and
               SDPA's backward (the cuDNN kernels it ran named); a
               full-width train step of the imported weights with kernels
               against plain under phase 7's gates, launch counts and ms
               of ten steps, samples/s, idle share, peak memory beside
               phase 7's; the train CLI with the import CLI's config.yaml
               as its --cfg_file on phase 7's corpus (30 steps, a resume to
               36, launches exact with its DDPM-750 eval samples), then
               the generation CLI's DDIM-50 at batch 8 from its export,
               launches gated at 2200 / 2250 / 50 / 50
  18. gn bwd   the training arm's GroupNorm+SiLU (ops.GroupNormSiLUFunction):
               the stats kernel with its mean/rstd output (mul and add
               bit-identical to the launch without it) and the backward
               (csrc/group_norm.cu, two launches a call) against their plain
               versions at ragged shapes (odd sizes, 3 channels a group, 16
               groups, a dy in another layout) and at every (H, C) of the
               45 sites at batch 14, two calls bit-identical; the backward
               timed cold against its byte bound (10 bytes an element),
               plain, and PyTorch's autograd of F.group_norm + F.silu; warm
               too at [14, 256, 256, 64], [14, 256, 256, 192],
               [14, 128, 128, 384] and [14, 32, 32, 1024]; the forward
               beside the composition's; one train step's sums

About 770-950 s on an H100, builds included; phase 14 about 215-295 s
of it; phase 16 about 35 s; phase 17 about 90 s. It prints each phase's
seconds before its JSON lines.

The last lines are one JSON object per kernel table, the card's nvidia-smi
line, and {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import atexit
import dataclasses
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12      # H100 SXM HBM3
BATCH, STEPS = 8, 50
# MUFU.EX2 results a clock an SM (Hopper): the head-dim-8 attention's
# exponentials at that rate are printed beside its bound, not in it.
EX2_PER_CLOCK = 16
# bf16 outputs: at most 4 bf16 ulps (2^-6 relative) of the largest value.
BF16_TOL = 2.0 ** -6
# f32 GroupNorm vectors: summation order only.
F32_TOL = 1e-4
# The whole UNet forward, bf16 end to end: rounding differences of 44 conv
# pairs compound; the bound tests/test_unet_fused_gn_conv.py uses.
FORWARD_TOL = 0.05
# Phase 7's train-step comparison, kernels against plain versions, bf16 end
# to end: the loss within 1% relative, grad_norm within 2%, and the cosine
# of the flattened gradients at least 0.999.
TRAIN_LOSS_TOL, TRAIN_GNORM_TOL, TRAIN_COS_MIN = 0.01, 0.02, 0.999
# The forward's lse is f32 from f32 accumulators: summation order only.
LSE_TOL = 1e-4
TRAIN_STEPS, CLI_STEPS, CLI_RESUME_STEPS, CLI_IMAGES = 10, 30, 36, 256
# The DPM-Solver++ samplers' default steps, the guidance scale of config-5
# (drivescenegen_tpu/configs/config5_cond_128n.yaml), and its CLI run.
DPM_STEPS, SDE_STEPS, GUIDANCE = 20, 25, 3.0
CLI5_STEPS, CLI5_IMAGES = 20, 128
# A whole sampling run (batch 8, 256x256, values in [-1, 1]) with kernels
# against the same run with plain versions on the same x_T and noise: the
# mean |delta| over every value. The largest |delta| is not gated: a few
# values of a many-step chain can diverge from bf16 rounding alone (phase
# 8 prints the same reading for plain bf16 against plain f32).
MEAN_DELTA_TOL = 0.01
# Phase 12: the end-to-end CLI's scenes (three batches of BATCH), and how
# far the vectorization CLI's lanes and agents may sit from the JAX
# package's record made on another machine (numpy and scipy versions may
# differ; its graphs must be equal).
E2E_SCENES, STAGE2_TOL = 24, 1e-6
# Phase 13: the rich synthetic scenes it preprocesses and rasterizes; the
# card's float raster against the CPU's (the same float32 operations in
# the same order: equal in practice), and the share of pixels that may sit
# one uint8 level apart, or be box-edge pixels one side covers and the
# other does not.
FRONT_SCENES, RASTER_TOL, RASTER_PX_SHARE = 64, 1e-5, 1e-4
# Phase 13's dense scenes: rich synthetic layouts merged with random shifts
# until a scene reaches the 512-polyline bucket, and vehicles enough for the
# 128-agent bucket (dense_scenario).
DENSE_SCENES, DENSE_LAYOUTS, DENSE_VEHICLES, DENSE_SPREAD = 8, 48, 120, 25.0


# Phase 14: config-3 (drivescenegen_tpu/configs/config3_train_dp.yaml), its
# per-chip batch of 14 on one rank. The corpus is reduced: SCALE_SCENES
# synthetic scenes, each also rotated, against ~70k rasters, and the device
# budget holds the share of it that config-3's 6 GB holds of its 13.8 GB.
CONFIG3_MESH = dict(data=-1, model=1)
CONFIG3_TRAIN = dict(batch_size=112, num_epochs=10, learning_rate=1e-5, lr_warmup_steps=500,
                     seed=14555)
SCALE_BATCH, SCALE_SCENES, POOL_SHARE = 14, 1024, 6.0 / 13.8
SCALE_STEPS, SUP_STEPS = 12, 21


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


# (phase number, perf_counter at its start), in the order the phases run.
PHASE_STARTS: list = []


def phase(name: str) -> None:
    PHASE_STARTS.append((name.split()[0], time.perf_counter()))
    print(f"== {name}", flush=True)


def phase_seconds() -> dict:
    """{phase number: seconds from its start to the next phase's, the last
    one's to now}."""
    ends = [t for _, t in PHASE_STARTS[1:]] + [time.perf_counter()]
    return {n: round(end - t, 1) for (n, t), end in zip(PHASE_STARTS, ends)}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def smi_query(field: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={field}", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, min_total_ms: float = 30.0, graph: bool = True, min_calls: int = 3) -> float:
    """Mean ms per call, by CUDA events, after warm-up. graph=True captures
    the calls back to back in a CUDA graph and times its replay: device
    time, without the host's launch cost. graph=False times eager calls,
    host included. At least min_calls calls are timed."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    n = max(min_calls,
            min(50 if graph else 200, int(min_total_ms / max(start.elapsed_time(stop), 1e-3))))
    if graph:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        g.replay()
        run = g.replay
    else:
        def run():
            for _ in range(n):
                fn()
    torch.cuda.synchronize()
    start.record()
    run()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def time_cold_ms(fn, inputs, bound, bytes_moved: float, min_total_ms: float = 30.0):
    """time_ms of fn(*inputs), with the inputs of a call bound by bytes
    (bound = bound_ms(...)) read from device memory and not from the L2
    cache. Back-to-back calls on one set of inputs find them in L2 when the
    call's bytes (inputs and outputs) are under twice its size, and would
    time the cache. So the calls then rotate over copies of the inputs
    whose total exceeds twice the L2. Returns (ms, copies); copies is 1
    when no rotation was needed, as for a call bound by operations."""
    import torch

    props = torch.cuda.get_device_properties(0)
    l2 = getattr(props, "L2_cache_size", 50 * 2**20)
    in_bytes = sum(t.numel() * t.element_size() for t in inputs)
    rotate = bound[1] == "bytes" and bytes_moved < 2 * l2
    copies = -(-2 * l2 // in_bytes) + 1 if rotate else 1
    sets = [tuple(inputs)] + [tuple(t.clone() for t in inputs) for _ in range(copies - 1)]
    turn = itertools.count()
    ms = time_ms(lambda: fn(*sets[next(turn) % copies]), min_total_ms, min_calls=copies)
    return ms, copies


def device_kernels(fn, n: int = 1, tries: int = 3):
    """The device kernels n calls of fn launch, by torch.profiler, as
    (name, count, device us) rows. A profiling session that recorded no
    device event at all (CUPTI can miss a session's activity) is run
    again, up to `tries` sessions; after that the rows are empty: not
    measured."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type != DeviceType.CPU and not getattr(e, "is_user_annotation", False)]
        if rows:
            return rows
        print(f"profiler: session {attempt + 1} of {tries} recorded no device event")
    return []


def device_ms(fn, n: int = 20) -> float:
    """Device time per call of fn: the time of the kernels it launches,
    summed by torch.profiler over n calls after a warm-up call. Free of the
    host's enqueue cost, as a CUDA-graph replay is, for calls that cannot
    be captured in one (autograd's backward). Where the profiler records
    nothing, the eager time by CUDA events, host included, said so."""
    import torch

    fn()
    torch.cuda.synchronize()
    total_us = sum(r[2] for r in device_kernels(fn, n))
    if total_us > 0:
        return total_us / 1e3 / n
    print("device_ms: the profiler recorded no device time; timed eagerly, host included")
    return time_ms(fn, graph=False)


def host_us(fn, n: int = 2000) -> float:
    """Host time per call of n back-to-back calls, without waiting for the
    device: what the eager loop pays to enqueue the call."""
    import torch

    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def bound_ms(bytes_moved: float, flops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_of(lib_path) -> str:
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True)
    check(out.returncode == 0, f"cuobjdump -sass {lib_path}: {out.stderr.strip()[-500:]}")
    return out.stdout


def profile_device(fn, n: int = 3, label: str = "forward", top: int = 12):
    """Device time of n calls of fn by kernel name (torch.profiler), and
    the device's busy share of the wall time, which it returns (None when
    the profiler recorded no device time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # Device rows only: a CPU op (aten::add) also carries the device
        # time of the kernels it launched, which would count them twice; so
        # does a program span's range on the device's timeline.
        if e.device_type == DeviceType.CPU or getattr(e, "is_user_annotation", False):
            continue
        dev_us = e.self_device_time_total
        if dev_us > 0:
            rows.append((dev_us / 1e3 / n, e.count // n, e.key))
    busy = sum(r[0] for r in rows)
    if not rows:
        print("profile: the profiler recorded no device time")
        return None
    print(f"profile: {n} {label}s in {wall_ms:.2f} ms wall; device busy {busy * n:.2f} ms "
          f"({100 * busy * n / wall_ms:.1f}%); per {label} by kernel:")
    for ms, count, name in sorted(rows, reverse=True)[:top]:
        print(f"  {ms:8.3f} ms  x{count:<4d} {name[:90]}")
    print(f"  {sum(r[0] for r in sorted(rows, reverse=True)[top:]):8.3f} ms  (the other "
          f"{max(0, len(rows) - top)} kernels)")
    return busy * n / wall_ms


def synthetic_corpus(directory: str, n: int, res: int, seed: int) -> str:
    """n seeded res x res RGB PNGs: a gray field with random lane-like bands
    and dots, as rasterized scenes look. Returns the glob."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res]
    for i in range(n):
        img = np.full((res, res, 3), 128, np.uint8)
        for _ in range(rng.integers(2, 6)):
            a, c, w = rng.uniform(-1, 1), rng.uniform(0, res), rng.uniform(2, 6)
            band = np.abs(yy - (a * xx + c)) < w
            img[band] = rng.integers(0, 256, size=3, dtype=np.uint8)
        pts = rng.integers(0, res, size=(rng.integers(3, 12), 2))
        for y, x in pts:
            img[max(0, y - 3):y + 3, max(0, x - 3):x + 3] = rng.integers(0, 256, size=3)
        Image.fromarray(img).save(os.path.join(directory, f"{i:05d}.png"))
    return os.path.join(directory, "*.png")


def run_module(here: str, module: str, args, nproc: int = 0, timeout: int = 600) -> str:
    """python -m `module` with `args` from the repository root, under
    torch.distributed.run with nproc processes when nproc > 0; returns its
    output (stdout and stderr), raising if it failed."""
    launcher = ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                str(nproc)] if nproc else []
    cmd = [sys.executable, *launcher, "-m", module, *args]
    out = subprocess.run(cmd, cwd=here, capture_output=True, text=True, timeout=timeout)
    log = out.stdout + out.stderr
    check(out.returncode == 0, f"{module} exited {out.returncode}:\n{log[-3000:]}")
    return log


def run_cli(here: str, args, timeout: int = 600) -> str:
    """The train CLI with `args` (run_module)."""
    return run_module(here, "drivescenegen_torch.scripts.train", args, timeout=timeout)


def logged_launches(log: str, what: str = "kernel launches") -> dict:
    """The launch counts the train CLI logs at its end: by wrapper, or with
    what="attention forward launches by source" the attention forward's by
    source."""
    import ast

    lines = [ln for ln in log.splitlines() if what in ln]
    check(len(lines) == 1, f"train CLI logged {len(lines)} lines of {what!r}")
    return ast.literal_eval(lines[0].split(what + " ", 1)[1])


def row_launches(counts: dict, by_source: dict, head_dim: int = 64) -> dict:
    """counts (ops.launch_counts()) keyed by the kernels line's rows: the
    attention wrapper's one counter split by the source that launched
    (ops.attention.launches_by_source), "attention" for
    csrc/flash_attention.cu and "attention_d8" for csrc/flash_attention_d8.cu.
    Fails unless every attention launch was the kernel of head_dim, the
    path's."""
    split = {"attention": by_source["flash_attention"],
             "attention_d8": by_source["flash_attention_d8"]}
    ours = "attention_d8" if head_dim == 8 else "attention"
    want = {k: counts["attention"] if k == ours else 0 for k in split}
    check(split == want, f"attention forward launches by source {by_source}: a head dim "
                         f"{head_dim} path's {counts['attention']} should all be its kernel's")
    return {**counts, **split}


class KernelRow:
    """Sums of one kernel's numbers over the launches of one UNet forward."""

    def __init__(self, name, route, source, replaces):
        self.d = dict(name=name, route=route, source=source, replaces=replaces, launches=0,
                      max_abs_err=0.0, max_rel_err=0.0, ms=0.0, plain_ms=0.0, bound_ms=0.0,
                      bound_by=None, library_ms=None, launches_per_forward=0,
                      launches_by_path={})
        self._by = Counter()

    def add(self, count, err, ref_max, ms, plain_ms, bound, library_ms=None):
        d = self.d
        d["max_abs_err"] = max(d["max_abs_err"], err)
        d["max_rel_err"] = max(d["max_rel_err"], err / max(ref_max, 1e-30))
        d["ms"] += count * ms
        d["plain_ms"] += count * plain_ms
        d["bound_ms"] += count * bound[0]
        self._by[bound[1]] += count * bound[0]
        d["bound_by"] = self._by.most_common(1)[0][0]
        if library_ms is not None:
            d["library_ms"] = (d["library_ms"] or 0.0) + count * library_ms
        d["launches_per_forward"] += count


def attention_d8_bound(B: int, heads: int, S: int, D: int, n_products: int, nbytes: float,
                       sms: int, clock_mhz: float):
    """(ms, bound_by, terms) of a head-dim-8 attention call: the larger of
    its bytes / 3.35 TB/s and its n_products products (2 S^2 D FLOP each
    per (batch, head)) / 989 TFLOP/s. terms also holds, as a design note
    and outside the bound, its B heads S^2 exponentials at MUFU.EX2's rate
    alone (EX2_PER_CLOCK x SMs x the SM's top clock): a kernel can beat
    that time by computing some exp2 on the FMA pipe, as cuDNN's SDPA
    backward does at head dim 8."""
    exps = B * heads * S * S
    terms = {"bytes": nbytes / PEAK_BYTES * 1e3,
             "products": n_products * 2 * exps * D / PEAK_BF16_FLOPS * 1e3}
    by = max(terms, key=terms.get)
    terms["exponentials_mufu_only"] = exps / (EX2_PER_CLOCK * sms * clock_mhz * 1e6) * 1e3
    return terms[by], "bytes" if by == "bytes" else "operations", terms


def attention_d8_checks(mcfg, B: int, row: KernelRow) -> dict:
    """Phase 3's head-dim-8 forward (csrc/flash_attention_d8.cu): at the
    mid-block attention of mcfg (mid_attention_shape) at batch B, its q, k
    and v views of a fused qkv as the model makes them, then at ragged
    shapes, each within BF16_TOL x the largest output of its plain version
    and two runs bit-identical; its lse output at a ragged shape against
    plain (phase 17 checks it at the train shape). The main shape is
    timed beside plain, SDPA (its backend named by the kernels it ran) and
    the bound (attention_d8_bound). Its numbers go into `row`; returns
    them."""
    import torch
    import torch.nn.functional as F

    from drivescenegen_torch import ops
    from drivescenegen_torch.models.unet2d import mid_attention_shape

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(8)
    heads, S, D = mid_attention_shape(mcfg)
    sc = 1.0 / math.sqrt(D)

    def fused(Bq, Hq, Sq):
        return torch.randn(Bq, Sq, 3 * Hq * D, generator=gen, device=dev).bfloat16()

    def split(qkv, Hq):
        Bq, Sq, _ = qkv.shape
        return tuple(t.view(Bq, Sq, Hq, D).transpose(1, 2) for t in qkv.split(Hq * D, dim=-1))

    def held(q, k, v, label):
        got, again = ops.attention(q, k, v, sc), ops.attention(q, k, v, sc)
        ref = ops.reference_attention(q, k, v, sc)
        err = (got.float() - ref.float()).abs().max().item()
        ref_max = ref.float().abs().max().item()
        check(err <= BF16_TOL * ref_max, f"attention {label}: err {err} vs max {ref_max}")
        check(torch.equal(got, again), f"attention {label}: two runs differ")
        print(f"attention     {label}: err {err:.3g} (max {ref_max:.3g}, tol "
              f"{BF16_TOL * ref_max:.3g}); two runs bit-identical")
        return err, ref_max

    qkv = fused(B, heads, S)
    err, ref_max = held(*split(qkv, heads), f"[{B},{heads},{S},{D}] (the imported model's, views "
                                            f"of a fused qkv)")
    nbytes = 4 * B * heads * S * D * 2
    exps = B * heads * S * S
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock_mhz = float(smi_query("clocks.max.sm"))
    *bnd, terms = attention_d8_bound(B, heads, S, D, 2, nbytes, sms, clock_mhz)
    ms, _ = time_cold_ms(lambda a: ops.attention(*split(a, heads), sc), (qkv,), bnd, nbytes)
    plain, _ = time_cold_ms(lambda a: ops.reference_attention(*split(a, heads), sc), (qkv,), bnd,
                            nbytes)
    lib, _ = time_cold_ms(lambda a: F.scaled_dot_product_attention(*split(a, heads), scale=sc),
                          (qkv,), bnd, nbytes)
    q, k, v = split(qkv, heads)
    sdpa = sorted({r[0] for r in device_kernels(
        lambda: F.scaled_dot_product_attention(q, k, v, scale=sc)) if "emset" not in r[0]})
    row.add(1, err, ref_max, ms, plain, bnd, lib)
    print(f"attention     [{B},{heads},{S},{D}]: {ms:.4f} ms ({exps / ms / 1e9:.1f} G exp/s, "
          f"{100 * bnd[0] / ms:.1f}% of the bound), plain {plain:.4f} ms, SDPA {lib:.4f} ms "
          f"(ran {sdpa or 'not measured'}), bound {bnd[0]:.4f} ms ({bnd[1]}: products "
          f"{terms['products']:.4f}, bytes {terms['bytes']:.4f} ms; the {exps / 1e6:.1f} M "
          f"exponentials at MUFU's {EX2_PER_CLOCK} a clock x {sms} SMs x {clock_mhz:.0f} MHz "
          f"alone {terms['exponentials_mufu_only']:.4f} ms)  x1")
    del qkv, q, k, v

    # Ragged shapes: one head, odd head and batch counts, S = 128 and 256;
    # views of a fused qkv at S = 256; slices of [B, heads, S, 2D] buffers,
    # whose head stride is larger than their token stride.
    for Bq, Hq, Sq in ((1, 1, 128), (3, 5, 256)):
        q, k, v = (torch.randn(Bq, Hq, Sq, D, generator=gen, device=dev).bfloat16()
                   for _ in range(3))
        held(q, k, v, f"[{Bq},{Hq},{Sq},{D}] (ragged)")
    held(*split(fused(2, heads, 256), heads), f"[2,{heads},256,{D}] (ragged, fused qkv views)")
    wide = [torch.randn(3, 5, 384, 2 * D, generator=gen, device=dev).bfloat16() for _ in range(3)]
    q, k, v = (t[..., D:] for t in wide)
    held(q, k, v, f"[3,5,384,{D}] (ragged) strides {tuple(q.stride())}")
    o, lse = ops.attention_with_lse(q, k, v, sc)
    ref = ops.reference_attention(q, k, v, sc)
    e_o, m_o = (o.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()
    lse_err = (lse - ops.reference_attention_lse(q, k, sc)).abs().max().item()
    check(e_o <= BF16_TOL * m_o and lse_err <= LSE_TOL,
          f"attention_with_lse [3,5,384,{D}] (ragged): o err {e_o} (max {m_o}), lse err {lse_err}")
    print(f"attention_with_lse [3,5,384,{D}] (ragged): o err {e_o:.3g} (max {m_o:.3g}), lse err "
          f"{lse_err:.3g} (tol {LSE_TOL})")
    return dict(ms=ms, plain_ms=plain, sdpa_ms=lib, sdpa_kernels=sdpa, bound_ms=bnd[0],
                bound_terms_ms=terms, clock_mhz=clock_mhz, sms=sms, max_abs_err=err,
                shape=[B, heads, S, D])


def stage2_constructions(res: int):
    """uint8 [8, res, res, 3]: the lane mask's hard cases. Image 0: the
    float64 boundary (R = 153 on the 128 background, |153/255 - 128/256| ==
    0.1 in real arithmetic: lane on the host). Images 1-6: every uint8
    value in R and in G against six background modes. Image 7: exact
    first-max ties in both histograms."""
    import numpy as np

    imgs = np.full((8, res, res, 3), 128, np.uint8)
    imgs[0, 3, 4, 0] = 153
    vals = np.arange(256, dtype=np.uint8).reshape(16, 16)
    for img, mode in zip(imgs[1:7], (0, 77, 128, 153, 204, 255)):
        img[:] = mode
        img[:16, :16, 0] = vals
        img[16:32, 16:32, 1] = vals
    half = res // 2
    imgs[7, :half, :, 0], imgs[7, half:, :, 0] = 60, 200
    imgs[7, :half, :, 1], imgs[7, half:, :, 1] = 200, 60
    return imgs


def phase_stage2(here: str, work: str, model_dir: str, q_ddim, ddim_rate: float) -> dict:
    """Phase 12: stage 2 on the card. Returns its numbers for the summary."""
    import glob
    import pickle

    import numpy as np
    import torch
    from PIL import Image

    from drivescenegen_torch import ops
    from drivescenegen_torch.config import VectorizeConfig
    from drivescenegen_torch.ops import stage2
    from drivescenegen_torch.ops.lane_mask import lane_mask_batch
    from drivescenegen_torch.scripts import end_to_end, generation, vectorization
    from drivescenegen_torch.vectorize import native_graph

    dev = torch.device("cuda")
    B, S0 = q_ddim.shape[:2]
    phase(f"12 stage 2: lane mask, skeleton and bit-pack on the card; the vectorization CLI; "
          f"the end-to-end CLI, DDIM-{STEPS}, batch {B}, {E2E_SCENES} scenes")
    out = {}

    # 12a: the device pass against the same pass on the CPU, bit for bit.
    fixture = os.path.join(here, "tests", "fixtures", "torch_stage2")
    fixture_pngs = sorted(glob.glob(os.path.join(fixture, "*.png")))
    check(len(fixture_pngs) == 4, f"fixture holds {len(fixture_pngs)} PNGs, not 4")
    rasters = np.zeros((B, S0, S0, 3), np.uint8)
    rasters[:4] = np.stack([np.asarray(Image.open(f).convert("RGB")) for f in fixture_pngs])
    batches = {"fixture rasters (padded)": torch.from_numpy(rasters).to(dev),
               f"DDIM-{STEPS} batch of phase 5": q_ddim,
               "tie-break and float64-boundary constructions":
                   torch.from_numpy(stage2_constructions(S0)).to(dev)}
    for name, q in batches.items():
        mask, packed = lane_mask_batch(q), stage2.skeleton_pass(q)
        q_cpu = q.cpu()
        check(torch.equal(mask.cpu(), lane_mask_batch(q_cpu)), f"{name}: masks differ from the CPU's")
        check(torch.equal(packed.cpu(), stage2.skeleton_pass(q_cpu)),
              f"{name}: packed skeletons differ from the CPU's")
        print(f"device pass on {name} {tuple(q.shape)}: masks ({int(mask.sum())} lane px) and packed "
              f"skeletons {tuple(packed.shape)} ({int(np.unpackbits(packed.cpu().numpy()).sum())} px) "
              f"bit-identical to the CPU's")
    q = q_ddim
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        stage2.skeleton_pass(q)
        syncs = None
    except RuntimeError as e:
        syncs = str(e)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(syncs is None, f"the device pass syncs the host: {syncs}")
    launches = sum(r[1] for r in device_kernels(lambda: stage2.skeleton_pass(q)))
    pass_ms = device_ms(lambda: stage2.skeleton_pass(q), n=5)
    pass_eager_ms = time_ms(lambda: stage2.skeleton_pass(q), 100.0, graph=False)
    out.update(pass_device_ms=pass_ms, pass_eager_ms=pass_eager_ms, pass_launches=launches)
    print(f"device pass, batch {B} at {S0}x{S0}: {pass_ms:.4f} ms of device time per batch "
          f"(torch.profiler), {pass_eager_ms:.4f} ms eager with the host's enqueue (CUDA events); "
          f"{launches} device kernels per batch; syncs the host: no")

    # 12b: the vectorization CLI on the fixture, against the JAX package's
    # record of it (numpy and scipy may differ between machines: arrays
    # within STAGE2_TOL, graphs exact).
    check(native_graph.available(), "the native graph library did not build or load")
    print(f"native graph library: {native_graph.library_path().name}, loaded")
    vec_dir = os.path.join(work, "vectorized")
    t0 = time.perf_counter()
    totals = vectorization.main(["--load_path", fixture, "--save_path", vec_dir, "--device",
                                 "cuda", "--n_workers", "2"])
    cli_s = time.perf_counter() - t0
    check(totals["n_images"] == 4 and totals["n_ok"] == 4, f"vectorization CLI: {totals}")
    expected = np.load(os.path.join(fixture, "expected.npz"))
    for i in range(4):
        with open(os.path.join(vec_dir, "graph", f"{i}_graph.pickle"), "rb") as f:
            graph = pickle.load(f)
        nodes = np.asarray(list(graph.nodes), np.int64).reshape(-1, 2)
        edges = np.asarray([(*u, *v) for u, v in graph.edges], np.int64).reshape(-1, 4)
        check(np.array_equal(nodes, expected[f"nodes_{i}"]) and
              np.array_equal(edges, expected[f"edges_{i}"]), f"image {i}: graph differs")
        scenario = torch.load(os.path.join(vec_dir, "vectorized", f"{i}.pkl"), weights_only=False)
        lanes = scenario["lane"]
        check(len(lanes) == expected["n_lanes"][i], f"image {i}: {len(lanes)} lanes")
        worst = 0.0
        for k, lane in enumerate(lanes):
            ref = expected[f"lane_{i}_{k}"]
            check(np.shape(lane) == ref.shape, f"image {i} lane {k}: shape {np.shape(lane)}")
            worst = max(worst, float(np.abs(np.asarray(lane) - ref).max()))
        for agents in (np.asarray(scenario["all_agent"], np.float64).reshape(-1, 9),
                       np.load(os.path.join(vec_dir, "agent", f"{i}_agents.npy")).reshape(-1, 9)):
            ref = expected[f"agents_{i}"]
            check(agents.shape == ref.shape, f"image {i}: agents {agents.shape} != {ref.shape}")
            if ref.size:
                worst = max(worst, float(np.abs(agents - ref).max()))
        check(worst <= STAGE2_TOL, f"image {i}: lanes/agents off by {worst} > {STAGE2_TOL}")
        print(f"image {i}: {nodes.shape[0]} nodes, {edges.shape[0]} edges equal; "
              f"{len(lanes)} lanes and {len(expected[f'agents_{i}'])} agents within {worst:.3g}")
    # The host's graph passes alone, per image, warm, in this process.
    skels = vectorization._batch_skeletonize(fixture_pngs, dev)
    imgs = [Image.open(f).convert("RGB") for f in fixture_pngs]
    for img, f in zip(imgs, fixture_pngs):
        vectorization.vectorize(img, skel=skels[f], vcfg=VectorizeConfig())
    t0 = time.perf_counter()
    for _ in range(3):
        for img, f in zip(imgs, fixture_pngs):
            vectorization.vectorize(img, skel=skels[f], vcfg=VectorizeConfig())
    host_s = (time.perf_counter() - t0) / (3 * len(imgs))
    out.update(vectorization_cli_s=cli_s, host_vectorize_s_per_image=host_s)
    print(f"vectorization CLI (--n_workers 2, spawn included): {cli_s:.3f} s for 4 images; "
          f"host graph passes per image, warm: {host_s:.5f} s")

    # 12c: the end-to-end CLI at full width, and the generation CLI's PNGs.
    e2e_dir, gen_dir = os.path.join(work, "e2e"), os.path.join(work, "gen")
    argv = ["--model_dir", model_dir, "--output_dir", e2e_dir, "--num_scenes", str(E2E_SCENES),
            "--batch_size", str(B), "--sampler", "ddim", "--steps", str(STEPS), "--n_workers", "2",
            "--seed", "5", "--device", "cuda"]
    ops.reset_launch_counts()
    stats, timings = end_to_end.main(argv)
    counts = ops.launch_counts()
    n_batches = E2E_SCENES // B
    want = {"silu_conv3x3": 44 * STEPS * n_batches, "gn_mul_add": 45 * STEPS * n_batches,
            "silu_affine": STEPS * n_batches, "attention": STEPS * n_batches,
            "attention_bwd_prep": 0, "attention_bwd_main": 0, "attention_bwd_dq": 0,
            "attention_bwd_d8": 0, "group_norm_silu_bwd": 0}
    check(counts == want, f"end-to-end launch counts {counts} != {want}")
    check(stats["n_images"] == E2E_SCENES and
          stats["n_ok"] + stats["n_rejected"] + stats["n_failed"] == E2E_SCENES,
          f"end-to-end stats {stats}")
    sampling_rate = E2E_SCENES / timings["sampling_wall_s"]
    e2e_rate = E2E_SCENES / timings["wall_time_s"]
    out.update(e2e_first_batch_s=timings["first_batch_s"], e2e_sampling_scenes_per_s=sampling_rate,
               e2e_scenes_per_s=e2e_rate, phase5_ddim_scenes_per_s=ddim_rate,
               e2e_counts={k: stats[k] for k in ("n_ok", "n_rejected", "n_failed")})
    print(f"end-to-end CLI: {E2E_SCENES} scenes, first batch {timings['first_batch_s']:.3f} s, "
          f"sampling {sampling_rate:.4f} scenes/s, end to end {e2e_rate:.4f} scenes/s (phase 5's "
          f"DDIM-{STEPS}: {ddim_rate:.4f} scenes/s); ok {stats['n_ok']}, rejected "
          f"{stats['n_rejected']}, failed {stats['n_failed']}; launches {counts}")
    generation.main(["--model_dir", model_dir, "--output_dir", gen_dir, "--sampler", "ddim",
                     "--steps", str(STEPS), "--batch_size", str(B), "--num_batches",
                     str(n_batches), "--seed", "5", "--device", "cuda"])
    fused = sorted(os.listdir(os.path.join(e2e_dir, "diffusion")))
    check(fused == sorted(os.listdir(gen_dir)) and len(fused) == E2E_SCENES,
          f"end-to-end wrote {fused}")
    for name in fused:
        a = np.asarray(Image.open(os.path.join(e2e_dir, "diffusion", name)))
        b = np.asarray(Image.open(os.path.join(gen_dir, name)))
        check(np.array_equal(a, b), f"{name}: end-to-end and generation CLI pixels differ")
    print(f"end-to-end PNGs: {len(fused)} pixel-equal to the generation CLI's (--seed 5 "
          f"--num_batches {n_batches})")

    # 12d: --resume reloads every batch and samples none.
    ops.reset_launch_counts()
    again, timings = end_to_end.main(argv + ["--resume"])
    counts = ops.launch_counts()
    check(timings["n_resumed"] == timings["n_batches"] == n_batches,
          f"--resume resumed {timings['n_resumed']}/{timings['n_batches']} batches")
    check(set(counts.values()) == {0}, f"--resume launched kernels: {counts}")
    check(all(again[k] == stats[k] for k in ("n_images", "n_ok", "n_rejected", "n_failed")),
          f"--resume stats {again} != {stats}")
    print(f"--resume: {timings['n_resumed']}/{timings['n_batches']} batches resumed, no kernel "
          f"launched, the same counts, {timings['wall_time_s']:.3f} s")
    return out


def raster_gate(card, cpu, agents: bool) -> dict:
    """A card raster against the CPU's (float [H, W, C] in [0, 1]): the
    largest |delta| off flipped box-edge pixels, and the uint8 levels the
    rasterization CLI would write. A flipped pixel is one of the agent
    channel that one side covers and the other does not."""
    import numpy as np

    flip = ((card[..., 2] == 0) != (cpu[..., 2] == 0)) if agents else np.zeros(card.shape[:2], bool)
    keep = ~flip
    levels = np.abs(np.clip(card * 255.0, 0, 255).astype(np.uint8).astype(int)
                    - np.clip(cpu * 255.0, 0, 255).astype(np.uint8).astype(int))
    return dict(max_abs=float(np.abs(card - cpu)[keep].max(initial=0.0)),
                max_level=int(levels[keep].max(initial=0)),
                one_level_px=int((levels[keep] > 0).any(axis=-1).sum()),
                flipped_px=int(flip.sum()), px=int(flip.size))


def check_raster_totals(name: str, t: dict, floats: bool = True) -> None:
    """Phase 13's gates on summed raster_gate readings; floats=False for
    rasters read back from PNGs, which hold uint8 levels only."""
    if floats:
        check(t["max_abs"] <= RASTER_TOL,
              f"{name}: card vs CPU max |delta| {t['max_abs']} > {RASTER_TOL}")
    check(t["max_level"] <= 1, f"{name}: uint8 pixels {t['max_level']} levels apart")
    for key in ("one_level_px", "flipped_px"):
        check(t[key] <= RASTER_PX_SHARE * t["px"],
              f"{name}: {t[key]} {key} of {t['px']} (limit {RASTER_PX_SHARE:.2%})")


def dense_scenario(seed: int) -> bytes:
    """A scene that fills the rasterizer's budgets, from a seed: the lanes of
    DENSE_LAYOUTS rich synthetic layouts, each shifted by up to
    DENSE_SPREAD m, so that lanes cross and overlap as at a large
    intersection, and DENSE_VEHICLES vehicles on them, the ego (track 0) at
    the middle of lane 0."""
    import numpy as np

    from drivescenegen_torch.data import synthetic
    from drivescenegen_torch.data.protos import dsg_scenario_pb2

    rng = np.random.default_rng(seed)
    sc = dsg_scenario_pb2.Scenario()
    sc.scenario_id = f"dense_{seed:08d}"
    sc.current_time_index = 10
    sc.timestamps_seconds.extend(t * 0.1 for t in range(91))
    lanes = []
    for _ in range(DENSE_LAYOUTS):
        shift = rng.uniform(-DENSE_SPREAD, DENSE_SPREAD, size=2)
        lanes += [(pts + shift, v) for pts, v in synthetic.synthetic_layout(rng, rich=True)]
    offset = rng.uniform(-2000, 2000, size=2)
    for i, (pts, _) in enumerate(lanes):
        feat = sc.map_features.add()
        feat.id = i + 1
        synthetic._fill_lane(feat, pts + offset)
    sc.sdc_track_index = 0
    for v in range(DENSE_VEHICLES):
        pts, speed = lanes[int(rng.integers(0, len(lanes))) if v else 0]
        track = sc.tracks.add()
        track.id = 1000 + v
        synthetic._track_along_lane(track, pts + offset, speed * rng.uniform(0.0, 1.2),
                                    start_frac=0.5 if v == 0 else float(rng.uniform(0.1, 0.9)))
    return sc.SerializeToString()


def raster_probe(infos, kw: dict, dev: str) -> dict:
    """What the scenes ask of the rasterizer, read on the card in a pass of
    their own (the readings cost syncs, so no timed pass makes them): the
    polyline and agent buckets the splat and the agent channel see, the
    largest number of samples that one pixel's sum adds in turn (the
    splat's loop runs once per sample of that run), and the box-edge
    pixels that cos/sin taken on the card would flip against the shipped
    host cos/sin, which make card and CPU agree by construction."""
    import numpy as np
    import torch

    from drivescenegen_torch.ops import raster

    seen = dict(polylines=[], agents=[], run=[], pixels=[], samples=[], flipped_px=0,
                headings_apart=0)
    segment_sum, agent_channel = raster._segment_sum, raster.rasterize_agent_channel

    def spy_sum(idx, vals, n):
        counts = torch.unique(idx[vals[:, -1] != 0], return_counts=True)[1]
        seen["run"].append(int(counts.max()) if counts.numel() else 0)
        seen["pixels"].append(counts.numel())
        seen["samples"].append(int(counts.sum()))
        return segment_sum(idx, vals, n)

    def spy_agents(boxes, gate, gate_valid, half_range, H, W, cos_sin):
        host = agent_channel(boxes, gate, gate_valid, half_range, H=H, W=W, cos_sin=cos_sin)
        card = agent_channel(boxes, gate, gate_valid, half_range, H=H, W=W)
        card_cs = torch.stack([torch.cos(boxes[:, 4]), torch.sin(boxes[:, 4])], dim=1)
        seen["agents"].append(boxes.shape[0])
        seen["flipped_px"] += int(((host == 0) != (card == 0)).sum())
        seen["headings_apart"] += int((card_cs != cos_sin).any(dim=1).sum())
        return host

    polylines = raster.mp.pad_polylines
    raster._segment_sum, raster.rasterize_agent_channel = spy_sum, spy_agents
    raster.mp.pad_polylines = lambda f, m, n: (seen["polylines"].append(n), polylines(f, m, n))[1]
    try:
        for info in infos:
            raster.rasterize_scenario(info, device=dev, **kw)
    finally:
        raster._segment_sum, raster.rasterize_agent_channel = segment_sum, agent_channel
        raster.mp.pad_polylines = polylines
    return dict(polyline_buckets=sorted(set(seen["polylines"])),
                agent_buckets=sorted(set(seen["agents"])), max_run=max(seen["run"]),
                mean_run_max=float(np.mean(seen["run"])),
                pixels_per_scene=float(np.mean(seen["pixels"])),
                samples_per_scene=float(np.mean(seen["samples"])),
                card_trig_flipped_px=seen["flipped_px"],
                card_trig_headings_apart=seen["headings_apart"],
                px=len(infos) * kw["img_res"] ** 2)


def raster_variants(label: str, infos, kw: dict, dev: str) -> dict:
    """rasterize_scenario on the card against the CPU for each scene in the
    four variants: the gates, two card runs compared, wall ms both ways,
    device ms and kernels per scene (torch.profiler); then raster_probe."""
    import numpy as np

    from drivescenegen_torch.ops.raster import rasterize_scenario

    modes = {"dxdy_agents": {}, "dxdy_agents t=10": {"agent_time_index": 10},
             "with_agent=False": {"with_agent": False}, "occupancy": {"mode": "occupancy"}}
    n = len(infos)
    out = {}
    for name, extra in modes.items():
        totals = dict(max_abs=0.0, max_level=0, one_level_px=0, flipped_px=0, px=0)
        cpu_s = card_s = 0.0
        same_twice = True
        for info in infos:
            t0 = time.perf_counter()
            cpu = rasterize_scenario(info, device="cpu", **kw, **extra)
            t1 = time.perf_counter()
            card = rasterize_scenario(info, device=dev, **kw, **extra)
            t2 = time.perf_counter()
            cpu_s, card_s = cpu_s + t1 - t0, card_s + t2 - t1
            same_twice &= np.array_equal(card, rasterize_scenario(info, device=dev, **kw, **extra))
            g = raster_gate(card, cpu, agents=card.shape[-1] == 3 and "with_agent" not in extra)
            totals = {k: (max(totals[k], g[k]) if k.startswith("max") else totals[k] + g[k])
                      for k in totals}
        check_raster_totals(f"rasterize_scenario {name}, {label}", totals)
        check(same_twice, f"rasterize_scenario {name}, {label}: two card runs differ")
        scenes = itertools.cycle(infos)
        rows = device_kernels(lambda: rasterize_scenario(next(scenes), device=dev, **kw, **extra),
                              n=n)
        dev_ms = sum(r[2] for r in rows) / 1e3 / n if rows else None
        kernels = sum(r[1] for r in rows) / n if rows else None
        top = sorted(rows, key=lambda r: -r[2])[:3]
        out[name] = dict(totals, card_wall_ms=card_s / n * 1e3, cpu_wall_ms=cpu_s / n * 1e3,
                         device_ms=dev_ms, kernels_per_scene=kernels,
                         bit_identical_twice=same_twice,
                         top_kernels=[(k[:60], c / n, us / 1e3 / n) for k, c, us in top])
        print(f"rasterize_scenario {name}, {label}, card vs CPU: max |delta| "
              f"{totals['max_abs']:.3g} (tol {RASTER_TOL}), uint8 max {totals['max_level']} "
              f"level, {totals['one_level_px']} px one level apart, {totals['flipped_px']} "
              f"flipped box-edge px, of {totals['px']}; two card runs bit-identical: {same_twice}; "
              f"per scene: card {card_s / n * 1e3:.2f} ms wall, "
              + (f"{dev_ms:.4f} ms device time in {kernels:.1f} kernels (torch.profiler; most: "
                 + "; ".join(f"{k[:40]} x{c / n:.1f} {us / 1e3 / n:.4f} ms" for k, c, us in top)
                 + ")" if rows else "device time not measured (the profiler recorded nothing)")
              + f"; CPU {cpu_s / n * 1e3:.2f} ms wall")
    probe = raster_probe(infos, kw, dev)
    out["probe"] = probe
    print(f"rasterize_scenario, {label}: polyline buckets {probe['polyline_buckets']} of "
          f"{kw['max_polylines']}, agent buckets {probe['agent_buckets']} of {kw['max_agents']}; "
          f"splat: {probe['samples_per_scene']:.0f} weighted samples on "
          f"{probe['pixels_per_scene']:.0f} pixels a scene, the longest per-pixel run "
          f"{probe['max_run']} (mean of the scenes' longest {probe['mean_run_max']:.1f}); cos/sin "
          f"on the card instead of the host: {probe['card_trig_headings_apart']} headings apart, "
          f"{probe['card_trig_flipped_px']} box-edge px flipped of {probe['px']}")
    return out


def phase_front_end(here: str, work: str, dev: str = "cuda") -> dict:
    """Phase 13: the data front end and the evaluation on the card. Returns
    its numbers for the summary."""
    import glob
    import pickle

    import numpy as np
    from PIL import Image

    from drivescenegen_torch.config import RasterConfig
    from drivescenegen_torch.data import native_io, tfrecord
    from drivescenegen_torch.data.graph_export import export_scenario
    from drivescenegen_torch.data.preprocess import decode_scenario
    from drivescenegen_torch.data.synthetic import make_synthetic_scenario
    from drivescenegen_torch.eval.map_metrics import STATS_NAMES
    from drivescenegen_torch.ops.raster import rasterize_scenario
    from drivescenegen_torch.scripts import (compute_map_metrics, data_preprocess,
                                             data_rasterization, run_demo, vectorization)

    rc = RasterConfig()
    N = FRONT_SCENES
    phase(f"13 front end: preprocess {N} rich synthetic scenes; the rasterizer on the card at "
          f"{rc.img_res}x{rc.img_res}, {rc.map_range:g} m, {rc.max_polylines} polylines, "
          f"{rc.max_agents} agents, interp_k {rc.interp_k}, against the CPU; the rasterization "
          f"CLI; GT export, vectorization and the round-trip metrics; the demo")
    out = {}
    fe = os.path.join(work, "front_end")

    # 13a: preprocess, synthetic and from a TFRecord shard through each reader.
    pre = os.path.join(fe, "preprocessed")
    t0 = time.perf_counter()
    ids = data_preprocess.main(["--synthetic", str(N), "--synthetic_rich", "--save_path", pre])
    rates = {"synthetic": N / (time.perf_counter() - t0)}
    check(len(ids) == N, f"preprocess CLI wrote {len(ids)} scenes")
    raw = os.path.join(fe, "raw")
    os.makedirs(raw)
    tfrecord.write_tfrecord(os.path.join(raw, "synthetic.tfrecord"),
                            [make_synthetic_scenario(i, rich=True) for i in range(N)])
    check(native_io.available(), "the native TFRecord reader did not build or load")
    pickles = sorted(glob.glob(os.path.join(pre, "sample_*.pkl")))
    for backend in ("native", "python"):
        d = os.path.join(fe, f"pre_{backend}")
        t0 = time.perf_counter()
        data_preprocess.main(["--load_path", raw, "--save_path", d, "--n_workers", "1",
                              "--backend", backend])
        rates[backend] = N / (time.perf_counter() - t0)
        for a in pickles:
            with open(a, "rb") as f1, open(os.path.join(d, os.path.basename(a)), "rb") as f2:
                check(f1.read() == f2.read(), f"{backend} reader: {os.path.basename(a)} differs")
    fixture = os.path.join(here, "tests", "fixtures", "womd_mini.tfrecord")
    recs = [bytes(r) for r in tfrecord.read_tfrecord(fixture, backend="native")]
    check(recs == list(tfrecord.read_tfrecord_python(fixture)) and len(recs) == 3,
          "womd_mini.tfrecord: the native and Python readers disagree")
    sids = [decode_scenario(r)["scenario_id"] for r in recs]
    out["preprocess_scenes_per_s"] = rates
    print(f"preprocess CLI, {N} rich synthetic scenes: {rates['synthetic']:.1f} scenes/s "
          f"(generate + decode); from a TFRecord shard of them: native reader "
          f"({native_io.library_path().name}) {rates['native']:.1f} scenes/s, Python reader "
          f"{rates['python']:.1f} scenes/s, pickles byte-identical; womd_mini.tfrecord: both "
          f"readers give the same 3 records ({', '.join(sids)})")

    # 13b: rasterize_scenario on the card against the CPU, every scene, every mode; then
    # the same on dense scenes that fill the polyline and agent budgets.
    infos = []
    for path in pickles:
        with open(path, "rb") as f:
            infos.append(pickle.load(f))
    kw = dict(img_res=rc.img_res, map_range=rc.map_range, max_polylines=rc.max_polylines,
              max_agents=rc.max_agents, interp_k=rc.interp_k)
    rasterize_scenario(infos[0], device=dev, **kw)  # the card's first use
    out["raster"] = raster_variants(f"{N} rich scenes", infos, kw, dev)
    dense = [decode_scenario(dense_scenario(seed)) for seed in range(DENSE_SCENES)]
    out["raster_dense"] = raster_variants(
        f"{DENSE_SCENES} dense scenes ({DENSE_LAYOUTS} rich layouts, {DENSE_VEHICLES} vehicles "
        f"each)", dense, kw, dev)

    # 13c: the rasterization CLI, 2 workers on the card, then on the CPU.
    cli = {}
    for d in (dev, "cpu"):
        res = data_rasterization.main(["--load_path", pre, "--save_path",
                                       os.path.join(fe, f"raster_{d}"), "--n_workers", "2",
                                       "--device", d])
        check(res["n_png"] == N, f"rasterization CLI --device {d} wrote {res['n_png']} PNGs")
        cli[d] = res
    png_dir = cli[dev]["out_dir"]
    names = sorted(os.listdir(png_dir))
    check(names == sorted(os.listdir(cli["cpu"]["out_dir"])), "the CLIs' PNG names differ")
    totals = dict(max_abs=0.0, max_level=0, one_level_px=0, flipped_px=0, px=0)
    for name in names:
        a = np.asarray(Image.open(os.path.join(png_dir, name)), np.float32) / 255.0
        b = np.asarray(Image.open(os.path.join(cli["cpu"]["out_dir"], name)), np.float32) / 255.0
        g = raster_gate(a, b, agents=True)
        totals = {k: (max(totals[k], g[k]) if k.startswith("max") else totals[k] + g[k])
                  for k in totals}
    check_raster_totals("rasterization CLI PNGs", totals, floats=False)
    out["cli_scenes_per_s"] = {d: N / cli[d]["seconds"] for d in cli}
    out["cli_png_totals"] = totals
    print(f"rasterization CLI, {N} scenes, --n_workers 2 (spawn included): card "
          f"{N / cli[dev]['seconds']:.2f} scenes/s, --device cpu {N / cli['cpu']['seconds']:.2f} "
          f"scenes/s; PNGs card vs CPU: uint8 max {totals['max_level']} level, "
          f"{totals['one_level_px']} px one level apart, {totals['flipped_px']} flipped px")

    # 13d: GT export, the vectorization CLI on the card's rasters, round-trip metrics.
    gt, vec = os.path.join(fe, "gt"), os.path.join(fe, "vec")
    for i, info in enumerate(infos):
        export_scenario(info, gt, i)
    vstats = vectorization.main(["--load_path", png_dir, "--save_path", vec, "--n_workers", "2",
                                 "--device", dev])
    check(vstats["n_images"] == N and vstats["n_ok"] > 0, f"vectorization CLI: {vstats}")
    t0 = time.perf_counter()
    metrics = compute_map_metrics.main(["--gt_dir", gt, "--gen_dir", vec, "--map_range",
                                        str(rc.map_range), "--map_res", str(rc.img_res)])
    metrics_s = time.perf_counter() - t0
    check(sorted(metrics) == sorted(["frechet", "mmd_degrees", "mmd_spectrum", "n_gt_graphs",
                                     "n_gen_graphs", "n_gen_images", "n_rejected", "n_failed"])
          and list(metrics["frechet"]) == STATS_NAMES, f"metrics JSON keys {sorted(metrics)}")
    check(all(math.isfinite(v) for v in [*metrics["frechet"].values(), metrics["mmd_degrees"],
                                         metrics["mmd_spectrum"]]), f"metrics not finite: {metrics}")
    check(metrics["n_gt_graphs"] == N and metrics["n_gen_images"] == N
          and metrics["n_gen_graphs"] == vstats["n_ok"], f"metrics counts {metrics}")
    out.update(vectorization=vstats, metrics=metrics, metrics_wall_s=metrics_s)
    print(f"round trip: {N} GT graphs exported; vectorization CLI ok {vstats['n_ok']}, rejected "
          f"{vstats['n_rejected']}, failed {vstats['n_failed']}; compute_map_metrics "
          f"{metrics_s:.3f} s wall: {json.dumps(metrics)}")

    # 13e: the demo at its default tiny size, on the card with --plain.
    times = run_demo.main(["--work_dir", os.path.join(fe, "demo"), "--plain", "--device", dev])
    out["demo_stage_s"] = times
    print("demo (--plain, default size): " + ", ".join(f"{k} {v:.2f} s" for k, v in times.items()))
    return out


def children_of(pid: int):
    """The pids whose parent is `pid` (/proc)."""
    kids = []
    for d in os.listdir("/proc"):
        if d.isdigit():
            try:
                with open(f"/proc/{d}/stat") as f:
                    stat = f.read()
            except OSError:
                continue
            if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
                kids.append(int(d))
    return kids


def phase_scale(here: str, work: str, model_dir: str, gen6_dir: str, train7_run: str,
                train_path, rows: dict, step7_ms: float) -> dict:
    """Phase 14: config-3's training at scale. Returns its numbers."""
    import numpy as np
    import torch

    from drivescenegen_torch import ops
    from drivescenegen_torch.config import Config, MeshConfig, ModelConfig, TrainConfig, save_config
    from drivescenegen_torch.data.dataset import (RasterDataset, array_to_device, decoded_corpus,
                                                  hybrid_index_batches, sidecar_path)
    from drivescenegen_torch.diffusion import make_schedule
    from drivescenegen_torch.models import UNet2D
    from drivescenegen_torch.parallel import Mesh, make_mesh
    from drivescenegen_torch.scripts import train as train_cli
    from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
    from drivescenegen_torch.training.checkpoint import latest_step

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20261017)
    n_rasters = 2 * SCALE_SCENES
    phase(f"14 training at scale: config-3 at batch {SCALE_BATCH} on one rank, a {n_rasters}-"
          f"raster corpus with its sidecar, hybrid/resident/streamed, --init_from, "
          f"--profile_steps, --supervise, dropout, torchrun generation")
    sc = os.path.join(work, "scale")
    out = {"card": smi_line()}
    t_phase = time.perf_counter()

    # 14a: the corpus. Synthetic scenes preprocessed by four CLI processes,
    # rasterized by the CLI on the card with each scene also rotated 180
    # degrees (--augment rot180) and the sidecar written as it goes.
    t0 = time.perf_counter()
    per = SCALE_SCENES // 4
    procs = [subprocess.Popen([sys.executable, "-m", "drivescenegen_torch.scripts.data_preprocess",
                               "--synthetic", str(per), "--synthetic_offset", str(k * per),
                               "--save_path", os.path.join(sc, f"pre{k}")], cwd=here,
                              stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
             for k in range(4)]
    for p_ in procs:
        _, err = p_.communicate(timeout=600)
        check(p_.returncode == 0, f"data_preprocess exited {p_.returncode}: {err[-2000:]}")
    pre = os.path.join(sc, "pre")
    os.makedirs(pre)
    for k in range(4):
        for f in os.listdir(os.path.join(sc, f"pre{k}")):
            if f.startswith("sample_"):
                os.symlink(os.path.join(sc, f"pre{k}", f), os.path.join(pre, f))
    out["preprocess_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log = run_module(here, "drivescenegen_torch.scripts.data_rasterization",
                     ["--load_path", pre, "--save_path", os.path.join(sc, "ras"), "--n_workers",
                      "4", "--augment", "rot180", "--save_sidecar"])
    out["rasterize_with_sidecar_s"] = time.perf_counter() - t0
    img_dir = os.path.join(sc, "ras", "GT_70k_s80_dxdy_agents_img")
    pattern = os.path.join(img_dir, "*.png")
    ds = RasterDataset(pattern, img_res=256, n_channels=3, raw="auto")
    check(len(ds) == n_rasters, f"the rasterization CLI wrote {len(ds)} PNGs, not {n_rasters}")
    sidecar = sidecar_path(ds.files, 256, 3, np.uint8)
    check(f"sidecar written: {sidecar}" in log, f"no sidecar written:\n{log[-2000:]}")
    print(f"corpus: {SCALE_SCENES} synthetic scenes preprocessed in {out['preprocess_s']:.1f} s "
          f"(4 processes), {n_rasters} rasters of 256x256 and the sidecar by the rasterization "
          f"CLI (4 workers, --augment rot180 --save_sidecar) in "
          f"{out['rasterize_with_sidecar_s']:.1f} s; sidecar {os.path.getsize(sidecar) / 1e6:.1f} MB")

    # 14b: the sidecar against the decode it replaces: equal rows, and the
    # time of each.
    t0 = time.perf_counter()
    full = decoded_corpus(ds)
    out["sidecar_open_s"] = time.perf_counter() - t0
    check(isinstance(full, np.memmap) and full.filename == os.path.abspath(sidecar),
          "decoded_corpus did not map the rasterization CLI's sidecar")
    t0 = time.perf_counter()
    decoded = np.stack([ds[i] for i in range(len(ds))])
    out["decode_s"] = time.perf_counter() - t0
    check(np.array_equal(decoded, full), "the sidecar differs from the PNGs' decode")
    del decoded
    print(f"sidecar: mapped in {out['sidecar_open_s'] * 1e3:.2f} ms against {out['decode_s']:.2f} s "
          f"to decode the {n_rasters} PNGs (one host thread); every row equal")

    # 14c: array_to_device, the whole corpus in ~200 MB chunks.
    t0 = time.perf_counter()
    data = array_to_device(full, dev, label="phase 14 upload")
    dt = time.perf_counter() - t0
    idx = torch.randint(0, n_rasters, (16,), generator=gen, device=dev)
    check(np.array_equal(data[idx].cpu().numpy(), full[idx.cpu().numpy()]),
          "array_to_device rows differ from the sidecar's")
    out["array_to_device_gb_per_s"] = full.nbytes / 1e9 / dt
    print(f"array_to_device: {full.nbytes / 1e9:.4f} GB in {dt:.3f} s, "
          f"{out['array_to_device_gb_per_s']:.3f} GB/s (sidecar mmap, pageable copies)")
    del data
    torch.cuda.empty_cache()

    # 14d: the one-rank NCCL step against the step without a process group
    # (phase 7's) on the same weights, batch and draws. Phase 7's config,
    # with no lr warmup so that the step moves the parameters.
    mcfg = ModelConfig(attention_impl="flash")
    tcfg7 = TrainConfig(ema_decay=0.9999)
    tcfg = dataclasses.replace(tcfg7, lr_warmup_steps=0)
    schedule = make_schedule(device=dev)
    weights = UNet2D(mcfg, device=dev, generator=gen).state_dict()
    batch = torch.randint(0, 256, (SCALE_BATCH, 256, 256, 3), generator=gen,
                          device=dev).to(torch.uint8)

    def train_state(mesh):
        m = UNet2D(mcfg, device=dev, for_training=True)
        m.load_state_dict(weights)
        opt, lr_fn = create_optimizer(tcfg, 1000, m.parameters())
        return init_train_state(m, opt, ema=True), make_train_step(schedule, lr_fn, tcfg, mesh)

    def one_step(mesh):
        st, step = train_state(mesh)
        st, met = step(st, batch)
        torch.cuda.synchronize()
        named = list(st.model.named_parameters())
        return dict(loss=met["loss"].item(), gnorm=met["grad_norm"].item(),
                    grads=torch.cat([p.grad.reshape(-1) for _, p in named]),
                    params=torch.cat([p.detach().reshape(-1) for _, p in named]),
                    ema=torch.cat([v.reshape(-1) for v in st.ema_params.values()]))

    def step_ms(st, step):
        for _ in range(3):
            st, _m = step(st, batch)
        torch.cuda.synchronize()
        times = []
        for _ in range(10):
            t0 = time.perf_counter()
            st, _m = step(st, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)[len(times) // 2], times

    def same(a, b):
        return a["loss"] == b["loss"] and a["gnorm"] == b["gnorm"] and all(
            torch.equal(a[k], b[k]) for k in ("grads", "params", "ema"))

    plain_a, plain_b = one_step(None), one_step(None)
    dist_env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                    MASTER_PORT=str(free_port()))
    os.environ.update(dist_env)
    try:
        mesh = make_mesh(MeshConfig(), "cuda")
        check(mesh.distributed and torch.distributed.get_backend() == "nccl",
              "make_mesh under torchrun's variables did not start NCCL")
        nccl = one_step(mesh)
        bitwise = same(nccl, plain_a)
        cos = torch.nn.functional.cosine_similarity(nccl["grads"], plain_a["grads"], dim=0).item()
        print(f"one-rank NCCL step against the step without a process group: bit-identical "
              f"(loss, grad_norm, every gradient, parameter and EMA value) {bitwise}; the plain "
              f"step twice bit-identical {same(plain_a, plain_b)}; loss {nccl['loss']:.6f} vs "
              f"{plain_a['loss']:.6f}, grad_norm {nccl['gnorm']:.6f} vs {plain_a['gnorm']:.6f}, "
              f"gradient cosine {cos:.7f}")
        if not bitwise:  # then phase 7's gates
            check(abs(nccl["loss"] - plain_a["loss"]) <= TRAIN_LOSS_TOL * abs(plain_a["loss"])
                  and abs(nccl["gnorm"] - plain_a["gnorm"]) <= TRAIN_GNORM_TOL * plain_a["gnorm"]
                  and cos >= TRAIN_COS_MIN, "the NCCL step is outside phase 7's gates")
        out.update(nccl_step_bit_identical=bitwise, plain_step_repeatable=same(plain_a, plain_b),
                   nccl_gradient_cosine=cos)
        del plain_a, plain_b, nccl
        st, step = train_state(mesh)
        out["nccl_step_ms"], out["nccl_step_ms_runs"] = step_ms(st, step)
        rows_ = [r for r in device_kernels(lambda: step(st, batch), n=3)
                 if "nccl" in r[0].lower()]
        # None: no NCCL kernel in the profile (a world of one reduces in
        # place, which launches nothing).
        out["all_reduce_device_ms"] = sum(r[2] for r in rows_) / 1e3 / 3 if rows_ else None
        out["all_reduce_kernels"] = sorted({r[0][:80] for r in rows_})
        del st, step
        torch.cuda.empty_cache()
        st, step = train_state(None)
        out["plain_step_ms"], out["plain_step_ms_runs"] = step_ms(st, step)
        del st, step
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k in dist_env:
            os.environ.pop(k, None)
    torch.cuda.empty_cache()
    ar = out["all_reduce_device_ms"]
    print(f"train step at batch {SCALE_BATCH}: one-rank NCCL {out['nccl_step_ms']:.2f} ms, no "
          f"process group {out['plain_step_ms']:.2f} ms (medians of ten after three warm-up; "
          f"phase 7's {step7_ms:.2f} ms); the gradient all_reduce: "
          + ("no NCCL kernel in torch.profiler's trace" if ar is None else
             f"{ar:.4f} ms of device time a step {out['all_reduce_kernels']}"))

    # 14e: the three data modes on the corpus, one process, in turns
    # (hybrid, resident, streamed, then back): samples/s (ten steps after
    # three warm-up), the device's idle share, and what the tail streams a
    # step.
    budget_gb = POOL_SHARE * full.nbytes / 1024 ** 3
    tcfg_modes = dataclasses.replace(tcfg, batch_size=SCALE_BATCH, device_data_budget_gb=budget_gb,
                                     seed=CONFIG3_TRAIN["seed"])
    st, step = train_state(None)
    n_pool = int(budget_gb * 1024 ** 3) // (256 * 256 * 3)
    order = np.random.default_rng(tcfg_modes.seed).permutation(n_rasters)
    pool_idx, tail_idx = np.sort(order[:n_pool]), np.sort(order[n_pool:])
    modes = {}
    for mode in ("hybrid", "resident", "streamed", "streamed", "resident", "hybrid"):
        t0 = time.perf_counter()
        next_batch, info = train_cli.batch_source(mode, ds, tcfg_modes, Mesh(device=dev))
        setup_s = time.perf_counter() - t0
        first = next_batch()
        if mode == "hybrid":
            ps, ts = next(hybrid_index_batches(n_pool, n_rasters - n_pool, SCALE_BATCH,
                                               seed=tcfg_modes.seed))
            want = np.concatenate([full[pool_idx[ps]], full[tail_idx[ts]]])
            check(info["pool"] == n_pool and np.array_equal(first.cpu().numpy(), want),
                  "the hybrid batch is not the pool's rows, then the tail's")
        for _ in range(3):
            st, _m = step(st, next_batch())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            st, _m = step(st, next_batch())
        torch.cuda.synchronize()
        sps = 10 * SCALE_BATCH / (time.perf_counter() - t0)
        busy = profile_device(lambda: step(st, next_batch()), n=3, label=f"{mode} step", top=4)
        m = modes.setdefault(mode, dict(samples_per_s=[], idle=[], setup_s=[], **{
            k: v for k, v in info.items() if k != "mode"}))
        m["samples_per_s"].append(sps)
        m["idle"].append(None if busy is None else 1.0 - busy)
        m["setup_s"].append(setup_s)
        del next_batch
        torch.cuda.empty_cache()
    del st, step
    torch.cuda.empty_cache()
    hyb = modes["hybrid"]
    for mode, m in modes.items():
        idle = ", ".join("not measured" if x is None else f"{100 * x:.1f}%" for x in m["idle"])
        print(f"{mode}: {', '.join(f'{x:.2f}' for x in m['samples_per_s'])} samples/s (its two "
              f"turns), device idle {idle}, set-up {', '.join(f'{x:.2f}' for x in m['setup_s'])} s")
    print(f"hybrid: pool {hyb['pool']} of {n_rasters} ({100 * hyb['pool'] / n_rasters:.1f}%; "
          f"config-3's 6 GB of 13.8 GB is {100 * POOL_SHARE:.1f}%), a batch {hyb['k_res']} "
          f"resident + {hyb['k_str']} streamed rows, {hyb['tail_bytes_per_step'] / 1e6:.4f} MB "
          f"host to device a step")
    out["modes"] = modes

    # 14f: a full-width step with dropout 0.1, kernels against plain on the
    # same weights, batch, noise, t and masks, under phase 7's gates.
    noise = torch.randn(SCALE_BATCH, 256, 256, 3, generator=gen, device=dev)
    tt_ = torch.randint(0, 1000, (SCALE_BATCH,), generator=gen, device=dev)
    dropout = train_path(ModelConfig(attention_impl="flash", dropout=0.1), tcfg7, batch, noise,
                         tt_, None, f"dropout 0.1, batch {SCALE_BATCH}")
    out["dropout_step_ms"] = dropout["med_ms"]
    del noise, batch, weights
    torch.cuda.empty_cache()

    # 14g: the train CLI under torchrun, one rank over NCCL: config-3 with
    # device_data "auto" over its budget (hybrid), warm-started from phase
    # 7's run, steps 2-4 traced.
    run_cfg = Config(model=mcfg, mesh=MeshConfig(**CONFIG3_MESH))
    run_cfg.train = dataclasses.replace(
        TrainConfig(**CONFIG3_TRAIN), batch_size=SCALE_BATCH, device_data="auto",
        device_data_budget_gb=budget_gb, dataset_glob=pattern, log_every=1,
        eval_inference_steps=10, output_dir=os.path.join(sc, "run"))
    cfg_path = os.path.join(sc, "config3.yaml")
    save_config(run_cfg, cfg_path)
    t0 = time.perf_counter()
    log = run_module(here, "drivescenegen_torch.scripts.train",
                     ["--cfg_file", cfg_path, "--max_steps", str(SCALE_STEPS), "--init_from",
                      train7_run, "--profile_steps", "3"], nproc=1, timeout=900)
    out["hybrid_cli_s"] = time.perf_counter() - t0
    for want in ("mesh: {'data': 1, 'model': 1} on cuda:0 (torch.distributed)",
                 "hybrid device data: corpus", f"decoded_corpus: using sidecar {sidecar}",
                 f"warm-started params from {os.path.join(train7_run, 'checkpoints')}",
                 "profiler trace of steps 2-4"):
        check(want in log, f"the torchrun train CLI did not log {want!r}:\n{log[-3000:]}")
    launched = logged_launches(log)
    check(all(launched[k] == SCALE_STEPS for k in
              ("attention_bwd_prep", "attention_bwd_main", "attention_bwd_dq"))
          and launched["attention"] >= SCALE_STEPS, f"torchrun train CLI launches {launched}")
    per_row = row_launches(launched, logged_launches(log, "attention forward launches by source"))
    for name, row in rows.items():
        row.d["launches_by_path"][f"phase 14 torchrun train CLI, hybrid ({SCALE_STEPS} steps and "
                                  f"a DDIM-10 eval sample)"] = per_row[name]
    traces = [os.path.join(sc, "run", "trace", f) for f in
              os.listdir(os.path.join(sc, "run", "trace"))]
    check(len(traces) == 1, f"--profile_steps wrote {traces}")
    with open(traces[0]) as f:
        trace_text = f.read()
    named = {k: trace_text.count(k) for k in ("flash_attention_kernel", "prep_kernel",
                                              "bwd_kernel", "dq_kernel", "nccl")}
    check(all(named[k] for k in ("flash_attention_kernel", "prep_kernel", "bwd_kernel",
                                 "dq_kernel")), f"the trace does not name the attention kernels: "
                                                f"{named}")
    records = [json.loads(ln) for ln in open(os.path.join(sc, "run", "logs", "metrics.jsonl"))]
    out["hybrid_cli_samples_per_s"] = [r["samples_per_sec"] for r in records]
    after = sorted(out["hybrid_cli_samples_per_s"][1:])
    print(f"torchrun train CLI (1 rank, NCCL, hybrid, --init_from phase 7's run, "
          f"--profile_steps 3): {SCALE_STEPS} steps in {out['hybrid_cli_s']:.1f} s wall; samples/s "
          f"by step (the CLI's log, host clock between log lines, no sync) "
          f"{', '.join(f'{x:.1f}' for x in out['hybrid_cli_samples_per_s'])}, median after the "
          f"first {after[len(after) // 2]:.1f}; launches "
          f"{launched}; trace {os.path.basename(traces[0])} ({len(trace_text) / 1e6:.1f} MB) names "
          f"{named}")

    # 14h: --supervise 1 on a 100-raster subset (7 steps an epoch): the
    # child is killed once its first checkpoint and log line are written,
    # and the supervisor resumes it from that checkpoint to the end.
    sup_dir = os.path.join(sc, "supervised")
    run_cfg.train = dataclasses.replace(run_cfg.train, dataset_glob=os.path.join(img_dir, "0_1??.png"),
                                        output_dir=sup_dir, save_image_epochs=1000)
    sup_cfg = os.path.join(sc, "supervised.yaml")
    save_config(run_cfg, sup_cfg)
    sup_log = os.path.join(sc, "supervised.log")
    t0 = time.perf_counter()
    with open(sup_log, "w") as logf:
        sup = subprocess.Popen([sys.executable, "-m", "drivescenegen_torch.scripts.train",
                                "--cfg_file", sup_cfg, "--max_steps", str(SUP_STEPS),
                                "--supervise", "1"], cwd=here, stdout=logf,
                               stderr=subprocess.STDOUT)
        first_ckpt = os.path.join(sup_dir, "checkpoints", "step_00000007.pt")
        metrics = os.path.join(sup_dir, "logs", "metrics.jsonl")
        killed = None
        while sup.poll() is None and time.perf_counter() - t0 < 600:
            if killed is None and os.path.exists(first_ckpt) and os.path.exists(metrics) \
                    and os.path.getsize(metrics) > 0:
                kids = children_of(sup.pid)
                check(len(kids) == 1, f"the supervisor has children {kids}")
                os.kill(kids[0], 9)
                killed = time.perf_counter() - t0
            time.sleep(0.1)
        rc = sup.wait(timeout=600)
    sup_text = open(sup_log).read()
    out["supervised_s"] = time.perf_counter() - t0
    check(killed is not None, f"the supervised child ended before it was killed:\n{sup_text[-2000:]}")
    check(rc == 0 and "relaunching WITH --resume" in sup_text and "resumed from step" in sup_text
          and latest_step(os.path.join(sup_dir, "checkpoints")) == SUP_STEPS,
          f"supervised run rc {rc}:\n{sup_text[-3000:]}")
    resumed = [ln for ln in sup_text.splitlines() if "resumed from step" in ln][0]
    print(f"--supervise 1: child killed at {killed:.1f} s (after its checkpoint at step 7), the "
          f"supervisor probed the card and relaunched it with --resume ({resumed.split(' - ')[-1]}), "
          f"which ended rc 0 at step {SUP_STEPS}; {out['supervised_s']:.1f} s wall")

    # 14i: the generation CLI under torchrun, one rank: phase 6's PNGs.
    gen_dir = os.path.join(sc, "gen")
    run_module(here, "drivescenegen_torch.scripts.generation",
               ["--model_dir", model_dir, "--output_dir", gen_dir, "--sampler", "ddim", "--steps",
                str(STEPS), "--batch_size", "2", "--num_batches", "2", "--device", "cuda"], nproc=1)
    names = sorted(os.listdir(gen6_dir))
    check(sorted(os.listdir(gen_dir)) == names, f"torchrun generation wrote {os.listdir(gen_dir)}")
    for name in names:
        with open(os.path.join(gen_dir, name), "rb") as a, open(os.path.join(gen6_dir, name), "rb") as b:
            check(a.read() == b.read(), f"torchrun generation {name} differs from phase 6's")
    print(f"torchrun generation (1 rank, NCCL, DDIM-{STEPS}): {len(names)} PNGs byte-equal to phase 6's")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"phase 14: {out['phase_s']:.1f} s")
    return out



# Phase 15: config-3's model at its per-chip batch of 14, phase 7's weights,
# batch, noise and t, phase 7's TrainConfig without lr warmup (as phase
# 14d), on a mesh of data 1 x model 2: two ranks on the one card over gloo.
TP_MODEL, TP_STEPS_TIMED = 2, 3


def tp_train_config():
    from drivescenegen_torch.config import TrainConfig

    return dataclasses.replace(TrainConfig(ema_decay=0.9999), lr_warmup_steps=0)


def flat_of(tree, names):
    """The tensors of `tree` in the order of `names`, as one f32 vector."""
    import torch

    return torch.cat([tree[n].float().reshape(-1) for n in names])


def tp_worker(workdir: str) -> int:
    """One rank of phase 15b (chip_smoke.py --tp-worker <workdir>, started by
    torch.distributed.run): the training arm at model 2 on cuda:0 over gloo,
    with the kernels. Step 1 on phase 7's noise and t, its launches and
    gathered gradients; step 2 (the step's own draws), the gathered params
    and EMA after it; a checkpoint (rank 0 writes the gathered state) and
    params.npz; step 3 and its gathered gradients; then TP_STEPS_TIMED timed
    steps and the rank's peak memory. Rank 0 saves the gathered tensors;
    every rank writes its numbers as JSON."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from drivescenegen_torch import ops
    from drivescenegen_torch.config import Config, MeshConfig, ModelConfig, save_config
    from drivescenegen_torch.diffusion import make_schedule
    from drivescenegen_torch.models import UNet2D
    from drivescenegen_torch.parallel import gather_state_dict, make_mesh, shard_state_dict
    from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
    from drivescenegen_torch.training.checkpoint import (full_params, save_checkpoint,
                                                         save_params_only)

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    # Both ranks on the one card: NCCL refuses two ranks on one device.
    mesh = make_mesh(MeshConfig(data=1, model=TP_MODEL), "cuda:0", backend="gloo")
    try:
        dev = mesh.device
        inp = torch.load(os.path.join(workdir, "..", "train7_inputs.pt"), map_location=dev)
        mcfg, tcfg = ModelConfig(attention_impl="flash"), tp_train_config()
        torch.cuda.reset_peak_memory_stats()
        model = UNet2D(mcfg, device=dev, for_training=True, mesh=mesh)
        model.load_state_dict(shard_state_dict(inp["weights"], mesh, model.tp_plan))
        opt, lr_fn = create_optimizer(tcfg, 1000, model.parameters())
        state = init_train_state(model, opt, ema=True)
        step = make_train_step(make_schedule(device=dev), lr_fn, tcfg, mesh)
        names = [n for n, _ in model.named_parameters()]
        batch = inp["batch"][mesh.rows(len(inp["batch"]))]
        out = {"rank": mesh.rank, "model_index": mesh.model_index, "sharded": len(model.tp_plan),
               "local_params": sum(p.numel() for p in model.parameters())}
        tensors = {}

        def gathered_grads():
            return flat_of(gather_state_dict({n: p.grad for n, p in model.named_parameters()},
                                             mesh, model.tp_plan), names)

        ops.reset_launch_counts()
        state, m = step(state, batch, inp["noise"], inp["t"])
        torch.cuda.synchronize()
        out["launches_step1"] = ops.launch_counts()
        out["attention_by_source_step1"] = dict(ops.attention.launches_by_source)
        out["step1"] = (m["loss"].item(), m["grad_norm"].item())
        tensors["grads1"] = gathered_grads()
        state, m = step(state, batch)
        out["step2"] = (m["loss"].item(), m["grad_norm"].item())
        tensors["params2"] = flat_of(full_params(state, mesh), names)
        tensors["ema2"] = flat_of(full_params(state, mesh, ema=True), names)
        save_checkpoint(os.path.join(workdir, "checkpoints"), state, mesh=mesh)
        model_dir = os.path.join(workdir, "export")
        save_params_only(model_dir, full_params(state, mesh, ema=True), mesh=mesh)
        if mesh.is_main:
            save_config(Config(model=mcfg), os.path.join(model_dir, "config.yaml"))
        state, m = step(state, batch)
        out["step3"] = (m["loss"].item(), m["grad_norm"].item())
        tensors["grads3"] = gathered_grads()
        times = []
        for _ in range(TP_STEPS_TIMED):
            mesh.barrier()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = step(state, batch)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out["step_ms"] = times
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if mesh.is_main:
            torch.save(tensors, os.path.join(workdir, "tensors.pt"))
        with open(os.path.join(workdir, f"rank{mesh.rank}.json"), "w") as f:
            json.dump(out, f)
        mesh.barrier()
    finally:
        mesh.close()
    return 0


def phase_tp_train(here: str, work: str, inputs7: str) -> dict:
    """Phases 15b and 15c: the full-width TP train step on two gloo ranks on
    the card against the one-process step on the same weights, batch and
    draws, under phase 7's gates; the gathered params and EMA after two
    steps; the launches, ms per step and peak memory of each rank; then the
    tp = 2 checkpoint resumed by one process at tp = 1, its next step held
    to the tp = 2 run's, and the tp = 2 params.npz sampled by the generation
    CLI. Returns the numbers."""
    import torch

    from drivescenegen_torch.config import ModelConfig
    from drivescenegen_torch.diffusion import make_schedule
    from drivescenegen_torch.models import UNet2D
    from drivescenegen_torch.models.unet2d import gn_mul_add_shapes
    from drivescenegen_torch.scripts import generation
    from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
    from drivescenegen_torch.training.checkpoint import restore_checkpoint

    dev = torch.device("cuda")
    mcfg, tcfg = ModelConfig(attention_impl="flash"), tp_train_config()
    inp = torch.load(inputs7, map_location=dev)
    TB = len(inp["batch"])
    schedule = make_schedule(device=dev)
    out = {}

    def one_process():
        m_ = UNet2D(mcfg, device=dev, for_training=True)
        m_.load_state_dict(inp["weights"])
        opt, lr_fn = create_optimizer(tcfg, 1000, m_.parameters())
        return init_train_state(m_, opt, ema=True), make_train_step(schedule, lr_fn, tcfg)

    def grads_of(model):
        return torch.cat([p.grad.float().reshape(-1) for _, p in model.named_parameters()])

    # The one-process reference: steps 1-3 on the same weights and draws.
    st, step = one_process()
    names = [n for n, _ in st.model.named_parameters()]
    p0 = flat_of(dict(st.model.named_parameters()), names)
    ref = {}
    st, m = step(st, inp["batch"], inp["noise"], inp["t"])
    ref["step1"], ref["grads1"] = (m["loss"].item(), m["grad_norm"].item()), grads_of(st.model)
    lrs = [m["lr"]]
    st, m = step(st, inp["batch"])
    ref["step2"] = (m["loss"].item(), m["grad_norm"].item())
    lrs.append(m["lr"])
    ref["params2"] = flat_of(dict(st.model.named_parameters()), names)
    ref["ema2"] = flat_of(st.ema_params, names)
    st, m = step(st, inp["batch"])
    ref["step3"], ref["grads3"] = (m["loss"].item(), m["grad_norm"].item()), grads_of(st.model)
    del st, step, m
    torch.cuda.empty_cache()

    # 15b: two ranks on the card, started as a user starts them.
    tp_dir = os.path.join(work, "tp")
    os.makedirs(tp_dir)
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc_per_node", str(TP_MODEL), os.path.join(here, "chip_smoke.py"),
                          "--tp-worker", tp_dir], cwd=here, env=env, capture_output=True,
                         text=True, timeout=600)
    out["workers_s"] = time.perf_counter() - t0
    check(res.returncode == 0, f"the TP workers exited {res.returncode}:\n"
                               f"{(res.stdout + res.stderr)[-4000:]}")
    ranks = [json.load(open(os.path.join(tp_dir, f"rank{r}.json"))) for r in range(TP_MODEL)]
    got = torch.load(os.path.join(tp_dir, "tensors.pt"), map_location=dev)

    def gate(label, mine, theirs, g_mine, g_theirs):
        (lk, gk), (lp, gp) = mine, theirs
        cos = torch.nn.functional.cosine_similarity(g_mine, g_theirs, dim=0).item()
        print(f"{label}: loss {lk:.6f} vs {lp:.6f} (rel {abs(lk - lp) / lp:.2e}, tol "
              f"{TRAIN_LOSS_TOL}), grad_norm {gk:.6f} vs {gp:.6f} (rel {abs(gk - gp) / gp:.2e}, "
              f"tol {TRAIN_GNORM_TOL}), gradient cosine {cos:.6f} (min {TRAIN_COS_MIN})")
        check(abs(lk - lp) <= TRAIN_LOSS_TOL * abs(lp), f"{label}: loss differs")
        check(abs(gk - gp) <= TRAIN_GNORM_TOL * abs(gp), f"{label}: grad_norm differs")
        check(cos >= TRAIN_COS_MIN, f"{label}: gradient cosine {cos}")
        return cos

    check(ranks[0]["step1"] == ranks[1]["step1"], f"the two ranks' step 1 differ: {ranks}")
    out["step1_cosine"] = gate(f"TP step (model {TP_MODEL}, 2 gloo ranks) against one process, "
                               f"step 1 on phase 7's draws", ranks[0]["step1"], ref["step1"],
                               got["grads1"], ref["grads1"])
    # In AdamW's first two steps an element moves by at most its lr (after
    # bias correction |m / sqrt(v)| <= 1, by Cauchy-Schwarz), plus the decay
    # lr wd |p|; so two runs whose gradients differ in rounding stay within
    # 2 (lr_1 + lr_2) of each other, gated at 3 (lr_1 + lr_2), and the EMA,
    # an average of the params, within the same.
    bound = 3 * sum(lrs)
    for name in ("params2", "ema2"):
        diff = (got[name] - ref[name]).abs()
        upd = torch.nn.functional.cosine_similarity(got[name] - p0, ref[name] - p0, dim=0).item()
        print(f"{name[:-1]} after two steps: max |delta| {diff.max().item():.3g} (bound "
              f"{bound:.3g} = 3 x the two lrs), {100 * (diff <= 1e-7).float().mean().item():.2f}% "
              f"of {diff.numel()} values within 1e-7; cosine of the two runs' moves {upd:.6f}")
        check(diff.max().item() <= bound, f"the TP run's {name} is {diff.max().item()} away")
        check(upd >= TRAIN_COS_MIN, f"the TP run's {name} moved along {upd} of the one process's")
    n_gn = sum(gn_mul_add_shapes(mcfg).values())  # norm2 on its shard, groups / tp
    want1 = {"silu_conv3x3": 0, "gn_mul_add": n_gn, "silu_affine": n_gn, "attention": 1,
             "attention_bwd_prep": 1, "attention_bwd_main": 1, "attention_bwd_dq": 1,
             "attention_bwd_d8": 0, "group_norm_silu_bwd": n_gn}
    for r in ranks:
        check(r["launches_step1"] == want1, f"rank {r['rank']} launched {r['launches_step1']} "
                                            f"in one TP step, not {want1}")
        med = sorted(r["step_ms"])[len(r["step_ms"]) // 2]
        print(f"rank {r['rank']} (model index {r['model_index']}): {r['sharded']} sharded tensors, "
              f"{r['local_params']:,} parameters; launches in one step {r['launches_step1']}; "
              f"{', '.join(f'{x:.1f}' for x in r['step_ms'])} ms a step (median {med:.1f}): gloo "
              f"staged through host memory, both ranks on one card; not a TP speed; peak memory "
              f"{r['peak_gb']:.2f} GB (torch.cuda.max_memory_allocated)")
    out["ranks"] = ranks
    print(f"TP workers: {out['workers_s']:.1f} s wall (two processes, model build, 6 steps, "
          f"gathers, a checkpoint)")

    # 15c: the tp = 2 checkpoint (step 2) resumed by one process at tp = 1.
    st, step = one_process()
    st = restore_checkpoint(os.path.join(tp_dir, "checkpoints"), st)
    check(st.step == 2, f"resumed at step {st.step}")
    st, m = step(st, inp["batch"])
    out["resume_cosine"] = gate("tp = 2 checkpoint resumed at tp = 1: step 3 against the tp = 2 "
                                "run's step 3", (m["loss"].item(), m["grad_norm"].item()),
                                ranks[0]["step3"], grads_of(st.model), got["grads3"])
    gate("the tp = 2 run's step 3 against the one-process run's", ranks[0]["step3"],
         ref["step3"], got["grads3"], ref["grads3"])
    del st, step, m, got, ref
    torch.cuda.empty_cache()
    gen_dir = os.path.join(tp_dir, "gen")
    generation.main(["--model_dir", os.path.join(tp_dir, "export"), "--output_dir", gen_dir,
                     "--sampler", "ddim", "--steps", "10", "--batch_size", "1", "--num_batches",
                     "1", "--device", "cuda"])
    check(os.listdir(gen_dir) == ["loop_000_batch_000.png"], "generation from the tp = 2 export")
    print(f"the tp = 2 params.npz (the gathered EMA) sampled by the generation CLI (DDIM-10): "
          f"loop_000_batch_000.png; batch {TB} a step on each rank")
    return out


# Phase 16: the last modules on the card. A reference diffusers checkpoint
# at the default widths (random weights from a seed) imported at head dim 64
# and at diffusers' default of 8, DriveSceneGen's own model, which samples
# by DDIM-50 and by the reference's 750-step ancestral DDPM
# (generation.py:5,17 of the reference); config-5's agent evaluation; the
# port's FLOP count against this run's forward and DDIM-50; the Waymo
# validator.
IMPORT_STEPS, EVAL_RASTERS, EVAL_STEPS, DDPM_STEPS = 10, 16, 50, 750
CONFIG5_YAML = os.path.join("drivescenegen_tpu", "configs", "config5_cond_128n.yaml")
WOMD_FIXTURE = os.path.join("tests", "fixtures", "womd_mini.tfrecord")
DIFFUSERS_NAMES = (  # the port's module paths -> diffusers UNet2DModel's
    (r"^time_mlp\.dense1\.", "time_embedding.linear_1."),
    (r"^time_mlp\.dense2\.", "time_embedding.linear_2."),
    (r"^down_(\d+)_res_(\d+)\.", r"down_blocks.\1.resnets.\2."),
    (r"^down_(\d+)_downsample\.", r"down_blocks.\1.downsamplers.0."),
    (r"^up_(\d+)_res_(\d+)\.", r"up_blocks.\1.resnets.\2."),
    (r"^up_(\d+)_upsample\.", r"up_blocks.\1.upsamplers.0."),
    (r"^mid_res_(\d)\.", r"mid_block.resnets.\1."),
    (r"^mid_attn\.norm\.", "mid_block.attentions.0.group_norm."),
    (r"^mid_attn\.proj_out\.", "mid_block.attentions.0.to_out.0."),
    (r"^norm_out\.", "conv_norm_out."),
    (r"\.time_proj\.", ".time_emb_proj."),
    (r"\.shortcut\.", ".conv_shortcut."),
)


def diffusers_state_dict(state_dict) -> dict:
    """The port's UNet2D state dict under diffusers UNet2DModel's names:
    module paths renamed (DIFFUSERS_NAMES) and the fused qkv split into
    to_q, to_k and to_v. The layouts are torch's on both sides, so
    models/import_diffusers.py must give the same weights back."""
    import re

    out = {}
    for key, value in state_dict.items():
        if key.startswith("mid_attn.qkv."):
            leaf = key.rsplit(".", 1)[1]
            for name, part in zip(("to_q", "to_k", "to_v"), value.chunk(3, dim=0)):
                out[f"mid_block.attentions.0.{name}.{leaf}"] = part.clone()
            continue
        for pattern, repl in DIFFUSERS_NAMES:
            key = re.sub(pattern, repl, key)
        out[key] = value.clone()
    return out


def diffusers_config_json(cfg, head_dim=None) -> dict:
    """config.json of a diffusers UNet2DModel at cfg's widths, as the
    reference saves it; with head_dim None it names no attention_head_dim,
    as the reference's does, so diffusers' default of 8 applies."""
    out = {"_class_name": "UNet2DModel", "sample_size": cfg.sample_size,
           "in_channels": cfg.in_channels, "out_channels": cfg.out_channels,
           "layers_per_block": cfg.layers_per_block,
           "block_out_channels": list(cfg.block_out_channels),
           "norm_num_groups": cfg.norm_num_groups,
           "down_block_types": ["DownBlock2D"] * len(cfg.block_out_channels),
           "up_block_types": ["UpBlock2D"] * len(cfg.block_out_channels),
           "flip_sin_to_cos": True, "freq_shift": 0}
    if head_dim is not None:
        out["attention_head_dim"] = head_dim
    return out


def captured(fn, *args):
    """(fn(*args), its stdout), the stdout printed as well; a SystemExit's
    code is returned as the result."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        try:
            result = fn(*args)
        except SystemExit as e:
            result = e.code
    print(buf.getvalue(), end="")
    return result, buf.getvalue()


def phase_import_eval(here: str, work: str, rows: dict, fwd_graph_ms: float,
                      ddim_seconds: float) -> dict:
    """Phase 16: the diffusers import at head dim 64 and 8 (the head-dim-8
    model sampled by DDIM-50 and DDPM-750 with the kernels, the main path of
    rows["attention_d8"]), eval_cond_agents on config-5, the FLOP count's MFU and roofline,
    validate_waymo on the card. Returns its numbers for the summary."""
    import numpy as np
    import torch
    from PIL import Image

    from drivescenegen_torch import ops
    from drivescenegen_torch.config import Config, ModelConfig, load_config, save_config
    from drivescenegen_torch.data.preprocess import decode_scenario
    from drivescenegen_torch.data.synthetic import make_synthetic_scenario, make_synthetic_tfrecord
    from drivescenegen_torch.models import UNet2D
    from drivescenegen_torch.models.convert import flax_to_torch, load_npz, save_npz, torch_to_flax
    from drivescenegen_torch.diffusion import ddim_sample, make_schedule
    from drivescenegen_torch.models.unet2d import kernel_limit_errors, mid_attention_shape
    from drivescenegen_torch.ops.raster import rasterize_scenario
    from drivescenegen_torch.scripts import (eval_cond_agents, generation, import_reference,
                                             validate_waymo)
    from drivescenegen_torch.utils import flops

    phase(f"16 the diffusers import (head dim 64: DDIM-{IMPORT_STEPS} with the kernels; head dim "
          f"8: DDIM-{STEPS} and DDPM-{DDPM_STEPS} with the kernels, DDIM-{STEPS} --plain), "
          f"config-5's eval_cond_agents, MFU and roofline, validate_waymo")
    t16 = time.perf_counter()
    dev = torch.device("cuda")
    per_forward = {"silu_conv3x3": 44, "gn_mul_add": 45, "silu_affine": 1, "attention": 1}
    out = {}

    # 16a: a reference checkpoint at the default widths, head dim 64, as
    # .bin (seeded random weights, every parameter moved off its init so
    # that biases and norms are mapped too), through the import CLI.
    cfg = ModelConfig()
    src = UNet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(1616))
    g = torch.Generator().manual_seed(1617)
    with torch.no_grad():
        for p in src.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=g))
    want = {k: v.clone() for k, v in src.state_dict().items()}
    ckpt = os.path.join(work, "diffusers", "unet")
    os.makedirs(ckpt)
    torch.save(diffusers_state_dict(want), os.path.join(ckpt, "diffusion_pytorch_model.bin"))
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(diffusers_config_json(cfg, head_dim=64), f)
    del src
    t0 = time.perf_counter()
    imported = os.path.join(work, "imported64")
    _, log = captured(import_reference.main, ["--src", ckpt, "--dst", imported])
    out["import_s"] = time.perf_counter() - t0
    last = log.strip().splitlines()[-1]
    check(last == "sample with: python -m drivescenegen_torch.scripts.generation --model_dir "
          f"{imported}", f"import CLI at head dim 64 closed with {last!r}")
    icfg = load_config(os.path.join(imported, "config.yaml")).model
    check(icfg.attention_head_dim == 64 and icfg.torch_pad_downsample and
          kernel_limit_errors(icfg) == [], f"imported model config {icfg}")
    got = flax_to_torch(load_npz(os.path.join(imported, "params.npz")), icfg)
    check(sorted(got) == sorted(want) and all(torch.equal(got[k], want[k]) for k in want),
          "the imported weights differ from the checkpoint's")
    print(f"import CLI (head dim 64): {out['import_s']:.1f} s; params.npz equal to the "
          f"checkpoint's {len(want)} tensors; torch_pad_downsample, within the kernels' limits")
    model, _ = generation.load_model_for_sampling(load_config(), imported, dev)
    plain = UNet2D(icfg, device=dev, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    gen = torch.Generator(device=dev).manual_seed(161)
    xin = torch.randn(BATCH, cfg.sample_size, cfg.sample_size, 3, generator=gen, device=dev)
    tin = torch.randint(0, 1000, (BATCH,), generator=gen, device=dev)
    with torch.no_grad():
        eps_k, eps_p = model(xin, tin), plain(xin, tin)
    err = (eps_k - eps_p).abs().max().item()
    ref_max = eps_p.abs().max().item()
    tol = FORWARD_TOL * max(1.0, ref_max)
    print(f"imported forward, batch {BATCH}: kernels against plain max abs err {err:.4g} "
          f"(max |eps| {ref_max:.3g}, tol {tol:.3g})")
    check(bool(torch.isfinite(eps_k).all()) and err <= tol,
          f"imported forward: kernel and plain eps differ by {err} > {tol}")
    out.update(forward_max_abs_err=err, forward_max_abs_eps=ref_max, forward_tol=tol)
    del model, plain, eps_k, eps_p, got, want
    torch.cuda.empty_cache()
    gen_dir = os.path.join(work, "gen16a")
    ops.reset_launch_counts()
    rate = generation.main(["--model_dir", imported, "--output_dir", gen_dir, "--sampler", "ddim",
                            "--steps", str(IMPORT_STEPS), "--batch_size", str(BATCH),
                            "--num_batches", "1", "--device", "cuda"])
    counts = ops.launch_counts()
    per_row = row_launches(counts, ops.attention.launches_by_source)
    pngs = sorted(os.listdir(gen_dir))
    name = f"phase 16a generation CLI, imported model, DDIM-{IMPORT_STEPS} batch {BATCH}"
    want_counts = {k: per_forward.get(k, 0) * IMPORT_STEPS for k in counts}
    print(f"{name}: {len(pngs)} PNGs at {rate:.4f} scenes/s; launches {counts}")
    check(pngs == [f"loop_000_batch_{i:03d}.png" for i in range(BATCH)], f"{name} wrote {pngs}")
    check(counts == want_counts, f"{name} launches {counts} != {want_counts}")
    for k, row in rows.items():
        row.d["launches_by_path"][name] = per_row[k]
    out["generation_scenes_per_s"] = rate

    # 16b: the same weights with no attention_head_dim in config.json:
    # diffusers' default of 8, DriveSceneGen's own architecture (64 heads of
    # 8 over 1024 tokens). The import closes without --plain; UNet2D builds
    # on CUDA with the kernels (the training arm too, which phase 17
    # trains); its forward against plain; DDIM-50
    # timed as phase 5 times it; then DDIM-50 and DDPM-750 through the
    # generation CLI, each launch counted, and a --plain DDIM-50 beside.
    ckpt8 = os.path.join(work, "diffusers8", "unet")
    os.makedirs(ckpt8)
    os.symlink(os.path.join(ckpt, "diffusion_pytorch_model.bin"),
               os.path.join(ckpt8, "diffusion_pytorch_model.bin"))
    with open(os.path.join(ckpt8, "config.json"), "w") as f:
        json.dump(diffusers_config_json(cfg), f)
    imported8 = os.path.join(work, "imported8")
    _, log = captured(import_reference.main, ["--src", ckpt8, "--dst", imported8])
    icfg8 = load_config(os.path.join(imported8, "config.yaml")).model
    shape8 = mid_attention_shape(icfg8)
    last = log.strip().splitlines()[-1]
    check(icfg8.attention_head_dim == 8 and icfg8.torch_pad_downsample
          and kernel_limit_errors(icfg8) == [] and shape8[2] == 8
          and last == "sample with: python -m drivescenegen_torch.scripts.generation "
          f"--model_dir {imported8}", f"import CLI at head dim 8: limits "
          f"{kernel_limit_errors(icfg8)}, attention {shape8}, closing line {last!r}")
    training_limits = kernel_limit_errors(icfg8, for_training=True)
    check(training_limits == [], f"head dim 8 training arm outside the limits: {training_limits}")
    arm = UNet2D(icfg8, device=dev, for_training=True)
    check(arm.for_training and not arm.plain, "head dim 8 training arm")
    print("training arm at head dim 8 built on CUDA with the kernels, no --plain (phase 17 "
          "trains it)")
    del arm
    model, _ = generation.load_model_for_sampling(load_config(), imported8, dev)
    plain = UNet2D(icfg8, device=dev, plain=True).eval()
    plain.load_state_dict(model.state_dict())
    with torch.no_grad():
        eps_k, eps_p = model(xin, tin), plain(xin, tin)
        err = (eps_k - eps_p).abs().max().item()
        ref_max = eps_p.abs().max().item()
        tol = FORWARD_TOL * max(1.0, ref_max)
        check(bool(torch.isfinite(eps_k).all()) and err <= tol,
              f"imported forward at head dim 8: kernel and plain eps differ by {err} > {tol}")
        graph8_ms = time_ms(lambda: model(xin, tin), 100.0)
    print(f"import CLI (head dim 8): closes without --plain; attention {list(shape8)} a sample; "
          f"UNet2D built on CUDA with the kernels; forward, batch {BATCH}: kernels against "
          f"plain max abs err {err:.4g} (max |eps| {ref_max:.3g}, tol {tol:.3g}); as a CUDA "
          f"graph {graph8_ms:.3f} ms against the native model's {fwd_graph_ms:.3f} ms (phase 4)")
    del plain, eps_k, eps_p
    schedule = make_schedule(device=dev)
    ddim8_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            sample = ddim_sample(model, schedule, (BATCH, cfg.sample_size, cfg.sample_size, 3),
                                 torch.Generator(device=dev).manual_seed(7), STEPS, eta=0.0)
        torch.cuda.synchronize()
        ddim8_s.append(time.perf_counter() - t0)
    check(bool(torch.isfinite(sample).all()) and -1.0 <= sample.min().item()
          and sample.max().item() <= 1.0, "DDIM-50 of the head-dim-8 model: not finite in [-1, 1]")
    ddim8_med = sorted(ddim8_s)[1]
    print(f"DDIM-{STEPS}, head dim 8, batch {BATCH}: {', '.join(f'{t:.3f}' for t in ddim8_s)} s; "
          f"median {BATCH / ddim8_med:.4f} scenes/s against the native model's "
          f"{BATCH / ddim_seconds:.4f} (phase 5's median); device-only forwards "
          f"{STEPS * graph8_ms / 1e3:.3f} s, so the device idles "
          f"{100 * (1 - STEPS * graph8_ms / 1e3 / ddim8_med):.1f}%")
    out.update(head_dim8=dict(forward_max_abs_err=err, forward_max_abs_eps=ref_max,
                              forward_tol=tol, forward_graph_ms=graph8_ms,
                              ddim_seconds_runs=ddim8_s, ddim_scenes_per_s=BATCH / ddim8_med))
    del model, sample
    torch.cuda.empty_cache()
    for sampler, steps, plain_arg in (("ddim", STEPS, []), ("ddpm", DDPM_STEPS, []),
                                      ("ddim", STEPS, ["--plain"])):
        gen_dir = os.path.join(work, f"gen16b_{sampler}{steps}{'_plain' if plain_arg else ''}")
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        rate = generation.main(["--model_dir", imported8, "--output_dir", gen_dir, "--sampler",
                                sampler, "--steps", str(steps), "--batch_size", str(BATCH),
                                "--num_batches", "1", "--device", "cuda", *plain_arg])
        wall = time.perf_counter() - t0
        counts = ops.launch_counts()
        per_row = row_launches(counts, ops.attention.launches_by_source, head_dim=8)
        pngs = sorted(os.listdir(gen_dir))
        name = (f"phase 16b generation CLI, imported model at head dim 8, "
                f"{sampler.upper()}-{steps}{' --plain' if plain_arg else ''} batch {BATCH}")
        want_counts = {k: (0 if plain_arg else per_forward.get(k, 0) * steps) for k in counts}
        print(f"{name}: {len(pngs)} PNGs at {rate:.4f} scenes/s ({wall:.1f} s with the model "
              f"load); launches {counts}")
        check(pngs == [f"loop_000_batch_{i:03d}.png" for i in range(BATCH)], f"{name} wrote {pngs}")
        check(counts == want_counts, f"{name} launches {counts} != {want_counts}")
        if not plain_arg:
            for k, row in rows.items():
                row.d["launches_by_path"][name] = per_row[k]
        if sampler == "ddim" and not plain_arg:  # the D = 8 kernel's main path
            rows["attention_d8"].d["launches"] = per_row["attention_d8"]
        out["head_dim8"][f"cli_{sampler}{steps}{'_plain' if plain_arg else ''}"] = dict(
            scenes_per_s=rate, wall_s=wall, launches=counts)
    ddim_r, ddpm_r, plain_r = (out["head_dim8"][f"cli_{key}"]["scenes_per_s"] for key in
                               (f"ddim{STEPS}", f"ddpm{DDPM_STEPS}", f"ddim{STEPS}_plain"))
    print(f"head dim 8 through the CLI, batch {BATCH}: DDIM-{STEPS} {ddim_r:.4f} scenes/s, "
          f"DDPM-{DDPM_STEPS} {ddpm_r:.4f} ({ddim_r / ddpm_r:.2f}x the DDIM-{STEPS} time), "
          f"DDIM-{STEPS} --plain {plain_r:.4f} ({ddim_r / plain_r:.2f}x slower than with the "
          f"kernels)")

    # 16c: config-5's eval_cond_agents, random weights: precision and
    # recall are printed, not gated.
    yaml5 = os.path.join(here, CONFIG5_YAML)
    cfg5 = load_config(yaml5)
    S5 = cfg5.model.sample_size
    dir5, ras = os.path.join(work, "model5"), os.path.join(work, "ras16")
    os.makedirs(dir5)
    os.makedirs(ras)
    save_config(Config(model=cfg5.model), os.path.join(dir5, "config.yaml"))
    model5 = UNet2D(cfg5.model, device="cpu", generator=torch.Generator().manual_seed(165))
    save_npz(os.path.join(dir5, "params.npz"), torch_to_flax(model5.state_dict()))
    del model5
    for i in range(EVAL_RASTERS):
        info = decode_scenario(make_synthetic_scenario(16000 + i, rich=True))
        img = rasterize_scenario(info, img_res=S5, device="cuda")
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(
            os.path.join(ras, f"{i:03d}.png"))
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    result, _ = captured(eval_cond_agents.main, [
        "--cfg_file", yaml5, "--model_dir", dir5, "--raster_dir", ras, "--guidance", "1,3",
        "--steps", str(EVAL_STEPS), "--batch_size", str(BATCH), "--device", "cuda"])
    eval_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    per_row = row_launches(counts, ops.attention.launches_by_source)
    check(isinstance(result, dict), f"eval_cond_agents exited {result}")
    n_fwd = 2 * EVAL_STEPS * -(-EVAL_RASTERS // BATCH)  # one forward a step a batch, per g
    name = (f"phase 16c eval_cond_agents, config-5, {EVAL_RASTERS} rasters, g 1,3, "
            f"DDIM-{EVAL_STEPS} batch {BATCH}")
    want_counts = {k: per_forward.get(k, 0) * n_fwd for k in counts}
    print(f"{name}: {eval_s:.1f} s (model load and agent extraction included); launches {counts}")
    check(counts == want_counts, f"{name} launches {counts} != {want_counts}")
    check(result["n_images"] == EVAL_RASTERS and set(result["results"]) ==
          {"guidance_1", "guidance_3"} and all(math.isfinite(v) for r in
                                                result["results"].values() for v in r.values()),
          f"eval_cond_agents JSON {result}")
    for k, row in rows.items():
        row.d["launches_by_path"][name] = per_row[k]
    out["eval_cond_agents"] = dict(result, seconds=eval_s)

    # 16d: the port's FLOP count against this run's forward (phase 4, a CUDA
    # graph) and DDIM-50 (phase 5's median), both at batch BATCH.
    f_fwd = flops.unet2d_forward_flops(cfg, BATCH)
    roof = flops.unet2d_roofline_seconds(cfg, BATCH)
    mfu_fwd = f_fwd / (fwd_graph_ms / 1e3) / PEAK_BF16_FLOPS
    mfu_ddim = STEPS * f_fwd / ddim_seconds / PEAK_BF16_FLOPS
    print(f"FLOPs (utils/flops.py): {f_fwd / BATCH / 1e9:.2f} GFLOP a sample, {f_fwd / 1e12:.4f} "
          f"TFLOP a forward at batch {BATCH}; MFU against {PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s: "
          f"forward as a CUDA graph ({fwd_graph_ms:.3f} ms) {100 * mfu_fwd:.2f}%, DDIM-{STEPS} "
          f"({ddim_seconds:.3f} s) {100 * mfu_ddim:.2f}%; roofline {1e3 * roof['t_roofline_s']:.3f}"
          f" ms (FLOPs alone {1e3 * roof['t_flops_only_s']:.3f}, bytes alone "
          f"{1e3 * roof['t_mem_only_s']:.3f}; ceiling {100 * roof['mfu_ceiling']:.1f}%) against "
          f"the measured {fwd_graph_ms:.3f} ms "
          f"({100 * roof['t_roofline_s'] * 1e3 / fwd_graph_ms:.1f}% of it)")
    out["flops"] = dict(forward_flops=f_fwd, mfu_forward_graph=mfu_fwd, mfu_ddim=mfu_ddim,
                        roofline=roof, forward_graph_ms=fwd_graph_ms)

    # 16e: validate_waymo --rasterize on the card against the CPU. On the
    # fixture both exit 1: its one lane lies ~100 m from the ego, outside
    # the 40 m half range, so the raster holds no lane pixel (the JAX
    # package's validator says the same; tests/test_torch_validate_visualize.py).
    # A synthetic shard passes.
    shard = os.path.join(work, "synthetic16.tfrecord")
    make_synthetic_tfrecord(shard, 8, seed=16)
    for path, n, rc_want in ((os.path.join(here, WOMD_FIXTURE), 3, 1), (shard, 8, 0)):
        argv = ["--shard", path, "--n", str(n), "--rasterize"]
        rc, text = captured(validate_waymo.main, argv)
        rc_cpu, text_cpu = captured(validate_waymo.main, argv + ["--device", "cpu"])
        check(rc == rc_want and (rc, text) == (rc_cpu, text_cpu),
              f"validate_waymo on {path}: card rc {rc}, CPU rc {rc_cpu} (want {rc_want}), "
              f"outputs equal {text == text_cpu}")
        print(f"validate_waymo --rasterize {os.path.basename(path)}: rc {rc} on the card, "
              f"output and rc equal to the CPU's")
    out["phase_s"] = time.perf_counter() - t16
    print(f"phase 16: {out['phase_s']:.1f} s")
    return out


# Phase 17: DriveSceneGen's own model (phase 16b's import, head dim 8)
# trained on the card: the forward with lse and the head-dim-8 backward
# (csrc/flash_attention_bwd_d8.cu) at its train shape, at the heads of tp 2
# and 4 and at ragged shapes; a full-width train step against plain; the
# train CLI on the import CLI's own config.yaml, then the generation CLI on
# its export.
TRAIN8_RAGGED = ((1, 1, 128), (3, 5, 384))


def phase_train8(here: str, work: str, rows: dict, train_path, tcfg, d8_numbers: dict,
                 numbers7: dict, smi: str) -> dict:
    """Phase 17 (see above). Fills rows["attention_bwd_d8"], adds the lse
    path to rows["attention_d8"] and the phase's paths to every row's
    launches; returns its numbers."""
    import torch
    import torch.nn.functional as F

    from drivescenegen_torch import ops
    from drivescenegen_torch.config import load_config
    from drivescenegen_torch.models.convert import flax_to_torch, load_npz
    from drivescenegen_torch.models.unet2d import (gn_mul_add_shapes, kernel_limit_errors,
                                                   mid_attention_shape)
    from drivescenegen_torch.scripts import generation
    from drivescenegen_torch.training.checkpoint import latest_step

    phase("17 train8: DriveSceneGen's own model (head dim 8) trained on the card: the "
          "forward with lse and the head-dim-8 backward, a full-width train step against "
          "plain, the train CLI on the import CLI's config.yaml, the generation CLI")
    t17 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(17)
    imported8 = os.path.join(work, "imported8")
    cfg_yaml = os.path.join(imported8, "config.yaml")
    icfg8 = load_config(cfg_yaml).model
    heads, S, D = mid_attention_shape(icfg8)
    n_gn = sum(gn_mul_add_shapes(icfg8).values())  # the training arm's GN sites
    TB = tcfg.batch_size
    check((heads, S, D) == (64, 1024, 8) and kernel_limit_errors(icfg8, for_training=True) == [],
          f"the imported model trains at {(heads, S, D)}, limits "
          f"{kernel_limit_errors(icfg8, for_training=True)}")
    sc = 1.0 / math.sqrt(D)
    sms, clock_mhz = d8_numbers["sms"], d8_numbers["clock_mhz"]
    out = {"card": smi}

    def fused(Bq, Hq, Sq):
        qkv = torch.randn(Bq, Sq, 3 * Hq * D, generator=gen, device=dev).bfloat16()
        return [t.view(Bq, Sq, Hq, D).transpose(1, 2) for t in qkv.split(Hq * D, dim=-1)]

    def err_of(got, ref):
        return (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()

    # 17a: the forward with lse at the train shape, on views of a fused qkv;
    # the launch without lse at phase 3's shape beside it (row 3b).
    q, k, v = fused(TB, heads, S)
    o, lse = ops.attention_with_lse(q, k, v, sc)
    e_o, m_o = err_of(o, ops.reference_attention(q, k, v, sc))
    lse_err = (lse - ops.reference_attention_lse(q, k, sc)).abs().max().item()
    label = f"[{TB},{heads},{S},{D}]"
    print(f"attention_with_lse {label}: o err {e_o:.3g} (max {m_o:.3g}, tol "
          f"{BF16_TOL * m_o:.3g}), lse max abs err {lse_err:.3g} (tol {LSE_TOL})")
    check(e_o <= BF16_TOL * m_o, f"attention_with_lse {label} o: err {e_o} vs max {m_o}")
    check(lse_err <= LSE_TOL, f"attention_with_lse {label} lse err {lse_err}")
    fwd_bytes = 4 * TB * heads * S * D * 2 + TB * heads * S * 4
    fwd_bnd = attention_d8_bound(TB, heads, S, D, 2, fwd_bytes, sms, clock_mhz)
    fwd_ms = time_ms(lambda: ops.attention_with_lse(q, k, v, sc))
    fwd_plain = time_ms(lambda: (ops.reference_attention(q, k, v, sc),
                                 ops.reference_attention_lse(q, k, sc)), graph=False)
    fwd_lib = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
    q8, k8, v8 = fused(BATCH, heads, S)
    nolse_ms = time_ms(lambda: ops.attention(q8, k8, v8, sc))
    lse8_ms = time_ms(lambda: ops.attention_with_lse(q8, k8, v8, sc))
    print(f"attention_with_lse {label}: {fwd_ms:.4f} ms ({100 * fwd_bnd[0] / fwd_ms:.1f}% of the "
          f"bound {fwd_bnd[0]:.4f}, {fwd_bnd[1]}), SDPA forward {fwd_lib:.4f} ms, plain "
          f"{fwd_plain:.4f} ms; at [{BATCH},{heads},{S},{D}] without lse {nolse_ms:.4f} ms "
          f"(phase 3: {d8_numbers['ms']:.4f} cold), with lse "
          f"{lse8_ms:.4f} ms  ({smi})")
    rows["attention_d8"].d["with_lse"] = dict(
        shape=[TB, heads, S, D], ms=fwd_ms, plain_ms=fwd_plain, library_ms=fwd_lib,
        bound_ms=fwd_bnd[0], bound_by=fwd_bnd[1], max_abs_err=e_o, lse_max_abs_err=lse_err,
        no_lse_ms_batch8=nolse_ms, lse_ms_batch8=lse8_ms)
    out["forward_lse"] = rows["attention_d8"].d["with_lse"]
    del q, k, v, o, lse, q8, k8, v8

    # 17b: the backward at the train shape, at the heads of tp 2 and 4 and
    # at ragged shapes (a dO whose last dim is not contiguous, odd batch and
    # heads), each output within BF16_TOL x its largest plain value, two
    # runs bit-identical; the first three timed.
    bwd = {}
    shapes = [(TB, heads // tp, S, f"tp {tp}" if tp > 1 else "train") for tp in (1, 2, 4)]
    shapes += [(b_, h_, s_, "ragged") for b_, h_, s_ in TRAIN8_RAGGED]
    for Bq, Hq, Sq, kind in shapes:
        q, k, v = fused(Bq, Hq, Sq)
        if kind == "ragged" and Bq == 1:
            do = torch.randn(Bq, Hq, D, Sq, generator=gen, device=dev).bfloat16().transpose(2, 3)
        else:
            do = torch.randn(Bq, Sq, Hq, D, generator=gen, device=dev).bfloat16().transpose(1, 2)
        o, lse = ops.attention_with_lse(q, k, v, sc)
        got = ops.attention_bwd(q, k, v, o, lse, do, sc)
        again = ops.attention_bwd(q, k, v, o, lse, do, sc)
        ref = ops.reference_attention_bwd(q, k, v, o, lse, do, sc)
        lab = f"[{Bq},{Hq},{Sq},{D}] ({kind})"
        errs = []
        for name, a_, b_ in zip(("dq", "dk", "dv"), got, ref):
            e, m = err_of(a_, b_)
            errs.append((e, m))
            check(e <= BF16_TOL * m, f"attention_bwd_d8 {lab} {name}: err {e} vs max {m}")
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        check(same, f"attention_bwd_d8 {lab} is not deterministic")
        print(f"attention_bwd_d8 {lab}: " + ", ".join(
            f"{n} err {e:.3g} (max {m:.3g}, tol {BF16_TOL * m:.3g})"
            for n, (e, m) in zip(("dq", "dk", "dv"), errs)) + "; two runs bit-identical")
        entry = dict(max_abs_err=max(e for e, _ in errs), max_abs=max(m for _, m in errs))
        del got, again, ref
        if kind != "ragged":
            elems, nrows = Bq * Hq * Sq * D, Bq * Hq * Sq
            nbytes = 8 * elems * 2 + nrows * 4  # q k v o dO in, dq dk dv out; lse
            bnd = attention_d8_bound(Bq, Hq, Sq, D, 5, nbytes, sms, clock_mhz)
            ms, _ = time_cold_ms(lambda *x: ops.attention_bwd_d8(*x, sc), (q, k, v, o, lse, do),
                                 bnd, nbytes)
            plain = time_ms(lambda: ops.reference_attention_bwd(q, k, v, o, lse, do, sc),
                            graph=False)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, scale=sc)
            lib = device_ms(lambda: torch.autograd.grad(sdpa_out, (ql, kl, vl), do,
                                                        retain_graph=True))
            lib_kernels = sorted({r[0][:90] for r in device_kernels(
                lambda: torch.autograd.grad(sdpa_out, (ql, kl, vl), do, retain_graph=True))
                if "emset" not in r[0]})
            exps = Bq * Hq * Sq * Sq
            print(f"attention_bwd_d8 {lab}: {ms:.4f} ms ({exps / ms / 1e9:.1f} G exp/s, "
                  f"{100 * bnd[0] / ms:.1f}% of the bound {bnd[0]:.4f} ms, {bnd[1]}: "
                  f"products {bnd[2]['products']:.4f}, bytes {bnd[2]['bytes']:.4f}; the "
                  f"exponentials at MUFU's rate alone {bnd[2]['exponentials_mufu_only']:.4f}), "
                  f"SDPA backward "
                  f"({sdpa_out.grad_fn.name()}, device time) {lib:.4f} ms (ran "
                  f"{lib_kernels or 'not measured'}), plain {plain:.4f} ms  ({smi})")
            entry.update(ms=ms, plain_ms=plain, library_ms=lib, library_kernels=lib_kernels,
                         bound_ms=bnd[0], bound_by=bnd[1], bound_terms_ms=bnd[2])
            del ql, kl, vl, sdpa_out
        bwd[lab] = entry
        del q, k, v, o, lse, do
        torch.cuda.empty_cache()
    out["backward"] = bwd
    row = rows["attention_bwd_d8"]
    main = bwd[f"[{TB},{heads},{S},{D}] (train)"]
    # plain_ms and library_ms are the whole backward's, as the launch is.
    row.add(1, main["max_abs_err"], main["max_abs"], main["ms"], main["plain_ms"],
            (main["bound_ms"], main["bound_by"]), main["library_ms"])
    for tp in (2, 4):
        e = bwd[f"[{TB},{heads // tp},{S},{D}] (tp {tp})"]
        row.d.setdefault("tp_shapes", {})[f"tp {tp}: [{TB},{heads // tp},{S},{D}]"] = {
            n: e[n] for n in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                              "max_abs_err")}

    # 17c: a full-width train step of the imported model (its weights,
    # head dim 8, torch_pad_downsample) with kernels against plain, then a
    # run of steps, beside phase 7's head-dim-64 step.
    S0 = icfg8.sample_size
    weights = flax_to_torch(load_npz(os.path.join(imported8, "params.npz")), icfg8)
    weights = {n: t.to(dev) for n, t in weights.items()}
    batch = torch.randint(0, 256, (TB, S0, S0, icfg8.in_channels), generator=gen,
                          device=dev).to(torch.uint8)
    noise = torch.randn(TB, S0, S0, icfg8.in_channels, generator=gen, device=dev)
    t_ = torch.randint(0, 1000, (TB,), generator=gen, device=dev)
    tr = train_path(icfg8, tcfg, batch, noise, t_, None, f"head dim 8, batch {TB}",
                    weights=weights)
    print(f"head dim 8 train step, batch {TB}: median {tr['med_ms']:.2f} ms, "
          f"{tr['samples_per_s']:.2f} samples/s, device idle "
          f"{'not measured' if tr['idle'] is None else f'{100 * tr['idle']:.1f}%'}, peak "
          f"{tr['peak_gb']:.2f} GB; phase 7's head-dim-64 step {numbers7['med_ms']:.2f} ms, "
          f"{numbers7['samples_per_s']:.2f} samples/s, peak {numbers7['peak_gb']:.2f} GB  ({smi})")
    name = f"phase 17 train step of the imported model, head dim 8, batch {TB} (x{TRAIN_STEPS})"
    for k_, r_ in rows.items():
        r_.d["launches_by_path"][name] = tr["counts"][k_]
    row.d["launches"] = tr["counts"]["attention_bwd_d8"]
    row.d["launches_per_train_step"] = tr["counts"]["attention_bwd_d8"] // TRAIN_STEPS
    gn_row = rows["group_norm_silu_bwd"]
    gn_row.d["launches"] = tr["counts"]["group_norm_silu_bwd"]
    gn_row.d["launches_per_train_step"] = tr["counts"]["group_norm_silu_bwd"] // TRAIN_STEPS
    check(gn_row.d["launches_per_train_step"] == n_gn == tr["counts"]["gn_mul_add"] // TRAIN_STEPS,
          f"phase 17's train steps launched the GN backward {tr['counts']['group_norm_silu_bwd']} "
          f"and the stats {tr['counts']['gn_mul_add']} times, not {n_gn} each a step")
    out["train_step"] = {k_: tr[k_] for k_ in ("med_ms", "step_ms", "samples_per_s", "idle",
                                               "peak_gb", "counts")}
    del weights, batch, noise, t_
    torch.cuda.empty_cache()

    # 17d: the train CLI with the import CLI's config.yaml as its --cfg_file
    # (default TrainConfig: batch 14, no EMA, DDPM-750 eval samples) on
    # phase 7's corpus, ~30 steps, a resume, the export; then the
    # generation CLI's DDIM-50 at batch 8 from it.
    pattern = os.path.join(work, "train7", "data", "*.png")
    run_dir = os.path.join(work, "train8")
    cli = {}
    for steps, extra in ((CLI_STEPS, []), (CLI_RESUME_STEPS, ["--resume"])):
        t0 = time.perf_counter()
        log = run_cli(here, ["--cfg_file", cfg_yaml, "--dataset_glob", pattern, "--output_dir",
                             run_dir, "--max_steps", str(steps), *extra])
        wall = time.perf_counter() - t0
        launched = logged_launches(log)
        fwd_src = logged_launches(log, "attention forward launches by source")
        trained = steps - (CLI_STEPS if extra else 0)
        samples = log.count(": sample -> ")
        # Each train step launches the stats, apply and backward GN kernels
        # at every GN site of the training arm (n_gn), each eval forward the
        # sampling arm's kernels.
        want = {"silu_conv3x3": 44 * DDPM_STEPS * samples,
                "gn_mul_add": 45 * DDPM_STEPS * samples + n_gn * trained,
                "silu_affine": DDPM_STEPS * samples + n_gn * trained,
                "attention": trained + DDPM_STEPS * samples,
                "attention_bwd_prep": 0, "attention_bwd_main": 0, "attention_bwd_dq": 0,
                "attention_bwd_d8": trained, "group_norm_silu_bwd": n_gn * trained}
        check(launched == want, f"train CLI (head dim 8) launches {launched} != {want}")
        check(fwd_src == {"flash_attention": 0, "flash_attention_d8": want["attention"]},
              f"train CLI (head dim 8) forward launches by source: {fwd_src}")
        check(latest_step(os.path.join(run_dir, "checkpoints")) == steps,
              f"train CLI (head dim 8) ended without a checkpoint at step {steps}")
        if extra:
            check(f"resumed from step {CLI_STEPS}" in log, "train CLI --resume did not resume")
        records = [json.loads(ln) for ln in open(os.path.join(run_dir, "logs", "metrics.jsonl"))]
        last = records[-1]
        check(last["step"] == steps and math.isfinite(last["loss"]),
              f"train CLI (head dim 8) ended at {last}")
        key = "resume" if extra else "run"
        cli[key] = dict(steps=trained, wall_s=wall, eval_samples=samples, launches=launched,
                        last_log=last)
        print(f"train CLI --cfg_file {os.path.relpath(cfg_yaml, work)}"
              f"{' --resume' if extra else ''}: {trained} steps to step {steps} in {wall:.1f} s wall (process start, upload, "
              f"checkpoints and {samples} DDPM-{DDPM_STEPS} eval sample(s) included); last log "
              f"loss {last['loss']:.4f} at {last['samples_per_sec']:.1f} samples/s; launches "
              f"{launched}")
        name = (f"phase 17 train CLI, import CLI's config.yaml, head dim 8, {trained} steps"
                f"{' after --resume' if extra else ''} and {samples} DDPM-{DDPM_STEPS} eval "
                f"sample(s) at batch 1")
        per_row = row_launches(launched, fwd_src, head_dim=8)
        for k_, r_ in rows.items():
            r_.d["launches_by_path"][name] = per_row[k_]
    check(os.path.exists(os.path.join(run_dir, "params.npz")), "train CLI wrote no params.npz")
    gen_dir = os.path.join(work, "gen17")
    ops.reset_launch_counts()
    rate = generation.main(["--model_dir", run_dir, "--output_dir", gen_dir, "--sampler", "ddim",
                            "--steps", str(STEPS), "--batch_size", str(BATCH), "--num_batches",
                            "1", "--device", "cuda"])
    counts = ops.launch_counts()
    per_row = row_launches(counts, ops.attention.launches_by_source, head_dim=8)
    pngs = sorted(os.listdir(gen_dir))
    want = {k_: {"silu_conv3x3": 44, "gn_mul_add": 45, "silu_affine": 1,
                 "attention": 1}.get(k_, 0) * STEPS for k_ in counts}
    name = f"phase 17 generation CLI from the head-dim-8 export, DDIM-{STEPS} batch {BATCH}"
    print(f"{name}: {len(pngs)} PNGs at {rate:.4f} scenes/s; launches {counts}")
    check(pngs == [f"loop_000_batch_{i:03d}.png" for i in range(BATCH)], f"{name} wrote {pngs}")
    check(counts == want, f"{name} launches {counts} != {want}")
    for k_, r_ in rows.items():
        r_.d["launches_by_path"][name] = per_row[k_]
    cli["generation_scenes_per_s"] = rate
    out["cli"] = cli
    out["phase_s"] = time.perf_counter() - t17
    print(f"phase 17: {out['phase_s']:.1f} s")
    return out


# Phase 18: the training arm's GroupNorm+SiLU on the kernels, at the train
# batch of 14 and 32 groups: the widest sites and the narrowest first,
# then every other (H, C) of the training arm's 45 sites; ragged shapes:
# odd sizes, 3 channels a group, 16 groups (tp 2), a dy in another layout.
GN_BWD_MAIN = ((256, 64), (256, 192), (128, 384), (32, 1024))
GN_BWD_RAGGED = ((3, 7, 9, 96, 32, False), (2, 5, 3, 24, 8, False), (14, 64, 64, 128, 16, False),
                 (3, 16, 16, 64, 32, True))


def phase_gn_backward(rows: dict, batch: int, smi: str) -> dict:
    """Phase 18. At each shape: the stats kernel with its mean/rstd output
    (mul and add bit-identical to the launch without it, mean and rstd
    against the plain statistics), the backward (csrc/group_norm.cu, two
    launches a call) against reference_group_norm_silu_bwd, two calls
    bit-identical. Timed at every (H, C) of the training arm's sites: the
    backward cold (10 bytes an element: x and dy read twice, dx written),
    plain, and PyTorch's autograd of F.group_norm + F.silu (the f32 NCHW
    composition the training arm ran before) as the library; at the main
    shapes also warm, and the forward (stats, apply: 6 bytes an element)
    beside the composition's forward. Fills rows["group_norm_silu_bwd"]
    with the sums of one train step; returns the numbers."""
    import torch
    import torch.nn.functional as F

    from drivescenegen_torch import ops
    from drivescenegen_torch.config import ModelConfig
    from drivescenegen_torch.models.unet2d import gn_mul_add_shapes

    phase("18 gn backward: the training arm's GroupNorm+SiLU forward (statistics saved) and "
          "backward kernels against their plain versions, timed at every train shape")
    t18 = time.perf_counter()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(18)
    eps = 1e-6
    out = {"card": smi, "shapes": {}}

    def err_of(got, ref):
        return (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()

    def make(B, H, W, C, dy_nchw=False):
        x = (torch.randn(B, H, W, C, generator=gen, device=dev) * 1.5 + 0.3).bfloat16()
        if dy_nchw:
            dy = torch.randn(B, C, H, W, generator=gen, device=dev).bfloat16().permute(0, 2, 3, 1)
        else:
            dy = torch.randn(B, H, W, C, generator=gen, device=dev).bfloat16()
        dy = dy * 0.01
        sc = torch.randn(C, generator=gen, device=dev) * 0.2 + 1
        bi = torch.randn(C, generator=gen, device=dev) * 0.1
        return x, dy, sc, bi

    def checked(x, dy, sc, bi, g, lab):
        mul, add = ops.gn_mul_add(x, sc, bi, g, eps)
        mul2, add2, mean, rstd = ops.gn_mul_add(x, sc, bi, g, eps, with_stats=True)
        check(torch.equal(mul, mul2) and torch.equal(add, add2),
              f"gn_mul_add {lab}: mul and add differ when it writes the statistics")
        rm, rr = ops.reference_gn_stats(x, g, eps)
        e_m = (mean - rm).abs().max().item()
        e_r = ((rstd - rr).abs() / rr).max().item()
        check(e_m <= F32_TOL * max(rm.abs().max().item(), 1.0) and e_r <= F32_TOL,
              f"gn_mul_add {lab} statistics: mean err {e_m}, rstd rel err {e_r}")
        got = ops.group_norm_silu_bwd(dy, x, mean, rstd, sc, bi, g)
        again = ops.group_norm_silu_bwd(dy, x, mean, rstd, sc, bi, g)
        ref = ops.reference_group_norm_silu_bwd(dy, x, mean, rstd, sc, bi, g)
        errs = [err_of(a_, b_) for a_, b_ in zip(got, ref)]
        check(errs[0][0] <= BF16_TOL * errs[0][1], f"group_norm_silu_bwd {lab} dx: {errs[0]}")
        for name, (e, m) in zip(("dscale", "dbias"), errs[1:]):
            check(e <= F32_TOL * max(m, 1.0), f"group_norm_silu_bwd {lab} {name}: {e} vs max {m}")
        check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
              f"group_norm_silu_bwd {lab}: two calls differ")
        print(f"group_norm_silu_bwd {lab}: dx err {errs[0][0]:.3g} (max {errs[0][1]:.3g}), "
              f"dscale err {errs[1][0]:.3g} (max {errs[1][1]:.3g}), dbias err {errs[2][0]:.3g} "
              f"(max {errs[2][1]:.3g}); statistics mean err {e_m:.3g}, rstd rel {e_r:.3g}; two "
              f"calls bit-identical")
        return mean, rstd, errs

    for B, H, W, C, g, dy_nchw in GN_BWD_RAGGED:
        x, dy, sc, bi = make(B, H, W, C, dy_nchw)
        checked(x, dy, sc, bi, g, f"[{B},{H},{W},{C}] G{g} (ragged"
                                  f"{', dy strides ' + str(tuple(dy.stride())) if dy_nchw else ''})")
        del x, dy

    site_shapes = gn_mul_add_shapes(ModelConfig())
    check(sum(site_shapes.values()) == 45, f"the training arm's GN sites: {site_shapes}")
    main_first = [s_ for s_ in GN_BWD_MAIN if s_ in site_shapes]
    order = main_first + sorted(s_ for s_ in site_shapes if s_ not in main_first)
    row = rows["group_norm_silu_bwd"]
    step = dict(ms=0.0, bound_ms=0.0, plain_ms=0.0, library_ms=0.0, fwd_ms=0.0, fwd_bound_ms=0.0)
    G = 32
    for H, C in order:
        n_sites = site_shapes[(H, C)]
        lab = f"[{batch},{H},{H},{C}]"
        x, dy, sc, bi = make(batch, H, H, C)
        mean, rstd, errs = checked(x, dy, sc, bi, G, lab)
        n = x.numel()
        bnd = bound_ms(10 * n, 0)
        ms, copies = time_cold_ms(
            lambda dy_, x_: ops.group_norm_silu_bwd(dy_, x_, mean, rstd, sc, bi, G), (dy, x), bnd,
            10 * n)
        plain = time_ms(lambda: ops.reference_group_norm_silu_bwd(dy, x, mean, rstd, sc, bi, G))
        xr, w, b = x.detach().requires_grad_(), sc.detach().requires_grad_(), bi.detach().requires_grad_()
        y = F.silu(F.group_norm(xr.permute(0, 3, 1, 2).float(), G, w, b, eps=eps)).to(
            torch.bfloat16).permute(0, 2, 3, 1)
        lib = device_ms(lambda: torch.autograd.grad(y, (xr, w, b), dy, retain_graph=True), n=5)
        fbnd = bound_ms(6 * n, 0)
        fwd, _ = time_cold_ms(
            lambda x_: ops.silu_affine(x_, *ops.gn_mul_add(x_, sc, bi, G, eps, with_stats=True)[:2]),
            (x,), fbnd, 6 * n)
        entry = dict(sites=n_sites, ms=ms, cold_copies=copies, bound_ms=bnd[0], bound_by=bnd[1],
                     plain_ms=plain, library_ms=lib, fwd_ms=fwd, fwd_bound_ms=fbnd[0],
                     max_abs_err=errs[0][0], max_abs=errs[0][1],
                     dscale_err=errs[1][0], dbias_err=errs[2][0])
        line = (f"group_norm_silu_bwd {lab} (x{n_sites} a step): {ms:.4f} ms cold "
                f"({copies} input sets), {100 * bnd[0] / ms:.1f}% of the bound {bnd[0]:.4f} ms "
                f"({bnd[1]}), plain {plain:.4f} ms, autograd of F.group_norm + F.silu {lib:.4f} ms; "
                f"forward (stats with mean/rstd, apply) {fwd:.4f} ms, "
                f"{100 * fbnd[0] / fwd:.1f}% of {fbnd[0]:.4f}")
        if (H, C) in GN_BWD_MAIN:
            warm = time_ms(lambda: ops.group_norm_silu_bwd(dy, x, mean, rstd, sc, bi, G))
            flib = device_ms(lambda: F.silu(F.group_norm(
                x.permute(0, 3, 1, 2).float(), G, sc, bi, eps=eps)).to(torch.bfloat16).permute(
                    0, 2, 3, 1).contiguous(), n=5)
            entry.update(warm_ms=warm, fwd_library_ms=flib)
            line += f"; warm {warm:.4f} ms; the composition's forward {flib:.4f} ms"
        print(line + f"  ({smi})", flush=True)
        row.add(n_sites, errs[0][0], errs[0][1], ms, plain, bnd, lib)
        for k_ in ("ms", "bound_ms", "plain_ms", "library_ms", "fwd_ms", "fwd_bound_ms"):
            step[k_] += n_sites * entry[k_]
        out["shapes"][lab] = entry
        del x, dy, xr, w, b, y, mean, rstd
        torch.cuda.empty_cache()
    print(f"one train step's 45 GN+SiLU sites at batch {batch}: backward {step['ms']:.3f} ms "
          f"({100 * step['bound_ms'] / step['ms']:.1f}% of {step['bound_ms']:.3f}), plain "
          f"{step['plain_ms']:.3f}, the composition's backward {step['library_ms']:.3f}; forward "
          f"{step['fwd_ms']:.3f} ms ({100 * step['fwd_bound_ms'] / step['fwd_ms']:.1f}% of "
          f"{step['fwd_bound_ms']:.3f})  ({smi})")
    out["train_step_sums"] = step
    out["phase_s"] = time.perf_counter() - t18
    print(f"phase 18: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    t_main = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this check runs only on the GPU",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    try:
        from drivescenegen_torch import ops
        from drivescenegen_torch.config import Config, ModelConfig, TrainConfig, save_config
        from drivescenegen_torch.diffusion import (ddim_sample, dpmpp_2m_sample,
                                                   dpmpp_2m_sde_sample, make_guided_denoise,
                                                   make_schedule)
        from drivescenegen_torch.models import UNet2D
        from drivescenegen_torch.models import import_diffusers
        from drivescenegen_torch.models.unet2d import (conv3x3_shapes, gn_mul_add_shapes,
                                                       kernel_limit_errors, mid_attention_shape)
        from drivescenegen_torch.models.convert import save_npz, torch_to_flax
        from drivescenegen_torch.ops import build
        from drivescenegen_torch.ops import stage2
        from drivescenegen_torch.scripts import generation
        from drivescenegen_torch.training import (create_optimizer, init_train_state,
                                                  make_train_step)
        from drivescenegen_torch.training.checkpoint import latest_step
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e}); run it from the "
              f"repository root", file=sys.stderr)
        return 1
    import numpy as np
    import torch.nn.functional as F

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(20260916)

    # ---------------------------------------------------------------- 1
    phase("1 device")
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
          f"{torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("reference computations: TF32 off for cuDNN convolutions and matmuls")
    from google.protobuf import __version__ as protobuf_version
    from google.protobuf.internal import api_implementation

    print(f"protobuf {protobuf_version} ({api_implementation.Type()})")

    # ---------------------------------------------------------------- 2
    phase("2 build")
    t0 = time.perf_counter()
    report = build.build()
    for name in build.SOURCES:
        lib = build.library_path(name)
        check(lib.exists(), f"{name}: no library after the build")
        info = report.get(name)
        if info is None:
            print(f"{name}: already built at {lib.name}")
            continue
        usage = [ln.split("info    : ")[-1] for ln in info["ptxas"].splitlines() if "Used" in ln
                 or "spill" in ln or "Performance Loss" in ln]
        print(f"{name}: built in {info['seconds']:.1f}s; " + "; ".join(usage))
    print(f"build: {time.perf_counter() - t0:.1f}s")
    for name in build.SOURCES:
        sass = sass_of(build.library_path(name))
        found = {op: sass.count(op) for op in build.sass_must_hold(name)}
        print(f"{name}: SASS " + ", ".join(f"{op} x{n}" for op, n in found.items()))
        check(all(found.values()), f"{name}: SASS lacks {[op for op, n in found.items() if not n]}")

    # ---------------------------------------------------------------- 3
    phase("3 kernels against their plain versions")
    cfg = ModelConfig(use_pallas_gn=True, use_pallas_gn_conv=True, attention_impl="flash")
    shapes = conv3x3_shapes(cfg)
    check(sum(shapes.values()) == 44, f"expected 44 conv pairs per forward, got {sum(shapes.values())}")

    def forward_rows():
        return {
            "silu_conv3x3": KernelRow("silu_conv3x3", "cuda",
                                      "drivescenegen_torch/csrc/gn_silu_conv.cu",
                                      "drivescenegen_tpu/ops/pallas/gn_silu_conv.py:150"),
            "gn_mul_add": KernelRow("gn_mul_add", "cuda", "drivescenegen_torch/csrc/group_norm.cu",
                                    "drivescenegen_tpu/ops/pallas/group_norm.py:39"),
            "silu_affine": KernelRow("silu_affine", "triton", "drivescenegen_torch/ops/group_norm.py",
                                     "drivescenegen_tpu/ops/pallas/group_norm.py:48"),
            "attention": KernelRow("attention", "cuda", "drivescenegen_torch/csrc/flash_attention.cu",
                                   "drivescenegen_tpu/models/unet2d.py:307"),
        }

    rows = forward_rows()
    G, eps, B = cfg.norm_num_groups, 1e-6, BATCH

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device=dev) * std

    def err_of(got, ref):
        return (got.float() - ref.float()).abs().max().item(), ref.float().abs().max().item()

    def forward_kernels(mcfg, B, rows):
        """Every forward kernel of a UNet2D of mcfg at batch B against its
        plain version at every shape the forward gives it (conv3x3_shapes,
        gn_mul_add_shapes, mid_attention_shape), timed, summed into rows.
        Calls bound by bytes are timed with their inputs out of L2
        (time_cold_ms); the stats' warm time is printed beside it."""
        G = mcfg.norm_num_groups
        stats_seen = Counter()

        def check_stats(x, scale, bias, count, label):
            stats_seen[(x.shape[1], x.shape[-1])] += count
            mul, add = ops.gn_mul_add(x, scale, bias, G, eps)
            rm, ra = ops.reference_gn_mul_add(x, scale, bias, G, eps)
            e1, m1 = err_of(mul, rm)
            e2, m2 = err_of(add, ra)
            err, ref_max = max(e1, e2), max(m1, m2)
            check(err <= F32_TOL * max(ref_max, 1.0), f"gn_mul_add {label}: err {err} vs max {ref_max}")
            C = x.shape[-1]
            nbytes = x.numel() * 2 + 2 * C * 4 + 2 * x.shape[0] * C * 4
            bnd = bound_ms(nbytes, 3 * x.numel())
            ms, copies = time_cold_ms(lambda *a: ops.gn_mul_add(*a, G, eps), (x, scale, bias), bnd,
                                      nbytes)
            warm = time_ms(lambda: ops.gn_mul_add(x, scale, bias, G, eps))
            plain, _ = time_cold_ms(lambda *a: ops.reference_gn_mul_add(*a, G, eps), (x, scale, bias),
                                    bnd, nbytes)
            # Library yardstick: the same per-(batch, group) moments in one call.
            lib, _ = time_cold_ms(lambda x_: torch.var_mean(x_.view(x_.shape[0], -1, G, C // G),
                                                            dim=(1, 3)), (x,), bnd, nbytes)
            rows["gn_mul_add"].add(count, err, ref_max, ms, plain, bnd, lib)
            print(f"  gn_mul_add  {label}: err {err:.3g} (max {ref_max:.3g})  {ms:.4f} ms over "
                  f"{copies} input copies (warm in L2 {warm:.4f} ms), plain {plain:.4f} ms, var_mean "
                  f"{lib:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})  x{count}")
            return rm, ra

        for (H, C, Co), count in sorted(conv3x3_shapes(mcfg).items()):
            label = f"[{B},{H},{H},{C}]->{Co}"
            x = randn(B, H, H, C).bfloat16()
            scale, bias = 1.0 + randn(C, std=0.2), randn(C, std=0.1)
            # The weight as the model hands it over: bf16, channels-last OIHW.
            w = randn(Co, C, 3, 3, std=1.0 / math.sqrt(9 * C)).to(
                torch.bfloat16, memory_format=torch.channels_last)
            cb = randn(Co, std=0.1)
            mul, add = check_stats(x, scale, bias, count, label)
            got = ops.silu_conv3x3(x, mul, add, w, cb)
            ref = ops.reference_silu_conv3x3(x, mul, add, w, cb)
            err, ref_max = err_of(got, ref)
            check(err <= BF16_TOL * ref_max, f"silu_conv3x3 {label}: err {err} vs max {ref_max}")
            M = B * H * H
            nbytes = M * C * 2 + 2 * B * C * 4 + Co * C * 9 * 2 + Co * 4 + M * Co * 2
            bnd = bound_ms(nbytes, 2 * M * Co * 9 * C)
            ms, _ = time_cold_ms(ops.silu_conv3x3, (x, mul, add, w, cb), bnd, nbytes)
            plain, _ = time_cold_ms(ops.reference_silu_conv3x3, (x, mul, add, w, cb), bnd, nbytes)
            # Library yardstick: cuDNN's conv alone (channels_last bf16) on the
            # already activated input — a lower bound, not the same function.
            t = ops.reference_silu_affine(x, mul, add).permute(0, 3, 1, 2)
            cbl = cb.bfloat16()
            lib, _ = time_cold_ms(lambda t_, w_, b_: F.conv2d(t_, w_, b_, padding=1), (t, w, cbl),
                                  bnd, nbytes)
            rows["silu_conv3x3"].add(count, err, ref_max, ms, plain, bnd, lib)
            print(f"silu_conv3x3  {label}: err {err:.3g} (max {ref_max:.3g}, tol {BF16_TOL * ref_max:.3g})"
                  f"  {ms:.4f} ms ({2 * M * Co * 9 * C / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms,"
                  f" cuDNN conv {lib:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})  x{count}")
            del x, w, t, got, ref

        # norm_out: GroupNorm+SiLU at the full resolution.
        C0, S0 = mcfg.block_out_channels[0], mcfg.sample_size
        x = randn(B, S0, S0, C0).bfloat16()
        scale, bias = 1.0 + randn(C0, std=0.2), randn(C0, std=0.1)
        label = f"[{B},{S0},{S0},{C0}]"
        mul, add = check_stats(x, scale, bias, 1, label)
        got, ref = ops.silu_affine(x, mul, add), ops.reference_silu_affine(x, mul, add)
        err, ref_max = err_of(got, ref)
        check(err <= BF16_TOL * ref_max, f"silu_affine {label}: err {err} vs max {ref_max}")
        nbytes = 2 * x.numel() * 2 + 2 * B * C0 * 4
        bnd = bound_ms(nbytes, 5 * x.numel())
        ms, copies = time_cold_ms(ops.silu_affine, (x, mul, add), bnd, nbytes)
        plain, _ = time_cold_ms(ops.reference_silu_affine, (x, mul, add), bnd, nbytes)
        rows["silu_affine"].add(1, err, ref_max, ms, plain, bnd)
        print(f"silu_affine   {label}: err {err:.3g} (max {ref_max:.3g})  {ms:.4f} ms over {copies} "
              f"input copies, plain {plain:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]})  x1")
        check(stats_seen == gn_mul_add_shapes(mcfg),
              f"gn_mul_add checked at {dict(stats_seen)}, the forward calls {gn_mul_add_shapes(mcfg)}")
        del x, got, ref

        # Mid-block attention: q, k, v as strided views of the fused qkv output.
        heads, S, hd = mid_attention_shape(mcfg)
        Cm = heads * hd
        qkv = randn(B, S, 3 * Cm).bfloat16()

        def split_qkv(a):
            return (tt.view(B, S, heads, hd).transpose(1, 2) for tt in a.split(Cm, dim=-1))

        q, k, v = split_qkv(qkv)
        sc = 1.0 / math.sqrt(hd)
        got, ref = ops.attention(q, k, v, sc), ops.reference_attention(q, k, v, sc)
        err, ref_max = err_of(got, ref)
        label = f"[{B},{heads},{S},{hd}]"
        check(err <= BF16_TOL * ref_max, f"attention {label}: err {err} vs max {ref_max}")
        flops = 4 * B * heads * S * S * hd
        nbytes = 4 * B * heads * S * hd * 2
        bnd = bound_ms(nbytes, flops)
        # The fused qkv buffer is the input; q, k and v are views of it.
        ms, _ = time_cold_ms(lambda a: ops.attention(*split_qkv(a), sc), (qkv,), bnd, nbytes)
        plain, _ = time_cold_ms(lambda a: ops.reference_attention(*split_qkv(a), sc), (qkv,), bnd,
                                nbytes)
        lib, _ = time_cold_ms(lambda a: F.scaled_dot_product_attention(*split_qkv(a), scale=sc),
                              (qkv,), bnd, nbytes)
        rows["attention"].add(1, err, ref_max, ms, plain, bnd, lib)
        print(f"attention     {label}: err {err:.3g} (max {ref_max:.3g})  {ms:.4f} ms "
              f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain:.4f} ms, SDPA {lib:.4f} ms "
              f"({flops / lib / 1e9:.1f} TFLOP/s), bound {bnd[0]:.4f} ms ({bnd[1]})  x1")
        del qkv, q, k, v, got, ref

    forward_kernels(cfg, B, rows)
    C0, S0 = cfg.block_out_channels[0], cfg.sample_size
    heads, S, hd = mid_attention_shape(cfg)
    Cm, sc = heads * hd, 1.0 / math.sqrt(hd)

    # Ragged shapes, checked and not timed: H and W not multiples of the
    # 8x16 tile, both output-channel tiles (64 and 128), and an add of 0.5
    # so that silu(add) != 0 would show in the border if the kernel padded
    # before the activation.
    for Bq, H, W, C, Co in ((2, 20, 36, 128, 64), (1, 12, 20, 64, 128)):
        label = f"[{Bq},{H},{W},{C}]->{Co}"
        x = randn(Bq, H, W, C).bfloat16()
        mul, add = 1.0 + randn(Bq, C, std=0.2), 0.5 + randn(Bq, C, std=0.1)
        w = randn(Co, C, 3, 3, std=1.0 / math.sqrt(9 * C)).to(
            torch.bfloat16, memory_format=torch.channels_last)
        cb = randn(Co, std=0.1)
        got = ops.silu_conv3x3(x, mul, add, w, cb)
        ref = ops.reference_silu_conv3x3(x, mul, add, w, cb)
        err, ref_max = err_of(got, ref)
        check(err <= BF16_TOL * ref_max, f"silu_conv3x3 {label}: err {err} vs max {ref_max}")
        print(f"silu_conv3x3  {label} (ragged): err {err:.3g} (max {ref_max:.3g}, tol "
              f"{BF16_TOL * ref_max:.3g})")
        del x, w, got, ref

    # GroupNorm stats, checked and not timed: ragged shapes (B = 1 and 3;
    # C = 192, 768, 1024 and the widest the kernel takes; row counts that
    # are not multiples of the THREADS / (C/8) rows a CTA reads per step;
    # a single row), each called twice, which must agree bit for bit.
    def stats_err(x, scale, bias, ref):
        got = ops.gn_mul_add(x, scale, bias, G, eps)
        again = ops.gn_mul_add(x, scale, bias, G, eps)
        check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
              f"gn_mul_add {tuple(x.shape)}: two calls differ")
        check(all(bool(torch.isfinite(t).all()) for t in got), f"gn_mul_add {tuple(x.shape)}: not finite")
        (e1, m1), (e2, m2) = err_of(got[0], ref[0]), err_of(got[1], ref[1])
        err, ref_max = max(e1, e2), max(m1, m2)
        check(err <= F32_TOL * max(ref_max, 1.0), f"gn_mul_add {tuple(x.shape)}: err {err} vs max {ref_max}")
        return err, ref_max

    max_c = build.source_int("group_norm", "MAX_C")
    for shp in ((1, 13, 17, 192), (3, 7, 29, 768), (3, 31, 31, 1024), (1, 1, 1, 64),
                (2, 5, 3, max_c)):
        C = shp[-1]
        x = (randn(*shp) + 0.5).bfloat16()
        scale, bias = 1.0 + randn(C, std=0.2), randn(C, std=0.1)
        err, ref_max = stats_err(x, scale, bias, ops.reference_gn_mul_add(x, scale, bias, G, eps))
        print(f"  gn_mul_add  {list(shp)} (ragged): err {err:.3g} (max {ref_max:.3g}); two calls "
              f"bit-identical")
    # |mean| >> std, where the one-pass variance comes out negative: every
    # group of 1712 values (214 rows x 8 channels) holds 12 and one 12.125.
    # The sums are exact in f32 in any order, so kernel and plain version
    # compute the same variance, -1.5e-5 < -eps, and without the clamp
    # rsqrt(var + eps) would be NaN. The plain version runs on the CPU here:
    # on CUDA, torch divides by a scalar through its reciprocal, which
    # rounds the mean otherwise than a division.
    Bq, Nq, Cq = 3, 214, 256
    rng = np.random.default_rng(20260916)
    xn = np.full((Bq, Nq, Cq), 12.0, np.float32)
    for b_ in range(Bq):
        for g_ in range(G):
            xn[b_, rng.integers(Nq), g_ * (Cq // G) + rng.integers(Cq // G)] = 12.125
    xc = torch.from_numpy(xn).bfloat16().reshape(Bq, 2, Nq // 2, Cq)
    sc_c, bi_c = 1.0 + 0.2 * torch.randn(Cq, generator=torch.Generator().manual_seed(1)), torch.zeros(Cq)
    xf = xc.float().reshape(Bq, Nq, G, Cq // G)
    count = Nq * (Cq // G)
    mean_c = xf.sum(dim=(1, 3)) / count
    var_c = (xf * xf).sum(dim=(1, 3)) / count - mean_c * mean_c
    check(bool((var_c < -eps).all()), f"clamp case: one-pass variance {var_c.max().item()} not < -eps")
    ref_c = tuple(t.to(dev) for t in ops.reference_gn_mul_add(xc, sc_c, bi_c, G, eps))
    err, ref_max = stats_err(xc.to(dev), sc_c.to(dev), bi_c.to(dev), ref_c)
    print(f"  gn_mul_add  [{Bq},2,{Nq // 2},{Cq}] (|mean| >> std, one-pass variance "
          f"{var_c.max().item():.3g} in every group, clamped): err {err:.3g} (max {ref_max:.3g})")
    # Two replays of one captured call agree with an eager call (the
    # arrival counters are back at 0 after each launch), and one call is
    # one device kernel: no memset, no second pass.
    Hs, Cs = min(gn_mul_add_shapes(cfg))
    x = randn(B, Hs, Hs, Cs).bfloat16()
    scale, bias = 1.0 + randn(Cs, std=0.2), randn(Cs, std=0.1)
    eager = ops.gn_mul_add(x, scale, bias, G, eps)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = ops.gn_mul_add(x, scale, bias, G, eps)
    replays = []
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        replays.append([t.clone() for t in captured])
    check(all(torch.equal(a_, b_) for r in replays for a_, b_ in zip(r, eager)),
          "gn_mul_add: CUDA-graph replays differ from an eager call")
    del graph, captured
    kernels = [r[:2] for r in device_kernels(lambda: ops.gn_mul_add(x, scale, bias, G, eps))]
    if kernels:
        check(len(kernels) == 1 and kernels[0][1] == 1 and "gn_stats_kernel" in kernels[0][0],
              f"one gn_mul_add call ran {kernels} on the device")
        one = f"one call is one device kernel ({kernels[0][0][:60]})"
    else:
        one = "kernels per call not measured (the profiler recorded no device event)"
    print(f"  gn_mul_add  [{B},{Hs},{Hs},{Cs}]: two CUDA-graph replays equal an eager call; {one}")
    del xc, eager, replays

    # Ragged attention, checked and not timed: S = 256 from a fused qkv
    # projection (strided views), and S = 384 (an odd number of 128-key
    # tiles) sliced from [B, heads, S, 2D] buffers, whose head stride is
    # larger than its token stride.
    qkv = randn(2, 256, 3 * Cm).bfloat16()
    views = [(t.view(2, 256, heads, hd).transpose(1, 2) for t in qkv.split(Cm, dim=-1))]
    wide = [randn(2, heads, 384, 2 * hd).bfloat16() for _ in range(3)]
    views.append(t[..., hd:] for t in wide)
    for q, k, v in views:
        check(not q.is_contiguous(), "ragged attention case should be a strided view")
        got, ref = ops.attention(q, k, v, sc), ops.reference_attention(q, k, v, sc)
        err, ref_max = err_of(got, ref)
        label = f"[{q.shape[0]},{heads},{q.shape[2]},{hd}] strides {tuple(q.stride())}"
        check(err <= BF16_TOL * ref_max, f"attention {label}: err {err} vs max {ref_max}")
        print(f"attention     {label} (ragged): err {err:.3g} (max {ref_max:.3g})")
    del qkv, wide, views, q, k, v, got, ref

    # The head-dim-8 forward at the shape of DriveSceneGen's own model, as
    # the import CLI configures it from a config.json that names no
    # attention_head_dim (diffusers' default 8): 64 heads over 1024 tokens.
    # load_model_config reads config.json only; the empty weights file makes
    # the directory a checkpoint's.
    cfg_dir = tempfile.mkdtemp(prefix="chip_smoke_cfg_")
    atexit.register(shutil.rmtree, cfg_dir, True)
    with open(os.path.join(cfg_dir, "config.json"), "w") as f:
        json.dump(diffusers_config_json(cfg), f)
    open(os.path.join(cfg_dir, "diffusion_pytorch_model.bin"), "wb").close()
    icfg8, _ = import_diffusers.load_model_config(cfg_dir)
    check(mid_attention_shape(icfg8) == (64, 1024, 8) and kernel_limit_errors(icfg8) == [],
          f"the imported reference model: attention {mid_attention_shape(icfg8)}, limits "
          f"{kernel_limit_errors(icfg8)}")
    rows["attention_d8"] = KernelRow("attention_d8", "cuda",
                                     "drivescenegen_torch/csrc/flash_attention_d8.cu",
                       "drivescenegen_tpu/models/unet2d.py:316")
    d8_numbers = attention_d8_checks(icfg8, B, rows["attention_d8"])

    # ---------------------------------------------------------------- 4
    phase("4 full-width UNet2D forward, kernels against plain versions")
    model = UNet2D(cfg, device=dev, generator=gen).eval()
    plain_model = UNet2D(cfg, device=dev, plain=True).eval()
    plain_model.load_state_dict(model.state_dict())
    n_params = sum(p.numel() for p in model.parameters())
    print(f"UNet2D {cfg.block_out_channels} x{cfg.layers_per_block}, {n_params / 1e6:.1f} M params")
    xin = randn(B, S0, S0, cfg.in_channels)
    tin = torch.randint(0, 1000, (B,), generator=gen, device=dev)
    with torch.no_grad():
        eps_k = model(xin, tin)
        eps_p = plain_model(xin, tin)
        torch.cuda.synchronize()
        check(tuple(eps_k.shape) == (B, S0, S0, cfg.out_channels) and eps_k.dtype == torch.float32,
              f"forward output {tuple(eps_k.shape)} {eps_k.dtype}")
        check(bool(torch.isfinite(eps_k).all()), "forward output is not finite")
        err, ref_max = err_of(eps_k, eps_p)
        mean_err = (eps_k - eps_p).abs().mean().item()
        tol = FORWARD_TOL * max(1.0, ref_max)
        print(f"forward eps: max abs err {err:.4g}, mean abs err {mean_err:.3g} (max |eps| "
              f"{ref_max:.3g}, tol {tol:.3g})")
        check(err <= tol, f"forward: kernel and plain eps differ by {err} > {tol}")
        fwd_ms = time_ms(lambda: model(xin, tin), 200.0, graph=False)
        fwd_plain_ms = time_ms(lambda: plain_model(xin, tin), 200.0, graph=False)
        fwd_graph_ms = time_ms(lambda: model(xin, tin), 100.0)
    print(f"forward time (eager, host included): kernels {fwd_ms:.2f} ms, plain "
          f"{fwd_plain_ms:.2f} ms; kernels replayed as a CUDA graph (device only) "
          f"{fwd_graph_ms:.2f} ms (batch {B})")
    del plain_model, eps_p
    with torch.no_grad():
        profile_device(lambda: model(xin, tin))

    # ---------------------------------------------------------------- 5
    phase(f"5 DDIM-{STEPS} sampling, batch {B}, {S0}x{S0}")
    schedule = make_schedule(device=dev)
    shape = (B, S0, S0, cfg.out_channels)

    def run_ddim():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = ddim_sample(model, schedule, shape, torch.Generator(device=dev).manual_seed(7),
                              STEPS, eta=0.0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    ops.reset_launch_counts()
    sample, dt = run_ddim()
    counts = ops.launch_counts()
    ddim_counts = row_launches(counts, ops.attention.launches_by_source)
    print(f"DDIM-{STEPS}: {dt:.3f} s, {B / dt:.4f} scenes/s; launches {counts}")
    want = {"silu_conv3x3": 44 * STEPS, "gn_mul_add": 45 * STEPS, "silu_affine": STEPS,
            "attention": STEPS, "attention_bwd_prep": 0, "attention_bwd_main": 0,
            "attention_bwd_dq": 0, "attention_bwd_d8": 0, "group_norm_silu_bwd": 0}
    check(counts == want, f"launch counts {counts} != {want}")
    # The eager loop launches every kernel from the host, whose cores the
    # machine shares: two more runs show the spread, and the CUDA-graph
    # forward time of phase 4 gives the device's idle share.
    times = [dt] + [run_ddim()[1] for _ in range(2)]
    dt = sorted(times)[1]
    device_s = STEPS * fwd_graph_ms / 1e3
    print(f"DDIM-{STEPS} runs: {', '.join(f'{s:.3f}' for s in times)} s; median {dt:.3f} s, "
          f"{B / dt:.4f} scenes/s; device-only forwards {device_s:.3f} s, so the device idles "
          f"{100 * (1 - device_s / dt):.1f}% of the median run")
    check(bool(torch.isfinite(sample).all()), "DDIM output is not finite")
    lo, hi = sample.min().item(), sample.max().item()
    check(-1.0 <= lo and hi <= 1.0, f"DDIM output outside [-1, 1]: [{lo}, {hi}]")
    print(f"DDIM output: finite, in [{lo:.3f}, {hi:.3f}]")
    for name, row in rows.items():
        row.d["launches"] = ddim_counts[name]
    ddim_rate = B / dt
    q_ddim = stage2.quantize(sample)  # phase 12's device pass reads it
    del sample

    # Host cost per wrapper call at a tiny shape (the device work is
    # negligible), beside one PyTorch op of each kind for scale.
    xs = randn(1, 8, 16, 64).bfloat16()
    ones, zeros = torch.ones(1, 64, device=dev), torch.zeros(1, 64, device=dev)
    ws = randn(64, 64, 3, 3).to(torch.bfloat16, memory_format=torch.channels_last)
    qs = randn(1, 1, 128, 64).bfloat16()
    c64 = torch.ones(64, device=dev)
    host = {
        "silu_conv3x3": host_us(lambda: ops.silu_conv3x3(xs, ones, zeros, ws, c64)),
        "gn_mul_add": host_us(lambda: ops.gn_mul_add(xs, c64, c64, G, eps)),
        "attention": host_us(lambda: ops.attention(qs, qs, qs, 0.125)),
        "F.conv2d": host_us(lambda: F.conv2d(xs.permute(0, 3, 1, 2), ws, None, padding=1)),
        "bf16 add": host_us(lambda: xs + xs),
        # What a wrapper pays to name the stream with the public call (the
        # stats wrapper reads the raw handle instead).
        "torch.cuda.current_stream": host_us(lambda: torch.cuda.current_stream(dev).cuda_stream),
    }
    print("host us per call: " + ", ".join(f"{k} {v:.1f}" for k, v in host.items())
          + f"; gn_mul_add at most silu_conv3x3: {host['gn_mul_add'] <= host['silu_conv3x3']}")

    # ---------------------------------------------------------------- 6
    phase("6 generation CLI")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    atexit.register(shutil.rmtree, work, True)
    model_dir = os.path.join(work, "model")  # phase 12 samples from it again
    os.makedirs(model_dir)
    save_config(Config(model=cfg), os.path.join(model_dir, "config.yaml"))
    save_npz(os.path.join(model_dir, "params.npz"), torch_to_flax(model.state_dict()))
    out_dir = os.path.join(work, "gen6")  # phase 14 samples the same PNGs under torchrun
    rate = generation.main(["--model_dir", model_dir, "--output_dir", out_dir, "--sampler",
                            "ddim", "--steps", str(STEPS), "--batch_size", "2",
                            "--num_batches", "2", "--device", "cuda"])
    pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
    print(f"cli: {pngs} at {rate:.4f} scenes/s")
    check(pngs == [f"loop_{n:03d}_batch_{i:03d}.png" for n in range(2) for i in range(2)],
          f"cli wrote {pngs}")

    del model, schedule
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 7
    tcfg = TrainConfig(ema_decay=0.9999)
    TB = tcfg.batch_size
    phase(f"7 training at full width, batch {TB}")
    def attention_bwd_checks(TB, heads, S, hd):
        """The attention's train-step launches at [TB, heads, S, hd], each
        against its plain version: q, k, v as views of the fused qkv
        projection and dO as the graph hands it over (a [B, heads, S, D]
        view of [B, S, heads, D]); the forward's o and lse
        (attention_with_lse); the whole attention_bwd call, two runs
        bit-identical; then each backward launch on the same inputs: the
        pre-pass's di (f32 sums), the main pass's dk, dv and f32 dQ
        accumulator (dq before its scale, in the kernel's fragment order)
        given that di, the dQ pass on that accumulator. Returns the inputs
        and intermediates, and the largest error and reference of each
        launch."""
        Cm, sc = heads * hd, 1.0 / math.sqrt(hd)
        label = f"[{TB},{heads},{S},{hd}]"
        qkv = randn(TB, S, 3 * Cm).bfloat16()
        q, k, v = (tt.view(TB, S, heads, hd).transpose(1, 2) for tt in qkv.split(Cm, dim=-1))
        do = randn(TB, S, heads, hd).bfloat16().transpose(1, 2)
        o, lse = ops.attention_with_lse(q, k, v, sc)
        e_o, m_o = err_of(o, ops.reference_attention(q, k, v, sc))
        check(e_o <= BF16_TOL * m_o, f"attention_with_lse {label} o: err {e_o} vs max {m_o}")
        lse_err = (lse - ops.reference_attention_lse(q, k, sc)).abs().max().item()
        print(f"attention_with_lse {label}: o err {e_o:.3g} (max {m_o:.3g}, tol "
              f"{BF16_TOL * m_o:.3g}), lse max abs err {lse_err:.3g} against torch.logsumexp "
              f"(tol {LSE_TOL})")
        check(lse_err <= LSE_TOL, f"attention lse {label} err {lse_err}")
        got = ops.attention_bwd(q, k, v, o, lse, do, sc)
        ref = ops.reference_attention_bwd(q, k, v, o, lse, do, sc)
        for name, a_, b_ in zip(("dq", "dk", "dv"), got, ref):
            e, m = err_of(a_, b_)
            print(f"attention_bwd {label} {name}: err {e:.3g} (max {m:.3g}, tol {BF16_TOL * m:.3g})")
            check(e <= BF16_TOL * m, f"attention_bwd {label} {name}: err {e} vs max {m}")
        again = ops.attention_bwd(q, k, v, o, lse, do, sc)
        same = all(torch.equal(a_, b_) for a_, b_ in zip(got, again))
        print(f"attention_bwd {label}: two runs bit-identical: {same}")
        check(same, f"attention_bwd {label} is not deterministic")
        del got, ref, again
        di, sems = ops.attention_bwd_prep(o, do)
        di_ref = ops.reference_attention_di(o, do)
        e_di, m_di = err_of(di, di_ref)
        check(e_di <= F32_TOL * max(m_di, 1.0),
              f"attention_bwd_prep {label} di: err {e_di} vs max {m_di}")
        e_main, m_main = 0.0, 0.0
        main_out = ops.attention_bwd_main(q, k, v, do, lse, di, sems, sc)
        main_ref = ops.reference_attention_bwd_main(q, k, v, do, lse, di_ref, sc)
        for name, a_, b_ in zip(("dk", "dv", "acc"), main_out, main_ref):
            e, m = err_of(a_, b_)
            check(e <= BF16_TOL * m, f"attention_bwd_main {label} {name}: err {e} vs max {m}")
            e_main, m_main = max(e_main, e), max(m_main, m)
        acc = main_out[2]
        e_dq, m_dq = err_of(ops.attention_bwd_dq(acc, sc), ops.reference_attention_bwd_dq(acc, sc))
        check(e_dq <= BF16_TOL * m_dq, f"attention_bwd_dq {label}: err {e_dq} vs max {m_dq}")
        print(f"attention_bwd {label} per launch: pre-pass di err {e_di:.3g} (max {m_di:.3g}), "
              f"main pass dk/dv/acc err {e_main:.3g} (max {m_main:.3g}), dQ pass err {e_dq:.3g} "
              f"(max {m_dq:.3g})")
        del main_ref, di_ref
        return dict(q=q, k=k, v=v, o=o, lse=lse, do=do, di=di, sems=sems, acc=acc,
                    errs={"attention_with_lse": (e_o, m_o), "attention_bwd_prep": (e_di, m_di),
                          "attention_bwd_main": (e_main, m_main), "attention_bwd_dq": (e_dq, m_dq)})

    def attention_bwd_times(a, TB, heads, S, hd):
        """Times of the attention's train-step launches on the inputs and
        intermediates attention_bwd_checks returned (a): the forward with
        lse, the pre-pass, the main pass and the dQ pass, each beside its
        bound and its plain version, the whole attention_bwd call, and
        SDPA's forward and backward. Calls bound by bytes whose working set
        fits in twice the L2 are timed over rotated input copies
        (time_cold_ms), the warm time beside it."""
        q, k, v, o, lse, do, di, sems, acc = (a[n] for n in ("q", "k", "v", "o", "lse", "do",
                                                              "di", "sems", "acc"))
        sc = 1.0 / math.sqrt(hd)
        prod = 2 * TB * heads * S * S * hd
        elems, rows_ = TB * heads * S * hd, TB * heads * S
        # Bounds: per (batch, head) a product is 2 S^2 D FLOP. The forward
        # needs two and reads q, k, v and writes o and lse; the backward
        # needs five (S, dP, dV, dK, dQ), all in the main pass, which reads
        # q, k, v, dO, lse and di and writes dk, dv and the f32
        # accumulator. The pre- and dQ passes move bytes: o and dO in, di
        # (and the semaphores) out; the accumulator in, dq out.
        fwd_bytes = 4 * elems * 2 + rows_ * 4
        prep_bytes = 2 * elems * 2 + rows_ * 4 + rows_ // 64 * 4
        dq_bytes = elems * 4 + elems * 2
        t = dict(prod=prod, bnd_fwd=bound_ms(fwd_bytes, 2 * prod),
                 bnd_prep=bound_ms(prep_bytes, 2 * elems),
                 bnd_main=bound_ms(4 * elems * 2 + 2 * rows_ * 4 + 2 * elems * 2 + elems * 4,
                                   5 * prod),
                 bnd_dq=bound_ms(dq_bytes, elems),
                 bnd_all=bound_ms(5 * elems * 2 + rows_ * 4 + 3 * elems * 2, 5 * prod))
        t["fwd_ms"], _ = time_cold_ms(lambda *x: ops.attention_with_lse(*x, sc), (q, k, v),
                                      t["bnd_fwd"], fwd_bytes)
        t["fwd_plain_ms"] = time_ms(lambda: (ops.reference_attention(q, k, v, sc),
                                             ops.reference_attention_lse(q, k, sc)), graph=False)
        t["fwd_lib_ms"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=sc))
        t["prep_ms"], t["prep_copies"] = time_cold_ms(ops.attention_bwd_prep, (o, do),
                                                      t["bnd_prep"], prep_bytes)
        t["prep_warm"] = time_ms(lambda: ops.attention_bwd_prep(o, do))
        t["main_ms"] = time_ms(lambda: ops.attention_bwd_main(q, k, v, do, lse, di, sems, sc))
        t["dq_ms"], t["dq_copies"] = time_cold_ms(lambda x: ops.attention_bwd_dq(x, sc), (acc,),
                                                  t["bnd_dq"], dq_bytes)
        t["dq_warm"] = time_ms(lambda: ops.attention_bwd_dq(acc, sc))
        t["bwd_ms"] = time_ms(lambda: ops.attention_bwd(q, k, v, o, lse, do, sc))
        t["plain_ms"] = time_ms(lambda: ops.reference_attention_bwd(q, k, v, o, lse, do, sc),
                                graph=False)
        t["di_plain_ms"], _ = time_cold_ms(ops.reference_attention_di, (o, do), t["bnd_prep"],
                                           prep_bytes)
        t["dq_plain_ms"], _ = time_cold_ms(lambda x: ops.reference_attention_bwd_dq(x, sc),
                                           (acc,), t["bnd_dq"], dq_bytes)
        # Library yardstick of the pre-pass: rowsum(O·dO) in one call.
        t["di_lib_ms"], _ = time_cold_ms(lambda o_, do_: torch.linalg.vecdot(o_, do_, dim=-1),
                                         (o, do), t["bnd_prep"], prep_bytes)
        # Library yardstick: SDPA's backward alone (PyTorch picks its
        # backend; the forward is excluded), by device time: its host
        # enqueue is about as long as its device time, so an eager loop
        # would time the host.
        ql, kl, vl = (tt.detach().requires_grad_() for tt in (q, k, v))
        sdpa_out = F.scaled_dot_product_attention(ql, kl, vl, scale=sc)
        t["lib_ms"] = device_ms(lambda: torch.autograd.grad(sdpa_out, (ql, kl, vl), do,
                                                            retain_graph=True))
        t["lib_name"] = sdpa_out.grad_fn.name()
        return t

    def print_bwd_times(t, label):
        print(f"attention_bwd {label}: pre-pass {t['prep_ms']:.4f} ms over {t['prep_copies']} "
              f"input copies (warm in L2 {t['prep_warm']:.4f}; bound {t['bnd_prep'][0]:.4f}, "
              f"{t['bnd_prep'][1]}; torch.linalg.vecdot {t['di_lib_ms']:.4f}), main pass "
              f"{t['main_ms']:.4f} ms ({5 * t['prod'] / t['main_ms'] / 1e9:.1f} TFLOP/s, bound "
              f"{t['bnd_main'][0]:.4f}, {t['bnd_main'][1]}), dQ pass {t['dq_ms']:.4f} ms over "
              f"{t['dq_copies']} input copies (warm in L2 {t['dq_warm']:.4f}; bound "
              f"{t['bnd_dq'][0]:.4f}, {t['bnd_dq'][1]}); the three "
              f"{t['prep_ms'] + t['main_ms'] + t['dq_ms']:.4f} ms, one attention_bwd call "
              f"{t['bwd_ms']:.4f} ms ({5 * t['prod'] / t['bwd_ms'] / 1e9:.1f} TFLOP/s on the five "
              f"products) against the backward's bound {t['bnd_all'][0]:.4f} ms "
              f"({t['bnd_all'][1]}), SDPA backward ({t['lib_name']}, device time) "
              f"{t['lib_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms")

    # 7a: the attention backward kernels at the train step's shape.
    sc = 1.0 / math.sqrt(hd)
    a7 = attention_bwd_checks(TB, heads, S, hd)
    (e_di, m_di), (e_main, m_main), (e_dq, m_dq) = (
        a7["errs"][n] for n in ("attention_bwd_prep", "attention_bwd_main", "attention_bwd_dq"))
    label = f"[{TB},{heads},{S},{hd}]"
    t7 = attention_bwd_times(a7, TB, heads, S, hd)
    prod, bnd_prep, bnd_main, bnd_dq, bnd_all = (t7[n] for n in (
        "prod", "bnd_prep", "bnd_main", "bnd_dq", "bnd_all"))
    prep_ms, main_ms, dq_ms, bwd_ms, plain_ms, lib_ms = (t7[n] for n in (
        "prep_ms", "main_ms", "dq_ms", "bwd_ms", "plain_ms", "lib_ms"))
    lib_file = "jax/experimental/pallas/ops/tpu/flash_attention.py"
    src = "drivescenegen_torch/csrc/flash_attention_bwd.cu"
    rows["attention_bwd_prep"] = KernelRow("attention_bwd_prep", "cuda", src, f"{lib_file}:273")
    rows["attention_bwd_main"] = KernelRow("attention_bwd_main", "cuda", src, f"{lib_file}:941")
    rows["attention_bwd_dq"] = KernelRow("attention_bwd_dq", "cuda", src, f"{lib_file}:1287")
    # The head-dim-8 backward's row is measured in phase 17; it exists from
    # here so that every path records its launches (0 but on phase 17's).
    rows["attention_bwd_d8"] = KernelRow(
        "attention_bwd_d8", "cuda", "drivescenegen_torch/csrc/flash_attention_bwd_d8.cu",
        f"{lib_file}:941")
    rows["attention_bwd_d8"].d["also_replaces"] = f"{lib_file}:1287 and :273 (dQ, di)"
    # The training arm's GroupNorm+SiLU backward: measured in phase 18, its
    # launches recorded by every path from here.
    rows["group_norm_silu_bwd"] = KernelRow(
        "group_norm_silu_bwd", "cuda", "drivescenegen_torch/csrc/group_norm.cu",
        "none: the JAX training path differentiates jnp (reference_group_norm_silu, "
        "drivescenegen_tpu/ops/pallas/group_norm.py:195, from drivescenegen_tpu/models/"
        "unet2d.py:97)")
    rows["attention_bwd_prep"].add(1, e_di, m_di, prep_ms, t7["di_plain_ms"], bnd_prep,
                                   t7["di_lib_ms"])
    # plain_ms and library_ms of the main row are the whole backward's: no
    # plain or library call computes its outputs alone.
    rows["attention_bwd_main"].add(1, e_main, m_main, main_ms, plain_ms, bnd_main, lib_ms)
    rows["attention_bwd_main"].d["also_replaces"] = f"{lib_file}:1287 (dQ's products)"
    rows["attention_bwd_main"].d["yardsticks_cover"] = (
        "the whole backward, all three launches (plain_ms, library_ms)")
    rows["attention_bwd_dq"].add(1, e_dq, m_dq, dq_ms, t7["dq_plain_ms"], bnd_dq)
    print_bwd_times(t7, label)
    del a7

    # Ragged, checked and not timed: other batch and heads, the smallest S
    # the backward takes (o and lse from the plain forward: the forward
    # kernel needs S % 128), and a dO whose last dim is not contiguous.
    s_min = build.source_int("flash_attention_bwd", "S_MULTIPLE")
    q, k, v = (randn(3, 5, s_min, hd).bfloat16() for _ in range(3))
    do = randn(3, 5, hd, s_min).bfloat16().transpose(2, 3)
    o = ops.reference_attention(q, k, v, sc)
    lse = ops.reference_attention_lse(q, k, sc).float().contiguous()
    got = ops.attention_bwd(q, k, v, o, lse, do, sc)
    ref = ops.reference_attention_bwd(q, k, v, o, lse, do, sc)
    for name, a_, b_ in zip(("dq", "dk", "dv"), got, ref):
        e, m = err_of(a_, b_)
        print(f"attention_bwd [3,5,{s_min},{hd}] {name} (ragged, dO strides "
              f"{tuple(do.stride())}): err {e:.3g} (max {m:.3g})")
        check(e <= BF16_TOL * m, f"attention_bwd ragged {name}: err {e} vs max {m}")
    del q, k, v, do, o, lse, got, ref
    # More 128-key tiles than the main pass has CTAs (one per SM): it then
    # sums dQ in key-tile order instead of the rotated walk. Two runs must
    # still agree bit for bit.
    s_long = 128 * (torch.cuda.get_device_properties(0).multi_processor_count + 2)
    q, k, v, do = (randn(1, 1, s_long, hd).bfloat16() for _ in range(4))
    o, lse = ops.attention_with_lse(q, k, v, sc)
    got = ops.attention_bwd(q, k, v, o, lse, do, sc)
    ref = ops.reference_attention_bwd(q, k, v, o, lse, do, sc)
    for name, a_, b_ in zip(("dq", "dk", "dv"), got, ref):
        e, m = err_of(a_, b_)
        print(f"attention_bwd [1,1,{s_long},{hd}] {name} (key tiles > CTAs): err {e:.3g} "
              f"(max {m:.3g})")
        check(e <= BF16_TOL * m, f"attention_bwd S={s_long} {name}: err {e} vs max {m}")
    again = ops.attention_bwd(q, k, v, o, lse, do, sc)
    check(all(torch.equal(a_, b_) for a_, b_ in zip(got, again)),
          f"attention_bwd S={s_long} is not deterministic")
    del q, k, v, do, o, lse, got, ref, again
    torch.cuda.empty_cache()

    def train_path(mcfg, tcfg, batch, noise, t_, keep, label, keep_inputs=None, weights=None):
        """One train step with kernels against one with plain versions on the
        same weights, batch, noise, t (and keep mask): loss, grad_norm,
        gradient cosine, every parameter's gradient, the launches (the
        attention's kernels of mcfg's head dim); then a run of steps:
        launches, ms per step, samples/s, the device's idle share and peak
        memory. Returns those numbers. keep_inputs: a path the weights,
        batch, noise and t are saved to (phase 15 reads them); weights: a
        state dict to start from instead of seeded random ones."""
        TB = batch.shape[0]
        schedule = make_schedule(device=dev)
        if weights is None:
            weights = UNet2D(mcfg, device=dev, generator=gen).state_dict()
        if keep_inputs:
            torch.save(dict(weights=weights, batch=batch, noise=noise, t=t_), keep_inputs)

        def train_setup(plain):
            m = UNet2D(mcfg, device=dev, for_training=True, plain=plain)
            m.load_state_dict(weights)
            opt, lr_fn = create_optimizer(tcfg, 1000, m.parameters())
            return init_train_state(m, opt, ema=True), make_train_step(schedule, lr_fn, tcfg)

        # Calls of the f32 composition at the training arm's GN sites:
        # F.group_norm (the attention block's own GN calls it in both arms)
        # and the Function's CPU forward, which CUDA must never reach.
        import torch.nn.functional as F_
        from drivescenegen_torch.ops import group_norm as gn_module
        calls = Counter()

        def counted(mod, attr):
            inner = getattr(mod, attr)

            def wrapper(*a, **k):
                calls[attr] += 1
                return inner(*a, **k)
            return inner, wrapper

        results = {}
        for plain in (False, True):
            st, step = train_setup(plain)
            ops.reset_launch_counts()
            calls.clear()
            patched = [(mod, attr, *counted(mod, attr)) for mod, attr in
                       ((F_, "group_norm"), (gn_module, "composition_group_norm_silu"))]
            for mod, attr, _, wrapper in patched:
                setattr(mod, attr, wrapper)
            try:
                st, m = step(st, batch, noise, t_, keep)
                torch.cuda.synchronize()
            finally:
                for mod, attr, inner, _ in patched:
                    setattr(mod, attr, inner)
            counts1 = ops.launch_counts()
            calls1 = dict(calls)
            named = list(st.model.named_parameters())
            missing = [n for n, p in named if p.grad is None or not bool(p.grad.any())]
            check(not missing, f"{label} train step (plain={plain}): no gradient for {missing[:5]}")
            flat = torch.cat([p.grad.float().reshape(-1) for _, p in named])
            results[plain] = (m["loss"].item(), m["grad_norm"].item(), flat, counts1, calls1)
            if not plain:
                kstate, kstep = st, step
            else:
                del st, step, named, flat
        del weights
        (lk, gk, fk, ck, callk), (lp, gp, fp, cp, callp) = results[False], results[True]
        cos = torch.nn.functional.cosine_similarity(fk, fp, dim=0).item()
        print(f"{label} train step kernels vs plain: loss {lk:.6f} vs {lp:.6f} (rel "
              f"{abs(lk - lp) / lp:.2e}, tol {TRAIN_LOSS_TOL}), grad_norm {gk:.6f} vs {gp:.6f} "
              f"(rel {abs(gk - gp) / gp:.2e}, tol {TRAIN_GNORM_TOL}), gradient cosine {cos:.6f} "
              f"(min {TRAIN_COS_MIN}); every parameter has a gradient")
        check(abs(lk - lp) <= TRAIN_LOSS_TOL * abs(lp), f"{label} train step loss differs")
        check(abs(gk - gp) <= TRAIN_GNORM_TOL * abs(gp), f"{label} train step grad_norm differs")
        check(cos >= TRAIN_COS_MIN, f"{label} train step gradient cosine {cos}")
        head_dim = mid_attention_shape(mcfg)[2]
        d8 = int(head_dim == 8)
        # The GN+SiLU of every ResnetBlock's norm1 and norm2 and of norm_out:
        # the stats kernel (with mean and rstd), the apply kernel and the
        # backward once each a site, 45 at the default widths.
        n_gn = sum(gn_mul_add_shapes(mcfg).values())
        want1 = {"silu_conv3x3": 0, "gn_mul_add": n_gn, "silu_affine": n_gn, "attention": 1,
                 "attention_bwd_prep": 1 - d8, "attention_bwd_main": 1 - d8,
                 "attention_bwd_dq": 1 - d8, "attention_bwd_d8": d8,
                 "group_norm_silu_bwd": n_gn}
        check(ck == want1, f"launches in one kernel train step {ck} != {want1}")
        check(set(cp.values()) == {0}, f"the plain step launched kernels: {cp}")
        want_k = {"group_norm": 1}  # the attention block's GN alone
        want_p = {"group_norm": n_gn + 1}
        print(f"{label}: composition calls in one step, kernels {callk}, plain {callp}; "
              f"launches {ck}")
        check(callk == want_k, f"{label}: the kernel step called the composition {callk}")
        check(callp == want_p, f"{label}: the plain step's composition calls {callp} != {want_p}")
        del results, fk, fp
        torch.cuda.empty_cache()

        # A run of steps: launch counts, ms per step, samples/s, idle share,
        # peak memory.
        torch.cuda.reset_peak_memory_stats()
        for _ in range(3):
            kstate, m = kstep(kstate, batch)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        step_ms = []
        for _ in range(TRAIN_STEPS):
            t0 = time.perf_counter()
            kstate, m = kstep(kstate, batch)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        train_counts = ops.launch_counts()
        per_row = row_launches(train_counts, ops.attention.launches_by_source, head_dim)
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        want = {name: n * TRAIN_STEPS for name, n in want1.items()}
        print(f"{label}: {TRAIN_STEPS} train steps: launches {train_counts}")
        check(train_counts == want, f"launches over {TRAIN_STEPS} train steps {train_counts} != {want}")
        check(math.isfinite(m["loss"].item()), f"{label} train loss is not finite")
        med_ms = sorted(step_ms)[len(step_ms) // 2]
        busy = profile_device(lambda: kstep(kstate, batch), n=3, label="train step")
        idle = None if busy is None else 1.0 - busy
        print(f"{label} train step: median {med_ms:.2f} ms of {', '.join(f'{x:.1f}' for x in step_ms)}"
              f" ms; {TB / med_ms * 1e3:.2f} samples/s; device idle "
              f"{'not measured' if idle is None else f'{100 * idle:.1f}%'} of the profiled steps; "
              f"peak memory {peak_gb:.2f} GB (torch.cuda.max_memory_allocated)")
        del kstate, kstep
        torch.cuda.empty_cache()
        return dict(med_ms=med_ms, step_ms=step_ms, counts=per_row, idle=idle, peak_gb=peak_gb,
                    samples_per_s=TB / med_ms * 1e3)

    # 7b: one full-width train step with kernels against one with plain
    # versions, same weights, batch, noise and t; 7c: a run of steps.
    tcfg_model = ModelConfig(attention_impl="flash")
    batch = torch.randint(0, 256, (TB, S0, S0, tcfg_model.in_channels), generator=gen,
                          device=dev).to(torch.uint8)
    noise = randn(TB, S0, S0, tcfg_model.in_channels)
    tt_ = torch.randint(0, 1000, (TB,), generator=gen, device=dev)
    inputs7 = os.path.join(work, "train7_inputs.pt")  # phase 15 steps on them again
    tr = train_path(tcfg_model, tcfg, batch, noise, tt_, None, f"batch {TB}", keep_inputs=inputs7)
    med_ms, step_ms, idle, peak_gb, train_counts = (tr[k] for k in ("med_ms", "step_ms", "idle",
                                                                    "peak_gb", "counts"))
    for name, row in rows.items():
        row.d["launches_by_path"][f"DDIM-{STEPS}"] = ddim_counts[name]
        row.d["launches_per_train_step"] = train_counts[name] // TRAIN_STEPS
        row.d["launches_by_path"][f"train step, batch {TB} (x{TRAIN_STEPS})"] = train_counts[name]
        if name.startswith("attention_bwd"):
            row.d["launches"] = train_counts[name]
    del batch, noise
    torch.cuda.empty_cache()

    # 7d: the train CLI as a user runs it: a seeded synthetic corpus, the
    # whole corpus on the device, ~30 steps, a resume, and the export
    # sampled by the generation CLI.
    tmp = os.path.join(work, "train7")  # phase 14 warm-starts from its run
    data_dir, out_dir = os.path.join(tmp, "data"), os.path.join(tmp, "run")
    os.makedirs(data_dir)
    t0 = time.perf_counter()
    pattern = synthetic_corpus(data_dir, CLI_IMAGES, S0, seed=20260916)
    print(f"cli corpus: {CLI_IMAGES} PNGs of {S0}x{S0} in {time.perf_counter() - t0:.1f} s")
    cfg_path = os.path.join(tmp, "cfg.yaml")
    run_cfg = Config(model=tcfg_model)
    run_cfg.train = dataclasses.replace(tcfg, device_data="on", eval_inference_steps=10,
                                        log_every=5, output_dir=out_dir,
                                        dataset_glob=pattern)
    save_config(run_cfg, cfg_path)
    t0 = time.perf_counter()
    log = run_cli(here, ["--cfg_file", cfg_path, "--max_steps", str(CLI_STEPS)])
    cli_s = time.perf_counter() - t0
    records = [json.loads(ln) for ln in open(os.path.join(out_dir, "logs", "metrics.jsonl"))]
    last = records[-1]
    print(f"cli: {CLI_STEPS} steps in {cli_s:.1f} s wall (process start, upload, two "
          f"checkpoints and eval samples included); last log step {last['step']} loss "
          f"{last['loss']:.4f} at {last['samples_per_sec']:.1f} samples/s")
    check(last["step"] == CLI_STEPS and math.isfinite(last["loss"]),
          f"train CLI ended at {last}")
    check(latest_step(os.path.join(out_dir, "checkpoints")) == CLI_STEPS,
          "train CLI: no checkpoint at its last step")
    launched = logged_launches(log)
    check(all(launched[name] == CLI_STEPS for name in
              ("attention_bwd_prep", "attention_bwd_main", "attention_bwd_dq")),
          f"train CLI launches {launched}")
    log = run_cli(here, ["--cfg_file", cfg_path, "--max_steps", str(CLI_RESUME_STEPS),
                         "--resume"])
    check(f"resumed from step {CLI_STEPS}" in log, "train CLI --resume did not resume")
    check(latest_step(os.path.join(out_dir, "checkpoints")) == CLI_RESUME_STEPS,
          "train CLI --resume did not reach its max_steps")
    print(f"cli resume: {CLI_STEPS} -> {CLI_RESUME_STEPS} steps; launches "
          f"{logged_launches(log)}")
    gen_dir = os.path.join(tmp, "gen")
    generation.main(["--model_dir", out_dir, "--output_dir", gen_dir, "--sampler", "ddim",
                     "--steps", "10", "--batch_size", "1", "--num_batches", "1",
                     "--device", "cuda"])
    check(os.listdir(gen_dir) == ["loop_000_batch_000.png"], "generation from the export")
    print("cli export: the generation CLI sampled loop_000_batch_000.png (DDIM-10) from the "
          "trained params.npz")

    # ---------------------------------------------------------------- 8
    phase(f"8 DPM-Solver++ samplers: DPM-{DPM_STEPS} and SDE-{SDE_STEPS}, batch {B}, {S0}x{S0}")
    model = UNet2D(cfg, device=dev, generator=gen).eval()
    plain_model = UNet2D(cfg, device=dev, plain=True).eval()
    plain_model.load_state_dict(model.state_dict())
    schedule = make_schedule(device=dev)
    shape = (B, S0, S0, cfg.out_channels)
    per_forward = {"silu_conv3x3": 44, "gn_mul_add": 45, "silu_affine": 1, "attention": 1}

    def timed_sample(fn, denoise, shape, n, seed=9):
        """One sampling run from a seeded generator (the same x_T and noise
        for every denoiser), synchronized; returns (x, seconds)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            out = fn(denoise, schedule, shape, torch.Generator(device=dev).manual_seed(seed), n)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    # The same weights with f32 activations (plain versions, TF32 off): how
    # far bf16 rounding alone moves each sampler's output from its f32
    # path, beside how far the kernels move it from the bf16 plain path.
    plain32 = UNet2D(dataclasses.replace(cfg, dtype="float32"), device=dev, plain=True).eval()
    plain32.load_state_dict(model.state_dict())

    def deltas(a, b):
        d = (a - b).abs()
        return d.max().item(), d.mean().item()

    dpm_summary, outs = {}, {}
    for name, fn, n in ((f"DPM-{DPM_STEPS}", dpmpp_2m_sample, DPM_STEPS),
                        (f"SDE-{SDE_STEPS}", dpmpp_2m_sde_sample, SDE_STEPS),
                        (f"DDIM-{STEPS}", ddim_sample, STEPS)):
        ops.reset_launch_counts()
        out, dt0 = timed_sample(fn, model, shape, n)
        counts = ops.launch_counts()
        per_row = row_launches(counts, ops.attention.launches_by_source)
        want = {k: per_forward.get(k, 0) * n for k in counts}
        print(f"{name}: {dt0:.3f} s; launches {counts}")
        check(counts == want, f"{name} launch counts {counts} != {want}")
        check(bool(torch.isfinite(out).all()), f"{name} output is not finite")
        lo, hi = out.min().item(), out.max().item()
        check(-1.0 <= lo and hi <= 1.0, f"{name} output outside [-1, 1]: [{lo}, {hi}]")
        ref = timed_sample(fn, plain_model, shape, n)[0]
        ref32 = timed_sample(fn, plain32, shape, n)[0]
        d_kp, d_pf, d_kf = deltas(out, ref), deltas(ref, ref32), deltas(out, ref32)
        print(f"{name} on the same x_T and noise, max / mean |delta|: kernels vs plain bf16 "
              f"{d_kp[0]:.4g} / {d_kp[1]:.4g} (mean tol {MEAN_DELTA_TOL}); plain bf16 vs plain "
              f"f32 {d_pf[0]:.4g} / {d_pf[1]:.4g}; kernels vs plain f32 {d_kf[0]:.4g} / "
              f"{d_kf[1]:.4g}")
        check(d_kp[1] <= MEAN_DELTA_TOL, f"{name}: mean |delta| kernels vs plain {d_kp[1]} > "
                                         f"{MEAN_DELTA_TOL}")
        summary = dict(max_abs_delta_vs_plain=d_kp[0], mean_abs_delta_vs_plain=d_kp[1],
                       plain_bf16_vs_f32=d_pf, kernels_vs_plain_f32=d_kf)
        if fn is not ddim_sample:  # DDIM-50's launches and scenes/s are phase 5's
            for k, row in rows.items():
                row.d["launches_by_path"][name] = per_row[k]
            runs = [dt0] + [timed_sample(fn, model, shape, n)[1] for _ in range(2)]
            med = sorted(runs)[1]
            run_idle = 1 - n * fwd_graph_ms / 1e3 / med
            print(f"{name} runs: {', '.join(f'{x:.3f}' for x in runs)} s; median {med:.3f} s, "
                  f"{B / med:.4f} scenes/s, the device idle {100 * run_idle:.1f}% (phase 4's graph "
                  f"forward x {n}); output finite, in [{lo:.3f}, {hi:.3f}]")
            summary.update(seconds_runs=runs, scenes_per_s=B / med, device_idle=run_idle)
        dpm_summary[name] = summary
        outs[name] = out
        del ref, ref32
    # Two correct solvers of one ODE from the same x_T, for scale.
    d_sol = deltas(outs[f"DPM-{DPM_STEPS}"], outs[f"DDIM-{STEPS}"])
    print(f"DPM-{DPM_STEPS} vs DDIM-{STEPS}, both with kernels, on the same x_T: max / mean "
          f"|delta| {d_sol[0]:.4g} / {d_sol[1]:.4g}")
    dpm_summary["dpm_vs_ddim_same_x_T"] = d_sol
    del model, plain_model, plain32, outs
    torch.cuda.empty_cache()

    # ---------------------------------------------------------------- 9
    cfg5 = ModelConfig(sample_size=128, in_channels=1, out_channels=1, cond_channels=2)
    S5, GB5 = cfg5.sample_size, BATCH
    phase(f"9 config-5 ({S5}x{S5}, cond_channels {cfg5.cond_channels}): kernels at forward batch "
          f"{2 * GB5}, the guided forward, guided DDIM-{STEPS} at batch {GB5}")
    check(kernel_limit_errors(cfg5) == [] and kernel_limit_errors(cfg5, for_training=True) == [],
          f"config-5 outside the kernels' limits: {kernel_limit_errors(cfg5)}")
    rows5 = forward_rows()
    forward_kernels(cfg5, 2 * GB5, rows5)
    for name, row in rows5.items():
        rows[name].d[f"config5_forward_batch{2 * GB5}"] = {
            k: row.d[k] for k in ("launches_per_forward", "max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}
    model5 = UNet2D(cfg5, device=dev, generator=gen).eval()
    plain5 = UNet2D(cfg5, device=dev, plain=True).eval()
    plain5.load_state_dict(model5.state_dict())
    cond5 = randn(GB5, S5, S5, cfg5.cond_channels).clamp(-1.0, 1.0)
    x5 = randn(GB5, S5, S5, cfg5.in_channels)
    with torch.no_grad():
        t5 = torch.tensor(417, device=dev)
        eps_k = make_guided_denoise(model5, cond5, GUIDANCE)(x5, t5)
        eps_p = make_guided_denoise(plain5, cond5, GUIDANCE)(x5, t5)
    check(tuple(eps_k.shape) == (GB5, S5, S5, 1) and bool(torch.isfinite(eps_k).all()),
          f"guided eps {tuple(eps_k.shape)}, finite {bool(torch.isfinite(eps_k).all())}")
    err, ref_max = err_of(eps_k, eps_p)
    tol = FORWARD_TOL * max(1.0, ref_max)
    print(f"guided forward (g={GUIDANCE}, batch {GB5} doubled): max abs err {err:.4g}, mean abs "
          f"err {(eps_k - eps_p).abs().mean().item():.3g} (max |eps| {ref_max:.3g}, tol {tol:.3g})")
    check(err <= tol, f"guided forward: kernel and plain eps differ by {err} > {tol}")
    del plain5, eps_k, eps_p
    with torch.no_grad():
        xg = randn(2 * GB5, S5, S5, cfg5.in_channels)
        cg = torch.cat([cond5, torch.zeros_like(cond5)])
        fwd5_graph_ms = time_ms(lambda: model5(xg, t5, cg), 100.0)
    print(f"config-5 forward at batch {2 * GB5} as a CUDA graph (device only): {fwd5_graph_ms:.2f} ms")
    del xg, cg
    shape5 = (GB5, S5, S5, cfg5.out_channels)
    guided = {}
    for g in (GUIDANCE, 1.0):
        batches = []

        def spy(x, t, c):
            batches.append(x.shape[0])
            return model5(x, t, c)

        ops.reset_launch_counts()
        out, dt0 = timed_sample(ddim_sample, make_guided_denoise(spy, cond5, g), shape5, STEPS)
        counts = ops.launch_counts()
        per_row = row_launches(counts, ops.attention.launches_by_source)
        fb = GB5 if g == 1.0 else 2 * GB5
        want = {k: per_forward.get(k, 0) * STEPS for k in counts}
        name = f"config-5 guided DDIM-{STEPS}, g={g:g}"
        print(f"{name}: {dt0:.3f} s; launches {counts}; forward batches {Counter(batches)}")
        check(counts == want, f"{name} launch counts {counts} != {want}")
        check(batches == [fb] * STEPS, f"{name}: forward batches {Counter(batches)}, want {fb} x "
                                       f"{STEPS}")
        for k, row in rows.items():
            row.d["launches_by_path"][name] = per_row[k]
        check(bool(torch.isfinite(out).all()) and out.abs().max().item() <= 1.0,
              f"{name} output not finite or outside [-1, 1]")
        runs = [dt0]
        if g != 1.0:
            runs += [timed_sample(ddim_sample, make_guided_denoise(model5, cond5, g), shape5,
                                  STEPS)[1] for _ in range(2)]
        med = sorted(runs)[len(runs) // 2]
        run_idle = 1 - STEPS * fwd5_graph_ms / 1e3 / med if g != 1.0 else None
        print(f"{name} runs: {', '.join(f'{x:.3f}' for x in runs)} s; median {med:.3f} s, "
              f"{GB5 / med:.4f} scenes/s (forward batch {fb})"
              + (f"; the device idle {100 * run_idle:.1f}% (the graph forward x {STEPS})"
                 if run_idle is not None else ""))
        guided[name] = dict(seconds_runs=runs, scenes_per_s=GB5 / med, forward_batch=fb,
                            device_idle=run_idle)
        del out
    del model5
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 10
    tcfg5 = TrainConfig(batch_size=32, learning_rate=1e-4, lr_warmup_steps=500, ema_decay=0.999,
                        cond_dropout=0.1)
    TB5 = tcfg5.batch_size
    phase(f"10 config-5 conditional training, batch {TB5}, cond_dropout {tcfg5.cond_dropout}")
    # The attention's forward with lse and its three backward launches at
    # the shape this train step gives them, each against its plain version
    # (at S = 256 both key tiles start their dQ walk at query tile 0).
    a10 = attention_bwd_checks(TB5, *mid_attention_shape(cfg5))
    label5 = "x".join(str(n) for n in a10["q"].shape)
    for name, (e, _) in a10["errs"].items():
        row = rows["attention" if name == "attention_with_lse" else name]
        row.d[f"config5_train_{label5}_max_abs_err"] = e
    del a10
    ch5 = cfg5.cond_channels + cfg5.in_channels
    batch5 = torch.randint(0, 256, (TB5, S5, S5, ch5), generator=gen, device=dev).to(torch.uint8)
    noise5 = randn(TB5, S5, S5, cfg5.in_channels)
    tt5 = torch.randint(0, 1000, (TB5,), generator=gen, device=dev)
    keep5 = torch.rand(TB5, generator=gen, device=dev) >= tcfg5.cond_dropout
    keep5[0] = False  # at least one sample trains the null branch
    print(f"keep mask: {int(keep5.sum())} of {TB5} samples keep their conditioning")
    tr5 = train_path(cfg5, tcfg5, batch5, noise5, tt5, keep5, f"config-5 batch {TB5}")
    for name, row in rows.items():
        row.d["launches_by_path"][f"config-5 train step, batch {TB5} (x{TRAIN_STEPS})"] = \
            tr5["counts"][name]
    del batch5, noise5
    torch.cuda.empty_cache()

    # --------------------------------------------------------------- 11
    phase("11 conditional CLIs and the kernels' limits at construction")
    from PIL import Image

    with tempfile.TemporaryDirectory() as tmp:
        data_dir, out_dir = os.path.join(tmp, "data"), os.path.join(tmp, "run")
        os.makedirs(data_dir)
        pattern = synthetic_corpus(data_dir, CLI5_IMAGES, S5, seed=20261016)
        cfg_path = os.path.join(tmp, "cfg.yaml")
        run_cfg = Config(model=cfg5)
        run_cfg.train = dataclasses.replace(tcfg5, device_data="on", eval_inference_steps=10,
                                            log_every=5, save_model_epochs=1000,
                                            save_image_epochs=1000, output_dir=out_dir,
                                            dataset_glob=pattern)
        save_config(run_cfg, cfg_path)
        t0 = time.perf_counter()
        log = run_cli(here, ["--cfg_file", cfg_path, "--max_steps", str(CLI5_STEPS)])
        cli5_s = time.perf_counter() - t0
        records = [json.loads(ln) for ln in open(os.path.join(out_dir, "logs", "metrics.jsonl"))]
        last = records[-1]
        launched = logged_launches(log)
        print(f"conditional train CLI: {CLI5_STEPS} steps in {cli5_s:.1f} s wall; last log step "
              f"{last['step']} loss {last['loss']:.4f} at {last['samples_per_sec']:.1f} samples/s; "
              f"launches {launched}")
        check(last["step"] == CLI5_STEPS and math.isfinite(last["loss"]),
              f"conditional train CLI ended at {last}")
        check(all(launched[name] == CLI5_STEPS for name in
                  ("attention_bwd_prep", "attention_bwd_main", "attention_bwd_dq")),
              f"conditional train CLI launches {launched}")
        cond_pngs = sorted(f for f in os.listdir(data_dir) if f.endswith(".png"))
        for sampler, n in (("dpm", DPM_STEPS), ("sde", SDE_STEPS)):
            gen_dir = os.path.join(tmp, f"gen_{sampler}")
            ops.reset_launch_counts()
            rate = generation.main(["--model_dir", out_dir, "--output_dir", gen_dir, "--sampler",
                                    sampler, "--cond_dir", data_dir, "--guidance", str(GUIDANCE),
                                    "--batch_size", "2", "--num_batches", "1", "--device",
                                    "cuda"])
            counts = ops.launch_counts()
            pngs = sorted(os.listdir(gen_dir))
            check(pngs == ["loop_000_batch_000.png", "loop_000_batch_001.png"],
                  f"conditional generation CLI ({sampler}) wrote {pngs}")
            for i, png in enumerate(pngs):
                img = np.asarray(Image.open(os.path.join(gen_dir, png)))
                src = np.asarray(Image.open(os.path.join(data_dir, cond_pngs[i])))
                check(img.shape == (S5, S5, 3) and np.array_equal(img[..., :2], src[..., :2]),
                      f"conditional generation CLI ({sampler}): {png} is not [cond R/G | sample]")
            want = {k: per_forward.get(k, 0) * n for k in counts}
            check(counts == want, f"conditional generation CLI ({sampler}) launches {counts}")
            print(f"conditional generation CLI --sampler {sampler} (default {n} steps) --cond_dir "
                  f"--guidance {GUIDANCE}: {pngs}, cond R/G first, at {rate:.4f} scenes/s; "
                  f"launches {counts}")

        # F1: a model outside the kernels' limits (config-1's model section:
        # f32, widths 32/64, head dim 8) is refused at construction on the
        # card, naming plain=True; the train CLI's --plain runs it there.
        cfg1 = ModelConfig(sample_size=64, in_channels=1, out_channels=1,
                           block_out_channels=(32, 64), layers_per_block=1, norm_num_groups=8,
                           attention_head_dim=8, dtype="float32")
        for for_training in (False, True):
            try:
                UNet2D(cfg1, device=dev, for_training=for_training)
            except ValueError as e:
                check("plain=True" in str(e) and all(line in str(e) for line in
                                                     kernel_limit_errors(cfg1, for_training)),
                      f"config-1 construction error does not name its limits: {e}")
                print(f"config-1 on CUDA (for_training={for_training}) refused at construction: "
                      + str(e).replace("\n", " | "))
            else:
                raise SmokeFailure(f"UNet2D(config-1, cuda, for_training={for_training}) built")
        data1, out1 = os.path.join(tmp, "data1"), os.path.join(tmp, "run1")
        os.makedirs(data1)
        pattern1 = synthetic_corpus(data1, 16, cfg1.sample_size, seed=1)
        cfg1_path = os.path.join(tmp, "cfg1.yaml")
        run1 = Config(model=cfg1)
        run1.train = dataclasses.replace(TrainConfig(batch_size=8), eval_inference_steps=10,
                                         log_every=1, save_model_epochs=1000,
                                         save_image_epochs=1000, output_dir=out1,
                                         dataset_glob=pattern1)
        save_config(run1, cfg1_path)
        log = run_cli(here, ["--cfg_file", cfg1_path, "--max_steps", "4", "--plain"])
        launched = logged_launches(log)
        check(set(launched.values()) == {0}, f"--plain train CLI launched kernels: {launched}")
        check(latest_step(os.path.join(out1, "checkpoints")) == 4 and
              os.listdir(os.path.join(out1, "samples")) == ["000.png"],
              "--plain train CLI on config-1 did not finish")
        print("config-1 train CLI --plain on CUDA: 4 steps, a checkpoint and an eval sample; "
              f"launches {launched}")
        gen1 = os.path.join(tmp, "gen1")
        ops.reset_launch_counts()
        generation.main(["--model_dir", out1, "--output_dir", gen1, "--sampler", "dpm", "--steps",
                         "5", "--batch_size", "1", "--num_batches", "1", "--device", "cuda",
                         "--plain"])
        counts = ops.launch_counts()
        check(os.listdir(gen1) == ["loop_000_batch_000.png"] and set(counts.values()) == {0},
              f"--plain generation CLI on config-1 wrote {os.listdir(gen1)}, launches {counts}")
        print(f"config-1 generation CLI --plain on CUDA from that export: DPM-5, "
              f"loop_000_batch_000.png; launches {counts}")

    # --------------------------------------------------------------- 12
    stage2_numbers = phase_stage2(here, work, model_dir, q_ddim, ddim_rate)

    # --------------------------------------------------------------- 13
    front_end_numbers = phase_front_end(here, work)

    # --------------------------------------------------------------- 14
    scale_numbers = phase_scale(here, work, model_dir, os.path.join(work, "gen6"),
                                os.path.join(work, "train7", "run"), train_path, rows, med_ms)

    # --------------------------------------------------------------- 15
    phase(f"15 tensor parallelism: the attention kernels at heads/tp; config-3's train step at "
          f"model {TP_MODEL} on two gloo ranks on the card; checkpoints across tp")
    t15 = time.perf_counter()
    # 15a: the attention's four train-step launches at the heads one rank
    # runs at tp = 2 and 4, each against its plain version, two runs of the
    # backward bit-identical (attention_bwd_checks), and timed.
    for tp in (2, 4):
        h_tp = heads // tp
        label = f"[{TB},{h_tp},{S},{hd}]"
        a15 = attention_bwd_checks(TB, h_tp, S, hd)
        t15a = attention_bwd_times(a15, TB, h_tp, S, hd)
        print(f"attention_with_lse {label} (tp {tp}): {t15a['fwd_ms']:.4f} ms "
              f"({2 * t15a['prod'] / t15a['fwd_ms'] / 1e9:.1f} TFLOP/s), bound "
              f"{t15a['bnd_fwd'][0]:.4f} ms ({t15a['bnd_fwd'][1]}), SDPA forward "
              f"{t15a['fwd_lib_ms']:.4f} ms, plain {t15a['fwd_plain_ms']:.4f} ms")
        print_bwd_times(t15a, f"{label} (tp {tp})")
        for name, key, plain_key, lib_key, bnd in (
                ("attention", "fwd_ms", "fwd_plain_ms", "fwd_lib_ms", "bnd_fwd"),
                ("attention_bwd_prep", "prep_ms", "di_plain_ms", "di_lib_ms", "bnd_prep"),
                ("attention_bwd_main", "main_ms", "plain_ms", "lib_ms", "bnd_main"),
                ("attention_bwd_dq", "dq_ms", "dq_plain_ms", None, "bnd_dq")):
            err = a15["errs"]["attention_with_lse" if name == "attention" else name][0]
            rows[name].d.setdefault("tp_shapes", {})[f"tp {tp}: {label}"] = dict(
                ms=t15a[key], plain_ms=t15a[plain_key],
                library_ms=t15a[lib_key] if lib_key else None, bound_ms=t15a[bnd][0],
                bound_by=t15a[bnd][1], max_abs_err=err)
        del a15, t15a
        torch.cuda.empty_cache()
    tp_numbers = phase_tp_train(here, work, inputs7)
    rank0 = tp_numbers["ranks"][0]
    per_row = row_launches(rank0["launches_step1"], rank0["attention_by_source_step1"])
    for name, row in rows.items():
        row.d["launches_by_path"][f"phase 15 TP train step, model {TP_MODEL}, batch {TB}, "
                                  f"each rank (x1)"] = per_row[name]
    tp_numbers["phase_s"] = time.perf_counter() - t15
    print(f"phase 15: {tp_numbers['phase_s']:.1f} s")

    # --------------------------------------------------------------- 16
    import_eval_numbers = phase_import_eval(here, work, rows, fwd_graph_ms, dt)

    # --------------------------------------------------------------- 17
    train8_numbers = phase_train8(here, work, rows, train_path, tcfg, d8_numbers, tr, smi)

    # --------------------------------------------------------------- 18
    gn_bwd_numbers = phase_gn_backward(rows, tcfg.batch_size, smi)

    seconds = phase_seconds()
    print(f"seconds by phase: {seconds}, {time.perf_counter() - t_main:.1f} s in all")
    print(json.dumps({"summary": {"forward_ms": fwd_ms, "forward_plain_ms": fwd_plain_ms,
                                  "forward_graph_ms": fwd_graph_ms,
                                  "ddim_seconds": dt, "ddim_scenes_per_s": B / dt,
                                  "ddim_seconds_runs": times, "host_us_per_call": host,
                                  "batch": B, "steps": STEPS,
                                  "train_batch": TB, "train_step_ms_median": med_ms,
                                  "train_step_ms": step_ms,
                                  "train_samples_per_s": TB / med_ms * 1e3,
                                  "train_device_idle": idle, "train_peak_memory_gb": peak_gb,
                                  "attention_bwd_ms": bwd_ms,
                                  "attention_bwd_parts_ms": [prep_ms, main_ms, dq_ms],
                                  "attention_bwd_tflops": 5 * prod / bwd_ms / 1e9,
                                  "attention_bwd_bound_ms": bnd_all[0],
                                  "attention_bwd_sdpa_ms": lib_ms,
                                  "attention_bwd_plain_ms": plain_ms,
                                  "train_cli_seconds": cli_s,
                                  "dpm_samplers": dpm_summary,
                                  "config5_guided_ddim": guided,
                                  "config5_forward_graph_ms": fwd5_graph_ms,
                                  "config5_train_step": {k: tr5[k] for k in (
                                      "med_ms", "step_ms", "samples_per_s", "idle", "peak_gb")},
                                  "config5_train_cli_seconds": cli5_s, "stage2": stage2_numbers,
                                  "front_end": front_end_numbers,
                                  "training_at_scale": scale_numbers,
                                  "tensor_parallel": tp_numbers,
                                  "import_eval": import_eval_numbers,
                                  "attention_d8": d8_numbers,
                                  "train_head_dim8": train8_numbers,
                                  "gn_backward": gn_bwd_numbers,
                                  "script_s": time.perf_counter() - t_main,
                                  "phase_s": seconds,
                                  "card": smi}}))
    print(json.dumps({"kernels": [row.d for row in rows.values()]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--tp-worker"]:  # one rank of phase 15b
        sys.exit(tp_worker(sys.argv[2]))
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        sys.exit(1)
