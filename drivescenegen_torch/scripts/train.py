"""DDPM UNet training (port of drivescenegen_tpu/scripts/train.py).

  python -m drivescenegen_torch.scripts.train --cfg_file cfg.yaml \
      [--dataset_glob 'imgs/*.png'] [--output_dir out] [--resume] \
      [--init_from <run dir>] [--max_steps N] [--profile_steps N] \
      [--supervise N] [--device cpu] [--plain]
  torchrun --nproc_per_node N -m drivescenegen_torch.scripts.train ...

AdamW with a cosine-warmup lr, bf16 activations over f32 params, the
attention's forward and backward kernels on the card (training/trainer.py).
Under torchrun it runs on the config's ("data", "model") mesh
(parallel/mesh.py): NCCL on the card, one GPU a rank, gloo with --device
cpu. train.batch_size is the global batch, which the data axis must
divide, and each data coordinate steps on its rows of it; mesh.model > 1
shards the model over each group of mesh.model ranks (tensor
parallelism, the JAX package's rules), and the data axis is the world
over it.
Writes <output_dir>/config.yaml, logs/metrics.jsonl and logs every
log_every steps, and at each epoch end a full-state checkpoint
(checkpoints/step_N.pt), params.npz (the EMA weights when ema_decay > 0),
which the generation CLI samples from, and a sample PNG (samples/NNN.png;
DDIM when eval_inference_steps <= 100, else DDPM); rank 0 writes them. A
file <output_dir>/STOP ends the run at the next log line, after a
checkpoint and an export. Checkpoints and params.npz hold the whole model
whatever mesh.model is, so a run resumes, or warm-starts, at another;
the eval sample is rank 0's, on a full model, from the gathered weights.
A conditional model (cond_channels > 0) reads cond_channels +
in_channels channels of each image, the conditioning first, and trains
with cond-dropout; its eval samples are unconditional, as in the JAX
package. --plain builds both models on PyTorch's library ops, for a model
outside the kernels' limits (models/unet2d.py kernel_limit_errors). The
import CLI's config.yaml (scripts/import_reference.py) trains
DriveSceneGen's own architecture, head dim 8, on the kernels without it.

The data reach the card one of three ways (batch_source). Raw PNG
datasets are uint8 and normalized on the device. device_data "on", or
"auto" within device_data_budget_gb: the whole corpus is uploaded once and
each step gathers its batch on the device. "hybrid", or "auto" over the
budget: a budget-sized pool is resident and the rest streams from the
decoded-corpus sidecar, each batch the pool's rows then the tail's.
Otherwise every batch is decoded on the host and prefetched.

--init_from warm-starts params and EMA from another run (its output dir or
checkpoints/) with a fresh optimizer, schedule and step; --resume wins
once this run has checkpoints. --profile_steps N traces steps 2 .. N + 1
of the run into <output_dir>/trace (rank 0, torch.profiler, Chrome trace).
--supervise N runs the trainer as a child process, the whole data-parallel
group through torch.distributed.run when the data axis is over 1, and
relaunches it with --resume up to N times after a crash or a stall of its
logs, once a throwaway process finds the device healthy.
Runs on --device (default cuda).
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import os
import sys
import time

import numpy as np
import torch

from drivescenegen_torch import ops
from drivescenegen_torch.config import load_config, save_config
from drivescenegen_torch.data.dataset import (
    RasterDataset,
    batch_iterator,
    dataset_to_device,
    hybrid_device_data,
    hybrid_index_batches,
    index_batches,
    prefetch_to_device,
)
from drivescenegen_torch.diffusion import ddim_sample, ddpm_sample, make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.parallel import make_mesh
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
from drivescenegen_torch.training.checkpoint import (
    full_params,
    latest_step,
    restore_checkpoint,
    restore_params,
    save_checkpoint,
    save_params_only,
)
from drivescenegen_torch.utils import prng, profiling
from drivescenegen_torch.utils.logging import MetricWriter, configure_file_logging, get_logger

logger = get_logger("train")


def save_sample_image(model, schedule, cfg, out_dir: str, seed: int, sampler: str = "ddpm",
                      steps: int = 750) -> str:
    """One eval sample from `model` (its weights already loaded), saved as
    the next samples/NNN.png (drivescenegen_tpu/scripts/train.py:53-84).
    The image is truncated to uint8, (x01 * 255).astype(uint8), as the JAX
    package's eval image is; the generation CLIs round."""
    from PIL import Image

    shape = (1, cfg.model.sample_size, cfg.model.sample_size, cfg.model.out_channels)
    fn = ddpm_sample if sampler == "ddpm" else ddim_sample
    gen = prng.root_generator(seed, schedule.device)
    with torch.no_grad():
        x = fn(model, schedule, shape, gen, steps)
    img = (np.clip(x[0].float().cpu().numpy() / 2 + 0.5, 0, 1) * 255).astype(np.uint8)
    if img.shape[-1] == 1:
        img = img[..., 0]
    os.makedirs(out_dir, exist_ok=True)
    count = len([f for f in os.listdir(out_dir) if f.endswith(".png")])
    path = os.path.join(out_dir, f"{count:03d}.png")
    Image.fromarray(img).save(path)
    return path


def supervise(cmd, retries: int, health_check, sleep_s: float = 60.0,
              max_wait_s: float = 7200.0, resume_cmd=None, progress_path: str | None = None,
              stall_s: float = 1800.0) -> int:
    """Run `cmd` (an argv list) and, on a non-zero exit, wait until
    `health_check()` finds the device back, then relaunch it (as
    `resume_cmd` when given: the first attempt keeps the user's own
    --resume choice, only relaunches force one), up to `retries` times.
    Returns the last exit code (drivescenegen_tpu/scripts/train.py:87-174).

    With `progress_path` (the trainer's logs dir) the newest mtime under
    it is the child's liveness: no progress for `stall_s` seconds kills
    the child and counts as a crash. The supervisor is the outer process
    of a run; under torchrun (WORLD_SIZE > 1) it refuses, since each rank
    would supervise a group of its own."""
    import glob as _glob
    import subprocess

    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise SystemExit("--supervise runs in the outer process, which launches the data-"
                         "parallel group itself; do not start it under torchrun")

    def progress_mtime() -> float:
        files = _glob.glob(os.path.join(progress_path, "*")) if progress_path else []
        return max((os.path.getmtime(f) for f in files), default=0.0)

    def run(argv) -> int:
        proc = subprocess.Popen(argv)
        if not progress_path:
            return proc.wait()
        started = time.time()
        while True:
            try:
                return proc.wait(timeout=min(30.0, stall_s))
            except subprocess.TimeoutExpired:
                pass
            if time.time() - max(progress_mtime(), started) > stall_s:
                logger.error(f"no training progress for {stall_s:.0f}s with the child alive "
                             f"(hung device op?); killing pid {proc.pid}")
                proc.kill()
                proc.wait()
                return -9

    attempt = 0
    while True:
        rc = run(cmd)
        if rc == 0 or attempt >= retries:
            return rc
        attempt += 1
        if resume_cmd is not None:
            if cmd != resume_cmd:
                logger.warning("relaunching WITH --resume (crash recovery)")
            cmd = resume_cmd
        logger.warning(f"training attempt {attempt}/{retries} exited rc={rc}; waiting for "
                       f"device health before resuming")
        waited = 0.0
        while waited < max_wait_s and not health_check():
            time.sleep(sleep_s)
            waited += sleep_s
        if waited >= max_wait_s:
            logger.error("device never came back; giving up")
            return rc


def _device_healthy(device: str = "cuda", timeout_s: float = 180.0) -> bool:
    """Run a tiny op on `device` in a throwaway subprocess: a hung device
    blocks the caller forever, a child can be killed."""
    import subprocess

    code = f"import torch; torch.ones(8, 8, device={device!r}).sum().item()"
    try:
        return subprocess.run([sys.executable, "-c", code], timeout=timeout_s,
                              stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL).returncode == 0
    except subprocess.TimeoutExpired:
        return False


def supervised_commands(argv, cfg, device: str):
    """The child's command and its relaunch form with --resume: argv
    without --supervise, run as the plain module, or through
    torch.distributed.run with one process per rank of the mesh when it
    has more than one (data -1: every GPU, or the model axis's ranks on
    the CPU)."""
    cleaned, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a == "--supervise":
            skip = True
        elif not a.startswith("--supervise="):
            cleaned.append(a)
    model = max(1, cfg.mesh.model)
    n_proc = cfg.mesh.data * model if cfg.mesh.data > 0 else (
        torch.cuda.device_count() if torch.device(device).type == "cuda" else model)
    launcher = [sys.executable, "-m"]
    if n_proc > 1:
        launcher += ["torch.distributed.run", "--standalone", "--nproc_per_node", str(n_proc),
                     "-m"]
    cmd = launcher + ["drivescenegen_torch.scripts.train"] + cleaned
    return cmd, (cmd if "--resume" in cleaned else cmd + ["--resume"])


def data_mode(tcfg, dataset: RasterDataset, n_bytes: int) -> str:
    """"resident", "hybrid" or "streamed" for device_data and the corpus:
    "auto" keeps a raw corpus within device_data_budget_gb resident and
    goes hybrid over it, as the JAX trainer does
    (drivescenegen_tpu/scripts/train.py:312-320)."""
    budget = int(tcfg.device_data_budget_gb * 1024 ** 3)
    auto_raw = tcfg.device_data == "auto" and dataset.raw
    if tcfg.device_data == "hybrid" or (auto_raw and n_bytes > budget):
        return "hybrid"
    if tcfg.device_data == "on" or auto_raw:
        return "resident"
    return "streamed"


def batch_source(mode: str, dataset: RasterDataset, tcfg, mesh):
    """Returns (next_batch, info): next_batch() is this rank's rows of the
    next global batch, on the rank's device, in the order the JAX trainer
    builds the batch for the same seed; info holds the mode and, for
    hybrid, the pool and tail sizes and the tail's bytes a step."""
    device, B = mesh.device, tcfg.batch_size
    rows = mesh.rows(B)
    info = {"mode": mode}
    if mode == "hybrid":
        budget = int(tcfg.device_data_budget_gb * 1024 ** 3)
        data_dev, pool_idx, tail_idx, full = hybrid_device_data(dataset, device, budget,
                                                                seed=tcfg.seed)
        if len(tail_idx) == 0:
            raise SystemExit("device_data: hybrid requested but the whole corpus fits the "
                             f"{budget / 1e9:.2f} GB budget; use device_data: on")
        idx_it = hybrid_index_batches(len(pool_idx), len(tail_idx), B, seed=tcfg.seed,
                                      align=mesh.shape["data"])
        first = next(idx_it)
        k_res, k_str = len(first[0]), len(first[1])
        idx_a, idx_b = itertools.tee(itertools.chain([first], idx_it))
        # The global batch is the pool's k_res rows, then the tail's k_str;
        # this rank's rows fall in one part or straddle both, and it reads
        # and moves only its tail rows.
        pool_rows = slice(min(rows.start, k_res), min(rows.stop, k_res))
        tail_rows = slice(max(rows.start - k_res, 0), max(rows.stop - k_res, 0))
        tail_it = prefetch_to_device((full[tail_idx[t[tail_rows]]] for _, t in idx_b), device)
        sample_bytes = int(np.prod(full.shape[1:])) * full.dtype.itemsize
        info.update(pool=len(pool_idx), tail=len(tail_idx), k_res=k_res, k_str=k_str,
                    tail_bytes_per_step=k_str * sample_bytes)

        def next_batch():
            with profiling.annotate("feed.next_batch"):
                pool_slots, _ = next(idx_a)
                slots = torch.from_numpy(pool_slots[pool_rows].astype(np.int64)).to(device)
                return torch.cat([data_dev[slots], next(tail_it)])
    elif mode == "resident":
        data_dev = dataset_to_device(dataset, device)
        idx_it = index_batches(len(dataset), B, seed=tcfg.seed)

        def next_batch():
            with profiling.annotate("feed.next_batch"):
                return data_dev[torch.from_numpy(next(idx_it)[rows]).to(device)]
    else:
        it = prefetch_to_device(batch_iterator(dataset, B, seed=tcfg.seed, num_epochs=None),
                                device, rows=rows)

        def next_batch():
            with profiling.annotate("feed.next_batch"):
                return next(it)
    return next_batch, info


def main(argv=None):
    parser = argparse.ArgumentParser(description="DDPM training (PyTorch)")
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--dataset_glob", default=None, type=str)
    parser.add_argument("--output_dir", default=None, type=str)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--init_from", default=None, type=str,
                        help="warm start: params (+EMA) from another run's output_dir (or its "
                             "checkpoints/) with a fresh optimizer, schedule and step; --resume "
                             "wins once this run has checkpoints")
    parser.add_argument("--max_steps", default=0, type=int,
                        help="cap total optimizer steps (0 = epochs * steps/epoch)")
    parser.add_argument("--profile_steps", default=0, type=int,
                        help="trace N steps after the first into <output_dir>/trace")
    parser.add_argument("--supervise", default=0, type=int, metavar="N",
                        help="run the trainer as a supervised child process and resume it up "
                             "to N times after a crash (waits for device health between "
                             "attempts)")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--plain", action="store_true",
                        help="run PyTorch's library ops instead of the CUDA kernels, for a "
                             "model outside their limits")
    args = parser.parse_args(argv)
    if args.profile_steps < 0 or args.supervise < 0:
        raise SystemExit("--profile_steps and --supervise take a count >= 0")

    overrides = {"train": {}}
    if args.dataset_glob:
        overrides["train"]["dataset_glob"] = args.dataset_glob
    if args.output_dir:
        overrides["train"]["output_dir"] = args.output_dir
    cfg = load_config(args.cfg_file, overrides)
    tcfg = cfg.train

    if args.supervise > 0:
        cmd, resume_cmd = supervised_commands(
            argv if argv is not None else sys.argv[1:], cfg, args.device)
        raise SystemExit(supervise(
            cmd, args.supervise, lambda: _device_healthy(args.device), resume_cmd=resume_cmd,
            progress_path=os.path.join(tcfg.output_dir, "logs")))

    mesh = make_mesh(cfg.mesh, args.device)
    device = mesh.device
    n_data = mesh.shape["data"]
    if tcfg.batch_size % n_data:
        raise SystemExit(f"global batch {tcfg.batch_size} not divisible by data axis {n_data}")
    if mesh.is_main:
        os.makedirs(tcfg.output_dir, exist_ok=True)
        save_config(cfg, os.path.join(tcfg.output_dir, "config.yaml"))
        writer = MetricWriter(os.path.join(tcfg.output_dir, "logs"))
        configure_file_logging(os.path.join(tcfg.output_dir, "logs"))
    else:
        logger.setLevel("WARNING")
    logger.info(f"mesh: {mesh.shape} on {device}" + (" (torch.distributed)" if mesh.distributed
                                                      else "")
                + (f"; tensor parallel over {mesh.shape['model']} ranks a model group"
                   if mesh.shape["model"] > 1 else ""))

    n_channels = cfg.model.in_channels + cfg.model.cond_channels
    dataset = RasterDataset(tcfg.dataset_glob, img_res=cfg.model.sample_size,
                            n_channels=n_channels, cache=tcfg.cache_dataset, raw="auto")
    if len(dataset) < tcfg.batch_size:
        raise SystemExit(f"dataset has {len(dataset)} samples < batch_size {tcfg.batch_size}; "
                         f"reduce train.batch_size or add data")
    steps_per_epoch = len(dataset) // tcfg.batch_size
    total_steps = args.max_steps or steps_per_epoch * tcfg.num_epochs
    logger.info(f"dataset: {len(dataset)} samples, {steps_per_epoch} steps/epoch on {device}")

    model = UNet2D(cfg.model, device=device, for_training=True, plain=args.plain,
                   generator=prng.for_purpose(tcfg.seed, "init", device), mesh=mesh)
    schedule = make_schedule(cfg.diffusion, device=device)
    optimizer, lr_sched = create_optimizer(tcfg, total_steps, model.parameters())
    state = init_train_state(model, optimizer, ema=tcfg.ema_decay > 0.0)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model parameters: {n_params:,}" + (
        f" on this rank ({len(model.tp_plan)} tensors sharded)" if model.tp_plan else ""))
    ckpt_dir = os.path.join(tcfg.output_dir, "checkpoints")
    if args.resume and latest_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state, mesh)
        logger.info(f"resumed from step {state.step}")
    elif args.init_from:
        init_dir = args.init_from
        if os.path.isdir(os.path.join(init_dir, "checkpoints")):
            init_dir = os.path.join(init_dir, "checkpoints")
        try:
            donor_step = restore_params(init_dir, state, mesh)
        except FileNotFoundError as e:
            raise SystemExit(f"--init_from: {e}") from None
        logger.info(f"warm-started params from {init_dir} (donor step {donor_step}; "
                    f"optimizer/schedule/step reset to 0)")
    step_fn = make_train_step(schedule, lr_sched, tcfg, mesh)
    # The sampling arm, for the eval images: the export's weights, the kernels
    # (library ops under --plain).
    eval_model = UNet2D(cfg.model, device=device, plain=args.plain).eval() if mesh.is_main \
        else None

    # Each epoch is a permutation from one numpy stream (the JAX package's
    # order for the seed); a resumed run starts the stream again, as there.
    n_bytes = len(dataset) * cfg.model.sample_size ** 2 * n_channels
    mode = data_mode(tcfg, dataset, n_bytes)
    budget_gb = tcfg.device_data_budget_gb * 1024 ** 3 / 1e9
    if mode == "hybrid":
        logger.info(f"hybrid device data: corpus {n_bytes / 1e9:.2f} GB > budget "
                    f"{budget_gb:.2f} GB; streaming the tail")
    elif mode == "resident":
        logger.info(f"uploading the dataset to {device} ({n_bytes / 1e9:.3f} GB)")
    next_batch, info = batch_source(mode, dataset, tcfg, mesh)
    if mode == "hybrid":
        logger.info(f"hybrid: pool {info['pool']}, tail {info['tail']}; a batch is {info['k_res']} "
                    f"pool + {info['k_str']} tail rows ({info['tail_bytes_per_step'] / 1e6:.3f} "
                    f"MB streamed a step)")

    def export_params():
        """The export's weights, whole (a collective under tensor
        parallelism: every rank calls it)."""
        return full_params(state, mesh, ema=state.ema_params is not None)

    def export_and_save():
        save_checkpoint(ckpt_dir, state, max_to_keep=tcfg.checkpoint_max_to_keep, mesh=mesh)
        export = export_params()
        save_params_only(tcfg.output_dir, export, mesh=mesh)
        return export

    stop_file = os.path.join(tcfg.output_dir, "STOP")
    start_step = logged_step = state.step
    trace_dir = os.path.join(tcfg.output_dir, "trace")
    tracer, tracing = contextlib.ExitStack(), False
    t_start = t_last = time.perf_counter()
    for step_i in range(start_step, total_steps):
        if args.profile_steps and step_i == start_step + 1 and mesh.is_main:
            tracer.enter_context(profiling.trace(trace_dir))  # after the first step's warm-up
            tracing = True
        state, metrics = step_fn(state, next_batch())
        if tracing and step_i == start_step + args.profile_steps:
            tracer.close()
            tracing = False
            logger.info(f"profiler trace of steps {start_step + 2}-{step_i + 1} -> {trace_dir}")
        if (step_i + 1) % tcfg.log_every == 0 or step_i + 1 == total_steps:
            now = time.perf_counter()
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_sec"] = (step_i + 1 - logged_step) / max(now - t_last, 1e-9)
            m["samples_per_sec"] = m["steps_per_sec"] * tcfg.batch_size
            t_last, logged_step = now, step_i + 1
            if mesh.is_main:
                writer.write(step_i + 1, m)
            logger.info(f"step {step_i + 1}/{total_steps} loss {m['loss']:.4f} "
                        f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.2e} "
                        f"{m['samples_per_sec']:.1f} samples/s")
            if mesh.agree(os.path.exists(stop_file)):
                logger.info(f"stop file found ({stop_file}); saving state and exiting at step "
                            f"{step_i + 1}")
                export_and_save()
                break
        epoch_end = (step_i + 1) % steps_per_epoch == 0 or step_i + 1 == total_steps
        if epoch_end:
            epoch = (step_i + 1) // steps_per_epoch
            last = step_i + 1 == total_steps
            export = None
            if epoch % tcfg.save_model_epochs == 0 or last:
                export = export_and_save()
            if epoch % tcfg.save_image_epochs == 0 or last:
                if export is None:
                    export = export_params()
                if mesh.is_main:
                    eval_model.load_state_dict(export)
                    path = save_sample_image(
                        eval_model, schedule, cfg, os.path.join(tcfg.output_dir, "samples"),
                        tcfg.seed, sampler="ddim" if tcfg.eval_inference_steps <= 100 else "ddpm",
                        steps=tcfg.eval_inference_steps)
                    logger.info(f"epoch {epoch}: sample -> {path}")
            mesh.barrier()
    tracer.close()

    dt = time.perf_counter() - t_start
    logger.info(f"trained {state.step - start_step} steps in {dt:.1f}s; kernel launches "
                f"{ops.launch_counts()}")
    logger.info(f"attention forward launches by source {ops.attention.launches_by_source}")
    if mesh.is_main:
        writer.close()
    mesh.close()
    return state


if __name__ == "__main__":
    main()
