"""DDPM UNet training (port of drivescenegen_tpu/scripts/train.py on one
device).

  python -m drivescenegen_torch.scripts.train --cfg_file cfg.yaml \
      [--dataset_glob 'imgs/*.png'] [--output_dir out] [--resume] \
      [--max_steps N] [--device cpu] [--plain]

AdamW with a cosine-warmup lr, bf16 activations over f32 params, the
attention's forward and backward kernels on the card (training/trainer.py).
Writes <output_dir>/config.yaml, logs/metrics.jsonl and logs every
log_every steps, and at each epoch end a full-state checkpoint
(checkpoints/step_N.pt), params.npz (the EMA weights when ema_decay > 0),
which the generation CLI samples from, and a sample PNG (samples/NNN.png;
DDIM when eval_inference_steps <= 100, else DDPM). A file <output_dir>/STOP
ends the run at the next log line, after a checkpoint and an export.
A conditional model (cond_channels > 0) reads cond_channels +
in_channels channels of each image, the conditioning first, and trains
with cond-dropout; its eval samples are unconditional, as in the JAX
package. --plain builds both models on PyTorch's library ops, for a model
outside the kernels' limits (models/unet2d.py kernel_limit_errors).
Raw PNG datasets are uint8 and normalized on the device; with
device_data "on", or "auto" within device_data_budget_gb, the whole corpus
is uploaded once and each step gathers its batch on the device.
Runs on --device (default cuda).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from drivescenegen_torch import ops
from drivescenegen_torch.config import load_config, save_config
from drivescenegen_torch.data.dataset import (
    RasterDataset,
    batch_iterator,
    dataset_to_device,
    index_batches,
)
from drivescenegen_torch.diffusion import ddim_sample, ddpm_sample, make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
from drivescenegen_torch.training.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
    save_params_only,
)
from drivescenegen_torch.utils import prng
from drivescenegen_torch.utils.device import resolve_device
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


def main(argv=None):
    parser = argparse.ArgumentParser(description="DDPM training (PyTorch)")
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--dataset_glob", default=None, type=str)
    parser.add_argument("--output_dir", default=None, type=str)
    parser.add_argument("--resume", action="store_true")
    parser.add_argument("--max_steps", default=0, type=int,
                        help="cap total optimizer steps (0 = epochs * steps/epoch)")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--plain", action="store_true",
                        help="run PyTorch's library ops instead of the CUDA kernels, for a "
                             "model outside their limits")
    for later in ("--init_from", "--profile_steps", "--supervise"):
        parser.add_argument(later, default=None, help="not in the port yet")
    args = parser.parse_args(argv)
    for later in ("init_from", "profile_steps", "supervise"):
        if getattr(args, later) is not None:
            raise SystemExit(f"--{later} comes with a later slice of the port")

    overrides = {"train": {}}
    if args.dataset_glob:
        overrides["train"]["dataset_glob"] = args.dataset_glob
    if args.output_dir:
        overrides["train"]["output_dir"] = args.output_dir
    cfg = load_config(args.cfg_file, overrides)
    tcfg = cfg.train
    device = resolve_device(args.device)
    os.makedirs(tcfg.output_dir, exist_ok=True)
    save_config(cfg, os.path.join(tcfg.output_dir, "config.yaml"))
    writer = MetricWriter(os.path.join(tcfg.output_dir, "logs"))
    configure_file_logging(os.path.join(tcfg.output_dir, "logs"))

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
                   generator=prng.for_purpose(tcfg.seed, "init", device))
    schedule = make_schedule(cfg.diffusion, device=device)
    optimizer, lr_sched = create_optimizer(tcfg, total_steps, model.parameters())
    state = init_train_state(model, optimizer, ema=tcfg.ema_decay > 0.0)
    logger.info(f"model parameters: {sum(p.numel() for p in model.parameters()):,}")
    ckpt_dir = os.path.join(tcfg.output_dir, "checkpoints")
    if args.resume and latest_step(ckpt_dir) is not None:
        state = restore_checkpoint(ckpt_dir, state)
        logger.info(f"resumed from step {state.step}")
    step_fn = make_train_step(schedule, lr_sched, tcfg)
    # The sampling arm, for the eval images: the export's weights, the kernels
    # (library ops under --plain).
    eval_model = UNet2D(cfg.model, device=device, plain=args.plain).eval()

    if tcfg.device_data == "hybrid":
        raise SystemExit("device_data: hybrid (resident pool + streamed tail) comes with a later "
                         "slice of the port; use on, off or auto")
    n_bytes = len(dataset) * cfg.model.sample_size ** 2 * n_channels
    use_device_data = tcfg.device_data == "on" or (
        tcfg.device_data == "auto" and dataset.raw
        and n_bytes <= tcfg.device_data_budget_gb * 1024 ** 3)
    # Each epoch is a permutation from one numpy stream (the JAX package's
    # order for the seed); a resumed run starts the stream again, as there.
    if use_device_data:
        logger.info(f"uploading the dataset to {device} ({n_bytes / 1e9:.3f} GB)")
        data_dev = dataset_to_device(dataset, device)
        idx_it = index_batches(len(dataset), tcfg.batch_size, seed=tcfg.seed)
        batches = (data_dev[torch.from_numpy(i).to(device)] for i in idx_it)
    else:
        batches = batch_iterator(dataset, tcfg.batch_size, seed=tcfg.seed, num_epochs=None)

    def export_and_save():
        save_checkpoint(ckpt_dir, state, max_to_keep=tcfg.checkpoint_max_to_keep)
        export = state.ema_params if state.ema_params is not None else model.state_dict()
        save_params_only(tcfg.output_dir, export)
        return export

    stop_file = os.path.join(tcfg.output_dir, "STOP")
    start_step = logged_step = state.step
    t_start = t_last = time.perf_counter()
    for step_i in range(start_step, total_steps):
        batch = torch.as_tensor(next(batches)).to(device, non_blocking=True)
        state, metrics = step_fn(state, batch)
        if (step_i + 1) % tcfg.log_every == 0 or step_i + 1 == total_steps:
            now = time.perf_counter()
            m = {k: float(v) for k, v in metrics.items()}
            m["steps_per_sec"] = (step_i + 1 - logged_step) / max(now - t_last, 1e-9)
            m["samples_per_sec"] = m["steps_per_sec"] * tcfg.batch_size
            t_last, logged_step = now, step_i + 1
            writer.write(step_i + 1, m)
            logger.info(f"step {step_i + 1}/{total_steps} loss {m['loss']:.4f} "
                        f"grad_norm {m['grad_norm']:.4f} lr {m['lr']:.2e} "
                        f"{m['samples_per_sec']:.1f} samples/s")
            if os.path.exists(stop_file):
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
                    export = state.ema_params if state.ema_params is not None \
                        else model.state_dict()
                eval_model.load_state_dict(export)
                path = save_sample_image(
                    eval_model, schedule, cfg, os.path.join(tcfg.output_dir, "samples"),
                    tcfg.seed, sampler="ddim" if tcfg.eval_inference_steps <= 100 else "ddpm",
                    steps=tcfg.eval_inference_steps)
                logger.info(f"epoch {epoch}: sample -> {path}")

    dt = time.perf_counter() - t_start
    logger.info(f"trained {state.step - start_step} steps in {dt:.1f}s; kernel launches "
                f"{ops.launch_counts()}")
    writer.close()
    return state


if __name__ == "__main__":
    main()
