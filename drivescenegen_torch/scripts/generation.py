"""Sample scene rasters from a trained model (port of
drivescenegen_tpu/scripts/generation.py for the DDPM and DDIM samplers).

  python -m drivescenegen_torch.scripts.generation --model_dir <dir> \
      --sampler ddim --steps 50 --batch_size 8 --num_batches 4

<model_dir> holds config.yaml (its model and diffusion sections are spliced
into the run's config) and params.npz, the flat flax parameter tree
(models/convert.py). Images are written as loop_NNN_batch_III.png, rounded
to uint8 from [-1, 1]. Runs on --device (default cuda).
"""

from __future__ import annotations

import argparse
import functools
import os
import time

import numpy as np
import torch

from drivescenegen_torch.config import load_config
from drivescenegen_torch.diffusion import ddim_sample, ddpm_sample, make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, load_npz
from drivescenegen_torch.utils.device import resolve_device
from drivescenegen_torch.utils.logging import get_logger

logger = get_logger("generation")


def load_model_for_sampling(cfg, model_dir: str, device):
    """Build the UNet + schedule on `device` and load <model_dir>/params.npz.
    The model/diffusion config sections are spliced from
    <model_dir>/config.yaml when it exists; cfg is updated in place."""
    model_cfg_path = os.path.join(model_dir, "config.yaml")
    if os.path.exists(model_cfg_path):
        trained = load_config(model_cfg_path)
        cfg.model = trained.model
        cfg.diffusion = trained.diffusion
    params_path = os.path.join(model_dir, "params.npz")
    if not os.path.exists(params_path):
        raise SystemExit(f"no weights at {params_path}: the port reads the flat flax tree "
                         f"from params.npz (models/convert.py save_npz)")
    model = UNet2D(cfg.model, device=device)
    model.load_state_dict(flax_to_torch(load_npz(params_path), cfg.model))
    model.eval()
    return model, make_schedule(cfg.diffusion, device=device)


def batch_generator(seed: int, num: int, device) -> torch.Generator:
    """The generator that draws batch `num` of a run seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + num)


def quantize(x: torch.Tensor) -> np.ndarray:
    """[-1, 1] samples -> uint8 images, rounded (not truncated)."""
    arr01 = np.clip(x.float().cpu().numpy() / 2 + 0.5, 0.0, 1.0)
    return np.round(arr01 * 255).astype(np.uint8)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Scene generation (PyTorch)")
    parser.add_argument("--cfg_file", default=None, type=str)
    parser.add_argument("--model_dir", default=None, type=str)
    parser.add_argument("--output_dir", default=None, type=str)
    parser.add_argument("--sampler", default=None, choices=[None, "ddpm", "ddim", "dpm", "sde"])
    parser.add_argument("--steps", default=0, type=int)
    parser.add_argument("--batch_size", default=0, type=int)
    parser.add_argument("--num_batches", default=0, type=int)
    parser.add_argument("--seed", default=0, type=int)
    parser.add_argument("--eta", default=None, type=float,
                        help="DDIM stochasticity (0 = deterministic)")
    parser.add_argument("--spacing", default=None, choices=[None, "leading", "trailing"],
                        help="timestep spacing (default leading, diffusers parity)")
    parser.add_argument("--cond_dir", default=None, type=str,
                        help="conditional mode (not in the port yet)")
    parser.add_argument("--guidance", default=None, type=float,
                        help="classifier-free guidance scale (conditional mode)")
    parser.add_argument("--device", default="cuda", type=str)
    args = parser.parse_args(argv)

    cfg = load_config(args.cfg_file)
    gcfg = cfg.generation
    sampler = args.sampler or gcfg.sampler
    if sampler in ("dpm", "sde"):
        raise SystemExit(f"--sampler {sampler}: the DPM-Solver++ samplers come with the next "
                         f"slice of the port; use ddpm or ddim")
    if args.cond_dir is not None:
        raise SystemExit("--cond_dir: conditional generation (diffusion/cfg.py) comes with the "
                         "next slice of the port")
    device = resolve_device(args.device)
    model_dir = args.model_dir or gcfg.model_dir
    output_dir = args.output_dir or gcfg.output_dir
    steps = args.steps or (gcfg.ddim_steps if sampler == "ddim" else gcfg.num_inference_steps)
    batch_size = args.batch_size or gcfg.batch_size
    num_batches = args.num_batches or gcfg.num_batches
    os.makedirs(output_dir, exist_ok=True)

    model, schedule = load_model_for_sampling(cfg, model_dir, device)
    res = cfg.model.sample_size
    shape = (batch_size, res, res, cfg.model.out_channels)
    if sampler == "ddim":
        eta = args.eta if args.eta is not None else gcfg.ddim_eta
        fn = functools.partial(ddim_sample, eta=eta, spacing=args.spacing or "leading")
    else:
        fn = ddpm_sample

    total = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for num in range(num_batches):
            x = fn(model, schedule, shape, batch_generator(args.seed, num, device), steps)
            imgs = quantize(x)  # copies to the host, so the batch is finished here
            if num == 0:
                logger.info(f"first batch ({batch_size}) in {time.perf_counter() - t0:.1f}s")
            for i in range(imgs.shape[0]):
                from PIL import Image

                Image.fromarray(imgs[i]).save(
                    os.path.join(output_dir, f"loop_{num:03d}_batch_{i:03d}.png"))
            total += imgs.shape[0]
    dt = time.perf_counter() - t0
    logger.info(f"generated {total} scenes with {sampler}-{steps} on {device} in {dt:.1f}s "
                f"({total / dt:.3f} scenes/s)")
    return total / dt


if __name__ == "__main__":
    main()
