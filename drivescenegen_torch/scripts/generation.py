"""Sample scene rasters from a trained model (port of
drivescenegen_tpu/scripts/generation.py).

  python -m drivescenegen_torch.scripts.generation --model_dir <dir> \
      --sampler ddim|ddpm|dpm|sde [--steps N] --batch_size 8 --num_batches 4 \
      [--cond_dir <map rasters> --guidance 3] [--plain]

<model_dir> holds config.yaml (its model and diffusion sections are spliced
into the run's config) and params.npz, the flat flax parameter tree
(models/convert.py); a JAX package's model directory (orbax params/) is
converted first by tools/params_bridge.py to-npz. The default steps are ddim_steps for ddim, 20 for dpm
(DPM-Solver++(2M)), 25 for sde (its SDE variant) and num_inference_steps
for ddpm; the default spacing is trailing for dpm and sde, leading for
ddim and ddpm. With --cond_dir (a model with cond_channels > 0) batch
`num` is conditioned on the sorted PNGs of that directory, taken in turn
((num * B + i) % count), their first cond_channels channels mapped to
[-1, 1], under classifier-free guidance --guidance (default
generation.guidance_scale); each PNG then holds the cond channels first
and the sample after. Images are written as loop_NNN_batch_III.png,
rounded to uint8 from [-1, 1]; a one-channel sample (an unconditional
out_channels 1 model) as a gray PNG, where the JAX package's CLI raises
in PIL. Runs on --device (default cuda); --plain
runs PyTorch's library ops there instead of the kernels, for a model
outside their limits (models/unet2d.py kernel_limit_errors).

Batch-parallel under torchrun (parallel/mesh.py; `torchrun
--nproc_per_node N -m drivescenegen_torch.scripts.generation ...`): the
batch is rounded down to a multiple of the data axis (at least one row a
rank), as the JAX CLI rounds it; every rank draws batch `num`'s global x_T
and noise and samples its rows of them (row_draws), and writes those rows
under their global file names. So the PNGs of a W-rank run are those of
the one-process run with the same batch and seed. A mesh with mesh.model >
1 runs as the JAX CLI runs it: the parameters replicated, the data axis the
world over mesh.model; the ranks of a model group sample the same rows
(those of their data coordinate), and its model-index-0 rank writes them.
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import time

import numpy as np
import torch

from drivescenegen_torch.config import load_config
from drivescenegen_torch.data.dataset import load_image
from drivescenegen_torch.diffusion import (
    ddim_sample,
    ddpm_sample,
    dpmpp_2m_sample,
    dpmpp_2m_sde_sample,
    make_guided_denoise,
    make_schedule,
)
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, load_npz
from drivescenegen_torch.parallel import make_mesh
from drivescenegen_torch.utils import profiling
from drivescenegen_torch.utils.logging import get_logger

logger = get_logger("generation")


def load_model_for_sampling(cfg, model_dir: str, device, plain: bool = False):
    """Build the UNet + schedule on `device` and load <model_dir>/params.npz.
    The model/diffusion config sections are spliced from
    <model_dir>/config.yaml when it exists; cfg is updated in place.
    plain=True builds the model on PyTorch's library ops."""
    model_cfg_path = os.path.join(model_dir, "config.yaml")
    if os.path.exists(model_cfg_path):
        trained = load_config(model_cfg_path)
        cfg.model = trained.model
        cfg.diffusion = trained.diffusion
    params_path = os.path.join(model_dir, "params.npz")
    if not os.path.exists(params_path):
        msg = (f"no weights at {params_path}: the port reads the flat flax tree from params.npz "
               f"(models/convert.py save_npz)")
        if os.path.isdir(os.path.join(model_dir, "params")):
            msg += (f"; {model_dir}/params is the JAX package's orbax export: convert it with "
                    f"python tools/params_bridge.py to-npz --src {model_dir} --dst <dir>")
        raise SystemExit(msg)
    model = UNet2D(cfg.model, device=device, plain=plain)
    model.load_state_dict(flax_to_torch(load_npz(params_path), cfg.model))
    model.eval()
    return model, make_schedule(cfg.diffusion, device=device)


def batch_generator(seed: int, num: int, device) -> torch.Generator:
    """The generator that draws batch `num` of a run seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + num)


def row_draws(generator: torch.Generator, shape, rows: slice):
    """x_T and the per-step noise source of a batch, drawn at the global
    `shape` from `generator` in the samplers' order (x_T first, then one
    draw for each step that takes one) and cut to `rows`: with all rows,
    the draws the samplers make from the generator themselves."""
    def draw(_step=None):
        return torch.randn(tuple(shape), generator=generator, device=generator.device,
                           dtype=torch.float32)[rows]

    return draw(), draw


def rounded_batch(batch_size: int, n_data: int) -> int:
    """The batch rounded down to a multiple of the data axis, at least one
    row a rank (drivescenegen_tpu/scripts/generation.py:138-142)."""
    if batch_size % n_data == 0:
        return batch_size
    return max(n_data, (batch_size // n_data) * n_data)


def quantize(x: torch.Tensor) -> np.ndarray:
    """[-1, 1] samples -> uint8 images, rounded (not truncated): the copy to
    the host (span quantize.copy), then numpy's passes (quantize.host)."""
    with profiling.annotate("quantize.copy"):
        arr = x.float().cpu().numpy()
    with profiling.annotate("quantize.host"):
        arr01 = np.clip(arr / 2 + 0.5, 0.0, 1.0)
        return np.round(arr01 * 255).astype(np.uint8)


def cond_batch(files, num: int, batch_size: int, res: int, cond_channels: int, device):
    """The conditioning of batch `num`: the cond PNGs taken in turn, their
    first cond_channels channels, mapped to [-1, 1]."""
    sel = [files[(num * batch_size + i) % len(files)] for i in range(batch_size)]
    maps = np.stack([load_image(p, res)[..., :cond_channels] for p in sel])
    return torch.from_numpy((maps - 0.5) / 0.5).to(device)


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
                        help="timestep spacing (default trailing for dpm/sde, leading for "
                             "ddim/ddpm)")
    parser.add_argument("--cond_dir", default=None, type=str,
                        help="conditional mode: directory of rasters whose R/G map channels "
                             "condition the generation (a cond_channels > 0 model)")
    parser.add_argument("--guidance", default=None, type=float,
                        help="classifier-free guidance scale (conditional mode; 0 = "
                             "unconditional)")
    parser.add_argument("--device", default="cuda", type=str)
    parser.add_argument("--plain", action="store_true",
                        help="run PyTorch's library ops instead of the CUDA kernels, for a "
                             "model outside their limits")
    args = parser.parse_args(argv)

    cfg = load_config(args.cfg_file)
    gcfg = cfg.generation
    sampler = args.sampler or gcfg.sampler
    mesh = make_mesh(cfg.mesh, args.device)
    device = mesh.device
    model_dir = args.model_dir or gcfg.model_dir
    output_dir = args.output_dir or gcfg.output_dir
    steps = args.steps or {"ddim": gcfg.ddim_steps, "dpm": 20, "sde": 25}.get(
        sampler, gcfg.num_inference_steps)
    batch_size = args.batch_size or gcfg.batch_size
    num_batches = args.num_batches or gcfg.num_batches
    os.makedirs(output_dir, exist_ok=True)

    model, schedule = load_model_for_sampling(cfg, model_dir, device, plain=args.plain)
    conditional = args.cond_dir is not None
    if conditional and cfg.model.cond_channels <= 0:
        raise SystemExit("--cond_dir given but the model has cond_channels=0")
    res = cfg.model.sample_size
    n_data = mesh.shape["data"]
    if rounded_batch(batch_size, n_data) != batch_size:
        batch_size = rounded_batch(batch_size, n_data)
        logger.info(f"rounded batch to {batch_size} (data axis {n_data})")
    rows = mesh.rows(batch_size)
    shape = (batch_size, res, res, cfg.model.out_channels)
    local_shape = (rows.stop - rows.start,) + shape[1:]
    if sampler == "ddim":
        eta = args.eta if args.eta is not None else gcfg.ddim_eta
        fn = functools.partial(ddim_sample, eta=eta, spacing=args.spacing or "leading")
    elif sampler in ("dpm", "sde"):
        fn = functools.partial(dpmpp_2m_sample if sampler == "dpm" else dpmpp_2m_sde_sample,
                               spacing=args.spacing or "trailing")
    else:
        fn = ddpm_sample
    if conditional:
        cond_files = sorted(glob.glob(os.path.join(args.cond_dir, "*.png")))
        if not cond_files:
            raise SystemExit(f"no cond rasters under {args.cond_dir}")
        guidance = args.guidance if args.guidance is not None else gcfg.guidance_scale

    total = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        for num in range(num_batches):
            denoise, cond = model, None
            if conditional:
                cond = cond_batch(cond_files, num, batch_size, res, cfg.model.cond_channels,
                                  device)[rows]
                denoise = make_guided_denoise(model, cond, guidance)
            x_T, noise = row_draws(batch_generator(args.seed, num, device), shape, rows)
            kw = {} if sampler == "dpm" else {"noise": noise}  # DPM-Solver++(2M) draws x_T only
            x = fn(denoise, schedule, local_shape, None, steps, x_T=x_T, **kw)
            if cond is not None:
                x = torch.cat([cond, x], dim=-1)  # map R/G, then the sample
            imgs = quantize(x)  # copies to the host, so the batch is finished here
            if num == 0:
                logger.info(f"first batch ({batch_size}) in {time.perf_counter() - t0:.1f}s")
            if imgs.shape[-1] == 1:
                imgs = imgs[..., 0]  # PIL takes no [H, W, 1] array: a gray PNG
            for i in range(imgs.shape[0] if mesh.model_index == 0 else 0):
                from PIL import Image

                Image.fromarray(imgs[i]).save(os.path.join(
                    output_dir, f"loop_{num:03d}_batch_{rows.start + i:03d}.png"))
            total += imgs.shape[0]
    mesh.barrier()
    mesh.close()
    dt = time.perf_counter() - t0
    mode = f"cfg(g={guidance})" if conditional else "uncond"
    logger.info(f"generated {total} scenes with {sampler}-{steps} {mode} on {device} in {dt:.1f}s "
                f"({total / dt:.3f} scenes/s)")
    return total / dt


if __name__ == "__main__":
    main()
