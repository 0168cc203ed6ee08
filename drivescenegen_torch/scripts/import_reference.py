"""Import a reference diffusers UNet2DModel checkpoint into a model
directory the port samples (port of
drivescenegen_tpu/scripts/import_reference.py).

The reference publishes its trained model via DDPMPipeline.save_pretrained
(reference: pipeline/training_pipeline.py:106-107) — config.json +
diffusion_pytorch_model.safetensors/.bin. This CLI converts that directory
into the port's model_dir layout (config.yaml + params.npz, the flat flax
tree of models/convert.py), after which the port's CLIs read it unchanged:

  python -m drivescenegen_torch.scripts.import_reference \
      --src /path/to/model_dxdy_agents_256_s80/unet \
      --dst ./outputs/imported_reference
  python -m drivescenegen_torch.scripts.generation \
      --model_dir ./outputs/imported_reference [--plain] ...

The imported config pins torch_pad_downsample=True and the diffusers
attention_head_dim (8 when config.json names none, as the reference's
does). The closing "sample with:" line adds --plain when the model is
outside the CUDA kernels' limits (models/unet2d.py kernel_limit_errors),
as narrower widths than the reference's are; the reference's own
architecture (widths 64/128/256/512, head dim 8) runs every kernel, and
its config.yaml, as the train CLI's --cfg_file, trains that architecture
on them too (the head-dim-8 attention forward with lse and backward).
Host work only: nothing runs on a device.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description="diffusers -> port model_dir import")
    parser.add_argument("--src", required=True,
                        help="diffusers UNet2DModel dir (or pipeline dir "
                             "containing unet/)")
    parser.add_argument("--dst", required=True,
                        help="output model_dir (config.yaml + params.npz)")
    args = parser.parse_args(argv)

    import numpy as np

    from drivescenegen_torch.config import load_config, save_config
    from drivescenegen_torch.models.convert import save_npz
    from drivescenegen_torch.models.import_diffusers import import_unet2d
    from drivescenegen_torch.models.unet2d import kernel_limit_errors

    model_cfg, flat = import_unet2d(args.src)

    os.makedirs(args.dst, exist_ok=True)
    cfg = load_config(None)
    cfg.model = model_cfg
    save_config(cfg, os.path.join(args.dst, "config.yaml"))
    save_npz(os.path.join(args.dst, "params.npz"), flat)

    n = sum(int(np.prod(np.shape(p))) for p in flat.values())
    print(f"imported {n:,} parameters from {args.src} -> {args.dst}")
    limits = kernel_limit_errors(model_cfg)
    for why in limits:
        print(f"outside the CUDA kernels' limits: {why}")
    print("sample with: python -m drivescenegen_torch.scripts.generation "
          f"--model_dir {args.dst}" + (" --plain" if limits else ""))


if __name__ == "__main__":
    main()
