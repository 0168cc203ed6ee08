"""drivescenegen_torch — the PyTorch/CUDA port of drivescenegen_tpu for
NVIDIA Hopper (H100).

It covers the sampling path: the UNet2D epsilon model
(models/unet2d.py) inside the DDPM/DDIM samplers (diffusion/), with the
model's GroupNorm+SiLU+conv3x3, GroupNorm+SiLU and attention hot spots as
kernels written by hand for sm_90a (ops/, csrc/). It also covers training
on one GPU (training/, data/, scripts/train.py), where the attention runs
its forward and backward kernels, and stage 2 (ops/lane_mask.py,
ops/morphology.py, vectorize/, scripts/vectorization.py and
scripts/end_to_end.py), and the data front end and evaluation (data/,
ops/raster.py on the card, eval/map_metrics.py, scripts/data_preprocess.py,
scripts/data_rasterization.py, scripts/compute_map_metrics.py and
scripts/run_demo.py). Public functions keep the
JAX package's NHWC layout. Entry points run on "cuda" unless the caller
passes device="cpu"; on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"


def __getattr__(name):
    # UNet2D on first use, so that importing a torch-free module of the
    # package (the stage-2 workers' vectorize/*) does not import torch.
    if name == "UNet2D":
        from drivescenegen_torch.models.unet2d import UNet2D

        return UNet2D
    raise AttributeError(f"module 'drivescenegen_torch' has no attribute {name!r}")
