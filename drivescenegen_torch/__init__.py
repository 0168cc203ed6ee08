"""drivescenegen_torch — the PyTorch/CUDA port of drivescenegen_tpu for
NVIDIA Hopper (H100).

It covers the sampling path: the UNet2D epsilon model
(models/unet2d.py) inside the DDPM/DDIM samplers (diffusion/), with the
model's GroupNorm+SiLU+conv3x3, GroupNorm+SiLU and attention hot spots as
kernels written by hand for sm_90a (ops/, csrc/). It also covers training
on one GPU (training/, data/, scripts/train.py), where the attention runs
its forward and backward kernels. Public functions keep the
JAX package's NHWC layout. Entry points run on "cuda" unless the caller
passes device="cpu"; on a CPU tensor every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
from drivescenegen_torch.models.unet2d import UNet2D  # noqa: F401,E402
