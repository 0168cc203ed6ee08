"""DDPM noise schedule (port of drivescenegen_tpu/diffusion/schedule.py):
diffusers DDPMScheduler() defaults — 1000 steps, linear betas 1e-4..0.02,
epsilon prediction, clip_sample=True.

Every coefficient array is float32 on the schedule's device, as in the JAX
code, so the samplers index it without host round trips.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from drivescenegen_torch.config import DiffusionConfig
from drivescenegen_torch.utils.device import resolve_device


def _bcast(coef: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Broadcast a scalar or [B] coefficient against x's trailing dims."""
    return coef.reshape(tuple(coef.shape) + (1,) * (x.dim() - coef.dim()))


@dataclass
class DiffusionSchedule:
    betas: torch.Tensor  # [T] float32
    alphas: torch.Tensor
    alphas_cumprod: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    num_train_timesteps: int
    clip_sample: bool
    prediction_type: str

    @property
    def device(self) -> torch.device:
        return self.alphas_cumprod.device

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t) -> torch.Tensor:
        """Forward diffusion q(x_t | x_0); `t` is a scalar or [B]."""
        t = torch.as_tensor(t, device=self.device)
        sqrt_acp = _bcast(self.sqrt_alphas_cumprod[t], x0)
        sqrt_1macp = _bcast(self.sqrt_one_minus_alphas_cumprod[t], x0)
        return sqrt_acp * x0.float() + sqrt_1macp * noise

    def pred_x0_from_eps(self, x_t: torch.Tensor, eps: torch.Tensor, t) -> torch.Tensor:
        t = torch.as_tensor(t, device=self.device)
        sqrt_acp = _bcast(self.sqrt_alphas_cumprod[t], x_t)
        sqrt_1macp = _bcast(self.sqrt_one_minus_alphas_cumprod[t], x_t)
        x0 = (x_t - sqrt_1macp * eps) / sqrt_acp
        if self.clip_sample:
            x0 = x0.clamp(-1.0, 1.0)
        return x0


def make_schedule(cfg: DiffusionConfig | None = None, device="cuda") -> DiffusionSchedule:
    cfg = cfg or DiffusionConfig()
    device = resolve_device(device)
    T = cfg.num_train_timesteps
    f32 = torch.float32
    if cfg.beta_schedule == "linear":
        betas = torch.linspace(cfg.beta_start, cfg.beta_end, T, dtype=f32)
    elif cfg.beta_schedule == "scaled_linear":
        betas = torch.linspace(cfg.beta_start**0.5, cfg.beta_end**0.5, T, dtype=f32) ** 2
    elif cfg.beta_schedule == "squaredcos_cap_v2":
        # Nichol & Dhariwal cosine schedule.
        def alpha_bar(s):
            return torch.cos((s + 0.008) / 1.008 * math.pi / 2) ** 2

        s = torch.arange(T, dtype=f32)
        betas = (1.0 - alpha_bar((s + 1) / T) / alpha_bar(s / T)).clamp(0.0, 0.999)
    else:
        raise ValueError(f"unknown beta schedule {cfg.beta_schedule!r}")

    alphas = 1.0 - betas
    alphas_cumprod = torch.cumprod(alphas, dim=0)
    return DiffusionSchedule(
        betas=betas.to(device),
        alphas=alphas.to(device),
        alphas_cumprod=alphas_cumprod.to(device),
        sqrt_alphas_cumprod=alphas_cumprod.sqrt().to(device),
        sqrt_one_minus_alphas_cumprod=(1.0 - alphas_cumprod).sqrt().to(device),
        num_train_timesteps=T,
        clip_sample=cfg.clip_sample,
        prediction_type=cfg.prediction_type,
    )
