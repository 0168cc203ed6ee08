"""DDPM ancestral and DDIM samplers (port of
drivescenegen_tpu/diffusion/samplers.py:24-183).

Semantics match diffusers' DDPMScheduler.step (variance "fixed_small",
clip_sample) and DDIMScheduler.step (leading or trailing timestep spacing,
eta, set_alpha_to_one). Each step goes to the timestep the chain visits
next; the final target is -1 with alpha_bar 1.

`denoise_fn(x, t) -> eps`, with x [B, H, W, C] float32 and t a 0-dim int64
tensor on the schedule's device.

JAX's threefry draws cannot be reproduced here, so the random inputs can be
given: `x_T` ([B, H, W, C]) and `noise`, either a callable `i -> tensor` or
a tensor [n_steps, B, H, W, C]. What is not given is drawn from
`generator`, x_T first and then one draw per step, in step order.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from drivescenegen_torch.diffusion.schedule import DiffusionSchedule

NoiseSource = Union[None, torch.Tensor, Callable[[int], torch.Tensor]]


def ddpm_timesteps(schedule: DiffusionSchedule, num_inference_steps: int) -> torch.Tensor:
    """Descending int64 timesteps (diffusers DDPMScheduler.set_timesteps),
    with its integer stride: at T=1000 and 750 steps the stride is 1 and
    the timesteps are 749..0."""
    T = schedule.num_train_timesteps
    n = min(num_inference_steps, T)
    step_ratio = T // n
    ts = torch.arange(0, n, dtype=torch.int64) * step_ratio
    return ts.flip(0)


def ddim_timesteps(
    schedule: DiffusionSchedule, num_inference_steps: int, spacing: str = "leading"
) -> torch.Tensor:
    """Descending int64 timesteps. "leading" is the diffusers DDIMScheduler
    default; "trailing" starts at T-1 (arXiv:2305.08891)."""
    if spacing == "leading":
        return ddpm_timesteps(schedule, num_inference_steps)
    if spacing != "trailing":
        raise ValueError(f"unknown timestep spacing {spacing!r}")
    T = schedule.num_train_timesteps
    n = min(num_inference_steps, T)
    # The JAX code's arithmetic: the length of arange(T, 0, -T/n) in double
    # precision, float32 values, round half to even.
    count = len(np.arange(T, 0, -(T / n)))
    grid = np.arange(T, 0, -np.float32(T / n), dtype=np.float32)[:count]
    return torch.from_numpy((np.round(grid) - 1).astype(np.int64))


def _acp(schedule: DiffusionSchedule, t: int) -> torch.Tensor:
    """alpha_bar at t, with alpha_bar(-1) = 1 (set_alpha_to_one)."""
    if t >= 0:
        return schedule.alphas_cumprod[t]
    return torch.ones((), dtype=torch.float32, device=schedule.device)


def ddpm_step(
    schedule: DiffusionSchedule,
    x_t: torch.Tensor,
    eps: torch.Tensor,
    t: int,
    prev_t: int,
    noise: Optional[torch.Tensor],
) -> torch.Tensor:
    """One ancestral DDPM step x_t -> x_{prev_t} (DDPMScheduler.step)."""
    acp_t = _acp(schedule, t)
    acp_prev = _acp(schedule, prev_t)
    beta_prod_t = 1.0 - acp_t
    beta_prod_prev = 1.0 - acp_prev
    alpha_t = acp_t / acp_prev
    beta_t = 1.0 - alpha_t

    x0 = schedule.pred_x0_from_eps(x_t, eps, t)
    x0_coeff = acp_prev.sqrt() * beta_t / beta_prod_t
    xt_coeff = alpha_t.sqrt() * beta_prod_prev / beta_prod_t
    mean = x0_coeff * x0 + xt_coeff * x_t
    if t <= 0:
        return mean
    # variance_type == "fixed_small"
    variance = (beta_prod_prev / beta_prod_t * beta_t).clamp(min=1e-20)
    return mean + variance.sqrt() * noise


def ddim_step(
    schedule: DiffusionSchedule,
    x_t: torch.Tensor,
    eps: torch.Tensor,
    t: int,
    prev_t: int,
    noise: Optional[torch.Tensor],
    eta: float = 0.0,
) -> torch.Tensor:
    """One DDIM step (DDIMScheduler.step, set_alpha_to_one=True)."""
    acp_t = _acp(schedule, t)
    acp_prev = _acp(schedule, prev_t)

    x0 = schedule.pred_x0_from_eps(x_t, eps, t)
    # Recompute eps from the (possibly clipped) x0, as diffusers does.
    eps = (x_t - acp_t.sqrt() * x0) / (1.0 - acp_t).sqrt()

    variance = (1.0 - acp_prev) / (1.0 - acp_t) * (1.0 - acp_t / acp_prev)
    sigma = eta * variance.clamp(min=0.0).sqrt()
    dir_xt = (1.0 - acp_prev - sigma**2).clamp(min=0.0).sqrt() * eps
    x_prev = acp_prev.sqrt() * x0 + dir_xt
    if eta > 0:
        x_prev = x_prev + sigma * noise
    return x_prev


def _noise_at(noise: NoiseSource, i: int, shape, device, generator) -> torch.Tensor:
    if noise is None:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    if callable(noise):
        return noise(i).to(device=device, dtype=torch.float32)
    return noise[i].to(device=device, dtype=torch.float32)


def _sample_loop(
    denoise_fn: Callable,
    schedule: DiffusionSchedule,
    shape,
    timesteps: torch.Tensor,
    step_fn: Callable,
    needs_noise: Callable[[int], bool],
    generator: Optional[torch.Generator],
    x_T: Optional[torch.Tensor],
    noise: NoiseSource,
) -> torch.Tensor:
    device = schedule.device
    shape = tuple(shape)
    if generator is None and (x_T is None or noise is None):
        raise ValueError("pass a torch.Generator, or both x_T and noise")
    if x_T is None:
        x = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    else:
        x = x_T.to(device=device, dtype=torch.float32)
    ts = [int(t) for t in timesteps]
    prev = ts[1:] + [-1]
    t_dev = timesteps.to(device)
    for i, (t, prev_t) in enumerate(zip(ts, prev)):
        eps = denoise_fn(x, t_dev[i]).float()
        z = _noise_at(noise, i, shape, device, generator) if needs_noise(t) else None
        x = step_fn(x, eps, t, prev_t, z)
    return x


def ddpm_sample(
    denoise_fn: Callable,
    schedule: DiffusionSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    num_inference_steps: int = 750,
    x_T: Optional[torch.Tensor] = None,
    noise: NoiseSource = None,
) -> torch.Tensor:
    """Ancestral DDPM sampling from pure noise. Returns x0 in [-1, 1]."""
    ts = ddpm_timesteps(schedule, num_inference_steps)

    def step_fn(x, eps, t, prev_t, z):
        return ddpm_step(schedule, x, eps, t, prev_t, z)

    return _sample_loop(denoise_fn, schedule, shape, ts, step_fn,
                        lambda t: t > 0, generator, x_T, noise)


def ddim_sample(
    denoise_fn: Callable,
    schedule: DiffusionSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    num_inference_steps: int = 50,
    eta: float = 0.0,
    spacing: str = "leading",
    x_T: Optional[torch.Tensor] = None,
    noise: NoiseSource = None,
) -> torch.Tensor:
    """DDIM sampling — the fast path (50 steps). At eta=0 no per-step noise
    is drawn."""
    ts = ddim_timesteps(schedule, num_inference_steps, spacing=spacing)

    def step_fn(x, eps, t, prev_t, z):
        return ddim_step(schedule, x, eps, t, prev_t, z, eta=eta)

    return _sample_loop(denoise_fn, schedule, shape, ts, step_fn,
                        lambda t: eta > 0, generator, x_T, noise)
