"""DDPM ancestral, DDIM and DPM-Solver++(2M) (ODE and SDE) samplers (port
of drivescenegen_tpu/diffusion/samplers.py).

Semantics match diffusers' DDPMScheduler.step (variance "fixed_small",
clip_sample), DDIMScheduler.step (leading or trailing timestep spacing,
eta, set_alpha_to_one) and DPMSolverMultistepScheduler (solver_order 2,
"dpmsolver++" or "sde-dpmsolver++", final_sigmas_type "zero",
lower_order_final). Each step goes to the timestep the chain visits next;
the final target is -1 with alpha_bar 1.

`denoise_fn(x, t) -> eps`, with x [B, H, W, C] float32 and t a 0-dim int64
tensor on the schedule's device.

JAX's threefry draws cannot be reproduced here, so the random inputs can be
given: `x_T` ([B, H, W, C]) and `noise`, either a callable `i -> tensor` or
a tensor [n_steps, B, H, W, C]. What is not given is drawn from
`generator`, x_T first and then one draw per step, in step order.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import numpy as np
import torch

from drivescenegen_torch.diffusion.schedule import DiffusionSchedule
from drivescenegen_torch.utils import profiling

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


def _initial_x(shape, device, generator: Optional[torch.Generator],
               x_T: Optional[torch.Tensor], noise_missing: bool) -> torch.Tensor:
    """x_T as given, or the generator's first draw."""
    if generator is None and (x_T is None or noise_missing):
        raise ValueError("pass a torch.Generator, or x_T and (where the sampler draws per-step "
                         "noise) noise")
    if x_T is None:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return x_T.to(device=device, dtype=torch.float32)


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
    x = _initial_x(shape, device, generator, x_T, noise_missing=noise is None)
    ts = [int(t) for t in timesteps]
    prev = ts[1:] + [-1]
    t_dev = timesteps.to(device)
    for i, (t, prev_t) in enumerate(zip(ts, prev)):
        with profiling.annotate("sampler.step"):
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


def dpmpp_2m_coefficients(schedule: DiffusionSchedule, num_inference_steps: int,
                          spacing: str = "trailing", sde: bool = False
                          ) -> Dict[str, torch.Tensor]:
    """The per-step coefficients of DPM-Solver++(2M), or of its SDE variant
    (sde=True), in float32 on the schedule's device, computed as the JAX
    samplers compute them (drivescenegen_tpu/diffusion/samplers.py:216-241,
    :299-320). With x0_i the data prediction of step i, each step is

        D = w_c x0_i + w_p x0_{i-1};   x <- c_x x + c_d D  (+ c_n z).

    Returns "timesteps" (int64, on the CPU), "c_x", "c_d", "w_c", "w_p" and,
    for the SDE, "c_n", each [n]. The final target has alpha 1 and sigma 0,
    so lambda = +inf there: c_x = 0, c_d = 1 and c_n = 0 come out exact.
    Steps 0 (no history) and n-1 run first order (w_c = 1, w_p = 0); at
    n = 1, step 0 only."""
    ts = ddim_timesteps(schedule, num_inference_steps, spacing=spacing)
    n = ts.numel()
    acp = schedule.alphas_cumprod
    one = torch.ones(1, dtype=acp.dtype, device=acp.device)
    ts_dev = ts.to(acp.device)
    acp_cur = acp[ts_dev]
    acp_prev = torch.cat([acp[ts_dev[1:]], one])
    alpha_c, sigma_c = acp_cur.sqrt(), (1.0 - acp_cur).sqrt()
    alpha_p, sigma_p = acp_prev.sqrt(), (1.0 - acp_prev).sqrt()
    lam_c = alpha_c.log() - sigma_c.log()
    lam_p = alpha_p.log() - sigma_p.log()  # +inf at the final target
    h = lam_p - lam_c  # [n], positive; +inf at the final step
    out = {"timesteps": ts}
    if sde:
        e2h = torch.exp(-2.0 * h)  # 0 at the final step
        out["c_x"] = sigma_p / sigma_c * torch.exp(-h)
        out["c_d"] = alpha_p * (1.0 - e2h)
        out["c_n"] = sigma_p * (1.0 - e2h).clamp(min=0.0).sqrt()
    else:
        out["c_x"] = sigma_p / sigma_c
        out["c_d"] = alpha_p * (1.0 - torch.exp(-h))
    # r_i = h_{i-1} / h_i. At the final step r = 0 and the weights are
    # ~5e19 (at n = 1, NaN) until the first-order steps replace them.
    h_prev = torch.cat([h[:1], h[:-1]])
    r = (h_prev / h.clamp(min=1e-20)).clamp(min=1e-20)
    first_order = torch.zeros(n, dtype=torch.bool, device=acp.device)
    first_order[0] = True
    first_order[n - 1] = True
    out["w_c"] = torch.where(first_order, one, 1.0 + 1.0 / (2.0 * r))
    out["w_p"] = torch.where(first_order, torch.zeros_like(one), -1.0 / (2.0 * r))
    return out


def _dpmpp_loop(denoise_fn: Callable, schedule: DiffusionSchedule, shape,
                coeffs: Dict[str, torch.Tensor], generator: Optional[torch.Generator],
                x_T: Optional[torch.Tensor], noise: NoiseSource) -> torch.Tensor:
    """The multistep loop over (x, x0_prev), the JAX samplers' scan carry."""
    device = schedule.device
    shape = tuple(shape)
    sde = "c_n" in coeffs
    x = _initial_x(shape, device, generator, x_T, noise_missing=sde and noise is None)
    x0_prev = torch.zeros_like(x)
    t_dev = coeffs["timesteps"].to(device)
    c_x, c_d, w_c, w_p = (coeffs[k] for k in ("c_x", "c_d", "w_c", "w_p"))
    for i in range(t_dev.numel()):
        with profiling.annotate("sampler.step"):
            eps = denoise_fn(x, t_dev[i]).float()
            x0 = schedule.pred_x0_from_eps(x, eps, t_dev[i])
            x_next = c_x[i] * x + c_d[i] * (w_c[i] * x0 + w_p[i] * x0_prev)
            if sde:
                # One draw at every step, the last included (its c_n is 0).
                z = _noise_at(noise, i, shape, device, generator)
                x_next = x_next + coeffs["c_n"][i] * z
            x, x0_prev = x_next, x0
    return x


def dpmpp_2m_sample(
    denoise_fn: Callable,
    schedule: DiffusionSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    num_inference_steps: int = 20,
    spacing: str = "trailing",
    x_T: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """DPM-Solver++(2M), the deterministic second-order multistep solver of
    the probability-flow ODE in data-prediction form (Lu et al.,
    arXiv:2211.01095): ~20 steps for the quality DDIM reaches in ~50. It
    draws x_T only."""
    coeffs = dpmpp_2m_coefficients(schedule, num_inference_steps, spacing)
    return _dpmpp_loop(denoise_fn, schedule, shape, coeffs, generator, x_T, None)


def dpmpp_2m_sde_sample(
    denoise_fn: Callable,
    schedule: DiffusionSchedule,
    shape,
    generator: Optional[torch.Generator] = None,
    num_inference_steps: int = 25,
    spacing: str = "trailing",
    x_T: Optional[torch.Tensor] = None,
    noise: NoiseSource = None,
) -> torch.Tensor:
    """SDE-DPM-Solver++(2M): the stochastic second-order multistep solver,
    which re-injects noise each step as ancestral sampling does,

        x <- (sigma_p/sigma_c) e^-h x + alpha_p (1 - e^-2h) D
             + sigma_p sqrt(1 - e^-2h) z,

    with D the deterministic 2M's data combination. It draws x_T, then one
    z per step, the last included."""
    coeffs = dpmpp_2m_coefficients(schedule, num_inference_steps, spacing, sde=True)
    return _dpmpp_loop(denoise_fn, schedule, shape, coeffs, generator, x_T, noise)
