"""The plain reference of what the sampling and training cells drive: the
linear-beta schedule, DDIM (eta 0, leading spacing), classifier-free
guidance, the uint8 quantize, and the training step (the epsilon MSE, the
global-norm clip, AdamW under a linear warmup).

diffusers' DDPMScheduler defaults: 1000 steps, betas linear from 1e-4 to
0.02 in float32, alphas_cumprod their cumulative product; DDIMScheduler
with set_alpha_to_one (the last step goes to alpha_bar 1), clip_sample
(x0 clamped to [-1, 1]) and eps recomputed from the clipped x0. Training
follows optax: the global norm over every gradient, a scale of max/norm
only where norm >= max, and AdamW with decoupled weight decay and the
learning rate of the step count before the update. Imports nothing of the
program.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch

T_TRAIN, BETA_START, BETA_END = 1000, 1e-4, 0.02


def alphas_cumprod(device) -> torch.Tensor:
    betas = torch.linspace(BETA_START, BETA_END, T_TRAIN, dtype=torch.float32)
    return torch.cumprod(1.0 - betas, dim=0).to(device)


def ddim_timesteps(steps: int) -> List[int]:
    """Leading spacing: 980, 960, ..., 0 for 50 steps of 1000."""
    ratio = T_TRAIN // steps
    return [i * ratio for i in reversed(range(steps))]


def ddim_chain(denoise: Callable, x_T: torch.Tensor, steps: int) -> torch.Tensor:
    """DDIM at eta 0 from x_T [B, H, W, C]: x0 in [-1, 1]."""
    acp = alphas_cumprod(x_T.device)
    ts = ddim_timesteps(steps)
    x = x_T.float()
    for t, prev in zip(ts, ts[1:] + [-1]):
        a_t = acp[t]
        a_prev = acp[prev] if prev >= 0 else torch.ones((), device=x.device)
        eps = denoise(x, torch.full((x.shape[0],), t, device=x.device, dtype=torch.int64))
        x0 = ((x - (1 - a_t).sqrt() * eps) / a_t.sqrt()).clamp(-1.0, 1.0)
        eps = (x - a_t.sqrt() * x0) / (1 - a_t).sqrt()
        x = a_prev.sqrt() * x0 + (1 - a_prev).sqrt() * eps
    return x


def guided(model: Callable, cond: torch.Tensor, scale: float) -> Callable:
    """eps_u + g (eps_c - eps_u), the unconditional branch on zero cond."""

    def denoise(x, t):
        eps_c = model(x, t, cond)
        eps_u = model(x, t, torch.zeros_like(cond))
        return eps_u + scale * (eps_c - eps_u)

    return denoise


def quantize(x: torch.Tensor) -> np.ndarray:
    """[-1, 1] -> uint8, rounded half to even as numpy rounds."""
    return np.round(np.clip(x.detach().float().cpu().numpy() / 2 + 0.5, 0.0, 1.0) * 255
                    ).astype(np.uint8)


def warmup_lr(count: int, peak: float, warmup: int) -> float:
    """The learning rate at step count `count` inside the warmup: optax's
    linear schedule from 0 to `peak`, (0 - peak) (1 - count / warmup) +
    peak, in float32."""
    if count >= warmup:
        raise ValueError("the reference follows the warmup only")
    f32 = np.float32
    return float((f32(0) - f32(peak)) * (f32(1) - f32(count) / f32(warmup)) + f32(peak))


def diffusion_loss(model: Callable, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor,
                   rows_total: int) -> torch.Tensor:
    """This block of rows' share of the batch's mean squared error:
    sum over its rows of their mean, over the whole batch's rows."""
    acp = alphas_cumprod(x0.device)[t][:, None, None, None]
    x_t = acp.sqrt() * x0 + (1 - acp).sqrt() * noise
    err = (model(x_t, t) - noise) ** 2
    return err.flatten(1).mean(1).sum() / rows_total


def clip_by_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> torch.Tensor:
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).float()
    if norm >= max_norm:
        for g in grads.values():
            g.mul_(max_norm / norm)
    return norm


class AdamW:
    """torch's and optax's AdamW over a dict of float32 tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], b1: float, b2: float, eps: float,
                 weight_decay: float):
        self.p = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.b1, self.b2, self.eps, self.wd, self.t = b1, b2, eps, weight_decay, 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], lr: float) -> None:
        self.t += 1
        c1, c2 = 1 - self.b1 ** self.t, 1 - self.b2 ** self.t
        for k, p in self.p.items():
            g = grads[k]
            p.mul_(1 - lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            denom = (self.v[k].sqrt() / (c2 ** 0.5)).add_(self.eps)
            p.addcdiv_(self.m[k], denom, value=-lr / c1)
