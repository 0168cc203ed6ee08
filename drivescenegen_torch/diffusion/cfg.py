"""Classifier-free guidance for the map-conditioned model (port of
drivescenegen_tpu/diffusion/cfg.py).

The conditional UNet takes the map layers (R/G lane-direction channels)
concatenated to its input; the unconditional branch sees zero
conditioning, the null token that cond-dropout trains. Guided prediction:
eps = eps_uncond + g * (eps_cond - eps_uncond), both branches in one
forward over a doubled batch.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch


def make_guided_denoise(model: Callable, cond: torch.Tensor,
                        guidance_scale: float = 1.0) -> Callable:
    """denoise_fn(x, t) -> eps with classifier-free guidance, for
    `model(x, t, cond)` and cond [B, H, W, C_cond]. guidance_scale 0 is
    unconditional, 1 plain conditional (one forward, no batch doubling),
    > 1 amplified guidance."""
    if guidance_scale == 1.0:

        def denoise_cond(x, t):
            return model(x, t, cond)

        return denoise_cond

    cond2 = torch.cat([cond, torch.zeros_like(cond)], dim=0)

    def denoise_guided(x, t):
        eps_c, eps_u = model(torch.cat([x, x], dim=0), t, cond2).chunk(2, dim=0)
        return eps_u + guidance_scale * (eps_c - eps_u)

    return denoise_guided


def apply_cond_dropout(cond: torch.Tensor, dropout_prob: float,
                       generator: Optional[torch.Generator] = None,
                       keep: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Zero the conditioning per sample with probability dropout_prob (it
    trains the null branch guidance uses). `keep` ([B] bool) is the mask,
    drawn from `generator` as uniform < 1 - dropout_prob when not given.
    cond itself when dropout_prob <= 0."""
    if dropout_prob <= 0.0:
        return cond
    B = cond.shape[0]
    if keep is None:
        if generator is None:
            raise ValueError("apply_cond_dropout: pass a torch.Generator or the keep mask")
        keep = torch.rand(B, generator=generator, device=cond.device) < 1.0 - dropout_prob
    shape = (B,) + (1,) * (cond.dim() - 1)
    return cond * keep.to(device=cond.device, dtype=cond.dtype).reshape(shape)
