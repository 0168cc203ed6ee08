"""Faults planted in the port's timed path, to see the check that decides
`correct` catch them (benchmark/tests, and calibrate.py on the card). Each
is a context manager that patches one function of the program and puts it
back on exit:

- unchanged_state: a step returns its state unchanged (sampling: the DDIM
  update hands x_t back; training: AdamW's step does nothing);
- half_batch: half of the batch left out (sampling: the denoiser runs on
  the first half of its rows and repeats them; training: the loss is the
  mean over the first half of the rows);
- altered_answer: an answer altered where it is produced (sampling: the
  quantized scenes inverted; training: the loss doubled);
- attention_scale: a wrong attention kernel, its softmax scale doubled (the
  mid block's attention, forward and, in training, backward, at the head
  dim the configuration states).
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from drivescenegen_torch import ops
from drivescenegen_torch.diffusion import samplers
from drivescenegen_torch.models import unet2d
from drivescenegen_torch.scripts import generation
from drivescenegen_torch.training import trainer


@contextlib.contextmanager
def patched(owner, name: str, value):
    old = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, old)


def unchanged_state(kind: str):
    if kind == "sample":
        return patched(samplers, "ddim_step", lambda schedule, x_t, *a, **k: x_t)
    return patched(torch.optim.AdamW, "step", lambda self, closure=None: None)


def half_batch(kind: str):
    if kind == "sample":
        forward = unet2d.UNet2D.forward

        def first_half(self, x, t, cond=None, dropout=None):
            h = x.shape[0] // 2
            t = torch.as_tensor(t, device=x.device).reshape(-1).expand(x.shape[0])
            out = forward(self, x[:h], t[:h], None if cond is None else cond[:h], dropout)
            return torch.cat([out, out], dim=0)

        return patched(unet2d.UNet2D, "forward", first_half)
    loss = trainer.diffusion_loss

    def half_loss(model, schedule, target, noise, t, cond=None, dropout=None):
        h = target.shape[0] // 2
        return loss(model, schedule, target[:h], noise[:h], t[:h],
                    None if cond is None else cond[:h], dropout)

    return patched(trainer, "diffusion_loss", half_loss)


def altered_answer(kind: str):
    if kind == "sample":
        quantize = generation.quantize
        return patched(generation, "quantize", lambda x: np.uint8(255) - quantize(x))
    loss = trainer.diffusion_loss
    return patched(trainer, "diffusion_loss", lambda *a, **k: 2.0 * loss(*a, **k))


def attention_scale(kind: str):
    attention = ops.attention
    return patched(ops, "attention", lambda q, k, v, scale: attention(q, k, v, 2.0 * scale))


FAULTS = {"unchanged_state": unchanged_state, "half_batch": half_batch,
          "altered_answer": altered_answer, "attention_scale": attention_scale}
