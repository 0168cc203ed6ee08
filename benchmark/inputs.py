"""Everything a run feeds the program, made from --seed: the weights (the
flat parameter tree), each batch's x_T and cond rasters, each training
step's noise and t, the training corpus and its order. The same seed gives
the same inputs, and the reference is handed these same inputs.

Draws on the card use a torch.Generator there, seeded per purpose and per
batch or step (sub_seed), so that a batch's inputs can be drawn again for
the reference without drawing every batch before it.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference.unet import param_shapes
from drivescenegen_torch.models.convert import flax_path


def sub_seed(seed: int, purpose: str, index: int = 0) -> int:
    """A 63-bit seed for one purpose and index of a run's seed."""
    digest = hashlib.sha256(f"{seed}/{purpose}/{index}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(seed: int, purpose: str, index: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, purpose, index))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The flat parameter tree, float32, drawn in one call into one buffer:
    kernels normal with std 1/sqrt(fan_in) (lecun normal), biases normal
    with std 0.02, norm scales 1 + normal with std 0.1. Each leaf is a view
    of the buffer."""
    shapes = param_shapes(cfg)
    sizes = [math.prod(s) for s in shapes.values()]
    std, mean = [], []
    for key, shape in shapes.items():
        if key.endswith("/kernel"):
            std.append(1.0 / math.sqrt(math.prod(shape[:-1])))
            mean.append(0.0)
        elif key.endswith("/scale"):
            std.append(0.1)
            mean.append(1.0)
        else:
            std.append(0.02)
            mean.append(0.0)
    counts = torch.tensor(sizes, device=device)
    buf = torch.randn(sum(sizes), generator=generator(seed, "weights", 0, device), device=device)
    buf.mul_(torch.repeat_interleave(torch.tensor(std, device=device), counts))
    buf.add_(torch.repeat_interleave(torch.tensor(mean, device=device), counts))
    return dict(zip(shapes, (v.view(s) for v, s in zip(buf.split(sizes), shapes.values()))))


def port_state_dict(model: torch.nn.Module, flat: Dict[str, torch.Tensor]) -> dict:
    """The flat tree as the port model's state dict, in the layouts of
    models/convert.py: views of the flat tree, on its device."""
    out = {}
    for key, p in model.state_dict().items():
        path, perm = flax_path(key, p.dim())
        out[key] = flat[path].permute(tuple(int(i) for i in np.argsort(perm)))
    return out


def x_T(seed: int, batch: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    """Batch `batch`'s starting noise [B, H, W, C], float32."""
    return torch.randn(shape, generator=generator(seed, "x_T", batch, device), device=device)


def cond_rasters(seed: int, batch: int, shape: Tuple[int, ...], device) -> torch.Tensor:
    """Batch `batch`'s map conditioning [B, H, W, C_cond] as the generation
    CLI hands it over: 8-bit raster levels mapped to [-1, 1]. Lanes are a
    few bright strokes of random rows and columns on a mid-gray ground."""
    g = generator(seed, "cond", batch, device)
    B, H, W, C = shape
    ground = torch.full(shape, 128, dtype=torch.uint8, device=device)
    rows = torch.rand((B, H, 1, C), generator=g, device=device) < 0.06
    cols = torch.rand((B, 1, W, C), generator=g, device=device) < 0.06
    level = torch.randint(0, 256, (B, 1, 1, C), generator=g, device=device, dtype=torch.uint8)
    levels = torch.where(rows | cols, level.expand(shape), ground)
    return (levels.float() / 255.0 - 0.5) / 0.5


def step_noise(seed: int, step: int, batch: int, shape: Tuple[int, ...], device):
    """Training step `step`'s (noise [B, H, W, C] float32, t [B] int64)."""
    g = generator(seed, "train", step, device)
    noise = torch.randn((batch,) + tuple(shape), generator=g, device=device)
    t = torch.randint(0, 1000, (batch,), generator=g, device=device)
    return noise, t


def corpus(seed: int, n: int, res: int, channels: int) -> np.ndarray:
    """n uint8 rasters [n, res, res, C] on the host: a mid-gray ground with
    a band of random levels along random rows and columns, as rasterized
    scenes carry lanes on a gray field."""
    rng = np.random.default_rng(sub_seed(seed, "corpus"))
    out = np.full((n, res, res, channels), 128, dtype=np.uint8)
    rows = rng.random((n, res, 1, 1)) < 0.08
    cols = rng.random((n, 1, res, 1)) < 0.08
    levels = rng.integers(0, 256, (n, 1, 1, channels), dtype=np.uint8)
    np.copyto(out, np.broadcast_to(levels, out.shape), where=rows | cols)
    return out


def order_seed(seed: int) -> int:
    """The seed of the corpus's per-epoch order (data.dataset.index_batches)."""
    return sub_seed(seed, "order") >> 32
