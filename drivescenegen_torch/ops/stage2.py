"""Stage 2's per-batch device pass: quantize, lane mask, skeleton, bit-pack.

Plain PyTorch ops on their input's device (the JAX package runs the same
pass as plain jnp inside its end-to-end jit, scripts/end_to_end.py
`run`): no operation waits for the host, so the pass queues behind the
sampler without stalling the enqueue of the next batch.
"""

from __future__ import annotations

import functools

import torch

from drivescenegen_torch.ops.lane_mask import lane_mask_batch
from drivescenegen_torch.ops.morphology import skeletonize_batch


def quantize(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] samples -> uint8 on their device: round(clip(x/2 + 0.5, 0, 1)
    * 255) in f32, IEEE-identical to scripts/generation.py quantize on the
    host."""
    return torch.round(torch.clamp(x.float() / 2 + 0.5, 0.0, 1.0) * 255.0).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _bit_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.uint8).to(device)


def skeleton_pass(q: torch.Tensor) -> torch.Tensor:
    """uint8 [B, H, W, C>=2] rasters -> their lane skeletons, [x][y]
    indexed (the (0, 2, 1) transpose of the mask) and packed 8 pixels per
    byte, most significant bit first (np.unpackbits order): uint8
    [B, W, H // 8], on q's device."""
    skel = skeletonize_batch(lane_mask_batch(q).transpose(1, 2))
    b, sh, sw = skel.shape
    bits = skel.reshape(b, sh, sw // 8, 8).to(torch.uint8) * _bit_weights(q.device)
    return bits.sum(dim=-1, dtype=torch.uint8)
