"""Lane masks on the card, integer-exact against the host path (the port's
copy of drivescenegen_tpu/ops/lane_mask.py).

The host path (vectorize/image_utils.py get_lane_mask) converts the
quantized uint8 raster to float32 [0, 1], finds the modal (background)
value of the R and G channels via 256-bin histograms, and marks as lane
every pixel deviating > 0.1 from the mode in either channel. Its
comparison promotes float32 pixels against a float64 Python-scalar mode,
so boundary pixels (v = 153 against the 0.5 background, where
|153/255 - 128/256| == 0.1 in real arithmetic) are decided by float64
rounding that float32 arithmetic on the card would get wrong.

For a fixed mode bin m the background test selects a contiguous range of
uint8 values (x(v) = f32(v/255) is strictly increasing), so the decision
collapses to integers:

  1. ``_BIN_LUT[v]``: the histogram bin of uint8 value v, computed with the
     host's float32 ops. It is strictly increasing in v (asserted), so the
     first-max argmax over value counts maps to the host's first-max argmax
     over bin counts.
  2. ``_BG_LO/_BG_HI[m]``: the inclusive uint8 range the host classifies as
     background when the mode bin is m, computed with the host's mixed
     f32/f64 arithmetic.

lane_mask_batch is then a per-channel 256-bin histogram of the raw uint8
values (one scatter-add), a first-max argmax, two table lookups and two
integer compares: no floating point, so the mask is bit-identical on the
card, on the CPU and to get_lane_mask, and no operation waits for the host.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _tables(threshold: float = 0.1):
    """(bin_lut[256], bg_lo[256], bg_hi[256]) int32 host-semantics tables."""
    v = np.arange(256, dtype=np.uint8)
    img01 = v.astype(np.float32) / np.float32(255.0)  # host: astype(f32)/255.
    bin_lut = np.clip(
        (img01 * np.float32(256.0)).astype(np.int64), 0, 255
    ).astype(np.int32)
    if not np.all(np.diff(bin_lut) >= 1):  # injective + monotone: argmax maps
        raise AssertionError("bin LUT must be strictly increasing")

    # Background range per mode bin, with the host's float64 comparison:
    # np.abs(f32_pixel - python_float_mode) <= 0.1 computes in float64.
    lo = np.full(256, 255, dtype=np.int32)
    hi = np.full(256, -1, dtype=np.int32)
    x64 = img01.astype(np.float64)  # exact widening of the f32 pixel values
    for m in range(256):
        mode_val = float(m) / 256.0
        is_bg = np.abs(x64 - mode_val) <= threshold
        idx = np.nonzero(is_bg)[0]
        if idx.size:
            if not np.all(np.diff(idx) == 1):
                raise AssertionError(f"background set not contiguous at m={m}")
            lo[m], hi[m] = idx[0], idx[-1]
    return bin_lut, lo, hi


@functools.lru_cache(maxsize=None)
def _device_tables(threshold: float, device: torch.device):
    """_tables on `device`, copied there once: a copy from host memory in
    every call would wait for the work queued before it."""
    return tuple(torch.from_numpy(t).to(device) for t in _tables(threshold))


def lane_mask_batch(q: torch.Tensor, threshold: float = 0.1) -> torch.Tensor:
    """uint8 [B, H, W, C>=2] quantized rasters -> bool [B, H, W] lane masks,
    bit-identical to vectorize.image_utils.get_lane_mask(q/255.) per image.
    Runs on q's device."""
    bin_lut, bg_lo, bg_hi = _device_tables(threshold, q.device)
    b, h, w = q.shape[:3]
    rg = q[..., :2].to(torch.int32)  # [B, H, W, 2]

    # Per-image, per-channel 256-bin histogram of raw uint8 values via one
    # flattened scatter-add (torch.bincount on CUDA reads the largest value
    # back to the host to size its output).
    flat = rg.permute(0, 3, 1, 2).reshape(b * 2, h * w)
    offs = torch.arange(b * 2, dtype=torch.int64, device=q.device)[:, None] * 256 + flat
    hist = torch.zeros(b * 2 * 256, dtype=torch.int32, device=q.device).scatter_add_(
        0, offs.reshape(-1), torch.ones(b * 2 * h * w, dtype=torch.int32, device=q.device)
    ).reshape(b * 2, 256)
    v_star = torch.argmax(hist, dim=-1)  # first max, like np.argmax(bincount)
    m_star = bin_lut[v_star].long()  # [B*2] mode bins (monotone injective map)
    lo = bg_lo[m_star].reshape(b, 1, 1, 2)
    hi = bg_hi[m_star].reshape(b, 1, 1, 2)

    is_bg = ((rg >= lo) & (rg <= hi)).all(dim=-1)
    return ~is_bg
