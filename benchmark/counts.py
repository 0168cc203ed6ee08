"""The yardstick's arithmetic: the UNet's FLOP count, the shapes of the
hand-written kernels' launches, each launch's operations and bytes, and the
H100's published peaks.

unet2d_forward_flops is a copy of drivescenegen_torch/utils/flops.py's
count (the JAX package's, line for line), over a configuration dict: the
matmul FLOPs (2 x contraction x outputs) of every conv, dense and attention
product; GroupNorm, SiLU, residual adds and the upsample are not counted.

A kernel's bound is max(bytes / PEAK_BYTES, operations / PEAK_FLOPS), with
each input byte read once and each output byte written once, whatever the
kernel reads again. Peaks: NVIDIA's data sheet for the H100 SXM, dense
bf16 without sparsity, at its full 700 W; the harness prints the card's
power limit beside every share taken against them.
"""

from __future__ import annotations

from collections import Counter
from typing import Tuple

PEAK_FLOPS = 989e12  # bf16 dense, FLOP/s
PEAK_BYTES = 3.35e12  # HBM3, B/s
BF16, F32 = 2, 4


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3, stride: int = 1) -> int:
    oh, ow = h // stride, w // stride
    return 2 * oh * ow * k * k * cin * cout


def unet2d_forward_flops(cfg: dict, batch: int = 1) -> int:
    """Matmul FLOPs of one UNet2D forward on a [batch, S, S, C] input."""
    s = cfg["sample_size"]
    chans = tuple(cfg["block_out_channels"])
    n_blocks = len(chans)
    lpb = cfg["layers_per_block"]
    embed = chans[0] * 4
    cin = cfg["in_channels"] + cfg.get("cond_channels", 0)

    total = 2 * chans[0] * embed + 2 * embed * embed
    res = s
    total += _conv(res, res, cin, chans[0])

    def resnet(h, c_in, c_out):
        f = _conv(h, h, c_in, c_out) + _conv(h, h, c_out, c_out)
        f += 2 * embed * c_out
        if c_in != c_out:
            f += _conv(h, h, c_in, c_out, k=1)
        return f

    skips = [(res, chans[0])]
    c_prev = chans[0]
    for i, ch in enumerate(chans):
        for _ in range(lpb):
            total += resnet(res, c_prev, ch)
            c_prev = ch
            skips.append((res, ch))
        if i != n_blocks - 1:
            total += _conv(res, res, ch, ch, stride=2)
            res //= 2
            skips.append((res, ch))

    c = chans[-1]
    total += 2 * resnet(res, c, c)
    tokens = res * res
    total += 2 * tokens * c * (3 * c)
    total += 2 * 2 * tokens * tokens * c
    total += 2 * tokens * c * c

    for i, ch in enumerate(reversed(chans)):
        for _ in range(lpb + 1):
            _, skip_c = skips.pop()
            total += resnet(res, c_prev + skip_c, ch)
            c_prev = ch
        if i != n_blocks - 1:
            res *= 2
            total += _conv(res, res, ch, ch)

    total += _conv(res, res, chans[0], cfg["out_channels"])
    return total * batch


def conv3x3_calls(cfg: dict) -> Counter:
    """(H, C, Co) of every GroupNorm+SiLU+conv3x3 pair the sampling arm runs
    in one forward (two a ResnetBlock, H = W the resolution), counted."""
    ch = tuple(cfg["block_out_channels"])
    lpb = cfg["layers_per_block"]
    calls: Counter = Counter()
    H, cin, skips = cfg["sample_size"], ch[0], [ch[0]]

    def resnet(c_in, c_out):
        calls[(H, c_in, c_out)] += 1
        calls[(H, c_out, c_out)] += 1

    for i, c in enumerate(ch):
        for _ in range(lpb):
            resnet(cin, c)
            cin = c
            skips.append(c)
        if i != len(ch) - 1:
            H = -(-H // 2)
            skips.append(c)
    resnet(cin, ch[-1])
    resnet(ch[-1], ch[-1])
    for i, c in enumerate(reversed(ch)):
        for _ in range(lpb + 1):
            resnet(cin + skips.pop(), c)
            cin = c
        if i != len(ch) - 1:
            H *= 2
    return calls


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / PEAK_BYTES, flops / PEAK_FLOPS)


def conv3x3_bound_s(B: int, H: int, C: int, Co: int) -> float:
    """silu_conv3x3 at [B, H, H, C] -> Co: reads x (bf16), mul and add (f32
    [B, C]), the weight (bf16) and its bias (f32); writes y (bf16)."""
    M = B * H * H
    nbytes = M * C * BF16 + 2 * B * C * F32 + Co * C * 9 * BF16 + Co * F32 + M * Co * BF16
    return bound_s(nbytes, 2 * M * Co * 9 * C)


def conv3x3_forward_bound_s(cfg: dict, rows: int) -> Tuple[float, int]:
    """(summed bound, launches) of one forward's conv kernels at `rows`."""
    calls = conv3x3_calls(cfg)
    return (sum(n * conv3x3_bound_s(rows, H, C, Co) for (H, C, Co), n in calls.items()),
            sum(calls.values()))


def mid_attention_shape(cfg: dict) -> Tuple[int, int, int]:
    """(heads, S, D) of the mid-block attention."""
    ch = tuple(cfg["block_out_channels"])
    side = cfg["sample_size"]
    for _ in range(len(ch) - 1):
        side = -(-side // 2)
    heads = max(1, ch[-1] // cfg["attention_head_dim"])
    return heads, side * side, ch[-1] // heads


def attention_fwd_bound_s(B: int, heads: int, S: int, D: int, with_lse: bool) -> float:
    """Forward: QK^T and PV (2 S^2 D FLOP each a head); reads q, k, v and
    writes o (bf16), and lse (f32) when asked."""
    nbytes = 4 * B * heads * S * D * BF16 + (B * heads * S * F32 if with_lse else 0)
    return bound_s(nbytes, 2 * 2 * B * heads * S * S * D)


def attention_bwd_bound_s(B: int, heads: int, S: int, D: int) -> float:
    """Backward: the five products (S recomputed, dV, dP, dQ, dK); reads q,
    k, v, o, dO (bf16) and lse (f32); writes dq, dk, dv (bf16)."""
    nbytes = 8 * B * heads * S * D * BF16 + B * heads * S * F32
    return bound_s(nbytes, 5 * 2 * B * heads * S * S * D)
