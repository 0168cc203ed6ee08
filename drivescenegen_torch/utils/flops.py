"""Analytic FLOP accounting for the UNet2D denoiser (port of
drivescenegen_tpu/utils/flops.py).

Walks the exact block structure of models/unet2d.py and sums matmul FLOPs
(2 * contraction * output elements) for every conv / dense / attention
einsum: the count MFU is taken against. unet2d_forward_flops is the JAX
package's count, line for line. The speed-of-light and roofline helpers
default to the H100 (989e12 bf16 FLOP/s, 3.35e12 B/s, no lane cap); with
the JAX package's TPU arguments they return its numbers
(tests/test_torch_flops.py).
"""

from __future__ import annotations

from drivescenegen_torch.config import ModelConfig


def _conv(h: int, w: int, cin: int, cout: int, k: int = 3, stride: int = 1) -> int:
    oh, ow = h // stride, w // stride
    return 2 * oh * ow * k * k * cin * cout


def unet2d_forward_flops(cfg: ModelConfig, batch: int = 1) -> int:
    """Matmul FLOPs of one UNet2D forward pass on a [batch, S, S, C] input.

    Counts convs (3x3 and 1x1 shortcuts), time-embedding/projection denses,
    and the mid-block attention einsums; elementwise work (GroupNorm, SiLU,
    residual adds, upsample) is excluded — it is HBM-bound, not MXU-bound.
    """
    s = cfg.sample_size
    chans = tuple(cfg.block_out_channels)
    n_blocks = len(chans)
    lpb = cfg.layers_per_block
    embed = chans[0] * 4
    cin = cfg.in_channels + cfg.cond_channels

    total = 0
    # Time MLP (per batch element, not per pixel): sinusoidal -> 2 denses.
    total += 2 * chans[0] * embed + 2 * embed * embed

    res = s
    total += _conv(res, res, cin, chans[0])  # conv_in

    def resnet(h, c_in, c_out):
        f = _conv(h, h, c_in, c_out) + _conv(h, h, c_out, c_out)
        f += 2 * embed * c_out  # time_proj dense
        if c_in != c_out:
            f += _conv(h, h, c_in, c_out, k=1)
        return f

    # Down path; record skip channels for the up path.
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

    # Mid block.
    c = chans[-1]
    total += 2 * resnet(res, c, c)
    tokens = res * res
    total += 2 * tokens * c * (3 * c)  # qkv
    total += 2 * 2 * tokens * tokens * c  # qk^T and att*v
    total += 2 * tokens * c * c  # proj_out

    # Up path.
    for i, ch in enumerate(reversed(chans)):
        for _ in range(lpb + 1):
            skip_res, skip_c = skips.pop()
            total += resnet(res, c_prev + skip_c, ch)
            c_prev = ch
        if i != n_blocks - 1:
            res *= 2
            total += _conv(res, res, ch, ch)  # upsample conv

    total += _conv(res, res, chans[0], cfg.out_channels)  # conv_out
    return total * batch


def unet2d_speed_of_light(cfg: ModelConfig, mxu_lanes: int = 1) -> float:
    """Achievable MFU ceiling for this UNet when a matmul with fewer than
    `mxu_lanes` output features fills only Cout/mxu_lanes of the matrix
    unit. Returns sum(flops) / sum(flops / per-layer-cap), i.e. the
    time-weighted utilization bound assuming every matmul otherwise runs
    at peak.

    On a 128x128-MXU TPU (mxu_lanes=128, the JAX package's default) a conv
    lowered to a matmul maps output features to the MXU's lane dimension,
    so a layer with Cout < 128 occupies at most Cout/128 of the array, and
    the flagship net's 64-channel stages cap it well below 100%. Hopper has
    no such cap: wgmma's N (the output features of a tile) runs from 8 to
    256 in steps of 8, so an m64nNk16 instruction at N = 64 issues at the
    same rate per FLOP as at N = 256, and the default cap of 1 makes this
    ceiling 1.0. What narrow layers do cost on the H100 (operand traffic,
    epilogues) is a bandwidth matter, which unet2d_roofline_seconds counts.
    """
    s = cfg.sample_size
    chans = tuple(cfg.block_out_channels)
    n_blocks = len(chans)
    lpb = cfg.layers_per_block
    cin = cfg.in_channels + cfg.cond_channels

    layers = []  # (flops, cout) per matmul; dense/time-MLP terms are ~0%

    def cap(cout: int) -> float:
        return min(1.0, cout / mxu_lanes)

    def add_conv(h, c_in, c_out, k=3, stride=1):
        layers.append((_conv(h, h, c_in, c_out, k=k, stride=stride), cap(c_out)))

    def add_resnet(h, c_in, c_out):
        add_conv(h, c_in, c_out)
        add_conv(h, c_out, c_out)
        if c_in != c_out:
            add_conv(h, c_in, c_out, k=1)

    res = s
    add_conv(res, cin, chans[0])
    c_prev = chans[0]
    for i, ch in enumerate(chans):
        for _ in range(lpb):
            add_resnet(res, c_prev, ch)
            c_prev = ch
        if i != n_blocks - 1:
            add_conv(res, ch, ch, stride=2)
            res //= 2

    c = chans[-1]
    add_resnet(res, c, c)
    add_resnet(res, c, c)
    tokens = res * res
    layers.append((2 * tokens * c * 3 * c, cap(3 * c)))
    layers.append((2 * 2 * tokens * tokens * c, cap(min(tokens, c))))
    layers.append((2 * tokens * c * c, cap(c)))

    skips = []  # mirror the up-path channel bookkeeping of the flop count
    res2, skips = s, [(s, chans[0])]
    cp = chans[0]
    for i, ch in enumerate(chans):
        for _ in range(lpb):
            skips.append((res2, ch))
            cp = ch
        if i != n_blocks - 1:
            res2 //= 2
            skips.append((res2, ch))
    for i, ch in enumerate(reversed(chans)):
        for _ in range(lpb + 1):
            _, skip_c = skips.pop()
            add_resnet(res, c_prev + skip_c, ch)
            c_prev = ch
        if i != n_blocks - 1:
            res *= 2
            add_conv(res, ch, ch)

    add_conv(res, chans[0], cfg.out_channels)

    total = sum(f for f, _ in layers)
    time_weighted = sum(f / max(u, 1e-9) for f, u in layers)
    return total / time_weighted


def unet2d_roofline_seconds(
    cfg: ModelConfig,
    batch: int,
    peak_flops: float = 989e12,
    hbm_bw: float = 3.35e12,
    act_bytes: int = 2,
    mxu_lanes: int = 1,
) -> dict:
    """Roofline estimate of one forward pass: per stage, time = max(matmul
    time, memory time), where memory traffic counts each conv's
    input+output activations plus one read+write per elementwise pass
    (GroupNorm+SiLU before every conv, residual add, up/downsample).
    Defaults are the H100 SXM's published dense bf16 peak (989 TFLOP/s)
    and HBM3 rate (3.35 TB/s). Each conv's matmul time is capped at
    Cout/mxu_lanes of the peak as in unet2d_speed_of_light: 1 (no cap) on
    Hopper, 128 for the TPU's MXU, where with the JAX package's arguments
    (197e12, 819e9, mxu_lanes=128) this returns that package's numbers.
    "mfu_ceiling" is the FLOP time at peak over the roofline time.
    """
    s = cfg.sample_size
    chans = tuple(cfg.block_out_channels)
    n_blocks = len(chans)
    lpb = cfg.layers_per_block
    cin = cfg.in_channels + cfg.cond_channels

    t_flop = 0.0
    t_mem = 0.0
    t_total = 0.0

    def px(h):
        return batch * h * h

    def add(flops, bytes_, lane_cap=1.0):
        nonlocal t_flop, t_mem, t_total
        tf, tm = flops / (peak_flops * lane_cap), bytes_ / hbm_bw
        t_flop += flops / peak_flops  # MFU numerator stays true FLOPs/peak
        t_mem += tm
        t_total += max(tf, tm)

    def conv(h, c_in, c_out, k=3, stride=1, fused_eltwise=2):
        # fused_eltwise: extra full-tensor read+write passes XLA cannot fuse
        # into the conv (GroupNorm needs two passes: stats + normalize).
        f = batch * _conv(h, h, c_in, c_out, k=k, stride=stride)
        b = (px(h) * c_in + px(h // stride) * c_out) * act_bytes
        b += fused_eltwise * px(h) * c_in * act_bytes
        add(f, b, lane_cap=min(1.0, c_out / mxu_lanes))

    res = s
    conv(res, cin, chans[0], fused_eltwise=0)
    c_prev = chans[0]
    skips = [(res, chans[0])]
    for i, ch in enumerate(chans):
        for _ in range(lpb):
            conv(res, c_prev, ch)
            conv(res, ch, ch)
            if c_prev != ch:
                conv(res, c_prev, ch, k=1, fused_eltwise=0)
            # residual add: read two, write one
            add(0, 3 * px(res) * ch * act_bytes)
            c_prev = ch
            skips.append((res, ch))
        if i != n_blocks - 1:
            conv(res, ch, ch, stride=2, fused_eltwise=0)
            res //= 2
            skips.append((res, ch))

    c = chans[-1]
    for _ in range(2):
        conv(res, c, c)
        conv(res, c, c)
        add(0, 3 * px(res) * c * act_bytes)
    tokens = res * res
    add(2 * batch * tokens * c * 4 * c + 4 * batch * tokens * tokens * c,
        8 * batch * tokens * c * act_bytes)

    for i, ch in enumerate(reversed(chans)):
        for _ in range(lpb + 1):
            _, skip_c = skips.pop()
            conv(res, c_prev + skip_c, ch)
            conv(res, ch, ch)
            if c_prev + skip_c != ch:
                conv(res, c_prev + skip_c, ch, k=1, fused_eltwise=0)
            add(0, 3 * px(res) * ch * act_bytes)
            c_prev = ch
        if i != n_blocks - 1:
            res *= 2
            conv(res, ch, ch, fused_eltwise=0)

    conv(res, chans[0], cfg.out_channels, fused_eltwise=0)
    return {
        "t_roofline_s": t_total,
        "t_flops_only_s": t_flop,
        "t_mem_only_s": t_mem,
        "mfu_ceiling": t_flop / t_total if t_total else 0.0,
    }
