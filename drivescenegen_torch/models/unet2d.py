"""UNet2D denoiser in PyTorch (port of drivescenegen_tpu/models/unet2d.py).

conv_in -> down blocks (ResnetBlocks + stride-2 conv downsample) -> mid
block (ResnetBlock, self-attention, ResnetBlock) -> up blocks (ResnetBlocks
over the skip concat + nearest x2 upsample) -> GroupNorm/SiLU/conv_out,
with a sinusoidal time embedding and 2-layer MLP feeding every ResnetBlock.

Layout and numerics follow the JAX module so the two agree on the same
weights (models/convert.py maps the parameter trees):
- public tensors are NHWC: forward(x[B,H,W,C], t) -> eps[B,H,W,C] in f32;
- activations in cfg.dtype (bf16) over f32 params, cast at use;
- GroupNorm eps 1e-6 everywhere, the attention block's norm included;
- XLA "SAME" padding: a stride-2 3x3 conv pads (0, 1), or (1, 1) under
  torch_pad_downsample;
- attention logits and softmax in f32.

Module names match the flax tree (down_{i}_res_{j}, mid_attn,
up_{i}_upsample, ...). On a CUDA tensor every GN+SiLU+conv3x3 pair of a
ResnetBlock, norm_out and the mid-block attention run the hand-written
kernels (drivescenegen_torch/ops); on a CPU tensor, their plain versions.
`plain=True` runs the plain versions on any device: the comparison for
the kernels on the card, and the explicit arm (the CLIs' --plain) for a
model outside the kernels' limits. On CUDA with plain=False the
constructor checks every kernel call a forward will make against those
limits (kernel_limit_errors) and raises there, naming each broken limit
and plain=True; nothing switches to the plain versions on its own.

`for_training=True` is the arm the train step differentiates. The GN+SiLU
kernels have no backward, in the JAX package either (its config.py:79-80),
so this arm runs every GN+SiLU+conv pair and norm_out as the composition
JAX trains with (drivescenegen_tpu/models/unet2d.py:224-227, :249-254):
GroupNorm in f32, SiLU, a cast, the conv. The attention runs its kernel
forward and backward (ops.AttentionFunction). The arm is a constructor
argument, not nn.Module.training, which defaults to True and would turn
the sampling kernels off unasked.

Dropout (cfg.dropout > 0) acts in the training arm only, between each
ResnetBlock's norm2+SiLU and conv2, as x / keep where its keep mask is set
and 0 elsewhere (drivescenegen_tpu/models/unet2d.py:249-252), with the
masks of a DropoutMasks handed to forward. The sampling arm is
deterministic, so dropout there is the identity: it keeps the fused
gn_silu_conv3x3 kernel, which computes the function the JAX module's
unfused path at dropout > 0 (:209) computes when deterministic.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import List, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from drivescenegen_torch import ops
from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.ops.attention import attention_bwd_shape_error, attention_shape_error
from drivescenegen_torch.ops.gn_silu_conv import conv_shape_error
from drivescenegen_torch.ops.group_norm import stats_shape_error
from drivescenegen_torch.utils.device import resolve_device

GN_EPS = 1e-6


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal embedding [cos, sin] (diffusers flip_sin_to_cos=True,
    downscale_freq_shift=0)."""
    t = timesteps.reshape(-1).float()
    half = dim // 2
    exponent = -math.log(max_period) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    args = t[:, None] * torch.exp(exponent)[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


def _param(shape, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=torch.float32, device=device))


class _Params(nn.Module):
    """f32 parameters, cast to the activation dtype at use as flax's
    promote_dtype does (conv weights channels-last, the layout cuDNN and the
    fused conv kernel read). Without autograd (no grad mode, or a parameter
    that needs none) the cast copy is kept until the parameter changes:
    sampling is inference only, and re-casting 56 M weights on every
    forward would cost more than several kernels. With autograd the cast is
    made anew, so that the gradient reaches the f32 parameter."""

    def cast(self, name: str, dtype: torch.dtype) -> torch.Tensor:
        p = getattr(self, name)
        fmt = torch.channels_last if p.dim() == 4 else torch.contiguous_format
        if torch.is_grad_enabled() and p.requires_grad:
            return p.to(dtype=dtype, memory_format=fmt)
        key = (p._version, p.data_ptr(), dtype)
        casts = self.__dict__.setdefault("_casts", {})
        hit = casts.get(name)
        if hit is None or hit[0] != key:
            hit = (key, p.detach().to(dtype=dtype, memory_format=fmt))
            casts[name] = hit
        return hit[1]


class Conv2d(_Params):
    """Parameters of a conv: weight [O, I, k, k] (OIHW), bias [O]."""

    def __init__(self, cin: int, cout: int, k: int, device=None):
        super().__init__()
        self.weight = _param((cout, cin, k, k), device)
        self.bias = _param((cout,), device)


class Dense(_Params):
    """Parameters of a dense layer: weight [O, I], bias [O]."""

    def __init__(self, cin: int, cout: int, device=None):
        super().__init__()
        self.weight = _param((cout, cin), device)
        self.bias = _param((cout,), device)

    def forward(self, x):
        return F.linear(x, self.cast("weight", x.dtype), self.cast("bias", x.dtype))


class Norm(nn.Module):
    """Parameters of a GroupNorm: weight (flax `scale`) and bias, [C]."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.weight = _param((channels,), device)
        self.bias = _param((channels,), device)


def conv_nhwc(x, weight, bias, stride: int = 1, pad=None):
    """Conv over NHWC x, with weight and bias already in x's dtype. `pad` is
    (left, right, top, bottom); None means SAME at stride 1."""
    xc = x.permute(0, 3, 1, 2)
    k = weight.shape[-1]
    if pad is None:
        padding = k // 2
    else:
        xc = F.pad(xc, pad)
        padding = 0
    y = F.conv2d(xc, weight, bias, stride=stride, padding=padding)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_module(x, conv: Conv2d, stride: int = 1, pad=None):
    return conv_nhwc(x, conv.cast("weight", x.dtype), conv.cast("bias", x.dtype), stride, pad)


def group_norm_silu_nhwc(x, norm: Norm, groups: int):
    """silu(GroupNorm(x)) over NHWC x, the norm in f32, returned in x's
    dtype: the composition the training arm differentiates."""
    h = F.group_norm(x.permute(0, 3, 1, 2).float(), groups, norm.weight, norm.bias, eps=GN_EPS)
    return F.silu(h).to(x.dtype).permute(0, 2, 3, 1)


class DropoutMasks:
    """The keep masks of one training-arm forward, one per ResnetBlock in
    forward order (down blocks, mid_res_0, mid_res_1, up blocks). Either
    handed in (`masks`, bool tensors of the blocks' activation shapes: the
    tests pass the JAX module's own), or drawn from `generator` as
    uniform < 1 - rate at the global batch `batch` (the shape of the
    activation with its batch dim replaced) and cut to this rank's `rows`,
    so that every rank of a data-parallel step draws the same numbers.
    `drawn` counts the masks used."""

    def __init__(self, rate: float, generator: Optional[torch.Generator] = None,
                 masks: Optional[List[torch.Tensor]] = None, batch: Optional[int] = None,
                 rows: slice = slice(None)):
        if (generator is None) == (masks is None):
            raise ValueError("DropoutMasks takes a generator or the masks, not both")
        self.keep = 1.0 - rate
        self.generator, self.masks, self.batch, self.rows = generator, masks, batch, rows
        self.drawn = 0

    def apply(self, h: torch.Tensor) -> torch.Tensor:
        """h / keep where the next mask is set, 0 elsewhere (flax's
        lax.select(mask, h / keep, 0)), in h's dtype."""
        if self.masks is not None:
            mask = self.masks[self.drawn].to(h.device)
        else:
            shape = (self.batch or h.shape[0],) + tuple(h.shape[1:])
            u = torch.rand(shape, generator=self.generator, device=self.generator.device)
            mask = (u < self.keep)[self.rows].to(h.device)
        self.drawn += 1
        return torch.where(mask, h / self.keep, torch.zeros_like(h))


def _same_pad(n: int, k: int = 3, s: int = 2):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class TimeMLP(nn.Module):
    def __init__(self, cin: int, embed_dim: int, device=None):
        super().__init__()
        self.dense1 = Dense(cin, embed_dim, device)
        self.dense2 = Dense(embed_dim, embed_dim, device)

    def forward(self, t_emb):
        return self.dense2(F.silu(self.dense1(t_emb)))


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> conv -> (+time) -> GroupNorm -> SiLU -> conv, with
    a 1x1 shortcut when the channel count changes. Pair mode (`skip` given)
    takes what would be concat(x, skip) without building it: the GroupNorm
    statistics fold jointly across the boundary, and conv1/shortcut split
    their kernels along the input channels."""

    def __init__(self, cin: int, cout: int, temb_dim: int, groups: int, plain: bool,
                 for_training: bool = False, device=None):
        super().__init__()
        self.groups, self.plain, self.for_training = groups, plain, for_training
        self.norm1 = Norm(cin, device)
        self.conv1 = Conv2d(cin, cout, 3, device)
        self.time_proj = Dense(temb_dim, cout, device)
        self.norm2 = Norm(cout, device)
        self.conv2 = Conv2d(cout, cout, 3, device)
        if cin != cout:
            self.shortcut = Conv2d(cin, cout, 1, device)

    def _gn_conv(self, x, norm: Norm, conv: Conv2d):
        if self.for_training:
            return conv_module(group_norm_silu_nhwc(x, norm, self.groups), conv)
        fn = ops.reference_gn_silu_conv3x3 if self.plain else ops.gn_silu_conv3x3
        return fn(x.contiguous(), norm.weight, norm.bias, conv.cast("weight", x.dtype),
                  conv.bias, self.groups, GN_EPS)

    def forward(self, x, temb, skip: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutMasks] = None):
        if skip is None:
            h = self._gn_conv(x, self.norm1, self.conv1)
        else:
            ca = x.shape[-1]
            ha, hb = ops.reference_group_norm_silu_multi(
                (x, skip), self.norm1.weight, self.norm1.bias, self.groups, GN_EPS)
            w = self.conv1.cast("weight", x.dtype)
            h = (conv_nhwc(ha, w[:, :ca], None) + conv_nhwc(hb, w[:, ca:], None)
                 + self.conv1.cast("bias", x.dtype))
        h = h + self.time_proj(F.silu(temb))[:, None, None, :]
        if self.for_training and dropout is not None:
            h = dropout.apply(group_norm_silu_nhwc(h, self.norm2, self.groups))
            h = conv_module(h, self.conv2)
        else:
            h = self._gn_conv(h, self.norm2, self.conv2)
        if hasattr(self, "shortcut"):
            if skip is None:
                x = conv_module(x, self.shortcut)
            else:
                ca = x.shape[-1]
                w = self.shortcut.cast("weight", x.dtype)
                x = (conv_nhwc(x, w[:, :ca], None) + conv_nhwc(skip, w[:, ca:], None)
                     + self.shortcut.cast("bias", x.dtype))
        return x + h


class AttentionBlock(nn.Module):
    """Spatial self-attention over H*W tokens with a fused qkv projection
    and a residual add (diffusers Attention in UNetMidBlock2D). Under
    autograd ops.attention runs its Function: kernels forward and backward."""

    def __init__(self, channels: int, head_dim: int, groups: int, plain: bool, device=None):
        super().__init__()
        self.groups, self.plain = groups, plain
        self.num_heads = max(1, channels // head_dim)
        self.norm = Norm(channels, device)
        self.qkv = Dense(channels, 3 * channels, device)
        self.proj_out = Dense(channels, channels, device)

    def forward(self, x):
        B, H, W, C = x.shape
        heads = self.num_heads
        hd = C // heads
        h = F.group_norm(x.permute(0, 3, 1, 2).float(), self.groups,
                         self.norm.weight, self.norm.bias, eps=GN_EPS)
        h = h.to(x.dtype).permute(0, 2, 3, 1).reshape(B, H * W, C)
        qkv = self.qkv(h)
        q, k, v = (t.view(B, H * W, heads, hd).transpose(1, 2) for t in qkv.split(C, dim=-1))
        fn = ops.reference_attention if self.plain else ops.attention
        out = fn(q, k, v, 1.0 / math.sqrt(hd))
        out = self.proj_out(out.transpose(1, 2).reshape(B, H * W, C))
        return x + out.reshape(B, H, W, C)


class Downsample(nn.Module):
    """Stride-2 3x3 conv. SAME pads (0, 1) on even inputs; torch_pad pads
    (1, 1) as diffusers' Downsample2D does."""

    def __init__(self, channels: int, torch_pad: bool, device=None):
        super().__init__()
        self.torch_pad = torch_pad
        self.conv = Conv2d(channels, channels, 3, device)

    def forward(self, x):
        if self.torch_pad:
            pad = (1, 1, 1, 1)
        else:
            pad = _same_pad(x.shape[2]) + _same_pad(x.shape[1])
        return conv_module(x, self.conv, stride=2, pad=pad)


class Upsample(nn.Module):
    """Nearest-neighbour x2, then a 3x3 conv."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.conv = Conv2d(channels, channels, 3, device)

    def forward(self, x):
        B, H, W, C = x.shape
        x = x[:, :, None, :, None, :].expand(B, H, 2, W, 2, C).reshape(B, 2 * H, 2 * W, C)
        return conv_module(x, self.conv)


def conv3x3_shapes(cfg: ModelConfig) -> Counter:
    """(H, C, Co) of every GN+SiLU+conv3x3 kernel call in one UNet2D forward
    (H = W, the resolution of the call), counted as UNet2D.forward makes
    them: two per ResnetBlock, except that under split_skip_conv an up
    block's conv1 runs on the skip pair outside the kernel."""
    ch = tuple(cfg.block_out_channels)
    shapes = Counter()
    H, cin, skips = cfg.sample_size, ch[0], [ch[0]]

    def resnet(c_in, c_out, pair=False):
        if not pair:
            shapes[(H, c_in, c_out)] += 1
        shapes[(H, c_out, c_out)] += 1

    for i, c in enumerate(ch):
        for _ in range(cfg.layers_per_block):
            resnet(cin, c)
            cin = c
            skips.append(c)
        if i != len(ch) - 1:
            H = -(-H // 2)
            skips.append(c)
    resnet(cin, ch[-1])
    resnet(ch[-1], ch[-1])
    for i, c in enumerate(reversed(ch)):
        for _ in range(cfg.layers_per_block + 1):
            resnet(cin + skips.pop(), c, pair=cfg.split_skip_conv)
            cin = c
        if i != len(ch) - 1:
            H *= 2
    return shapes


def gn_mul_add_shapes(cfg: ModelConfig) -> Counter:
    """(H, C) of every GroupNorm stats call (ops.gn_mul_add) in one UNet2D
    forward: the input of each GN+SiLU+conv3x3 call, then norm_out at the
    full resolution."""
    shapes = Counter()
    for (H, C, _), n in conv3x3_shapes(cfg).items():
        shapes[(H, C)] += n
    shapes[(cfg.sample_size, cfg.block_out_channels[0])] += 1
    return shapes


def mid_attention_shape(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(heads, S, D) of the mid-block attention: S tokens of the lowest
    resolution, head dim D."""
    ch = tuple(cfg.block_out_channels)
    side = cfg.sample_size
    for _ in range(len(ch) - 1):
        side = -(-side // 2)
    heads = max(1, ch[-1] // cfg.attention_head_dim)
    return heads, side * side, ch[-1] // heads


def kernel_limit_errors(cfg: ModelConfig, for_training: bool = False) -> List[str]:
    """Every limit of the hand-written kernels that a UNet2D forward of
    `cfg` on CUDA would break, one message per distinct breach; empty when
    the kernels take every call. The sampling arm runs all four forward
    kernels at the shapes conv3x3_shapes, gn_mul_add_shapes and
    mid_attention_shape list; the training arm (for_training=True) runs
    only the attention, forward and backward. The limits are the wrappers'
    own predicates, read from the kernel sources (ops/build.py
    source_int)."""
    errors = []
    kernels = "the attention kernels" if for_training else "silu_conv3x3, gn_mul_add and attention"
    if cfg.dtype != "bfloat16":
        errors.append(f"{kernels} take bfloat16 activations, got dtype {cfg.dtype}")
    heads, S, D = mid_attention_shape(cfg)
    checks = [("attention", attention_shape_error(S, D))]
    if for_training:
        checks.append(("attention backward", attention_bwd_shape_error(S, D)))
    else:
        checks += [("silu_conv3x3", conv_shape_error(C, Co))
                   for _, C, Co in sorted(conv3x3_shapes(cfg))]
        checks += [("gn_mul_add", stats_shape_error(C, cfg.norm_num_groups))
                   for _, C in sorted(gn_mul_add_shapes(cfg))]
    for kernel, why in checks:
        if why and f"{kernel}: {why}" not in errors:
            errors.append(f"{kernel}: {why}")
    return errors


class UNet2D(nn.Module):
    """The denoiser. forward(x_noisy, t, cond=None) -> eps_hat.

    x: [B, H, W, C_in] NHWC; t: [B] or scalar integer timesteps; cond:
    optional [B, H, W, C_cond], concatenated to the input (zeros when None
    and cfg.cond_channels > 0). for_training selects the arm the train step
    differentiates (module docstring); the default is the sampling arm.
    `dropout` (DropoutMasks) masks the training arm's ResnetBlocks; None,
    or the sampling arm, is deterministic.

    Weights are drawn at construction from `generator` (flax-like init:
    lecun-normal kernels, zero biases, unit norm scales); pass a seeded
    torch.Generator on `device`, or load a state dict afterwards.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", plain: bool = False,
                 generator: Optional[torch.Generator] = None, for_training: bool = False):
        super().__init__()
        device = resolve_device(device)
        if device.type == "cuda" and not plain:
            errors = kernel_limit_errors(cfg, for_training)
            if errors:
                raise ValueError(
                    "this model is outside the CUDA kernels' limits:\n  " + "\n  ".join(errors)
                    + "\nbuild it with UNet2D(..., plain=True) (the CLIs' --plain) to run "
                    "PyTorch's library ops instead")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        ch = tuple(cfg.block_out_channels)
        groups = cfg.norm_num_groups
        temb = ch[0] * 4
        kw = dict(groups=groups, plain=plain, for_training=for_training, device=device)

        self.time_mlp = TimeMLP(ch[0], temb, device)
        self.conv_in = Conv2d(cfg.in_channels + cfg.cond_channels, ch[0], 3, device)
        skip_ch = [ch[0]]
        cin = ch[0]
        for i, c in enumerate(ch):
            for j in range(cfg.layers_per_block):
                self.add_module(f"down_{i}_res_{j}", ResnetBlock(cin, c, temb, **kw))
                cin = c
                skip_ch.append(c)
            if i != len(ch) - 1:
                self.add_module(f"down_{i}_downsample",
                                Downsample(c, cfg.torch_pad_downsample, device))
                skip_ch.append(c)
        self.mid_res_0 = ResnetBlock(cin, ch[-1], temb, **kw)
        self.mid_attn = AttentionBlock(ch[-1], cfg.attention_head_dim, groups, plain, device)
        self.mid_res_1 = ResnetBlock(ch[-1], ch[-1], temb, **kw)
        for i, c in enumerate(reversed(ch)):
            for j in range(cfg.layers_per_block + 1):
                self.add_module(f"up_{i}_res_{j}",
                                ResnetBlock(cin + skip_ch.pop(), c, temb, **kw))
                cin = c
            if i != len(ch) - 1:
                self.add_module(f"up_{i}_upsample", Upsample(c, device))
        self.norm_out = Norm(ch[0], device)
        self.conv_out = Conv2d(ch[0], cfg.out_channels, 3, device)
        self.plain, self.for_training = plain, for_training
        if device.type != "meta":
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            self.init_weights(generator)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif p.dim() == 1:
                p.fill_(1.0)
            else:
                fan_in = p[0].numel()
                p.normal_(0.0, 1.0 / math.sqrt(fan_in), generator=generator)

    def forward(self, x, t, cond: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutMasks] = None):
        cfg = self.cfg
        dt = self.dtype
        ch = tuple(cfg.block_out_channels)
        n = len(ch)
        B = x.shape[0]
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(B)
        temb = self.time_mlp(timestep_embedding(t, ch[0]).to(dt))

        x = x.to(dt)
        if cfg.cond_channels > 0:
            if cond is None:
                cond = torch.zeros(x.shape[:-1] + (cfg.cond_channels,), dtype=dt, device=x.device)
            x = torch.cat([x, cond.to(dt)], dim=-1)

        h = conv_module(x, self.conv_in)
        skips = [h]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = getattr(self, f"down_{i}_res_{j}")(h, temb, dropout=dropout)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = self.mid_res_0(h, temb, dropout=dropout)
        h = self.mid_attn(h)
        h = self.mid_res_1(h, temb, dropout=dropout)

        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                skip = skips.pop()
                block = getattr(self, f"up_{i}_res_{j}")
                if cfg.split_skip_conv:
                    h = block(h, temb, skip=skip, dropout=dropout)
                else:
                    h = block(torch.cat([h, skip], dim=-1), temb, dropout=dropout)
            if i != n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)

        if self.for_training:
            h = group_norm_silu_nhwc(h, self.norm_out, cfg.norm_num_groups)
        else:
            gn = ops.reference_group_norm_silu if self.plain else ops.group_norm_silu
            h = gn(h.contiguous(), self.norm_out.weight, self.norm_out.bias, cfg.norm_num_groups,
                   GN_EPS)
        h = conv_module(h, self.conv_out)
        return h.float()
