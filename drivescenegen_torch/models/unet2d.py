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

`for_training=True` is the arm the train step differentiates. The
sampling arm's fused GN+SiLU+conv kernel has no backward, in the JAX
package either (its config.py:79-80), so this arm runs every GN+SiLU
(each ResnetBlock's norm1 and norm2, and norm_out) unfused, then the conv,
as JAX trains (drivescenegen_tpu/models/unet2d.py:224-227, :249-254).
Its GN+SiLU is ops.GroupNormSiLUFunction over NHWC bf16
(group_norm_silu_nhwc): on CUDA the stats and apply kernels forward and
a backward kernel, which JAX has no counterpart of (it differentiates
jnp); on CPU the f32 composition (GroupNorm in f32, SiLU, a cast) and a
plain backward; with plain=True that composition under autograd on any
device. Statistics, scale and bias and their gradients stay f32,
activations and dx bf16. The attention runs its kernel forward and
backward (ops.AttentionFunction). The arm is a constructor argument, not
nn.Module.training, which defaults to True and would turn the sampling
kernels off unasked.

Dropout (cfg.dropout > 0) acts in the training arm only, between each
ResnetBlock's norm2+SiLU and conv2, as x / keep where its keep mask is set
and 0 elsewhere (drivescenegen_tpu/models/unet2d.py:249-252), with the
masks of a DropoutMasks handed to forward. The sampling arm is
deterministic, so dropout there is the identity: it keeps the fused
gn_silu_conv3x3 kernel, which computes the function the JAX module's
unfused path at dropout > 0 (:209) computes when deterministic.

Tensor parallelism (`mesh` with a model axis over 1; parallel/mesh.py)
shards the training arm's blocks by the JAX package's rules, Megatron
style: TimeMLP's dense1 and each ResnetBlock's conv1, time_proj and norm2
are column-parallel, dense2, conv2 and the shortcut row-parallel with one
all_reduce a block (reduce_from_model; the biases of conv2 and the
shortcut added once, after it); the attention's qkv is split by heads, so
its kernels run at heads / tp heads, and proj_out is row-parallel. The
branch of a block passes through one copy_to_model, whose backward sums
the gradients over the model group: the input of the column-parallel conv1
(after the replicated norm1, so that norm1's gradient is whole on every
rank) and the shortcut's input; the identity residual takes x as it is, or
its gradient would count tp times. conv_in, conv_out, the down/upsample
convs, norm1, the attention's norm and norm_out stay replicated, as in
JAX. A block the plan (mesh.tp_plan) does not shard runs replicated. The
weights are drawn whole, as the one-process model draws them, and each
rank keeps its shards, so tp ranks hold the one-process model's weights.
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
from drivescenegen_torch.parallel.mesh import (Mesh, ModelAxis, copy_to_model, model_axis,
                                               reduce_from_model, tp_plan)
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


def group_norm_silu_nhwc(x, norm: Norm, groups: int, plain: bool = False):
    """silu(GroupNorm(x)) over NHWC x, the norm in f32, returned in x's
    dtype: what the training arm differentiates, ops.GroupNormSiLUFunction
    (kernels forward and backward on CUDA, returned NHWC-contiguous).
    plain=True: the f32 composition under autograd."""
    if plain:
        h = F.group_norm(x.permute(0, 3, 1, 2).float(), groups, norm.weight, norm.bias,
                         eps=GN_EPS)
        return F.silu(h).to(x.dtype).permute(0, 2, 3, 1)
    return ops.GroupNormSiLUFunction.apply(x.contiguous(), norm.weight, norm.bias, groups, GN_EPS)


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

    def apply(self, h: torch.Tensor, cols: slice = slice(None),
              width: Optional[int] = None) -> torch.Tensor:
        """h / keep where the next mask is set, 0 elsewhere (flax's
        lax.select(mask, h / keep, 0)), in h's dtype. A channel shard h of a
        tensor-parallel block is columns `cols` of an activation `width`
        channels wide: its mask is those columns of the full-width mask
        (drawn, or handed in at full width), so tp ranks draw what one
        process draws."""
        if self.masks is not None:
            mask = self.masks[self.drawn][..., cols].to(h.device)
        else:
            shape = (self.batch or h.shape[0],) + tuple(h.shape[1:-1]) + (width or h.shape[-1],)
            u = torch.rand(shape, generator=self.generator, device=self.generator.device)
            mask = (u < self.keep)[self.rows][..., cols].to(h.device)
        self.drawn += 1
        return torch.where(mask, h / self.keep, torch.zeros_like(h))


def _same_pad(n: int, k: int = 3, s: int = 2):
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


class TimeMLP(nn.Module):
    """dense1 -> SiLU -> dense2. Under tensor parallelism (`tp` set) dense1
    is column-parallel and dense2 row-parallel: its partial products summed
    over the model group, then its bias added once. The sinusoidal input
    needs no gradient, so it needs no copy_to_model."""

    tp: Optional[ModelAxis] = None

    def __init__(self, cin: int, embed_dim: int, device=None):
        super().__init__()
        self.dense1 = Dense(cin, embed_dim, device)
        self.dense2 = Dense(embed_dim, embed_dim, device)

    def forward(self, t_emb):
        h = F.silu(self.dense1(t_emb))
        if self.tp is None:
            return self.dense2(h)
        out = reduce_from_model(self.tp, F.linear(h, self.dense2.cast("weight", h.dtype)))
        return out + self.dense2.cast("bias", h.dtype)


class ResnetBlock(nn.Module):
    """GroupNorm -> SiLU -> conv -> (+time) -> GroupNorm -> SiLU -> conv, with
    a 1x1 shortcut when the channel count changes. Pair mode (`skip` given)
    takes what would be concat(x, skip) without building it: the GroupNorm
    statistics fold jointly across the boundary, and conv1/shortcut split
    their kernels along the input channels. Under tensor parallelism (`tp`
    set; the training arm) it holds its shards: _tp_forward."""

    tp: Optional[ModelAxis] = None

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
            return conv_module(group_norm_silu_nhwc(x, norm, self.groups, self.plain), conv)
        fn = ops.reference_gn_silu_conv3x3 if self.plain else ops.gn_silu_conv3x3
        return fn(x.contiguous(), norm.weight, norm.bias, conv.cast("weight", x.dtype),
                  conv.bias, self.groups, GN_EPS)

    def forward(self, x, temb, skip: Optional[torch.Tensor] = None,
                dropout: Optional[DropoutMasks] = None):
        if self.tp is not None:
            return self._tp_forward(x, temb, skip, dropout)
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
            h = dropout.apply(group_norm_silu_nhwc(h, self.norm2, self.groups, self.plain))
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

    def _tp_forward(self, x, temb, skip, dropout):
        """The block on its shards: norm1 replicated; conv1 and time_proj
        column-parallel (this rank's output channels); norm2 on them, with
        groups / tp groups; conv2 and the shortcut row-parallel, their
        partial sums added and reduced by one all_reduce, then their biases.
        `temb` is the time embedding after copy_to_model (UNet2D.forward).
        In pair mode the shortcut's input-channel shard may straddle the
        x | skip boundary: each part takes the channels of it that fall in
        the shard."""
        tp, dt = self.tp, x.dtype
        parts = (x,) if skip is None else (x, skip)
        if skip is None:
            hn = (group_norm_silu_nhwc(x, self.norm1, self.groups, self.plain),)
        else:
            hn = ops.reference_group_norm_silu_multi(parts, self.norm1.weight, self.norm1.bias,
                                                     self.groups, GN_EPS)
        has_shortcut = hasattr(self, "shortcut")
        copied = copy_to_model(tp, *hn, *(parts if has_shortcut else ()))
        hn, sc_in = copied[:len(hn)], copied[len(hn):]
        w = self.conv1.cast("weight", dt)
        h = self.conv1.cast("bias", dt)
        off = 0
        for part in hn:
            h = conv_nhwc(part, w[:, off:off + part.shape[-1]], None) + h
            off += part.shape[-1]
        h = h + self.time_proj(F.silu(temb))[:, None, None, :]
        h = group_norm_silu_nhwc(h, self.norm2, self.groups // tp.size, self.plain)
        if dropout is not None:
            n = h.shape[-1]
            h = dropout.apply(h, slice(tp.index * n, (tp.index + 1) * n), n * tp.size)
        out = conv_nhwc(h, self.conv2.cast("weight", dt), None)
        if has_shortcut:
            w = self.shortcut.cast("weight", dt)
            lo, hi = tp.index * w.shape[1], (tp.index + 1) * w.shape[1]
            off = 0
            for part in sc_in:
                a, b = max(lo, off), min(hi, off + part.shape[-1])
                if a < b:
                    out = out + conv_nhwc(part[..., a - off:b - off], w[:, a - lo:b - lo], None)
                off += part.shape[-1]
        out = reduce_from_model(tp, out) + self.conv2.cast("bias", dt)
        if has_shortcut:
            return out + self.shortcut.cast("bias", dt)
        return x + out


class AttentionBlock(nn.Module):
    """Spatial self-attention over H*W tokens with a fused qkv projection
    and a residual add (diffusers Attention in UNetMidBlock2D). Under
    autograd ops.attention runs its Function: kernels forward and backward.
    Under tensor parallelism (`tp` set) qkv holds this rank's heads' rows
    of q, k and v (mesh.Split parts=3), the attention runs on heads / tp
    heads, and proj_out is row-parallel, its bias added after the reduce."""

    tp: Optional[ModelAxis] = None

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
        if self.tp is not None:
            (h,) = copy_to_model(self.tp, h)
            heads //= self.tp.size
        c = heads * hd
        qkv = self.qkv(h)
        q, k, v = (t.view(B, H * W, heads, hd).transpose(1, 2) for t in qkv.split(c, dim=-1))
        fn = ops.reference_attention if self.plain else ops.attention
        out = fn(q, k, v, 1.0 / math.sqrt(hd)).transpose(1, 2).reshape(B, H * W, c)
        if self.tp is None:
            out = self.proj_out(out)
        else:
            out = reduce_from_model(self.tp, F.linear(out, self.proj_out.cast("weight", x.dtype)))
            out = out + self.proj_out.cast("bias", x.dtype)
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


def mid_attention_shape(cfg: ModelConfig, model: int = 1) -> Tuple[int, int, int]:
    """(heads, S, D) of the mid-block attention on one rank: S tokens of the
    lowest resolution, head dim D; with a model axis of `model`, heads /
    model heads when they divide it (mesh.param_shardings), else all."""
    ch = tuple(cfg.block_out_channels)
    side = cfg.sample_size
    for _ in range(len(ch) - 1):
        side = -(-side // 2)
    heads = max(1, ch[-1] // cfg.attention_head_dim)
    local = heads // model if heads % model == 0 else heads
    return local, side * side, ch[-1] // heads


def kernel_limit_errors(cfg: ModelConfig, for_training: bool = False, model: int = 1
                        ) -> List[str]:
    """Every limit of the hand-written kernels that a UNet2D forward of
    `cfg` on CUDA would break, one message per distinct breach; empty when
    the kernels take every call. The sampling arm runs all four forward
    kernels at the shapes conv3x3_shapes, gn_mul_add_shapes and
    mid_attention_shape list; the training arm (for_training=True) runs
    the attention, forward and backward, at the heads of a model axis of
    `model` (mid_attention_shape), and the GroupNorm stats kernel and its
    backward at gn_mul_add_shapes's widths (norm2 of a block sharded over
    `model` at width / model in groups / model, wherever both divide).
    The forward and backward attention kernels each take head dim 64 and
    8, so a model at diffusers' default head dim of 8 samples and trains
    with the kernels. The limits are the wrappers' own predicates, read
    from the kernel sources (ops/build.py source_int)."""
    errors = []
    kernels = ("the attention and GroupNorm kernels" if for_training
               else "silu_conv3x3, gn_mul_add and attention")
    if cfg.dtype != "bfloat16":
        errors.append(f"{kernels} take bfloat16 activations, got dtype {cfg.dtype}")
    heads, S, D = mid_attention_shape(cfg, model)
    groups = cfg.norm_num_groups
    checks = [("attention", attention_shape_error(S, D))]
    if for_training:
        checks.append(("attention backward", attention_bwd_shape_error(S, D)))
        widths = {(C, groups) for _, C in gn_mul_add_shapes(cfg)}
        if model > 1 and groups % model == 0:
            widths |= {(Co // model, groups // model) for _, _, Co in conv3x3_shapes(cfg)
                       if Co % model == 0}
        for C, g in sorted(widths):
            why = stats_shape_error(C, g)
            checks += [("gn_mul_add", why), ("group_norm_silu_bwd", why)]
    else:
        checks += [("silu_conv3x3", conv_shape_error(C, Co))
                   for _, C, Co in sorted(conv3x3_shapes(cfg))]
        checks += [("gn_mul_add", stats_shape_error(C, groups))
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

    `mesh` (parallel/mesh.py) with a model axis over 1 shards the training
    arm (module docstring); `tp_plan` then names each sharded parameter's
    Split, and the state dict holds this rank's shards
    (mesh.shard_state_dict and gather_state_dict carry a full one to them
    and back). The sampling arm runs with replicated parameters.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", plain: bool = False,
                 generator: Optional[torch.Generator] = None, for_training: bool = False,
                 mesh: Optional[Mesh] = None):
        super().__init__()
        device = resolve_device(device)
        axis = model_axis(mesh)
        if axis is not None and not for_training:
            raise ValueError("tensor parallelism (mesh.model > 1) shards the training arm "
                             "(for_training=True); the sampling arm runs replicated, with no mesh")
        if device.type == "cuda" and not plain:
            errors = kernel_limit_errors(cfg, for_training, axis.size if axis else 1)
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
        self.tp = axis
        self.tp_plan = {} if axis is None else tp_plan(
            {n: p.shape for n, p in self.named_parameters()}, axis.size, cfg)
        for name, split in self.tp_plan.items():
            block, layer, leaf = name.split(".")
            self.get_submodule(block).tp = axis
            module = self.get_submodule(f"{block}.{layer}")
            shard = split.take(getattr(module, leaf).detach(), axis.index, axis.size)
            setattr(module, leaf, nn.Parameter(shard.contiguous()))

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
        # One copy_to_model serves every sharded block's time_proj, so the
        # embedding's gradient is summed over the model group once.
        temb_tp = copy_to_model(self.tp, temb)[0] if self.tp is not None else None

        def resnet(block, h, **kw):
            return block(h, temb if block.tp is None else temb_tp, dropout=dropout, **kw)

        x = x.to(dt)
        if cfg.cond_channels > 0:
            if cond is None:
                cond = torch.zeros(x.shape[:-1] + (cfg.cond_channels,), dtype=dt, device=x.device)
            x = torch.cat([x, cond.to(dt)], dim=-1)

        h = conv_module(x, self.conv_in)
        skips = [h]
        for i in range(n):
            for j in range(cfg.layers_per_block):
                h = resnet(getattr(self, f"down_{i}_res_{j}"), h)
                skips.append(h)
            if i != n - 1:
                h = getattr(self, f"down_{i}_downsample")(h)
                skips.append(h)

        h = resnet(self.mid_res_0, h)
        h = self.mid_attn(h)
        h = resnet(self.mid_res_1, h)

        for i in range(n):
            for j in range(cfg.layers_per_block + 1):
                skip = skips.pop()
                block = getattr(self, f"up_{i}_res_{j}")
                if cfg.split_skip_conv:
                    h = resnet(block, h, skip=skip)
                else:
                    h = resnet(block, torch.cat([h, skip], dim=-1))
            if i != n - 1:
                h = getattr(self, f"up_{i}_upsample")(h)

        if self.for_training:
            h = group_norm_silu_nhwc(h, self.norm_out, cfg.norm_num_groups, self.plain)
        else:
            gn = ops.reference_group_norm_silu if self.plain else ops.group_norm_silu
            h = gn(h.contiguous(), self.norm_out.weight, self.norm_out.bias, cfg.norm_num_groups,
                   GN_EPS)
        h = conv_module(h, self.conv_out)
        return h.float()
