"""The plain reference UNet: DriveSceneGen's UNet2DModel semantics in plain
PyTorch, float32, with TF32 off.

It reads the flat parameter tree a model directory's params.npz holds
("params/<module>/<kernel|bias|scale>": conv kernels HWIO, dense kernels
[in, out], norm scales and biases [C]) and is frozen: no autograd state of
its own, the weights are whatever tensors it is handed (they may require
grad, for the training reference). It imports nothing of the program.

Run it inside plain_float32(). Public tensors are NHWC, as the program's:
forward(x [B, H, W, C], t [B]) -> eps [B, H, W, C_out]. Inside,
activations are NCHW, the layout F.conv2d takes. Where `taps` is a list,
each forward appends to it the mid-block attention's branch, proj_out's
output [B, H*W, C] before the residual add.

The walk: conv_in -> down blocks (ResnetBlocks, then a stride-2 3x3 conv
downsample) -> mid block (ResnetBlock, self-attention, ResnetBlock) -> up
blocks (ResnetBlocks over concat(h, skip), then nearest x2 and a 3x3
conv) -> GroupNorm, SiLU, conv_out. A sinusoidal time embedding [cos, sin]
feeds a 2-layer MLP whose SiLU'd output every ResnetBlock projects and adds
after its first conv. GroupNorm eps is 1e-6. A stride-2 conv pads (1, 1)
per side when the configuration says torch_pad_downsample (diffusers'
Downsample2D), else XLA's SAME: (0, 1) on an even side.

`precision` "fp8" rounds both operands of every conv, dense and attention
product to float8 e4m3 with a per-tensor scale (amax / 448), computed in
float32 after that: the control that a comparison has to fail. Under
autograd the rounding passes the gradient straight through.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

GN_EPS = 1e-6
FP8_MAX = 448.0


@contextlib.contextmanager
def plain_float32():
    """float32 products in float32 while it is open: TF32 off, and cuDNN
    off, so that a conv is PyTorch's own im2col and cuBLAS SGEMM (cuDNN's
    heuristics pick FFT algorithms for float32 convs on the H100: a 4-row
    256x256 forward took 6x as long). The flags are put back on exit, so the
    program runs as it was set."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.enabled)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.enabled = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.enabled) = flags


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale, back in x's dtype;
    the gradient passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
    return x + (q - x).detach() if x.requires_grad else q


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """The flat tree's key -> shape for a configuration (the keys the
    ModelConfig fields of `cfg` give), in the order the forward uses them."""
    ch = list(cfg["block_out_channels"])
    lpb, temb = cfg["layers_per_block"], ch[0] * 4
    shapes: Dict[str, Tuple[int, ...]] = {}

    def conv(name, cin, cout, k=3):
        shapes[f"params/{name}/kernel"] = (k, k, cin, cout)
        shapes[f"params/{name}/bias"] = (cout,)

    def dense(name, cin, cout):
        shapes[f"params/{name}/kernel"] = (cin, cout)
        shapes[f"params/{name}/bias"] = (cout,)

    def norm(name, c):
        shapes[f"params/{name}/scale"] = (c,)
        shapes[f"params/{name}/bias"] = (c,)

    def resnet(name, cin, cout):
        norm(f"{name}/norm1", cin)
        conv(f"{name}/conv1", cin, cout)
        dense(f"{name}/time_proj", temb, cout)
        norm(f"{name}/norm2", cout)
        conv(f"{name}/conv2", cout, cout)
        if cin != cout:
            conv(f"{name}/shortcut", cin, cout, k=1)

    dense("time_mlp/dense1", ch[0], temb)
    dense("time_mlp/dense2", temb, temb)
    conv("conv_in", cfg["in_channels"] + cfg.get("cond_channels", 0), ch[0])
    skips, cin = [ch[0]], ch[0]
    for i, c in enumerate(ch):
        for j in range(lpb):
            resnet(f"down_{i}_res_{j}", cin, c)
            cin = c
            skips.append(c)
        if i != len(ch) - 1:
            conv(f"down_{i}_downsample/conv", c, c)
            skips.append(c)
    resnet("mid_res_0", cin, ch[-1])
    norm("mid_attn/norm", ch[-1])
    dense("mid_attn/qkv", ch[-1], 3 * ch[-1])
    dense("mid_attn/proj_out", ch[-1], ch[-1])
    resnet("mid_res_1", ch[-1], ch[-1])
    for i, c in enumerate(reversed(ch)):
        for j in range(lpb + 1):
            resnet(f"up_{i}_res_{j}", cin + skips.pop(), c)
            cin = c
        if i != len(ch) - 1:
            conv(f"up_{i}_upsample/conv", c, c)
    norm("norm_out", ch[0])
    conv("conv_out", ch[0], cfg["out_channels"])
    return shapes


class ReferenceUNet:
    """The denoiser over the flat tree `params`, in float32 ("f32") or with
    its products' operands rounded to fp8 ("fp8")."""

    def __init__(self, cfg: dict, params: Dict[str, torch.Tensor], precision: str = "f32"):
        if precision not in ("f32", "fp8"):
            raise ValueError(f"precision is f32 or fp8, got {precision!r}")
        want = param_shapes(cfg)
        if set(want) != set(params):
            raise KeyError(f"the flat tree differs from the configuration's: missing "
                           f"{sorted(set(want) - set(params))[:4]}, extra "
                           f"{sorted(set(params) - set(want))[:4]}")
        for key, shape in want.items():
            if tuple(params[key].shape) != shape:
                raise ValueError(f"{key}: {tuple(params[key].shape)}, want {shape}")
        self.cfg, self.p, self.fp8 = cfg, params, precision == "fp8"
        self.taps = None

    def _q(self, x: torch.Tensor) -> torch.Tensor:
        return round_fp8(x) if self.fp8 else x

    def _w(self, name: str) -> torch.Tensor:
        return self.p[f"params/{name}"].float()

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, pad=None) -> torch.Tensor:
        k = self._w(f"{name}/kernel")  # HWIO
        w = self._q(k.permute(3, 2, 0, 1))
        if pad is None:
            return F.conv2d(self._q(x), w, self._w(f"{name}/bias"), stride=stride,
                            padding=k.shape[0] // 2)
        return F.conv2d(F.pad(self._q(x), pad), w, self._w(f"{name}/bias"), stride=stride)

    def dense(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return self._q(x) @ self._q(self._w(f"{name}/kernel")) + self._w(f"{name}/bias")

    def norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        return F.group_norm(x, self.cfg["norm_num_groups"], self._w(f"{name}/scale"),
                            self._w(f"{name}/bias"), eps=GN_EPS)

    def resnet(self, name: str, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = self.conv(f"{name}/conv1", F.silu(self.norm(f"{name}/norm1", x)))
        h = h + self.dense(f"{name}/time_proj", F.silu(temb))[:, :, None, None]
        h = self.conv(f"{name}/conv2", F.silu(self.norm(f"{name}/norm2", h)))
        if f"params/{name}/shortcut/kernel" in self.p:
            x = self.conv(f"{name}/shortcut", x)
        return x + h

    def attention(self, x: torch.Tensor) -> torch.Tensor:
        B, C, H, W = x.shape
        hd = self.cfg["attention_head_dim"]
        heads = max(1, C // hd)
        hd = C // heads
        h = self.norm("mid_attn/norm", x).flatten(2).transpose(1, 2)  # [B, S, C]
        qkv = self.dense("mid_attn/qkv", h)
        q, k, v = (t.reshape(B, H * W, heads, hd).transpose(1, 2) for t in qkv.split(C, dim=-1))
        logits = torch.einsum("bhqd,bhkd->bhqk", self._q(q), self._q(k)) / math.sqrt(hd)
        w = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhkd->bhqd", self._q(w), self._q(v))
        out = self.dense("mid_attn/proj_out", out.transpose(1, 2).reshape(B, H * W, C))
        if self.taps is not None:
            self.taps.append(out)
        return x + out.transpose(1, 2).reshape(B, C, H, W)

    def _down_pad(self, n: int) -> Tuple[int, int]:
        if self.cfg.get("torch_pad_downsample", False):
            return 1, 1
        total = max((-(-n // 2) - 1) * 2 + 3 - n, 0)
        return total // 2, total - total // 2

    def __call__(self, x: torch.Tensor, t: torch.Tensor, cond=None) -> torch.Tensor:
        cfg = self.cfg
        ch = list(cfg["block_out_channels"])
        n, lpb = len(ch), cfg["layers_per_block"]
        B = x.shape[0]
        x = x.float()
        if cfg.get("cond_channels", 0) > 0:
            if cond is None:
                cond = torch.zeros(x.shape[:-1] + (cfg["cond_channels"],), device=x.device)
            x = torch.cat([x, cond.float()], dim=-1)
        t = torch.as_tensor(t, device=x.device).reshape(-1).expand(B).float()
        half = ch[0] // 2
        freqs = torch.exp(-math.log(10000.0) * torch.arange(half, device=x.device) / half)
        args = t[:, None] * freqs[None, :]
        temb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
        temb = self.dense("time_mlp/dense2", F.silu(self.dense("time_mlp/dense1", temb)))

        h = self.conv("conv_in", x.permute(0, 3, 1, 2))
        skips: List[torch.Tensor] = [h]
        for i in range(n):
            for j in range(lpb):
                h = self.resnet(f"down_{i}_res_{j}", h, temb)
                skips.append(h)
            if i != n - 1:
                (top, bottom), (left, right) = (self._down_pad(h.shape[2]),
                                                self._down_pad(h.shape[3]))
                h = self.conv(f"down_{i}_downsample/conv", h, stride=2,
                              pad=(left, right, top, bottom))
                skips.append(h)
        h = self.resnet("mid_res_0", h, temb)
        h = self.attention(h)
        h = self.resnet("mid_res_1", h, temb)
        for i in range(n):
            for j in range(lpb + 1):
                h = self.resnet(f"up_{i}_res_{j}", torch.cat([h, skips.pop()], dim=1), temb)
            if i != n - 1:
                h = self.conv(f"up_{i}_upsample/conv",
                              F.interpolate(h, scale_factor=2, mode="nearest"))
        h = self.conv("conv_out", F.silu(self.norm("norm_out", h)))
        return h.permute(0, 2, 3, 1)
