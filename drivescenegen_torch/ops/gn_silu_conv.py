"""Fused GroupNorm + SiLU + 3x3 conv: a CUDA kernel and its plain version.

Replaces the Pallas TPU kernel `gn_silu_conv3x3`
(drivescenegen_tpu/ops/pallas/gn_silu_conv.py:150-212). The function is

    conv3x3_SAME(silu(GroupNorm(x)*scale + bias)) + conv_bias,  NHWC,

with the conv's zero padding taken after the activation. As in the JAX
code, the GroupNorm statistics are a separate pass: here the CUDA stats
kernel `gn_mul_add` (ops/group_norm.py, csrc/group_norm.cu) writes
per-(b, c) f32 mul/add, and
the CUDA kernel csrc/gn_silu_conv.cu (an implicit GEMM on wgmma fed by
TMA, with the affine + SiLU applied to the A operand in shared memory)
does the rest, so the activation never goes to device memory. It is bound by the tensor
cores at every UNet shape; see the source for the design.

On a CPU tensor `silu_conv3x3` runs its plain version; on a CUDA tensor it
launches the kernel or raises. It has no backward, as the Pallas kernel has
none: under autograd it raises on either device. `silu_conv3x3.launches`
counts launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from drivescenegen_torch.ops import build
from drivescenegen_torch.ops.group_norm import (
    _device_kind,
    gn_mul_add,
    no_backward,
    reference_gn_mul_add,
)


def reference_silu_conv3x3(x, mul, add, weight, conv_bias):
    """Plain version of the CUDA kernel: t = bf16(silu(x*mul + add)) in f32,
    then a SAME 3x3 conv in x's dtype (weight OIHW [Co, C, 3, 3]) plus
    conv_bias."""
    B, C = x.shape[0], x.shape[-1]
    t = x.float() * mul.reshape(B, 1, 1, C) + add.reshape(B, 1, 1, C)
    t = (t * torch.sigmoid(t)).to(x.dtype)
    y = F.conv2d(t.permute(0, 3, 1, 2), weight.to(x.dtype), None, padding=1)
    return y.permute(0, 2, 3, 1).contiguous() + conv_bias.to(x.dtype)


def reference_gn_silu_conv3x3(x, scale, bias, weight, conv_bias, groups=32, eps=1e-6):
    """Plain composition (drivescenegen_tpu/ops/pallas/gn_silu_conv.py:
    215-230): stats fold, f32 affine, SiLU, SAME conv."""
    mul, add = reference_gn_mul_add(x, scale, bias, groups, eps)
    return reference_silu_conv3x3(x, mul, add, weight, conv_bias)


def conv_shape_error(C: int, Co: int):
    """Why the CUDA kernel cannot take C input and Co output channels, or
    None if it can. The limits are read from csrc/gn_silu_conv.cu."""
    c_multiple = build.source_int("gn_silu_conv", "CK")
    co_multiple = build.source_int("gn_silu_conv", "CO_MULTIPLE")
    if C % c_multiple or Co % co_multiple:
        return (f"the kernel takes C % {c_multiple} == 0 and Co % {co_multiple} == 0, "
                f"got C={C}, Co={Co}")
    return None


def _lib():
    lib = build.load("gn_silu_conv")
    fn = lib.dsg_silu_conv3x3
    if fn.argtypes is None:
        # (x, mul, add, w, bias, out, B, H, W, C, Co, stream) -> cudaError_t
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def silu_conv3x3(x, mul, add, weight, conv_bias):
    """conv3x3_SAME(silu(x*mul + add)) + conv_bias over NHWC x with
    per-(b, c) f32 mul/add and an OIHW [Co, C, 3, 3] weight. No backward
    (no_backward)."""
    no_backward("silu_conv3x3", x, mul, add, weight, conv_bias)
    if _device_kind(x) == "cpu":
        return reference_silu_conv3x3(x, mul, add, weight, conv_bias)
    B, H, W, C = x.shape
    Co = weight.shape[0]
    if x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise TypeError("silu_conv3x3: x must be contiguous bf16 [B, H, W, C] on CUDA")
    if tuple(weight.shape) != (Co, C, 3, 3):
        raise ValueError(f"silu_conv3x3: weight {tuple(weight.shape)} is not [Co, {C}, 3, 3]")
    why = conv_shape_error(C, Co)
    if why:
        raise ValueError(f"silu_conv3x3: {why}")
    if mul.shape != (B, C) or add.shape != (B, C) or conv_bias.shape != (Co,):
        raise ValueError(f"silu_conv3x3: mul/add must be [{B}, {C}] and conv_bias [{Co}]")
    if any(t.device != x.device for t in (mul, add, weight, conv_bias)):
        raise ValueError(f"silu_conv3x3: every input must be on {x.device}")
    if x.data_ptr() % 16:
        raise ValueError("silu_conv3x3: x must be 16-byte aligned (TMA)")
    fn = _lib()
    mul = mul.to(torch.float32).contiguous()
    add = add.to(torch.float32).contiguous()
    # [Co, 3, 3, C] bf16 = [Co, 9C]: K index (ky*3 + kx)*C + c, as the
    # kernel's TMA boxes walk it; free on the model's channels-last copy.
    w = weight.permute(0, 2, 3, 1).to(torch.bfloat16).contiguous()
    cb = conv_bias.to(torch.float32).contiguous()
    out = torch.empty((B, H, W, Co), device=x.device, dtype=torch.bfloat16)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    build.check(fn(x.data_ptr(), mul.data_ptr(), add.data_ptr(), w.data_ptr(), cb.data_ptr(),
                   out.data_ptr(), B, H, W, C, Co, stream), "silu_conv3x3")
    silu_conv3x3.launches += 1
    return out


silu_conv3x3.launches = 0


def gn_silu_conv3x3(x, scale, bias, weight, conv_bias, groups=32, eps=1e-6):
    """conv3x3(silu(GroupNorm(x)*scale + bias)) + conv_bias, SAME padding,
    NHWC: the stats kernel, then the fused conv kernel. No backward."""
    no_backward("gn_silu_conv3x3", x, scale, bias, weight, conv_bias)
    mul, add = gn_mul_add(x, scale, bias, groups, eps)
    return silu_conv3x3(x, mul, add, weight, conv_bias)
