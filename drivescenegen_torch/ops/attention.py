"""Attention over [B, heads, S, D]: a CUDA flash-attention kernel and its
plain version.

Replaces the mid-block attention that the JAX UNet runs with
impl="flash" (drivescenegen_tpu/models/unet2d.py:307-316, JAX's library
Pallas kernel). The plain version is the impl="xla" branch (:319-328):
logits accumulated in f32, softmax in f32, weights cast to the input dtype
before the product with V. The kernel (csrc/flash_attention.cu) keeps the
logits in registers with an online softmax, streams K and V by TMA into
wgmma; it is bound by the tensor cores and the softmax arithmetic at the
mid block's 1024 tokens.

On a CPU tensor `attention` runs the plain version; on a CUDA tensor it
launches the kernel or raises. `attention.launches` counts launches.
"""

from __future__ import annotations

import ctypes

import torch

from drivescenegen_torch.ops import build
from drivescenegen_torch.ops.group_norm import _device_kind


def reference_attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v over [B, heads, S, D], f32 logits."""
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    weights = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def attention_shape_error(S: int, D: int):
    """Why the CUDA kernel cannot take sequence length S and head dim D, or
    None if it can. The limits are read from csrc/flash_attention.cu."""
    head_dim = build.source_int("flash_attention", "D")
    s_multiple = build.source_int("flash_attention", "S_MULTIPLE")
    if D != head_dim or S % s_multiple:
        return f"the kernel takes head_dim {head_dim} and S % {s_multiple} == 0, got D={D}, S={S}"
    return None


def _lib():
    lib = build.load("flash_attention")
    fn = lib.dsg_flash_attention
    if fn.argtypes is None:
        # (q, k, v, o, B, heads, S, head_dim, 12 element strides, scale,
        # stream) -> cudaError_t
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 12
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def attention(q, k, v, scale: float):
    """Non-causal softmax(q k^T * scale) v. q, k, v: [B, heads, S, D], any
    strides with a contiguous last dim (views into a fused qkv projection
    are fine). The CUDA kernel takes bf16 at the shapes attention_shape_error
    allows, and returns a [B, heads, S, D] view of a [B, S, heads, D]
    buffer, so that merging the heads afterwards is free."""
    if _device_kind(q) == "cpu":
        return reference_attention(q, k, v, scale)
    B, Hh, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16 or t.device != q.device:
            raise TypeError(f"attention: {name} must be bf16 {tuple(q.shape)} on {q.device}")
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"attention: {name} needs a contiguous last dim and 16-byte aligned rows")
    why = attention_shape_error(S, D)
    if why:
        raise ValueError(f"attention: {why}")
    fn = _lib()
    out = torch.empty((B, S, Hh, D), device=q.device, dtype=torch.bfloat16).transpose(1, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hh, S, D,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                   float(scale), stream), "attention")
    attention.launches += 1
    return out


attention.launches = 0
