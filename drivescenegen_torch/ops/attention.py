"""Attention over [B, heads, S, D]: CUDA flash-attention kernels, forward
and backward, and their plain versions.

Replaces the mid-block attention that the JAX UNet runs with
impl="flash" (drivescenegen_tpu/models/unet2d.py:307-316), JAX's library
Pallas kernel: its forward `_flash_attention_impl` and, under jax.grad,
its backward kernels `_flash_attention_bwd_dkv` and `_flash_attention_bwd_dq`
(jax/experimental/pallas/ops/tpu/flash_attention.py:589, :941, :1287). The
plain forward is the impl="xla" branch (:319-328): logits accumulated in
f32, softmax in f32, weights cast to the input dtype before the product
with V.

The forward kernel (csrc/flash_attention.cu) keeps the logits in registers
with an online softmax and streams K and V by TMA into wgmma; with an lse
buffer it also stores each row's log-sum-exp, the residual the backward
needs (the library saves l and m, flash_attention.py:248-251). The
backward kernels (csrc/flash_attention_bwd.cu) recompute P from q, k and
lse: one launch per query tile writes dQ and di = rowsum(o * dO), one per
key tile writes dK and dV; no atomics, so the result is deterministic.

`attention` runs the plain version on a CPU tensor and launches the kernel
on a CUDA tensor, or raises. When grad mode is on and an input requires
grad it goes through `AttentionFunction`, whose backward is
`attention_bwd`. Each wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import ctypes

import torch

from drivescenegen_torch.ops import build
from drivescenegen_torch.ops.group_norm import _device_kind, no_backward


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """f32 for bf16/f16/f32 inputs, f64 for f64 ones (gradcheck)."""
    return torch.promote_types(x.dtype, torch.float32)


def _logits(q, k, scale: float):
    acc = _acc_dtype(q)
    return torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)) * scale


def reference_attention(q, k, v, scale: float):
    """softmax(q k^T * scale) v over [B, heads, S, D], f32 logits."""
    weights = torch.softmax(_logits(q, k, scale), dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", weights, v)


def reference_attention_lse(q, k, scale: float):
    """Per-row log-sum-exp of the scaled logits, [B, heads, S] (natural
    log), the residual the backward reads."""
    return torch.logsumexp(_logits(q, k, scale), dim=-1)


def reference_attention_bwd(q, k, v, o, lse, do, scale: float):
    """Plain backward of o = softmax(q k^T * scale) v, the FlashAttention
    backward written step by step in f32 (f64 for f64 inputs):

        P  = exp(q k^T * scale - lse)      dV = P^T dO
        dP = dO v^T                        di = rowsum(o * dO)
        dS = P * (dP - di)                 dQ = dS k * scale,  dK = dS^T q * scale

    P and dS are rounded to the input dtype before their products, as the
    kernels round them to bf16. Returns (dq, dk, dv) in the input dtypes."""
    acc = _acc_dtype(q)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    p = torch.exp(_logits(q, k, scale) - lse.to(acc)[..., None])
    di = (o.to(acc) * dof).sum(dim=-1)
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).to(acc), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - di[..., None])).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_shape_error(S: int, D: int):
    """Why the CUDA forward kernel cannot take sequence length S and head
    dim D, or None if it can. The limits are read from csrc/flash_attention.cu."""
    head_dim = build.source_int("flash_attention", "D")
    s_multiple = build.source_int("flash_attention", "S_MULTIPLE")
    if D != head_dim or S % s_multiple:
        return f"the kernel takes head_dim {head_dim} and S % {s_multiple} == 0, got D={D}, S={S}"
    return None


def attention_bwd_shape_error(S: int, D: int):
    """The same for the backward kernels (csrc/flash_attention_bwd.cu)."""
    head_dim = build.source_int("flash_attention_bwd", "D")
    s_multiple = build.source_int("flash_attention_bwd", "S_MULTIPLE")
    if D != head_dim or S % s_multiple:
        return (f"the backward kernels take head_dim {head_dim} and S % {s_multiple} == 0, "
                f"got D={D}, S={S}")
    return None


def _entry(lib_name: str, fn_name: str, n_ptr: int, n_strides: int):
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        # (pointers..., B, heads, S, head_dim, element strides..., scale,
        # stream) -> cudaError_t
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * n_strides + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_view(name: str, t: torch.Tensor, like: torch.Tensor, what: str) -> None:
    if t.shape != like.shape or t.dtype != torch.bfloat16 or t.device != like.device:
        raise TypeError(f"{what}: {name} must be bf16 {tuple(like.shape)} on {like.device}")
    if not _kernel_layout(t):
        raise ValueError(f"{what}: {name} needs a contiguous last dim and 16-byte aligned rows")


def _kernel_layout(t: torch.Tensor) -> bool:
    """A view the kernels read by rows: last dim contiguous, row strides
    whole 16-byte lines, base 16-byte aligned."""
    return t.stride(3) == 1 and not any(s % 8 for s in t.stride()[:3]) and t.data_ptr() % 16 == 0


def _heads_view(B, S, heads, D, device):
    """A [B, heads, S, D] view of a [B, S, heads, D] buffer: merging the
    heads afterwards (or the qkv views' backward) is then free."""
    return torch.empty((B, S, heads, D), device=device, dtype=torch.bfloat16).transpose(1, 2)


def _attention_kernel(q, k, v, scale: float, with_lse: bool):
    B, Hh, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q, "attention")
    why = attention_shape_error(S, D)
    if why:
        raise ValueError(f"attention: {why}")
    fn = _entry("flash_attention", "dsg_flash_attention", 5, 12)
    out = _heads_view(B, S, Hh, D, q.device)
    lse = torch.empty((B, Hh, S), device=q.device, dtype=torch.float32) if with_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if lse is None else lse.data_ptr(), B, Hh, S, D,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                   float(scale), stream), "attention")
    attention.launches += 1
    return out, lse


def attention_with_lse(q, k, v, scale: float):
    """(attention(q, k, v), its rows' log-sum-exp [B, heads, S] f32): the
    forward kernel with its lse output on CUDA, the plain versions on CPU.
    No gradient of its own (it raises under autograd): AttentionFunction's
    forward."""
    no_backward("attention_with_lse", q, k, v, hint="ops.attention has one")
    if _device_kind(q) == "cpu":
        return reference_attention(q, k, v, scale), reference_attention_lse(q, k, scale)
    return _attention_kernel(q, k, v, scale, with_lse=True)


class AttentionFunction(torch.autograd.Function):
    """attention with a gradient: the forward kernel saving lse, the
    backward kernels (CUDA tensors); the plain versions (CPU tensors)."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        o, lse = attention_with_lse(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None


def attention(q, k, v, scale: float):
    """Non-causal softmax(q k^T * scale) v. q, k, v: [B, heads, S, D], any
    strides with a contiguous last dim (views into a fused qkv projection
    are fine). The CUDA kernel takes bf16 at the shapes attention_shape_error
    allows, and returns a [B, heads, S, D] view of a [B, S, heads, D]
    buffer, so that merging the heads afterwards is free. Differentiable
    (AttentionFunction) when grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttentionFunction.apply(q, k, v, scale)
    if _device_kind(q) == "cpu":
        return reference_attention(q, k, v, scale)
    return _attention_kernel(q, k, v, scale, with_lse=False)[0]


attention.launches = 0


def attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of attention from the forward's q, k, v, output o and
    lse ([B, heads, S] f32) and the output's gradient do. On CUDA: the dQ
    kernel, then the dK/dV kernel; do of any layout is copied to one they
    read. On CPU: reference_attention_bwd."""
    if _device_kind(q) == "cpu":
        return reference_attention_bwd(q, k, v, o, lse, do, scale)
    B, Hh, S, D = q.shape
    if do.dtype != torch.bfloat16:
        raise TypeError(f"attention_bwd: do must be bf16, got {do.dtype}")
    if do.shape == q.shape and not _kernel_layout(do):
        do = do.clone(memory_format=torch.contiguous_format)  # fresh, so aligned too
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_view(name, t, q, "attention_bwd")
    if lse.shape != (B, Hh, S) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"attention_bwd: lse must be contiguous f32 [{B}, {Hh}, {S}]")
    if lse.device != q.device:
        raise ValueError(f"attention_bwd: lse must be on {q.device}")
    why = attention_bwd_shape_error(S, D)
    if why:
        raise ValueError(f"attention_bwd: {why}")
    di = torch.empty((B, Hh, S), device=q.device, dtype=torch.float32)
    dq = attention_bwd_dq(q, k, v, o, do, lse, di, scale)
    dk, dv = attention_bwd_dkv(q, k, v, do, lse, di, scale)
    return dq, dk, dv


def attention_bwd_dq(q, k, v, o, do, lse, di, scale: float):
    """The dQ kernel alone, on inputs attention_bwd has checked: returns dq
    and writes di = rowsum(o * do) into `di` for attention_bwd_dkv."""
    B, Hh, S, D = q.shape
    fn = _entry("flash_attention_bwd", "dsg_flash_attention_bwd_dq", 8, 18)
    dq = _heads_view(B, S, Hh, D, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), di.data_ptr(), dq.data_ptr(), B, Hh, S, D,
                   *(s for t in (q, k, v, o, do, dq) for s in t.stride()[:3]),
                   float(scale), stream), "attention_bwd_dq")
    attention_bwd_dq.launches += 1
    return dq


attention_bwd_dq.launches = 0


def attention_bwd_dkv(q, k, v, do, lse, di, scale: float):
    """The dK/dV kernel alone, reading the di that attention_bwd_dq wrote."""
    B, Hh, S, D = q.shape
    fn = _entry("flash_attention_bwd", "dsg_flash_attention_bwd_dkv", 8, 18)
    dk, dv = _heads_view(B, S, Hh, D, q.device), _heads_view(B, S, Hh, D, q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   di.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hh, S, D,
                   *(s for t in (q, k, v, do, dk, dv) for s in t.stride()[:3]),
                   float(scale), stream), "attention_bwd_dkv")
    attention_bwd_dkv.launches += 1
    return dk, dv


attention_bwd_dkv.launches = 0
