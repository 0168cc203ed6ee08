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

The forward has one kernel for each head dim it takes. At D = 64
(csrc/flash_attention.cu) it keeps the logits in registers with an online
softmax and streams K and V by TMA into wgmma; with an lse buffer it also
stores each row's log-sum-exp, the residual the backward needs (the
library saves l and m, flash_attention.py:248-251). At D = 8, diffusers'
default head dim that an imported reference model keeps
(csrc/flash_attention_d8.cu), the exponentials bound it and it runs
mma.sync on K and V rows copied by cp.async; with an lse buffer it writes
the same residual. The backward also has one kernel for each head dim. At
D = 64 (csrc/flash_attention_bwd.cu) it is three launches: a pre-pass for
di = rowsum(o * dO) (the library's jnp step, :273); one pass over
(128-key tile, head, batch) items that recomputes P from q, k and lse,
writes dK and dV, and sums each query tile's dQ over the key tiles into an
f32 accumulator in a fixed order, so the result is deterministic; and a
dQ pass that scales the accumulator into dq. At D = 8
(csrc/flash_attention_bwd_d8.cu) it is one launch, a CTA a (head, batch)
holding the whole head in shared memory: di in its prologue, P recomputed
once, dQ summed over the warps' key tiles in a fixed order
(attention_bwd_d8, whose plain version is reference_attention_bwd).

`attention` runs the plain version on a CPU tensor and launches the kernel
of q's head dim on a CUDA tensor, or raises. When grad mode is on and an
input requires grad it goes through `AttentionFunction`, whose backward is
`attention_bwd`. Each wrapper counts its launches in `<wrapper>.launches`;
`attention.launches` counts the forward kernels of every head dim, and
`attention.launches_by_source` each kernel's own, by source (each
backward kernel has wrappers of its own).
"""

from __future__ import annotations

import ctypes
import functools

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
    dq, dk, dv = _reference_bwd(q, k, v, lse, reference_attention_di(o, do), do, scale)
    return (dq * scale).to(q.dtype), dk, dv


def reference_attention_di(o, do):
    """di = rowsum(o * do) [B, heads, S] in f32 (f64 for f64 inputs): the
    backward's pre-pass."""
    acc = _acc_dtype(o)
    return (o.to(acc) * do.to(acc)).sum(dim=-1)


def _reference_bwd(q, k, v, lse, di, do, scale: float):
    """(dS k in f32 or f64, dk, dv) given di: dq before its scale."""
    acc = _acc_dtype(q)
    qf, kf, vf, dof = (t.to(acc) for t in (q, k, v, do))
    p = torch.exp(_logits(q, k, scale) - lse.to(acc)[..., None])
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(q.dtype).to(acc), dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - di.to(acc)[..., None])).to(q.dtype).to(acc)
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# The head-dim-64 main pass leaves dQ in the order its dQ warpgroup holds it: per
# 64-query tile, float4 j of thread t (warp w = t // 32, lane 4g + tq) at
# j * 128 + t, holding rows 16w + g and 16w + g + 8, columns 8j + 2tq and
# 8j + 2tq + 1 (wgmma's accumulator layout). As dims of a [64, 64] tile:
# rows (w, r, g), columns (j, tq, e); stored (j, w, g, tq, r, e).
_TILE_ROWS_COLS = (4, 2, 8, 8, 4, 2)  # w, r, g, j, tq, e


def dq_to_fragment_order(x: torch.Tensor) -> torch.Tensor:
    """[B, heads, S, 64] -> [B, heads, S / 64, 4096] in the main pass's
    fragment order."""
    B, Hh, S, D = x.shape
    if D != 64:
        raise ValueError(f"dq_to_fragment_order: the fragment order is the head-dim-64 main "
                         f"pass's, got head_dim {D}")
    t = x.reshape(B, Hh, S // 64, *_TILE_ROWS_COLS)
    return t.permute(0, 1, 2, 6, 3, 5, 7, 4, 8).reshape(B, Hh, S // 64, 64 * D)


def dq_from_fragment_order(acc: torch.Tensor) -> torch.Tensor:
    """The inverse of dq_to_fragment_order."""
    B, Hh, tiles, n = acc.shape
    t = acc.reshape(B, Hh, tiles, 8, 4, 8, 4, 2, 2)  # j, w, g, tq, r, e
    return t.permute(0, 1, 2, 4, 7, 5, 3, 6, 8).reshape(B, Hh, tiles * 64, n // 64)


def reference_attention_bwd_main(q, k, v, do, lse, di, scale: float):
    """(dk, dv, acc): the head-dim-64 main pass's outputs given di, acc =
    dq / scale in f32 and fragment order."""
    dq, dk, dv = _reference_bwd(q, k, v, lse, di, do, scale)
    return dk, dv, dq_to_fragment_order(dq.float())


def reference_attention_bwd_dq(acc, scale: float):
    """dq = bf16(acc * scale), [B, heads, S, 64]: the dQ pass."""
    return (dq_from_fragment_order(acc) * scale).to(torch.bfloat16)


# The forward and backward kernels' sources, one of each for each head dim.
_FORWARD_SOURCES = ("flash_attention", "flash_attention_d8")
_BACKWARD_SOURCES = ("flash_attention_bwd", "flash_attention_bwd_d8")


@functools.cache
def forward_kernels() -> dict:
    """{head dim: (source, S multiple)} of the forward kernels, read from
    their sources' constexpr lines (build.source_int)."""
    return {build.source_int(name, "D"): (name, build.source_int(name, "S_MULTIPLE"))
            for name in _FORWARD_SOURCES}


def attention_shape_error(S: int, D: int):
    """Why no CUDA forward kernel can take sequence length S and head dim
    D, or None if one can. The limits are read from the kernels' sources."""
    kernels = forward_kernels()
    if D not in kernels or S % kernels[D][1]:
        takes = " or ".join(f"head_dim {d} with S % {m} == 0" for d, (_, m) in kernels.items())
        return f"the kernels take {takes}, got D={D}, S={S}"
    return None


@functools.cache
def backward_kernels() -> dict:
    """{head dim: (source, S multiple, S max or None)} of the backward
    kernels, read from their sources' constexpr lines (build.source_int);
    a source with no S_MAX line takes any multiple."""
    return {build.source_int(name, "D"): (name, build.source_int(name, "S_MULTIPLE"),
                                          build.source_int(name, "S_MAX", required=False))
            for name in _BACKWARD_SOURCES}


def attention_bwd_shape_error(S: int, D: int):
    """The same for the backward kernels, one for each head dim."""
    kernels = backward_kernels()
    if D not in kernels or S % kernels[D][1] or (kernels[D][2] and S > kernels[D][2]):
        takes = " or ".join(f"head_dim {d} with S % {m} == 0" + (f" and S <= {x}" if x else "")
                            for d, (_, m, x) in kernels.items())
        return f"the backward kernels take {takes}, got D={D}, S={S}"
    return None


def _entry(lib_name: str, fn_name: str, n_ptr: int, n_strides: int, with_scale: bool = True):
    lib = build.load(lib_name)
    fn = getattr(lib, fn_name)
    if fn.argtypes is None:
        # (pointers..., B, heads, S, head_dim, element strides..., [scale,]
        # stream) -> cudaError_t
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4
                       + [ctypes.c_longlong] * n_strides
                       + [ctypes.c_float] * with_scale + [ctypes.c_void_p])
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


def _stream(t: torch.Tensor):
    return torch.cuda.current_stream(t.device).cuda_stream


def _attention_kernel(q, k, v, scale: float, with_lse: bool):
    B, Hh, S, D = q.shape
    for name, t in (("q", q), ("k", k), ("v", v)):
        _check_view(name, t, q, "attention")
    why = attention_shape_error(S, D)
    if why:
        raise ValueError(f"attention: {why}")
    name = forward_kernels()[D][0]
    fn = _entry(name, f"dsg_{name}", 5, 12)
    out = _heads_view(B, S, Hh, D, q.device)
    lse = torch.empty((B, Hh, S), device=q.device, dtype=torch.float32) if with_lse else None
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   None if lse is None else lse.data_ptr(), B, Hh, S, D,
                   *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *out.stride()[:3],
                   float(scale), _stream(q)), "attention")
    attention.launches += 1
    attention.launches_by_source[name] += 1
    return out, lse


def attention_with_lse(q, k, v, scale: float):
    """(attention(q, k, v), its rows' log-sum-exp [B, heads, S] f32): the
    forward kernel of q's head dim with its lse output on CUDA, the plain
    versions on CPU.
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
    are fine). The CUDA kernels take bf16 at the shapes attention_shape_error
    allows (one kernel a head dim, one launch counter for both), and return
    a [B, heads, S, D] view of a [B, S, heads, D] buffer, so that merging
    the heads afterwards is free. Differentiable
    (AttentionFunction) when grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return AttentionFunction.apply(q, k, v, scale)
    if _device_kind(q) == "cpu":
        return reference_attention(q, k, v, scale)
    return _attention_kernel(q, k, v, scale, with_lse=False)[0]


attention.launches = 0
attention.launches_by_source = dict.fromkeys(_FORWARD_SOURCES, 0)


def attention_bwd(q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of attention from the forward's q, k, v, output o and
    lse ([B, heads, S] f32) and the output's gradient do. On CUDA, the
    kernel of q's head dim on the current stream: at D = 64 the pre-pass,
    the main pass and the dQ pass, in that order; at D = 8 attention_bwd_d8.
    do of any layout is copied to one they read. On CPU:
    reference_attention_bwd."""
    if _device_kind(q) == "cpu":
        return reference_attention_bwd(q, k, v, o, lse, do, scale)
    if backward_kernels().get(q.shape[-1], ("",))[0] == "flash_attention_bwd_d8":
        return attention_bwd_d8(q, k, v, o, lse, do, scale)
    do = _checked_bwd_inputs(q, k, v, o, lse, do, "attention_bwd")
    di, sems = attention_bwd_prep(o, do)
    dk, dv, acc = attention_bwd_main(q, k, v, do, lse, di, sems, scale)
    return attention_bwd_dq(acc, scale), dk, dv


def _checked_bwd_inputs(q, k, v, o, lse, do, what: str):
    """do, copied to the kernels' layout where it is not in it, once q, k,
    v, o, lse and do are what the backward kernels read; raises if not."""
    B, Hh, S, D = q.shape
    if do.dtype != torch.bfloat16:
        raise TypeError(f"{what}: do must be bf16, got {do.dtype}")
    if do.shape == q.shape and not _kernel_layout(do):
        do = do.clone(memory_format=torch.contiguous_format)  # fresh, so aligned too
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        _check_view(name, t, q, what)
    if (lse.shape != (B, Hh, S) or lse.dtype != torch.float32 or not lse.is_contiguous()
            or lse.data_ptr() % 16):
        raise ValueError(f"{what}: lse must be contiguous 16-byte aligned f32 [{B}, {Hh}, {S}]")
    if lse.device != q.device:
        raise ValueError(f"{what}: lse must be on {q.device}")
    why = attention_bwd_shape_error(S, D)
    if why:
        raise ValueError(f"{what}: {why}")
    return do


def attention_bwd_prep(o, do):
    """The pre-pass alone, on inputs attention_bwd has checked: (di, sems),
    di = rowsum(o * do) f32 [B, heads, S] and the main pass's dQ semaphores
    (int32, one per 64-query tile) zeroed. On CPU: reference_attention_di
    and zeros."""
    B, Hh, S, D = o.shape
    if _device_kind(o) == "cpu":
        return reference_attention_di(o, do), torch.zeros(B * Hh * S // 64, dtype=torch.int32)
    fn = _entry("flash_attention_bwd", "dsg_flash_attention_bwd_prep", 4, 6, with_scale=False)
    di = torch.empty((B, Hh, S), device=o.device, dtype=torch.float32)
    sems = torch.empty(B * Hh * S // 64, device=o.device, dtype=torch.int32)
    build.check(fn(o.data_ptr(), do.data_ptr(), di.data_ptr(), sems.data_ptr(), B, Hh, S, D,
                   *o.stride()[:3], *do.stride()[:3], _stream(o)), "attention_bwd_prep")
    attention_bwd_prep.launches += 1
    return di, sems


attention_bwd_prep.launches = 0


def attention_bwd_main(q, k, v, do, lse, di, sems, scale: float):
    """The main pass alone, after attention_bwd_prep: (dk, dv, acc), acc
    the f32 dq / scale in the fragment order of dq_to_fragment_order. On
    CPU: reference_attention_bwd_main."""
    B, Hh, S, D = q.shape
    if _device_kind(q) == "cpu":
        return reference_attention_bwd_main(q, k, v, do, lse, di, scale)
    fn = _entry("flash_attention_bwd", "dsg_flash_attention_bwd", 10, 18)
    dk, dv = _heads_view(B, S, Hh, D, q.device), _heads_view(B, S, Hh, D, q.device)
    acc = torch.empty((B, Hh, S // 64, 64 * D), device=q.device, dtype=torch.float32)
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                   di.data_ptr(), acc.data_ptr(), sems.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                   B, Hh, S, D, *(s for t in (q, k, v, do, dk, dv) for s in t.stride()[:3]),
                   float(scale), _stream(q)), "attention_bwd_main")
    attention_bwd_main.launches += 1
    return dk, dv, acc


attention_bwd_main.launches = 0


def attention_bwd_dq(acc, scale: float):
    """The dQ pass alone: dq = bf16(acc * scale), a [B, heads, S, 64] view
    of a [B, S, heads, 64] buffer. On CPU: reference_attention_bwd_dq."""
    if _device_kind(acc) == "cpu":
        return reference_attention_bwd_dq(acc, scale)
    B, Hh, tiles, n = acc.shape
    S, D = tiles * 64, n // 64
    fn = _entry("flash_attention_bwd", "dsg_flash_attention_bwd_dq", 2, 3)
    dq = _heads_view(B, S, Hh, D, acc.device)
    build.check(fn(acc.data_ptr(), dq.data_ptr(), B, Hh, S, D, *dq.stride()[:3], float(scale),
                   _stream(acc)), "attention_bwd_dq")
    attention_bwd_dq.launches += 1
    return dq


attention_bwd_dq.launches = 0


def attention_bwd_d8(q, k, v, o, lse, do, scale: float):
    """The head-dim-8 backward, one launch on CUDA tensors (attention_bwd
    takes CPU ones), with attention_bwd's checks: (dq, dk, dv), each a
    [B, heads, S, 8] view of a [B, S, heads, 8] buffer. It computes di
    itself."""
    if _device_kind(q) != "cuda":
        raise ValueError(f"attention_bwd_d8: CUDA tensors only, got {q.device}")
    B, Hh, S, D = q.shape
    if D != (head_dim := build.source_int("flash_attention_bwd_d8", "D")):
        raise ValueError(f"attention_bwd_d8: head_dim {D}, this kernel takes {head_dim}")
    do = _checked_bwd_inputs(q, k, v, o, lse, do, "attention_bwd_d8")
    fn = _entry("flash_attention_bwd_d8", "dsg_flash_attention_bwd_d8", 9, 24)
    dq, dk, dv = (_heads_view(B, S, Hh, D, q.device) for _ in range(3))
    build.check(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                   lse.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, Hh, S, D,
                   *(s for t in (q, k, v, o, do, dq, dk, dv) for s in t.stride()[:3]),
                   float(scale), _stream(q)), "attention_bwd_d8")
    attention_bwd_d8.launches += 1
    return dq, dk, dv


attention_bwd_d8.launches = 0
