"""GroupNorm + SiLU: a CUDA stats kernel, a Triton apply kernel, and their
plain PyTorch versions.

Replaces the Pallas TPU kernel `fused_group_norm_silu`
(drivescenegen_tpu/ops/pallas/group_norm.py:87-143, body `_kernel` :27-83).
That kernel walks its grid in order and carries per-channel sums in scratch
memory from phase 0 (sums) to phase 1 (normalize). Hopper runs blocks in no
order, so the port makes the two phases two launches:

  gn_mul_add   (stats, phase 0): csrc/group_norm.cu, one launch. CTAs over
               (row range, batch item) stream NHWC rows with 16-byte loads,
               sum each channel's values and squares in f32, and write them
               to a workspace kept per device. The last CTA of each batch
               item (an acq_rel counter, which it resets) folds the ranges,
               in a fixed order, into group statistics and writes the
               per-(b, c) vectors mul = rstd*scale, add = bias -
               mean*rstd*scale. The one-pass variance is clamped at 0, as
               the JAX reference paths do (group_norm.py:225); the Pallas
               kernel does not clamp (:68), so on |mean| >> std the port
               follows the references.
  silu_affine  (apply, phase 1): Triton, silu(x*mul + add) in f32, stored
               in x's dtype.

Both are bound by bytes on the H100 (a few operations per element against
~295 FLOP/byte of balance): stats reads x once, apply reads x and writes the
output once. gn_mul_add is also the stats pass of the fused conv
(ops/gn_silu_conv.py). The TPU's token packing for C < 128 and its one-hot
group matmul are lane artifacts with nothing to do here.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Neither has a backward: under autograd
(grad mode on, an input requiring grad) both raise on either device.
Each wrapper counts its launches in `<wrapper>.launches`.

The training arm differentiates GroupNormSiLUFunction instead, which the
JAX package has no kernel for (it differentiates jnp): its forward is
gn_mul_add with each group's mean and rstd saved, then silu_affine; its
backward is group_norm_silu_bwd (csrc/group_norm.cu, two launches a call:
per-(b, c) sums of d and d*x^ folded in a fixed order, then dx), 10 bytes
an element. On a CPU tensor the forward is the f32 composition the
training arm always ran (F.group_norm's own statistics) and the backward
reference_group_norm_silu_bwd, the kernel's arithmetic in PyTorch ops.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Sequence, Tuple

import torch

from drivescenegen_torch.ops import build


def _device_kind(x: torch.Tensor) -> str:
    if x.device.type in ("cpu", "cuda"):
        return x.device.type
    raise RuntimeError(f"unsupported device {x.device}: expected cpu or cuda")


_GN_HINT = ("nor do the JAX package's GN kernels, drivescenegen_tpu/config.py:79-80; "
            "train with UNet2D(for_training=True)")


def no_backward(what: str, *inputs, hint: str = _GN_HINT) -> None:
    """Raise if autograd would need a gradient through `what`: it has no
    backward, so it must not return a tensor that silently has none. Nor
    does the JAX package differentiate its Pallas GN kernels
    (drivescenegen_tpu/config.py:79-80); UNet2D(for_training=True) runs
    GroupNormSiLUFunction, which has one."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(f"{what} has no backward ({hint}): call it under torch.no_grad()")


def _bshape(x: torch.Tensor) -> Tuple[int, ...]:
    return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)


# --------------------------------------------------------------------------
# Plain versions.


def reference_gn_stats(x, groups: int = 32, eps: float = 1e-6):
    """Each group's mean and rstd, f32 [B, G], as the stats kernel takes
    them: one-pass variance clamped at 0."""
    B, C = x.shape[0], x.shape[-1]
    cpg = C // groups
    xf = x.float().reshape(B, -1, C)
    count = xf.shape[1] * cpg
    g_sum = xf.sum(dim=1).reshape(B, groups, cpg).sum(dim=-1)
    g_sq = (xf * xf).sum(dim=1).reshape(B, groups, cpg).sum(dim=-1)
    mean_g = g_sum / count
    var_g = (g_sq / count - mean_g * mean_g).clamp(min=0.0)
    return mean_g, torch.rsqrt(var_g + eps)


def reference_gn_mul_add(x, scale, bias, groups: int = 32, eps: float = 1e-6,
                         with_stats: bool = False):
    """Per-(batch, channel) f32 vectors with GN(x)*scale + bias == x*mul + add
    (drivescenegen_tpu/ops/pallas/gn_silu_conv.py:55-83); with_stats: also
    reference_gn_stats's mean and rstd."""
    cpg = x.shape[-1] // groups
    mean_g, inv_g = reference_gn_stats(x, groups, eps)
    inv_c = inv_g.repeat_interleave(cpg, dim=-1)
    mean_c = mean_g.repeat_interleave(cpg, dim=-1)
    sf = scale.float()[None, :]
    mul = inv_c * sf
    add = bias.float()[None, :] - mean_c * inv_c * sf
    return (mul, add, mean_g, inv_g) if with_stats else (mul, add)


def reference_silu_affine(x, mul, add):
    """silu(x*mul + add) in f32, returned in x's dtype."""
    t = x.float() * mul.reshape(_bshape(x)) + add.reshape(_bshape(x))
    return (t * torch.sigmoid(t)).to(x.dtype)


def reference_group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-6):
    """silu(GroupNorm(x)*scale + bias) over [B, ..., C]
    (drivescenegen_tpu/ops/pallas/group_norm.py:195-237). The affine runs in
    f32 before the cast, as the kernels do; the JAX reference rounds mul/add
    to x's dtype first, which differs only in bf16 rounding."""
    return reference_silu_affine(x, *reference_gn_mul_add(x, scale, bias, groups, eps))


def composition_group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-6):
    """silu(GroupNorm(x)*scale + bias) over NHWC x [B, H, W, C] as the
    training arm has always composed it: F.group_norm in f32 on the
    channels-last NCHW view, SiLU in f32, cast to x's dtype. Returns it
    (NHWC) with F.group_norm's own mean and rstd, f32 [B, G] (its
    torch.native_group_norm, which returns all three)."""
    B, C = x.shape[0], x.shape[-1]
    xc = x.permute(0, 3, 1, 2).float()
    h, mean, rstd = torch.native_group_norm(xc, scale, bias, B, C, xc[0, 0].numel(), groups, eps)
    return torch.nn.functional.silu(h).to(x.dtype).permute(0, 2, 3, 1), mean, rstd


def reference_group_norm_silu_bwd(dy, x, mean, rstd, scale, bias, groups: int = 32):
    """(dx, dscale, dbias) of y = silu(GroupNorm(x)*scale + bias) over
    [B, ..., C], given dy and the forward's mean and rstd (f32 [B, G]), in
    the kernel's arithmetic: x^ = (x - mean)*rstd, u = x^*scale + bias,
    s = sigmoid(u), d = dy*s*(1 + u*(1 - s)); per (b, c) the sums of d and
    d*x^ (their sums over b are dbias and dscale), per group k1 =
    sum(scale*d)/n and k2 = sum(scale*d*x^)/n over its n = N*cpg elements;
    dx = rstd*(scale*d - (k1 + x^*k2)). f32 throughout; dx in x's dtype,
    dscale and dbias f32 [C]."""
    B, C = x.shape[0], x.shape[-1]
    cpg = C // groups
    xf = x.float().reshape(B, -1, C)
    dyf = dy.float().reshape(B, -1, C)
    mu = mean.float().repeat_interleave(cpg, dim=-1)[:, None, :]
    r = rstd.float().repeat_interleave(cpg, dim=-1)[:, None, :]
    gam, bet = scale.float(), bias.float()
    xh = (xf - mu) * r
    u = xh * gam + bet
    s = torch.sigmoid(u)
    d = dyf * s * (1 + u * (1 - s))
    d1, d2 = d.sum(dim=1), (d * xh).sum(dim=1)
    count = xf.shape[1] * cpg
    k1 = (d1 * gam).reshape(B, groups, cpg).sum(dim=-1) / count
    k2 = (d2 * gam).reshape(B, groups, cpg).sum(dim=-1) / count
    k1 = k1.repeat_interleave(cpg, dim=-1)[:, None, :]
    k2 = k2.repeat_interleave(cpg, dim=-1)[:, None, :]
    dx = r * (gam * d - (k1 + xh * k2))
    return dx.to(x.dtype).reshape(x.shape), d2.sum(dim=0), d1.sum(dim=0)


def reference_group_norm_silu_multi(
    xs: Sequence[torch.Tensor], scale, bias, groups: int = 32, eps: float = 1e-6
):
    """GN+SiLU of concat(xs, dim=-1) without building the concat, returned
    as one tensor per input (drivescenegen_tpu/ops/pallas/group_norm.py:
    146-192). Per-channel sums are folded to groups jointly, so a group may
    straddle an input boundary (768 channels under 32 groups gives groups
    of 24 across a 512 + 256 concat)."""
    B = xs[0].shape[0]
    C = sum(x.shape[-1] for x in xs)
    cpg = C // groups
    ch_sum, ch_sq = [], []
    for x in xs:
        xf = x.float().reshape(B, -1, x.shape[-1])
        ch_sum.append(xf.sum(dim=1))
        ch_sq.append((xf * xf).sum(dim=1))
    count = xs[0][0, ..., 0].numel() * cpg
    g_sum = torch.cat(ch_sum, dim=-1).reshape(B, groups, cpg).sum(dim=-1)
    g_sq = torch.cat(ch_sq, dim=-1).reshape(B, groups, cpg).sum(dim=-1)
    mean_g = g_sum / count
    var_g = (g_sq / count - mean_g * mean_g).clamp(min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    inv_c = inv_g.repeat_interleave(cpg, dim=-1)
    mean_c = mean_g.repeat_interleave(cpg, dim=-1)
    sf = scale.float()[None, :]
    mul_full = inv_c * sf
    add_full = bias.float()[None, :] - mean_c * inv_c * sf

    outs, off = [], 0
    for x in xs:
        ci = x.shape[-1]
        mul = mul_full[:, off:off + ci].to(x.dtype).reshape(_bshape(x))
        add = add_full[:, off:off + ci].to(x.dtype).reshape(_bshape(x))
        off += ci
        outs.append(torch.nn.functional.silu(x * mul + add))
    return tuple(outs)


# --------------------------------------------------------------------------
# Kernels: the CUDA stats kernel (csrc/group_norm.cu, built by ops/build.py)
# and the Triton apply kernel (triton is imported only when it is launched).


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def silu_affine(x_ptr, mul_ptr, add_ptr, out_ptr, N, C,
                    BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr):
        b = tl.program_id(0)
        rows = tl.program_id(1) * BLOCK_N + tl.arange(0, BLOCK_N)
        cols = tl.program_id(2) * BLOCK_C + tl.arange(0, BLOCK_C)
        cmask = cols < C
        m = (rows[:, None] < N) & cmask[None, :]
        offs = b.to(tl.int64) * N * C + rows[:, None].to(tl.int64) * C + cols[None, :]
        x = tl.load(x_ptr + offs, mask=m, other=0.0).to(tl.float32)
        mu = tl.load(mul_ptr + b * C + cols, mask=cmask, other=0.0)
        ad = tl.load(add_ptr + b * C + cols, mask=cmask, other=0.0)
        y = x * mu[None, :] + ad[None, :]
        y = y * tl.sigmoid(y)
        tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=m)

    return triton, silu_affine


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous [B, ..., C]")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")


def _check_stats_input(x, scale, bias, groups: int, what: str) -> None:
    """Raise unless the stats and backward kernels take x (CUDA) with scale
    and bias at `groups` groups."""
    if x.dtype != torch.bfloat16 or not x.is_contiguous() or x.dim() < 2 or x.numel() == 0:
        raise TypeError(f"{what}: x must be a non-empty contiguous bf16 [B, ..., C] on CUDA")
    C = x.shape[-1]
    why = stats_shape_error(C, groups)
    if why:
        raise ValueError(f"{what}: {why}")
    if tuple(scale.shape) != (C,) or tuple(bias.shape) != (C,):
        raise ValueError(f"{what}: scale and bias must be [{C}]")
    if x.data_ptr() % 16:
        raise ValueError(f"{what}: x must be 16-byte aligned (16-byte loads)")


def stats_shape_error(C: int, groups: int):
    """Why the stats kernel cannot take C channels in `groups` groups, or
    None if it can. The limits are read from csrc/group_norm.cu."""
    vec = build.source_int("group_norm", "VEC")
    max_c = build.source_int("group_norm", "MAX_C")
    if groups <= 0 or C % groups:
        return f"{C} channels do not split into {groups} groups"
    if C % vec or C > max_c:
        return f"the kernel takes C % {vec} == 0 and C <= {max_c}, got C={C}"
    return None


def _lib():
    lib = build.load("group_norm")
    if lib.dsg_gn_mul_add.argtypes is None:
        # (x, scale, bias, mul, add, [mean, rstd,] work, work_floats, arrived, B, N, C,
        #  G, eps, stream) -> cudaError_t
        for fn, n_out in ((lib.dsg_gn_mul_add, 6), (lib.dsg_gn_mul_add_stats, 8)):
            fn.argtypes = ([ctypes.c_void_p] * n_out + [ctypes.c_longlong, ctypes.c_void_p]
                           + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        # (dy, x, mean, rstd, scale, bias, dx, dscale, dbias, work, work_floats, arrived,
        #  B, N, C, G, stream) -> cudaError_t
        fn = lib.dsg_gn_silu_bwd
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_longlong, ctypes.c_void_p]
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


# Per device, every (partials workspace f32, arrival counters int32) pair
# allocated. The last is in use; the kernel leaves its counters at 0. The
# earlier ones stay allocated, so that a CUDA graph captured before a
# growth still replays on live memory. Calls on one device share the pair,
# so they must be ordered (one stream at a time), as the sampling loop and
# CUDA-graph replays are.
_workspaces: Dict[int, List[Tuple[torch.Tensor, torch.Tensor]]] = {}


def _workspace(device: torch.device, floats: int, batch: int):
    pairs = _workspaces.setdefault(device.index, [])
    if pairs and pairs[-1][0].numel() >= floats and pairs[-1][1].numel() >= batch:
        return pairs[-1]
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("gn_mul_add: its workspace must grow for this shape, which cannot "
                           "happen during CUDA graph capture; call it once at this shape first")
    grown = [2 * t.numel() for t in pairs[-1]] if pairs else [0, 0]
    work = torch.empty(max(floats, grown[0]), device=device, dtype=torch.float32)
    arrived = torch.zeros(max(batch, grown[1]), device=device, dtype=torch.int32)
    torch.cuda.synchronize(device)  # the zeros are in place for a launch on any stream
    pairs.append((work, arrived))
    return pairs[-1]


def _f32_on(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t as a contiguous f32 tensor on dev: t itself when it is one."""
    if t.dtype == torch.float32 and t.device == dev and t.is_contiguous():
        return t
    return t.to(device=dev, dtype=torch.float32).contiguous()


def gn_mul_add(x, scale, bias, groups: int = 32, eps: float = 1e-6, with_stats: bool = False):
    """Per-(batch, channel) f32 (mul, add) of GroupNorm folded with scale and
    bias; with_stats: (mul, add, mean, rstd), each group's mean and rstd f32
    [B, G] too (the training arm's forward). The CUDA stats kernel (one
    launch) on CUDA, reference_gn_mul_add on CPU; no backward
    (no_backward)."""
    no_backward("gn_mul_add", x, scale, bias)
    if _device_kind(x) == "cpu":
        return reference_gn_mul_add(x, scale, bias, groups, eps, with_stats)
    _check_stats_input(x, scale, bias, groups, "gn_mul_add")
    B, C = x.shape[0], x.shape[-1]
    N = x.numel() // (B * C)
    dev = x.device
    scale, bias = _f32_on(scale, dev), _f32_on(bias, dev)
    mul = torch.empty((B, C), device=dev, dtype=torch.float32)
    add = torch.empty_like(mul)
    # Enough for any grid the entry point picks: B x ranges <= CTAS_PER_SM x SMs + B.
    ctas = build.source_int("group_norm", "CTAS_PER_SM") * _sm_count(dev)
    work, arrived = _workspace(dev, 2 * C * (ctas + B), B)
    # The current stream's raw handle, as Triton's launcher reads it:
    # torch.cuda.current_stream builds a Stream object on every call, a
    # cost the sampling loop pays 45 times a step.
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    lib, stats, ptrs = _lib(), (), ()
    if with_stats:
        stats = (torch.empty((B, groups), device=dev, dtype=torch.float32),
                 torch.empty((B, groups), device=dev, dtype=torch.float32))
        ptrs = (stats[0].data_ptr(), stats[1].data_ptr())
    fn = lib.dsg_gn_mul_add_stats if with_stats else lib.dsg_gn_mul_add
    build.check(fn(x.data_ptr(), scale.data_ptr(), bias.data_ptr(), mul.data_ptr(),
                   add.data_ptr(), *ptrs, work.data_ptr(), work.numel(), arrived.data_ptr(), B,
                   N, C, groups, eps, stream), "gn_mul_add")
    gn_mul_add.launches += 1
    return (mul, add) + stats


gn_mul_add.launches = 0


def silu_affine(x, mul, add):
    """silu(x*mul + add) with per-(batch, channel) f32 mul/add, in x's dtype.
    Triton apply kernel on CUDA, reference_silu_affine on CPU; no backward
    (no_backward)."""
    no_backward("silu_affine", x, mul, add)
    if _device_kind(x) == "cpu":
        return reference_silu_affine(x, mul, add)
    _check_cuda_input(x, "silu_affine")
    B, C = x.shape[0], x.shape[-1]
    N = x.numel() // (B * C)
    if mul.shape != (B, C) or add.shape != (B, C):
        raise ValueError(f"silu_affine: mul/add must be [{B}, {C}]")
    if mul.device != x.device or add.device != x.device:
        raise ValueError(f"silu_affine: mul/add must be on {x.device}")
    triton, kernel = _kernels()
    mul = mul.to(torch.float32).contiguous()
    add = add.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    block_c = min(triton.next_power_of_2(C), 128)
    block_n = max(16, 8192 // block_c)
    grid = (B, triton.cdiv(N, block_n), triton.cdiv(C, block_c))
    kernel[grid](x, mul, add, out, N, C, BLOCK_N=block_n, BLOCK_C=block_c, num_warps=8)
    silu_affine.launches += 1
    return out


silu_affine.launches = 0


def group_norm_silu(x, scale, bias, groups: int = 32, eps: float = 1e-6):
    """silu(GroupNorm(x)*scale + bias): the stats kernel then the apply
    kernel on CUDA, their plain versions on CPU. No backward."""
    no_backward("group_norm_silu", x, scale, bias)
    return silu_affine(x, *gn_mul_add(x, scale, bias, groups, eps))


def group_norm_silu_bwd(dy, x, mean, rstd, scale, bias, groups: int = 32):
    """(dx, dscale, dbias) of silu(GroupNorm(x)*scale + bias) from dy and
    the forward's mean and rstd (f32 [B, G]): on CUDA one call of the
    backward kernels (csrc/group_norm.cu, two launches on the current
    stream; dy of any layout is copied to a contiguous one), counted once
    in group_norm_silu_bwd.launches; on CPU reference_group_norm_silu_bwd.
    dx in x's dtype (bf16 on CUDA), dscale and dbias f32 [C]."""
    if _device_kind(x) == "cpu":
        return reference_group_norm_silu_bwd(dy, x, mean, rstd, scale, bias, groups)
    _check_stats_input(x, scale, bias, groups, "group_norm_silu_bwd")
    B, C = x.shape[0], x.shape[-1]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"group_norm_silu_bwd: dy must be {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on {dy.device}")
    if mean.shape != (B, groups) or rstd.shape != (B, groups):
        raise ValueError(f"group_norm_silu_bwd: mean and rstd must be [{B}, {groups}]")
    dev = x.device
    dy = dy.contiguous()
    if dy.data_ptr() % 16:
        dy = dy.clone()
    mean, rstd = _f32_on(mean, dev), _f32_on(rstd, dev)
    scale, bias = _f32_on(scale, dev), _f32_on(bias, dev)
    N = x.numel() // (B * C)
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=dev, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    # dsum [B, 2C], coef [B, 2G] (rounded up to 4 floats), partials of at
    # most BWD_CTAS_PER_SM x SMs ranges; B + 1 arrival counters.
    ctas = build.source_int("group_norm", "BWD_CTAS_PER_SM") * _sm_count(dev)
    work, arrived = _workspace(dev, 2 * C * (ctas + B) + 2 * groups * B + 4, B + 1)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    build.check(_lib().dsg_gn_silu_bwd(
        dy.data_ptr(), x.data_ptr(), mean.data_ptr(), rstd.data_ptr(), scale.data_ptr(),
        bias.data_ptr(), dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), work.data_ptr(),
        work.numel(), arrived.data_ptr(), B, N, C, groups, stream), "group_norm_silu_bwd")
    group_norm_silu_bwd.launches += 1
    return dx, dscale, dbias


group_norm_silu_bwd.launches = 0


class GroupNormSiLUFunction(torch.autograd.Function):
    """silu(GroupNorm(x)*scale + bias) over NHWC x with a gradient, the
    training arm's. CUDA: gn_mul_add (with_stats) and silu_affine forward,
    group_norm_silu_bwd backward, x bf16 and contiguous. CPU:
    composition_group_norm_silu forward, reference_group_norm_silu_bwd
    backward. Saves x, mean, rstd (f32 [B, G]), scale and bias."""

    @staticmethod
    def forward(ctx, x, scale, bias, groups: int, eps: float):
        if _device_kind(x) == "cpu":
            y, mean, rstd = composition_group_norm_silu(x, scale, bias, groups, eps)
        else:
            mul, add, mean, rstd = gn_mul_add(x, scale, bias, groups, eps, with_stats=True)
            y = silu_affine(x, mul, add)
        ctx.save_for_backward(x, mean, rstd, scale, bias)
        ctx.groups = groups
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        x, mean, rstd, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = group_norm_silu_bwd(dy, x, mean, rstd, scale, bias, ctx.groups)
        return dx, dscale, dbias, None, None
