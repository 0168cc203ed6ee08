"""GroupNorm + SiLU: two Triton kernels and their plain PyTorch versions.

Replaces the Pallas TPU kernel `fused_group_norm_silu`
(drivescenegen_tpu/ops/pallas/group_norm.py:87-143, body `_kernel` :27-83).
That kernel walks its grid in order and carries per-channel sums in scratch
memory from phase 0 (sums) to phase 1 (normalize). Hopper runs blocks in no
order, so the port makes the two phases two launches:

  gn_mul_add   (stats, phase 0): programs (batch, row split) read whole
               NHWC rows (coalesced), sum each channel's values and squares
               in f32 and write them to a [B, split, 2, C] workspace. The
               last program of each batch item to finish (an atomic
               counter) folds the splits, in a fixed order, into group
               statistics and writes the per-(b, c) vectors
               mul = rstd*scale, add = bias - mean*rstd*scale. The
               one-pass variance is clamped at 0, as the JAX reference
               paths do (group_norm.py:225); the Pallas kernel does not
               clamp (:68), so on |mean| >> std the port follows the
               references.
  silu_affine  (apply, phase 1): silu(x*mul + add) in f32, stored in x's
               dtype.

Both are bound by bytes on the H100 (a few operations per element against
~295 FLOP/byte of balance): stats reads x once, apply reads x and writes the
output once. gn_mul_add is also the stats pass of the fused conv
(ops/gn_silu_conv.py). The TPU's token packing for C < 128 and its one-hot
group matmul are lane artifacts with nothing to do here.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises. Neither has a backward: under autograd
(grad mode on, an input requiring grad) both raise on either device.
Each wrapper counts its launches in `<wrapper>.launches`.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch


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
    (drivescenegen_tpu/config.py:79-80); UNet2D(for_training=True) runs the
    plain composition instead, as JAX trains."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(f"{what} has no backward ({hint}): call it under torch.no_grad()")


def _bshape(x: torch.Tensor) -> Tuple[int, ...]:
    return (x.shape[0],) + (1,) * (x.dim() - 2) + (x.shape[-1],)


# --------------------------------------------------------------------------
# Plain versions.


def reference_gn_mul_add(x, scale, bias, groups: int = 32, eps: float = 1e-6):
    """Per-(batch, channel) f32 vectors with GN(x)*scale + bias == x*mul + add
    (drivescenegen_tpu/ops/pallas/gn_silu_conv.py:55-83)."""
    B, C = x.shape[0], x.shape[-1]
    cpg = C // groups
    xf = x.float().reshape(B, -1, C)
    count = xf.shape[1] * cpg
    g_sum = xf.sum(dim=1).reshape(B, groups, cpg).sum(dim=-1)
    g_sq = (xf * xf).sum(dim=1).reshape(B, groups, cpg).sum(dim=-1)
    mean_g = g_sum / count
    var_g = (g_sq / count - mean_g * mean_g).clamp(min=0.0)
    inv_g = torch.rsqrt(var_g + eps)
    inv_c = inv_g.repeat_interleave(cpg, dim=-1)
    mean_c = mean_g.repeat_interleave(cpg, dim=-1)
    sf = scale.float()[None, :]
    mul = inv_c * sf
    add = bias.float()[None, :] - mean_c * inv_c * sf
    return mul, add


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
# Triton kernels (triton is imported only when a kernel is launched).


@functools.lru_cache(maxsize=None)
def _kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def gn_stats(x_ptr, scale_ptr, bias_ptr, mul_ptr, add_ptr, part_ptr, count_ptr,
                 N, C, G, cpg, rows_per, split, eps,
                 BLOCK_N: tl.constexpr, BLOCK_C: tl.constexpr, BLOCK_CF: tl.constexpr,
                 BLOCK_GR: tl.constexpr, BLOCK_G: tl.constexpr, S_CHUNK: tl.constexpr):
        b = tl.program_id(0)
        s = tl.program_id(1)
        x_b = x_ptr + b.to(tl.int64) * N * C
        r0 = s * rows_per
        r1 = tl.minimum(r0 + rows_per, N)
        part_b = part_ptr + (b * split + s) * 2 * C  # workspace [B, split, 2, C]
        for c0 in range(0, C, BLOCK_C):
            cols = c0 + tl.arange(0, BLOCK_C)
            cmask = cols < C
            acc_s = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
            acc_q = tl.zeros([BLOCK_N, BLOCK_C], dtype=tl.float32)
            for n0 in range(r0, r1, BLOCK_N):
                rows = n0 + tl.arange(0, BLOCK_N)
                m = (rows[:, None] < r1) & cmask[None, :]
                v = tl.load(x_b + rows[:, None].to(tl.int64) * C + cols[None, :],
                            mask=m, other=0.0).to(tl.float32)
                acc_s += v
                acc_q += v * v
            tl.store(part_b + cols, tl.sum(acc_s, axis=0), mask=cmask)
            tl.store(part_b + C + cols, tl.sum(acc_q, axis=0), mask=cmask)
        # The barrier orders this program's stores before its acq_rel
        # atomic, so every program's partial sums are visible to the last
        # one. That one reduces the splits per channel (contiguous loads, a
        # fixed order), parks the totals in its batch item's first slot, and
        # folds them into groups.
        tl.debug_barrier()
        done = tl.atomic_add(count_ptr + b, 1)
        if done == split - 1:
            cf = tl.arange(0, BLOCK_CF)
            cfm = cf < C
            tot_s = tl.zeros([BLOCK_CF], dtype=tl.float32)
            tot_q = tl.zeros([BLOCK_CF], dtype=tl.float32)
            for s0 in range(0, split, S_CHUNK):
                si = s0 + tl.arange(0, S_CHUNK)
                p = part_ptr + (b * split + si[:, None]) * 2 * C + cf[None, :]
                m = (si[:, None] < split) & cfm[None, :]
                tot_s += tl.sum(tl.load(p, mask=m, other=0.0, cache_modifier=".cg"), axis=0)
                tot_q += tl.sum(tl.load(p + C, mask=m, other=0.0, cache_modifier=".cg"), axis=0)
            tot = part_ptr + b * split * 2 * C
            tl.store(tot + cf, tot_s, mask=cfm)
            tl.store(tot + C + cf, tot_q, mask=cfm)
            tl.debug_barrier()  # the totals are visible to the whole program
            gi = tl.arange(0, BLOCK_GR)
            gj = tl.arange(0, BLOCK_G)
            ch = gi[:, None] * cpg + gj[None, :]
            cm = (gi[:, None] < G) & (gj[None, :] < cpg)
            gsum = tl.sum(tl.load(tot + ch, mask=cm, other=0.0, cache_modifier=".cg"), axis=1)
            gsq = tl.sum(tl.load(tot + C + ch, mask=cm, other=0.0, cache_modifier=".cg"), axis=1)
            count = N * cpg * 1.0  # also right where Triton made N or cpg a constant
            mean = gsum / count
            var = tl.maximum(gsq / count - mean * mean, 0.0)
            inv = tl.rsqrt(var + eps)
            sc = tl.load(scale_ptr + ch, mask=cm, other=0.0)
            bi = tl.load(bias_ptr + ch, mask=cm, other=0.0)
            tl.store(mul_ptr + b * C + ch, inv[:, None] * sc, mask=cm)
            tl.store(add_ptr + b * C + ch, bi - (mean * inv)[:, None] * sc, mask=cm)

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

    return triton, gn_stats, silu_affine


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_cuda_input(x: torch.Tensor, what: str) -> None:
    if not x.is_contiguous():
        raise ValueError(f"{what}: x must be contiguous [B, ..., C]")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise TypeError(f"{what}: unsupported dtype {x.dtype}")


def gn_mul_add(x, scale, bias, groups: int = 32, eps: float = 1e-6):
    """Per-(batch, channel) f32 (mul, add) of GroupNorm folded with scale and
    bias. Triton stats kernel on CUDA, reference_gn_mul_add on CPU; no
    backward (no_backward)."""
    no_backward("gn_mul_add", x, scale, bias)
    if _device_kind(x) == "cpu":
        return reference_gn_mul_add(x, scale, bias, groups, eps)
    _check_cuda_input(x, "gn_mul_add")
    B, C = x.shape[0], x.shape[-1]
    if C % groups:
        raise ValueError(f"gn_mul_add: {C} channels do not split into {groups} groups")
    N = x.numel() // (B * C)
    cpg = C // groups
    triton, kernel, _ = _kernels()
    scale = scale.to(device=x.device, dtype=torch.float32).contiguous()
    bias = bias.to(device=x.device, dtype=torch.float32).contiguous()
    mul = torch.empty((B, C), device=x.device, dtype=torch.float32)
    add = torch.empty_like(mul)
    block_c = min(triton.next_power_of_2(C), 256)
    block_n = 4096 // block_c
    # Up to four programs per SM, each reading at least 32K elements.
    sms = _sm_count(x.device)
    split = max(1, min(triton.cdiv(4 * sms, B), (N * C) // 32768))
    rows_per = triton.cdiv(N, split)
    split = triton.cdiv(N, rows_per)
    part = torch.empty((B, split, 2, C), device=x.device, dtype=torch.float32)
    done = torch.zeros((B,), device=x.device, dtype=torch.int32)
    block_cf = triton.next_power_of_2(C)
    kernel[(B, split)](x, scale, bias, mul, add, part, done, N, C, groups, cpg, rows_per,
                       split, eps, BLOCK_N=block_n, BLOCK_C=block_c, BLOCK_CF=block_cf,
                       BLOCK_GR=triton.next_power_of_2(groups),
                       BLOCK_G=triton.next_power_of_2(cpg), S_CHUNK=max(1, 4096 // block_cf),
                       num_warps=4)
    gn_mul_add.launches += 1
    return mul, add


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
    triton, _, kernel = _kernels()
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
