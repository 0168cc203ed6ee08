"""The training arm's GroupNorm+SiLU gradient on the CPU: the plain
backward (ops.reference_group_norm_silu_bwd, the arithmetic of
csrc/group_norm.cu's backward kernels) and the autograd Function that
runs it (ops.GroupNormSiLUFunction), held against PyTorch's autograd of
the f32 composition the training arm ran before and against jax.vjp of
the JAX package's reference_group_norm_silu, at every width the default
config's GN sites take, 32 groups and 16 (tp 2), batch 1 and 3; the
training arm of a tiny UNet2D against the same model with plain=True;
the training arm's kernel limits. The CUDA kernels are checked against
these plain versions on the card by chip_smoke.py (phase 18)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from drivescenegen_tpu.ops.pallas.group_norm import (
    reference_group_norm_silu as jax_reference_group_norm_silu,
)
from drivescenegen_torch import ops
from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models import unet2d as unet2d_module
from drivescenegen_torch.models.unet2d import gn_mul_add_shapes, kernel_limit_errors
from drivescenegen_torch.ops import build

EPS = 1e-6
# Every width the default config's GN sites take (skip concats included).
WIDTHS = (64, 128, 192, 384, 512, 768, 1024)
# f32 on both sides: the same math in another order (F.group_norm's
# backward, or jax.vjp, against the kernel's sums), relative to each
# output's largest value.
F32_REL = 2e-5
# A bf16 dx from the same f32 values computed in another order may round
# one bf16 ulp (2^-8 relative) apart: two ulps of the largest value.
BF16_REL = 2.0 ** -7

TINY = dict(sample_size=16, block_out_channels=(16, 32), layers_per_block=1, norm_num_groups=4,
            attention_head_dim=8)


def _case(B, C, dtype, seed, H=3, W=5):
    g = torch.Generator().manual_seed(seed)
    x = (torch.randn(B, H, W, C, generator=g) * 1.5 + 0.3).to(dtype)
    scale = torch.randn(C, generator=g) * 0.2 + 1.0
    bias = torch.randn(C, generator=g) * 0.1
    dy = torch.randn(B, H, W, C, generator=g).to(dtype)
    return x, scale, bias, dy


def _composition_grads(x, scale, bias, dy, groups):
    """torch.autograd of F.group_norm + F.silu in f32 on the NCHW view, cast
    back to x's dtype: the training arm's GN+SiLU before the kernels."""
    xr, w, b = (t.detach().clone().requires_grad_() for t in (x, scale, bias))
    h = F.group_norm(xr.permute(0, 3, 1, 2).float(), groups, w, b, eps=EPS)
    y = F.silu(h).to(x.dtype).permute(0, 2, 3, 1)
    return y, torch.autograd.grad(y, (xr, w, b), dy)


def _function_grads(x, scale, bias, dy, groups):
    xr, w, b = (t.detach().clone().requires_grad_() for t in (x, scale, bias))
    y = ops.GroupNormSiLUFunction.apply(xr, w, b, groups, EPS)
    return y, torch.autograd.grad(y, (xr, w, b), dy)


def _close(got, want, rel):
    for g, w in zip(got, want):
        g, w = (t.double().numpy() if torch.is_tensor(t) else np.asarray(t, np.float64)
                for t in (g, w))
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= rel * np.abs(w).max(), np.abs(g - w).max() / np.abs(w).max()


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("groups", [32, 16])
@pytest.mark.parametrize("C", WIDTHS)
def test_plain_backward_matches_autograd_of_the_composition(C, groups, B):
    """f32 activations: the plain backward, fed the composition's own mean
    and rstd, against autograd of the composition, for dx, dscale, dbias."""
    x, scale, bias, dy = _case(B, C, torch.float32, seed=C + groups + B)
    _, want = _composition_grads(x, scale, bias, dy, groups)
    _, mean, rstd = ops.composition_group_norm_silu(x, scale, bias, groups, EPS)
    assert mean.shape == rstd.shape == (B, groups) and mean.dtype == torch.float32
    got = ops.reference_group_norm_silu_bwd(dy, x, mean, rstd, scale, bias, groups)
    assert got[0].dtype == torch.float32 and got[1].shape == got[2].shape == (C,)
    _close(got, want, F32_REL)
    # On a CPU tensor the wrapper is the plain version, and counts nothing.
    before = ops.group_norm_silu_bwd.launches
    again = ops.group_norm_silu_bwd(dy, x, mean, rstd, scale, bias, groups)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert ops.group_norm_silu_bwd.launches == before


@pytest.mark.parametrize("groups", [32, 16])
@pytest.mark.parametrize("C", WIDTHS)
def test_function_matches_the_composition_in_bf16(C, groups):
    """bf16 activations, as the training arm runs: the Function's output is
    the composition's bit for bit on the CPU, its dx is bf16 and within two
    bf16 ulps of the composition's largest, its dscale and dbias f32 as
    close as in f32."""
    x, scale, bias, dy = _case(3, C, torch.bfloat16, seed=7 * C + groups)
    y_want, want = _composition_grads(x, scale, bias, dy, groups)
    y_got, got = _function_grads(x, scale, bias, dy, groups)
    assert torch.equal(y_got, y_want) and y_got.dtype == torch.bfloat16
    assert got[0].dtype == torch.bfloat16 and got[1].dtype == got[2].dtype == torch.float32
    _close(got[:1], want[:1], BF16_REL)
    _close(got[1:], want[1:], F32_REL)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("groups", [32, 16])
@pytest.mark.parametrize("C", WIDTHS)
def test_function_backward_matches_jax_vjp(C, groups, B):
    """f32: the Function's gradients against jax.vjp of the JAX package's
    reference_group_norm_silu (drivescenegen_tpu/ops/pallas/group_norm.py:
    195), what the JAX training arm differentiates."""
    x, scale, bias, dy = _case(B, C, torch.float32, seed=3 * C + groups + B)
    _, got = _function_grads(x, scale, bias, dy, groups)
    y, vjp = jax.vjp(lambda a, s, b: jax_reference_group_norm_silu(a, s, b, groups, EPS),
                     jnp.asarray(x.numpy()), jnp.asarray(scale.numpy()), jnp.asarray(bias.numpy()))
    want = vjp(jnp.asarray(dy.numpy()))
    _close([t.numpy() for t in got], want, F32_REL)


def test_plain_statistics_are_the_stats_kernels():
    """gn_mul_add(with_stats=True) on the CPU: reference_gn_mul_add's mul
    and add unchanged, with reference_gn_stats's mean and rstd (one-pass
    variance, as the kernel), which agree with F.group_norm's own."""
    x, scale, bias, _ = _case(3, 96, torch.bfloat16, seed=1, H=6, W=4)
    mul, add = ops.gn_mul_add(x, scale, bias, 32, EPS)
    mul2, add2, mean, rstd = ops.gn_mul_add(x, scale, bias, 32, EPS, with_stats=True)
    assert torch.equal(mul, mul2) and torch.equal(add, add2)
    m_ref, r_ref = ops.reference_gn_stats(x, 32, EPS)
    assert torch.equal(mean, m_ref) and torch.equal(rstd, r_ref)
    _, m_nat, r_nat = ops.composition_group_norm_silu(x, scale, bias, 32, EPS)
    _close([mean, rstd], [m_nat, r_nat], F32_REL)
    # The affine folds them as mul = rstd * scale, per channel.
    assert torch.allclose(mul, r_ref.repeat_interleave(3, dim=-1) * scale, rtol=1e-6)


def _tiny_grads(dtype, plain):
    """eps-prediction and every parameter's gradient (by name) of a tiny
    UNet2D's training arm on fixed weights, input, t and output weighting."""
    cfg = ModelConfig(**dict(TINY, dtype=dtype))
    model = UNet2D(cfg, device="cpu", for_training=True, plain=plain,
                   generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    y = model(x, torch.tensor([3, 500]))
    (y * torch.linspace(-1, 1, y.numel()).reshape(y.shape)).sum().backward()
    return y.detach(), {n: p.grad for n, p in model.named_parameters()}


def test_training_arm_gradients_match_the_plain_arm_in_f32():
    """f32 activations: the training arm (the Function at every GN+SiLU
    site) against the same weights with plain=True (the composition under
    autograd): the same eps-prediction bit for bit on the CPU, every
    parameter's gradient within F32_REL of the leaf's largest."""
    y, got = _tiny_grads("float32", False)
    y_plain, want = _tiny_grads("float32", True)
    assert torch.equal(y, y_plain)
    for name, w in want.items():
        assert got[name] is not None and got[name].dtype == torch.float32, name
        assert (got[name] - w).abs().max() <= F32_REL * w.abs().max(), name


def test_training_arm_gradients_in_bf16_stay_as_close_to_f32():
    """bf16 activations, where every site's dx rounds to bf16 and one-ulp
    differences compound through the network: the eps-prediction is the
    plain arm's bit for bit; the flattened gradient lies as close to the
    f32 model's as the plain bf16 arm's does (within 5% of that distance),
    and within half that distance of the plain bf16 arm's."""
    y, got = _tiny_grads("bfloat16", False)
    y_plain, plain = _tiny_grads("bfloat16", True)
    _, f32 = _tiny_grads("float32", True)
    assert torch.equal(y, y_plain)
    flat = [torch.cat([g[n].reshape(-1) for n in f32]) for g in (got, plain, f32)]
    dist = [(a - flat[2]).norm() / flat[2].norm() for a in flat[:2]]
    assert dist[0] <= 1.05 * dist[1]
    assert (flat[0] - flat[1]).norm() / flat[2].norm() <= 0.5 * dist[1]


def test_training_arm_runs_the_function_at_every_gn_site(monkeypatch):
    """The training arm reaches the Function once a GN+SiLU site (every
    ResnetBlock's norm1 and norm2 and norm_out: gn_mul_add_shapes' count);
    plain=True never does. On the CPU no kernel launches."""
    cfg = ModelConfig(**dict(TINY, dtype="float32"))
    calls = []
    inner = ops.GroupNormSiLUFunction.apply

    def record(x, scale, bias, groups, eps):
        calls.append((tuple(x.shape), groups))
        assert x.is_contiguous()
        return inner(x, scale, bias, groups, eps)

    monkeypatch.setattr(ops.GroupNormSiLUFunction, "apply", record)
    x, t = torch.randn(2, 16, 16, 3), torch.tensor([3, 500])
    ops.reset_launch_counts()
    for plain in (True, False):
        calls.clear()
        model = UNet2D(cfg, device="cpu", for_training=True, plain=plain)
        model(x, t).sum().backward()
        n = 0 if plain else sum(gn_mul_add_shapes(cfg).values())
        assert len(calls) == n
        if not plain:
            seen = {(shape[1], shape[-1]) for shape, _ in calls}
            assert seen == set(gn_mul_add_shapes(cfg))
    assert set(ops.launch_counts().values()) == {0}
    assert "group_norm_silu_bwd" in ops.launch_counts()
    assert ops.group_norm_silu_bwd in ops.KERNEL_WRAPPERS


def test_training_kernel_limits_name_the_gn_kernels():
    """Skip concats of 4096 channels are beyond the stats kernel's largest
    C: the training arm, which now launches it and the GN backward, names
    both; the sampling arm names the stats kernel as before."""
    cfg = ModelConfig(block_out_channels=(64, 128, 256, 2048))
    max_c = build.source_int("group_norm", "MAX_C")
    why = f"the kernel takes C % 8 == 0 and C <= {max_c}, got C=4096"
    assert kernel_limit_errors(cfg, for_training=True) == [f"gn_mul_add: {why}",
                                                           f"group_norm_silu_bwd: {why}"]
    assert kernel_limit_errors(cfg) == [f"gn_mul_add: {why}"]


@pytest.mark.parametrize("model,ok", [(1, True), (2, True), (4, True), (8, True), (16, False)])
def test_training_kernel_limits_at_a_model_axis(model, ok):
    """Under tensor parallelism norm2 runs on its shard, width / model
    channels in 32 / model groups: the default widths take every model axis
    up to 8; at 16 the 64-wide blocks' shard has 4 channels, under the
    kernels' 16-byte loads of 8."""
    errors = kernel_limit_errors(ModelConfig(attention_head_dim=8), for_training=True,
                                 model=model)
    if ok:
        assert errors == []
    else:
        why = "the kernel takes C % 8 == 0 and C <= 3072, got C=4"
        assert errors == [f"gn_mul_add: {why}", f"group_norm_silu_bwd: {why}"]


def test_cuda_training_arm_outside_the_gn_limits_raises_at_construction(monkeypatch):
    """On CUDA the training arm is refused where the GN kernels cannot take
    a width (the card is faked; parameters on the meta device)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(unet2d_module, "_param", lambda shape, device: torch.nn.Parameter(
        torch.empty(shape, dtype=torch.float32, device="meta")))
    with pytest.raises(ValueError, match="group_norm_silu_bwd: .*C=4096"):
        UNet2D(ModelConfig(block_out_channels=(64, 128, 256, 2048)), device="cuda",
               for_training=True)
