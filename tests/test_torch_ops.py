"""The port's kernel modules (drivescenegen_torch/ops) held against the JAX
package on the CPU: each plain version against its Pallas kernel in
interpret mode and against the plain JAX reference, on the same numpy
inputs. On a CPU tensor every wrapper runs its plain version and counts no
launch. The CUDA kernels themselves are checked against these plain
versions on the card by chip_smoke.py."""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from drivescenegen_tpu.models.unet2d import AttentionBlock as JaxAttentionBlock
from drivescenegen_tpu.ops.pallas.gn_silu_conv import (
    gn_silu_conv3x3 as jax_gn_silu_conv3x3,
    reference_gn_silu_conv3x3 as jax_reference_gn_silu_conv3x3,
)
from drivescenegen_tpu.ops.pallas.group_norm import (
    fused_group_norm_silu as jax_fused_group_norm_silu,
    reference_group_norm_silu as jax_reference_group_norm_silu,
    reference_group_norm_silu_multi as jax_reference_group_norm_silu_multi,
)
from drivescenegen_torch import ops
from drivescenegen_torch.models.unet2d import AttentionBlock

CONV_TOL = dict(rtol=2e-4, atol=2e-4)  # f32, as tests/test_gn_silu_conv.py
GN_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _conv_case(rng, B, H, W, C, Co, dtype=np.float32):
    x = rng.normal(size=(B, H, W, C)).astype(dtype)
    scale = (rng.normal(size=(C,)) * 0.2 + 1.0).astype(np.float32)
    bias = (rng.normal(size=(C,)) * 0.1).astype(np.float32)
    kernel = (rng.normal(size=(3, 3, C, Co)) * 0.1).astype(np.float32)  # HWIO
    conv_bias = (rng.normal(size=(Co,)) * 0.1).astype(np.float32)
    return x, scale, bias, kernel, conv_bias


def _port_gn_silu_conv(x, scale, bias, kernel, conv_bias, groups):
    y = ops.gn_silu_conv3x3(_t(x), _t(scale), _t(bias), _t(kernel.transpose(3, 2, 0, 1)),
                            _t(conv_bias), groups=groups)
    return y.float().numpy()


CONV_CASES = [
    (2, 16, 16, 8, 8, 4),
    (1, 8, 8, 8, 16, 2),   # Co != C
    (2, 32, 8, 16, 16, 4),  # tall
    (1, 8, 8, 16, 8, 8),   # Co < C
]


@pytest.mark.parametrize("B,H,W,C,Co,groups", CONV_CASES)
def test_gn_silu_conv_matches_pallas_interpret(rng, B, H, W, C, Co, groups):
    case = _conv_case(rng, B, H, W, C, Co)
    want = jax_gn_silu_conv3x3(*map(jnp.asarray, case), groups=groups, interpret=True)
    np.testing.assert_allclose(_port_gn_silu_conv(*case, groups), np.asarray(want), **CONV_TOL)


@pytest.mark.parametrize("B,H,W,C,Co,groups", CONV_CASES)
def test_gn_silu_conv_matches_jax_reference(rng, B, H, W, C, Co, groups):
    case = _conv_case(rng, B, H, W, C, Co)
    want = jax_reference_gn_silu_conv3x3(*map(jnp.asarray, case), groups=groups)
    np.testing.assert_allclose(_port_gn_silu_conv(*case, groups), np.asarray(want), **CONV_TOL)


def test_gn_silu_conv_border_zero_padding():
    """Constant input: GN output = bias, silu(bias) != 0, so padding with
    silu(affine(0)) instead of 0 would show in the border pixels."""
    C = 8
    x = np.ones((1, 8, 8, C), np.float32)
    scale = np.ones((C,), np.float32)
    bias = np.full((C,), 2.0, np.float32)
    kernel = np.ones((3, 3, C, C), np.float32)
    conv_bias = np.zeros((C,), np.float32)
    got = _port_gn_silu_conv(x, scale, bias, kernel, conv_bias, 4)
    want = jax_gn_silu_conv3x3(*map(jnp.asarray, (x, scale, bias, kernel, conv_bias)),
                               groups=4, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    g = got[0, :, :, 0]
    assert abs(g[0, 0] / g[4, 4] - 4.0 / 9.0) < 1e-3  # corner: 4 taps of 9
    assert abs(g[0, 4] / g[4, 4] - 6.0 / 9.0) < 1e-3  # edge: 6 taps of 9


def test_gn_silu_conv_bf16(rng):
    """bf16 activations: the port's plain version agrees with the JAX
    reference to bf16 rounding."""
    x, scale, bias, kernel, conv_bias = _conv_case(rng, 2, 16, 8, 8, 8)
    xj = jnp.asarray(x, jnp.bfloat16)
    want = jax_reference_gn_silu_conv3x3(xj, *map(jnp.asarray, (scale, bias, kernel, conv_bias)),
                                         groups=4)
    got = ops.gn_silu_conv3x3(_t(np.asarray(xj.astype(jnp.float32))).bfloat16(), _t(scale),
                              _t(bias), _t(kernel.transpose(3, 2, 0, 1)), _t(conv_bias), groups=4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=0.05, atol=0.05)


GN_CASES = [
    ((2, 8, 8, 16), 4),
    ((1, 16, 16, 8), 2),
    ((2, 4, 4, 32), 8),
    ((2, 64, 24), 8),  # [B, N, C] token layout, 3 channels per group
]


def _gn_case(rng, shape):
    C = shape[-1]
    x = (rng.normal(size=shape) * 1.5 + 0.3).astype(np.float32)
    scale = rng.normal(size=(C,)).astype(np.float32)
    bias = rng.normal(size=(C,)).astype(np.float32)
    return x, scale, bias


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_silu_matches_pallas_interpret(rng, shape, groups):
    x, scale, bias = _gn_case(rng, shape)
    want = jax_fused_group_norm_silu(*map(jnp.asarray, (x, scale, bias)), groups=groups,
                                     interpret=True)
    got = ops.group_norm_silu(_t(x), _t(scale), _t(bias), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GN_TOL)


@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_group_norm_silu_matches_jax_reference(rng, shape, groups):
    x, scale, bias = _gn_case(rng, shape)
    want = jax_reference_group_norm_silu(*map(jnp.asarray, (x, scale, bias)), groups=groups)
    got = ops.group_norm_silu(_t(x), _t(scale), _t(bias), groups)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **GN_TOL)


def test_group_norm_silu_clamps_negative_variance():
    """A group of two close values far from 0 (|mean| >> std): the f32
    one-pass variance comes out negative. The port clamps it at 0 like the
    JAX references; the Pallas kernel, which does not clamp, differs."""
    x = np.array([[[[300.84375, 300.875, 0.5, -1.25]]]], np.float32)  # [1, 1, 1, 4]
    scale = np.array([1.0, 0.5, 1.0, 2.0], np.float32)
    bias = np.array([0.1, -0.2, 0.0, 0.3], np.float32)
    args = tuple(map(jnp.asarray, (x, scale, bias)))
    got = ops.group_norm_silu(_t(x), _t(scale), _t(bias), 2).numpy()
    want = np.asarray(jax_reference_group_norm_silu(*args, groups=2))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **GN_TOL)
    pallas = np.asarray(jax_fused_group_norm_silu(*args, groups=2, interpret=True))
    assert not np.allclose(pallas, got, equal_nan=False)


def test_gn_mul_add_matches_jax_fold(rng):
    """The stats pass shared with the fused conv: x*mul + add equals
    GroupNorm(x)*scale + bias."""
    from drivescenegen_tpu.ops.pallas.gn_silu_conv import _gn_mul_add as jax_gn_mul_add

    x, scale, bias = _gn_case(rng, (2, 8, 8, 16))
    mul, add = ops.gn_mul_add(_t(x), _t(scale), _t(bias), 4)
    jmul, jadd = jax_gn_mul_add(*map(jnp.asarray, (x, scale, bias)), 4, 1e-6)
    np.testing.assert_allclose(mul.numpy(), np.asarray(jmul), **GN_TOL)
    np.testing.assert_allclose(add.numpy(), np.asarray(jadd), **GN_TOL)


@pytest.mark.parametrize("split", [6, 8, 13])
def test_group_norm_silu_multi_straddling_groups(rng, split):
    """Pair form == GN of the concat, also when a group straddles the
    boundary (6 + 10 channels under 4 groups of 4)."""
    a = rng.normal(size=(2, 8, 8, split)).astype(np.float32)
    b = rng.normal(size=(2, 8, 8, 16 - split)).astype(np.float32)
    scale = rng.normal(size=(16,)).astype(np.float32)
    bias = rng.normal(size=(16,)).astype(np.float32)
    ja, jb = jax_reference_group_norm_silu_multi(
        (jnp.asarray(a), jnp.asarray(b)), jnp.asarray(scale), jnp.asarray(bias), groups=4)
    ta, tb = ops.reference_group_norm_silu_multi((_t(a), _t(b)), _t(scale), _t(bias), 4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-6, rtol=1e-6)
    whole = ops.reference_group_norm_silu(_t(np.concatenate([a, b], -1)), _t(scale), _t(bias), 4)
    np.testing.assert_allclose(torch.cat([ta, tb], -1).numpy(), whole.numpy(), atol=1e-6)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_attention_block_matches_jax(rng, impl):
    """The port's AttentionBlock (plain attention on the CPU) against the
    JAX block's impl="xla" branch; impl="flash" takes that branch off the
    TPU too."""
    C, head_dim, groups = 16, 8, 4
    x = rng.normal(size=(2, 4, 4, C)).astype(np.float32)
    jblock = JaxAttentionBlock(head_dim=head_dim, groups=groups, dtype=jnp.float32, impl=impl)
    params = jblock.init(jax.random.key(0), jnp.asarray(x))["params"]
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))

    block = AttentionBlock(C, head_dim, groups, plain=False, device="cpu")
    state = {
        "norm.weight": params["norm"]["scale"], "norm.bias": params["norm"]["bias"],
        "qkv.weight": np.asarray(params["qkv"]["kernel"]).T, "qkv.bias": params["qkv"]["bias"],
        "proj_out.weight": np.asarray(params["proj_out"]["kernel"]).T,
        "proj_out.bias": params["proj_out"]["bias"],
    }
    block.load_state_dict({k: _t(v) for k, v in state.items()})
    with torch.no_grad():
        got = block(_t(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_attention_plain_matches_jax_einsum(rng):
    """reference_attention over [B, heads, S, D] == the xla branch's einsums
    (models/unet2d.py:321-328) on the same q, k, v."""
    q, k, v = (rng.normal(size=(2, 3, 16, 8)).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(8.0)
    qj, kj, vj = (jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v))  # [B, S, h, D]
    logits = jnp.einsum("bqhd,bkhd->bhqk", qj, kj, preferred_element_type=jnp.float32) * scale
    want = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1), vj)
    got = ops.attention(_t(q), _t(k), _t(v), scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(0, 2, 1, 3),
                               rtol=2e-5, atol=2e-5)


def test_cpu_wrappers_run_plain_versions_and_count_nothing(rng):
    ops.reset_launch_counts()
    x, scale, bias, kernel, conv_bias = _conv_case(rng, 1, 8, 8, 8, 8)
    w = _t(kernel.transpose(3, 2, 0, 1))
    got = ops.gn_silu_conv3x3(_t(x), _t(scale), _t(bias), w, _t(conv_bias), groups=4)
    want = ops.reference_gn_silu_conv3x3(_t(x), _t(scale), _t(bias), w, _t(conv_bias), groups=4)
    assert torch.equal(got, want)
    ops.group_norm_silu(_t(x), _t(scale), _t(bias), 4)
    q = _t(rng.normal(size=(1, 2, 8, 4)).astype(np.float32))
    assert torch.equal(ops.attention(q, q, q, 0.5), ops.reference_attention(q, q, q, 0.5))
    assert ops.launch_counts() == {"silu_conv3x3": 0, "gn_mul_add": 0, "silu_affine": 0,
                                   "attention": 0, "attention_bwd_prep": 0,
                                   "attention_bwd_main": 0, "attention_bwd_dq": 0,
                                   "attention_bwd_d8": 0, "group_norm_silu_bwd": 0}


def test_wrappers_reject_other_devices():
    x = torch.empty((1, 4, 4, 8), device="meta")
    with pytest.raises(RuntimeError, match="unsupported device"):
        ops.gn_mul_add(x, torch.ones(8), torch.zeros(8), 4)
    with pytest.raises(RuntimeError, match="unsupported device"):
        ops.attention(x, x, x, 1.0)


def test_flax_groupnorm_eps_is_the_ports():
    """The attention block's plain nn.GroupNorm uses flax's default eps,
    1e-6 (torch's default is 1e-5)."""
    from drivescenegen_torch.models.unet2d import GN_EPS

    assert nn.GroupNorm().epsilon == GN_EPS
