"""The attention's backward in the port, on the CPU: the plain backward
(reference_attention_bwd, what the CUDA backward kernels are checked
against on the card) against JAX's, the autograd Function against
gradcheck, and the repairs that make the training arm differentiable:
_Params.cast keeps the graph, and the GN kernels (no backward, in the JAX
package either) raise under autograd instead of cutting it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import (
    mha_reference,
    mha_reference_no_custom_vjp,
)

from drivescenegen_tpu.models.unet2d import AttentionBlock as JaxAttentionBlock
from drivescenegen_torch import ops
from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.unet2d import AttentionBlock

# f32 on both sides: the same math in another summation order.
F32_REL = 1e-5
TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=4, attention_head_dim=8, dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


def _qkv(seed, shape=(2, 3, 16, 8)):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(4)]


def _port_bwd(q, k, v, do, scale):
    tq, tk, tv = _t(q), _t(k), _t(v)
    o = ops.reference_attention(tq, tk, tv, scale)
    lse = ops.reference_attention_lse(tq, tk, scale)
    return [g.numpy() for g in ops.reference_attention_bwd(tq, tk, tv, o, lse, _t(do), scale)]


def _close(got, want, rel=F32_REL):
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= rel * np.abs(w).max()


@pytest.mark.parametrize("scale", [0.35, 1.0 / np.sqrt(8.0)])
def test_plain_bwd_matches_vjp_of_library_reference(scale):
    """jax.vjp of the library's plain attention (flash_attention.py:1482),
    the function whose gradient its backward kernels compute."""
    q, k, v, do = _qkv(0)
    _, vjp = jax.vjp(lambda a, b, c: mha_reference_no_custom_vjp(a, b, c, None, sm_scale=scale),
                     *map(jnp.asarray, (q, k, v)))
    _close(_port_bwd(q, k, v, do, scale), vjp(jnp.asarray(do)))


def test_plain_bwd_matches_library_reference_bwd():
    """mha_reference's own step-by-step backward (flash_attention.py:1615,
    which takes sm_scale 1 only)."""
    q, k, v, do = _qkv(1, (1, 2, 32, 8))
    _, vjp = jax.vjp(lambda a, b, c: mha_reference(a, b, c, None, sm_scale=1.0),
                     *map(jnp.asarray, (q, k, v)))
    _close(_port_bwd(q, k, v, do, 1.0), vjp(jnp.asarray(do)))


def test_plain_bwd_matches_vjp_of_unet_xla_branch():
    """jax.vjp of the JAX AttentionBlock's impl="xla" math
    (drivescenegen_tpu/models/unet2d.py:319-328), heads-last layout."""
    q, k, v, do = _qkv(2)
    scale = 1.0 / np.sqrt(8.0)

    def xla(qh, kh, vh):
        logits = jnp.einsum("bqhd,bkhd->bhqk", qh, kh, preferred_element_type=jnp.float32) * scale
        return jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(logits, axis=-1), vh)

    _, vjp = jax.vjp(xla, *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)))
    want = [np.asarray(g).transpose(0, 2, 1, 3) for g in vjp(jnp.asarray(do).transpose(0, 2, 1, 3))]
    _close(_port_bwd(q, k, v, do, scale), want)


def test_lse_is_the_logsumexp_of_the_scaled_logits():
    q, k, _, _ = _qkv(3)
    logits = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64), k.astype(np.float64)) * 0.3
    want = np.log(np.exp(logits).sum(-1))
    got = ops.reference_attention_lse(_t(q), _t(k), 0.3).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("strided", [False, True])
def test_function_passes_gradcheck_f64(strided):
    """The autograd Function on the CPU (plain forward + lse, plain
    backward) in float64, on contiguous tensors and on q/k/v views of a
    fused qkv projection, as the model hands them over."""
    gen = torch.Generator().manual_seed(4)
    B, H, S, D = 1, 2, 8, 4
    if strided:
        qkv = torch.randn(B, S, 3 * H * D, generator=gen, dtype=torch.float64, requires_grad=True)

        def fn(t):
            q, k, v = (x.view(B, S, H, D).transpose(1, 2) for x in t.split(H * D, dim=-1))
            return ops.attention(q, k, v, 0.5)

        assert torch.autograd.gradcheck(fn, (qkv,))
    else:
        q, k, v = (torch.randn(B, H, S, D, generator=gen, dtype=torch.float64,
                               requires_grad=True) for _ in range(3))
        assert torch.autograd.gradcheck(lambda a, b, c: ops.attention(a, b, c, 0.5), (q, k, v))


def test_function_grads_equal_autograd_through_plain_forward():
    """f32: the Function's backward gives what autograd gives through
    reference_attention, the plain=True model's path."""
    q, k, v, do = _qkv(5)
    a = [_t(x).requires_grad_() for x in (q, k, v)]
    b = [_t(x).requires_grad_() for x in (q, k, v)]
    oa = ops.attention(*a, 0.4)
    assert oa.grad_fn is not None and "AttentionFunction" in type(oa.grad_fn).__name__
    oa.backward(_t(do))
    ops.reference_attention(*b, 0.4).backward(_t(do))
    _close([x.grad.numpy() for x in a], [x.grad.numpy() for x in b])


def test_attention_block_grads_match_jax(rng):
    """The port's AttentionBlock (the Function on the CPU) against
    jax.grad of the JAX block, impl="flash" (the xla branch off the TPU),
    every parameter and the input."""
    C, head_dim, groups = 16, 8, 4
    x = rng.normal(size=(2, 4, 4, C)).astype(np.float32)
    w = rng.normal(size=(2, 4, 4, C)).astype(np.float32)
    jblock = JaxAttentionBlock(head_dim=head_dim, groups=groups, dtype=jnp.float32, impl="flash")
    params = jblock.init(jax.random.key(0), jnp.asarray(x))["params"]
    loss_j = lambda p, xx: jnp.sum(jblock.apply({"params": p}, xx) * w)  # noqa: E731
    gp, gx = jax.grad(loss_j, argnums=(0, 1))(params, jnp.asarray(x))

    block = AttentionBlock(C, head_dim, groups, plain=False, device="cpu")
    block.load_state_dict({
        "norm.weight": _t(params["norm"]["scale"]), "norm.bias": _t(params["norm"]["bias"]),
        "qkv.weight": _t(np.asarray(params["qkv"]["kernel"]).T), "qkv.bias": _t(params["qkv"]["bias"]),
        "proj_out.weight": _t(np.asarray(params["proj_out"]["kernel"]).T),
        "proj_out.bias": _t(params["proj_out"]["bias"]),
    })
    tx = _t(x).requires_grad_()
    (block(tx) * _t(w)).sum().backward()
    pairs = [(tx.grad, gx), (block.qkv.weight.grad.T, gp["qkv"]["kernel"]),
             (block.proj_out.weight.grad.T, gp["proj_out"]["kernel"]),
             (block.norm.weight.grad, gp["norm"]["scale"]), (block.qkv.bias.grad, gp["qkv"]["bias"])]
    for got, want in pairs:
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-4 * max(np.abs(want).max(), 1.0)


BWD_COUNTS = ("attention_bwd_prep", "attention_bwd_main", "attention_bwd_dq")


def test_attention_bwd_wrapper_runs_plain_on_cpu_and_counts_nothing():
    ops.reset_launch_counts()
    q, k, v, do = (_t(a) for a in _qkv(6))
    o, lse = ops.reference_attention(q, k, v, 0.5), ops.reference_attention_lse(q, k, 0.5)
    got = ops.attention_bwd(q, k, v, o, lse, do, 0.5)
    want = ops.reference_attention_bwd(q, k, v, o, lse, do, 0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    counts = ops.launch_counts()
    assert all(name in counts for name in BWD_COUNTS)
    assert set(counts.values()) == {0}


# ------------------------------------- the backward's three passes (CPU)


@pytest.mark.parametrize("shape", [(1, 2, 64, 64), (2, 1, 192, 64)])
def test_dq_fragment_order_round_trips(shape):
    x = torch.from_numpy(np.random.default_rng(7).normal(size=shape).astype(np.float32))
    acc = ops.dq_to_fragment_order(x)
    assert acc.shape == (shape[0], shape[1], shape[2] // 64, 4096)
    assert torch.equal(ops.dq_from_fragment_order(acc), x)


def test_dq_fragment_order_is_the_wgmma_accumulator_layout():
    """Element e4 of float4 j of thread t (warp w, lane 4g + tq) is row
    16w + g + 8 (e4 // 2), column 8j + 2tq + e4 % 2 of the 64 x 64 tile,
    as the main pass stores its accumulator and dq_kernel reads it."""
    acc = torch.arange(4096, dtype=torch.float32).reshape(1, 1, 1, 4096)
    tile = ops.dq_from_fragment_order(acc)[0, 0]
    for j, t, e4 in ((0, 0, 0), (3, 37, 1), (7, 127, 3), (5, 66, 2)):
        w, g, tq = t // 32, (t % 32) // 4, t % 4
        row, col = 16 * w + g + 8 * (e4 // 2), 8 * j + 2 * tq + e4 % 2
        assert tile[row, col].item() == (j * 128 + t) * 4 + e4


@pytest.mark.parametrize("seed,shape", [(8, (1, 2, 128, 64)), (9, (2, 1, 64, 64))])
def test_bwd_passes_chained_match_vjp_of_library_reference(seed, shape):
    """The pre-pass, main pass and dQ pass that attention_bwd launches on
    CUDA, chained through their plain versions, against jax.vjp of the
    library's plain attention; none counts a launch on the CPU."""
    ops.reset_launch_counts()
    q, k, v, do = _qkv(seed, shape)
    scale = 0.125
    tq, tk, tv, tdo = (_t(a) for a in (q, k, v, do))
    o = ops.reference_attention(tq, tk, tv, scale)
    lse = ops.reference_attention_lse(tq, tk, scale)
    di, sems = ops.attention_bwd_prep(o, tdo)
    assert sems.dtype == torch.int32 and sems.numel() == shape[0] * shape[1] * shape[2] // 64
    assert not sems.any()
    dk, dv, acc = ops.attention_bwd_main(tq, tk, tv, tdo, lse, di, sems, scale)
    dq = ops.attention_bwd_dq(acc, scale)
    _, vjp = jax.vjp(lambda a, b, c: mha_reference_no_custom_vjp(a, b, c, None, sm_scale=scale),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(do))
    # dq comes back in bf16, as the kernel writes it: 2^-9 relative per
    # element, within 2^-7 of the largest.
    _close([dq.float().numpy()], [want[0]], rel=2.0 ** -7)
    _close([dk.numpy(), dv.numpy()], want[1:])
    assert all(ops.launch_counts()[name] == 0 for name in BWD_COUNTS)


def test_pre_pass_di_is_the_rowsum_of_o_times_do():
    o, do = (_t(a) for a in _qkv(11)[:2])
    want = np.einsum("bhsd,bhsd->bhs", o.numpy().astype(np.float64), do.numpy().astype(np.float64))
    np.testing.assert_allclose(ops.reference_attention_di(o, do).numpy(), want, rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------ repairs for training


def test_training_arm_gives_every_parameter_a_gradient():
    """_Params.cast no longer detaches under autograd: after backward every
    parameter of a tiny UNet2D(for_training=True) has a gradient that is
    not None and not all zero."""
    model = UNet2D(ModelConfig(**TINY), device="cpu", for_training=True,
                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, 16, 3, generator=gen)
    loss = (model(x, torch.tensor([3, 700])) - torch.randn(2, 16, 16, 3, generator=gen)).pow(2).mean()
    loss.backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None or not p.grad.any()]
    assert not missing, missing


def test_cast_is_cached_without_autograd_and_fresh_with_it():
    model = UNet2D(ModelConfig(**TINY), device="cpu")
    conv = model.conv_in
    with torch.no_grad():
        assert conv.cast("weight", torch.bfloat16) is conv.cast("weight", torch.bfloat16)
    w = conv.cast("weight", torch.bfloat16)
    assert w.requires_grad and w.grad_fn is not None
    assert w.dtype == torch.bfloat16 and w.is_contiguous(memory_format=torch.channels_last)


def test_training_and_sampling_arms_agree_in_value():
    """The training arm's composition is the sampling arm's function: the
    same eps on the same weights (f32, to summation order)."""
    cfg = ModelConfig(**TINY)
    a = UNet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(2))
    b = UNet2D(cfg, device="cpu", for_training=True)
    b.load_state_dict(a.state_dict())
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        ea, eb = a(x, torch.tensor([5, 900])), b(x, torch.tensor([5, 900]))
    assert (ea - eb).abs().max() <= 1e-5


def _gn_inputs(grad_on):
    x = torch.randn(1, 4, 4, 8, requires_grad="x" in grad_on)
    scale = torch.ones(8, requires_grad="scale" in grad_on)
    bias = torch.zeros(8)
    w = torch.randn(8, 8, 3, 3, requires_grad="w" in grad_on)
    return x, scale, bias, w, torch.zeros(8)


@pytest.mark.parametrize("name", ["gn_silu_conv3x3", "silu_conv3x3", "gn_mul_add",
                                  "group_norm_silu", "silu_affine"])
@pytest.mark.parametrize("grad_on", ["x", "scale", "w"])
def test_gn_kernel_wrappers_raise_under_autograd(name, grad_on):
    x, scale, bias, w, cb = _gn_inputs(grad_on)
    mul, add = torch.ones(1, 8, requires_grad=grad_on == "scale"), torch.zeros(1, 8)
    call = {
        "gn_silu_conv3x3": lambda: ops.gn_silu_conv3x3(x, scale, bias, w, cb, groups=4),
        "silu_conv3x3": lambda: ops.silu_conv3x3(x, mul, add, w, cb),
        "gn_mul_add": lambda: ops.gn_mul_add(x, scale, bias, 4),
        "group_norm_silu": lambda: ops.group_norm_silu(x, scale, bias, 4),
        "silu_affine": lambda: ops.silu_affine(x, mul, add),
    }[name]
    touches = {"gn_silu_conv3x3": "x scale w", "silu_conv3x3": "x scale w",
               "gn_mul_add": "x scale", "group_norm_silu": "x scale", "silu_affine": "x scale"}
    if grad_on in touches[name].split():
        with pytest.raises(RuntimeError, match="config.py:79-80"):
            call()
    else:
        call()
    with torch.no_grad():
        call()


def test_sampling_arm_raises_under_autograd_instead_of_cutting_the_graph():
    model = UNet2D(ModelConfig(**TINY), device="cpu")
    with pytest.raises(RuntimeError, match="for_training=True"):
        model(torch.zeros(1, 16, 16, 3), torch.tensor([1]))
