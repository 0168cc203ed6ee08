"""The head-dim-8 attention forward (csrc/flash_attention_d8.cu) and the
model it serves, DriveSceneGen's own UNet2DModel at diffusers' default
attention_head_dim of 8, held against the JAX package on the CPU: the
port's attention block and plain attention at head dim 8 against the JAX
AttentionBlock (its XLA branch, which impl="flash" also takes off the TPU)
and JAX's library mha_reference; the wrapper's limits, read from both
forward sources; a tiny imported head-dim-8 model's forward and DDIM-10
against the JAX package's on the same checkpoint and x_T. The CUDA kernel
itself is checked against the plain version on the card by chip_smoke.py
(phase 3)."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu.flash_attention import mha_reference

from drivescenegen_tpu.diffusion import ddim_sample as jax_ddim_sample
from drivescenegen_tpu.diffusion import make_schedule as jax_make_schedule
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_tpu.models import import_diffusers as jax_import
from drivescenegen_tpu.models.unet2d import AttentionBlock as JaxAttentionBlock
from drivescenegen_torch import ops
from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.diffusion import ddim_sample, make_schedule
from drivescenegen_torch.models import UNet2D, import_diffusers
from drivescenegen_torch.models import unet2d as unet2d_module
from drivescenegen_torch.models.convert import flax_to_torch
from drivescenegen_torch.models.unet2d import AttentionBlock, kernel_limit_errors, mid_attention_shape
from drivescenegen_torch.ops import build
from drivescenegen_torch.ops.attention import (
    _kernel_layout,
    attention_bwd_shape_error,
    attention_shape_error,
    forward_kernels,
)

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_import_diffusers import TorchUNet2D, _write_checkpoint  # noqa: E402

# f32 attention: the two frameworks sum the logits and the weighted values
# in other orders, nothing more.
F32_TOL = dict(rtol=2e-5, atol=2e-5)
# bf16 inputs: at most 4 bf16 ulps (2^-6 relative) of the largest output,
# the tolerance chip_smoke.py holds the kernel to.
BF16_TOL = 2.0 ** -6
# The reference's architecture (its scripts/train.py:39-57): what the
# import CLI reads from a config.json that names no attention_head_dim.
REFERENCE = {"sample_size": 256, "in_channels": 3, "out_channels": 3, "layers_per_block": 2,
             "block_out_channels": [64, 128, 256, 512], "norm_num_groups": 32,
             "down_block_types": ["DownBlock2D"] * 4, "up_block_types": ["UpBlock2D"] * 4}
CONFIG1 = dict(sample_size=64, in_channels=1, out_channels=1, block_out_channels=(32, 64),
               layers_per_block=1, norm_num_groups=8, attention_head_dim=8, dtype="float32")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def reference_cfgs(tmp_path_factory):
    """(port, JAX) ModelConfigs of the reference architecture, each read
    by its package's importer from the same config.json (an empty weights
    file beside it: only the config is read)."""
    d = tmp_path_factory.mktemp("reference") / "unet"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(REFERENCE))
    (d / "diffusion_pytorch_model.bin").write_bytes(b"")
    return import_diffusers.load_model_config(str(d))[0], jax_import.load_model_config(str(d))[0]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("hw", [(16, 16), (8, 16)], ids=["S256", "S128"])
def test_attention_block_at_head_dim_8_matches_jax(rng, impl, hw):
    """C = 64 in heads of 8 (8 heads) over S = 256 and 128 tokens: the
    port's AttentionBlock (plain attention on the CPU) against the JAX
    block's XLA branch on the same weights and input."""
    C, head_dim, groups = 64, 8, 8
    x = rng.normal(size=(2, *hw, C)).astype(np.float32)
    jblock = JaxAttentionBlock(head_dim=head_dim, groups=groups, dtype=jnp.float32, impl=impl)
    params = jblock.init(jax.random.key(3), jnp.asarray(x))["params"]
    want = np.asarray(jblock.apply({"params": params}, jnp.asarray(x)))

    block = AttentionBlock(C, head_dim, groups, plain=False, device="cpu")
    assert block.num_heads == 8
    state = {
        "norm.weight": params["norm"]["scale"], "norm.bias": params["norm"]["bias"],
        "qkv.weight": np.asarray(params["qkv"]["kernel"]).T, "qkv.bias": params["qkv"]["bias"],
        "proj_out.weight": np.asarray(params["proj_out"]["kernel"]).T,
        "proj_out.bias": params["proj_out"]["bias"],
    }
    block.load_state_dict({k: _t(v) for k, v in state.items()})
    with torch.no_grad():
        got = block(_t(x)).numpy()
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("shape", [(1, 1, 128, 8), (3, 5, 256, 8), (2, 64, 128, 8)])
def test_plain_attention_at_head_dim_8_matches_mha_reference(rng, shape):
    """reference_attention (and the wrapper, which runs it on a CPU tensor
    and counts no launch) against JAX's library mha_reference, the plain
    version of the Pallas kernel: in f32, and in bf16 within 4 bf16 ulps
    of the largest output."""
    q, k, v = (rng.normal(size=shape).astype(np.float32) for _ in range(3))
    scale = 1.0 / np.sqrt(shape[-1])
    want = np.asarray(mha_reference(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None,
                                    sm_scale=scale))
    ops.reset_launch_counts()
    got = ops.attention(_t(q), _t(k), _t(v), scale)
    assert ops.launch_counts()["attention"] == 0
    assert set(ops.attention.launches_by_source.values()) == {0}
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_array_equal(got.numpy(),
                                  ops.reference_attention(_t(q), _t(k), _t(v), scale).numpy())
    qb, kb, vb = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want_b = np.asarray(mha_reference(qb, kb, vb, None, sm_scale=scale).astype(jnp.float32))
    got_b = ops.reference_attention(*(_t(a).bfloat16() for a in (q, k, v)), scale)
    assert got_b.dtype == torch.bfloat16
    assert np.abs(got_b.float().numpy() - want_b).max() <= BF16_TOL * np.abs(want_b).max()


def test_forward_limits_are_read_from_both_sources():
    """One forward source a head dim: 64 (flash_attention.cu, which also
    writes the backward's lse) and 8 (flash_attention_d8.cu), each with the
    S multiple its constexpr line states."""
    names = ("flash_attention", "flash_attention_d8")
    assert all(name in build.SOURCES for name in names)
    assert forward_kernels() == {build.source_int(n, "D"): (n, build.source_int(n, "S_MULTIPLE"))
                                 for n in names}
    assert {d: n for d, (n, _) in forward_kernels().items()} == {64: names[0], 8: names[1]}
    assert build.source_int("flash_attention_bwd", "D") == 64
    assert build.source_int("flash_attention_bwd_d8", "D") == 8
    assert set(ops.attention.launches_by_source) == set(names)
    src = (build.CSRC_DIR / "flash_attention_d8.cu").read_text()
    assert 'extern "C" int dsg_flash_attention_d8(' in src


@pytest.mark.parametrize("S,D", [(1024, 8), (128, 8), (256, 8), (1024, 64)])
def test_attention_limits_take_head_dims_8_and_64(S, D):
    assert attention_shape_error(S, D) is None


@pytest.mark.parametrize("S,D", [(1024, 4), (1024, 16), (1024, 32), (1024, 128), (1000, 8),
                                 (64, 8)])
def test_attention_limits_refuse_other_shapes_naming_both_kernels(S, D):
    why = attention_shape_error(S, D)
    assert why is not None and why.endswith(f"got D={D}, S={S}")
    for d, (_, m) in forward_kernels().items():
        assert f"head_dim {d} with S % {m} == 0" in why


def test_the_d8_source_states_its_sass():
    """chip_smoke.py requires these in the library's SASS: the two
    mma.sync shapes (QK^T at k8, PV at k16), ldmatrix .trans for V,
    cp.async for K and V, and the exponential unit."""
    assert build.sass_must_hold("flash_attention_d8") == (
        "HMMA.1688.F32.BF16", "HMMA.16816.F32.BF16", "LDSM.16.MT88.4", "LDGSTS", "MUFU.EX2")


def test_fused_qkv_views_at_head_dim_8_take_the_kernel_layout():
    """The model's q, k and v at head dim 8 are views of one [B, S, 3 * 512]
    projection (16-byte rows, head stride 8): the kernel reads them as they
    are. A view whose base is not 16-byte aligned does not qualify."""
    B, S, heads, D = 2, 256, 64, 8
    qkv = torch.empty(B, S, 3 * heads * D, dtype=torch.bfloat16)
    views = [t.view(B, S, heads, D).transpose(1, 2) for t in qkv.split(heads * D, dim=-1)]
    assert all(_kernel_layout(t) for t in views)
    assert views[0].stride() == (S * 3 * heads * D, D, 3 * heads * D, 1)
    assert not _kernel_layout(qkv[..., 4:4 + heads * D].view(B, S, heads, D).transpose(1, 2))


def test_reference_architecture_takes_every_sampling_kernel(reference_cfgs):
    """DriveSceneGen's own model as the importers configure it: head dim 8,
    torch_pad_downsample, 64 heads over 1024 tokens, within every forward
    kernel's limits."""
    cfg, jcfg = reference_cfgs
    assert cfg.attention_head_dim == jcfg.attention_head_dim == 8
    assert cfg.torch_pad_downsample and cfg.dtype == "bfloat16"
    assert mid_attention_shape(cfg) == (64, 1024, 8)
    assert kernel_limit_errors(cfg) == []
    assert kernel_limit_errors(ModelConfig(attention_head_dim=8, torch_pad_downsample=True)) == []


def test_training_arm_at_head_dim_8_is_refused_naming_the_backward(reference_cfgs, monkeypatch):
    """The training arm of the reference model is within the kernels'
    limits (the head-dim-8 backward, csrc/flash_attention_bwd_d8.cu) and
    builds on CUDA with the kernels; the card is faked and the parameters
    live on the meta device, so nothing is allocated. (The name dates from
    when the backward took head dim 64 only and this arm was refused.)"""
    cfg, _ = reference_cfgs
    assert attention_bwd_shape_error(1024, 8) is None
    assert kernel_limit_errors(cfg, for_training=True) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(unet2d_module, "_param", lambda shape, device: torch.nn.Parameter(
        torch.empty(shape, dtype=torch.float32, device="meta")))
    model = UNet2D(cfg, device="cuda", for_training=True, generator=torch.Generator())
    assert model.for_training and not model.plain and model.mid_attn.num_heads == 64


def test_config1_is_still_refused_without_an_attention_line():
    """config-1 (f32, widths 32/64, head dim 8) breaks the conv's limits
    and the bf16 requirement; its head dim no longer breaks the attention's."""
    errors = kernel_limit_errors(ModelConfig(**CONFIG1))
    assert errors and any(e.startswith("silu_conv3x3:") for e in errors)
    assert not any(e.startswith("attention:") for e in errors)
    assert mid_attention_shape(ModelConfig(**CONFIG1))[2] == 8


@pytest.fixture(scope="module")
def imported_pair(tmp_path_factory):
    """A tiny reference checkpoint at head dim 8 (mid block 32 channels: 4
    heads of 8), imported by both packages, in f32 for a tight bound."""
    torch.manual_seed(8)
    replica = TorchUNet2D(chans=(16, 32), layers=1, groups=4, head_dim=8).eval()
    src = _write_checkpoint(tmp_path_factory.mktemp("ckpt8"), replica, chans=(16, 32), layers=1,
                            groups=4, head_dim=8)
    cfg, flat = import_diffusers.import_unet2d(src)
    jcfg, jparams = jax_import.import_unet2d(src)
    assert cfg.attention_head_dim == jcfg.attention_head_dim == 8 and cfg.torch_pad_downsample
    assert mid_attention_shape(cfg)[::2] == (4, 8)
    cfg.dtype = jcfg.dtype = "float32"
    model = UNet2D(cfg, device="cpu")
    model.load_state_dict(flax_to_torch(flat, cfg))
    jmodel = JaxUNet2D(jcfg)
    return jax.jit(lambda x, t: jmodel.apply(jparams, x, t)), model, replica


SHAPE8 = (2, 16, 16, 3)


def test_imported_head_dim_8_forward_matches_jax(imported_pair):
    jfn, model, replica = imported_pair
    rng = np.random.default_rng(13)
    x = rng.normal(size=SHAPE8).astype(np.float32)
    t = np.array([11, 642], np.int32)
    want = np.asarray(jfn(jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = model(_t(x), _t(t)).numpy()
        ref = replica(_t(x).permute(0, 3, 1, 2), _t(t)).permute(0, 2, 3, 1).numpy()
    assert np.abs(got - want).max() <= 2e-3
    assert np.abs(got - ref).max() <= 2e-3


def test_imported_head_dim_8_ddim10_matches_jax(imported_pair):
    """DDIM-10 (eta 0) from the x_T JAX's sampler draws from the same key."""
    jfn, model, _ = imported_pair
    key = jax.random.key(14)
    want = np.asarray(jax_ddim_sample(jfn, jax_make_schedule(), SHAPE8, key, 10, eta=0.0))
    x_key, _ = jax.random.split(key)
    x_T = _t(jax.random.normal(x_key, SHAPE8, jnp.float32))
    with torch.no_grad():
        got = ddim_sample(model, make_schedule(device="cpu"), SHAPE8, num_inference_steps=10,
                          x_T=x_T, noise=lambda i: None)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= 2e-3
