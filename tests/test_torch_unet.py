"""The port's UNet2D against the JAX UNet2D on the same weights: JAX
init -> flat numpy tree -> flax_to_torch -> the port's forward, compared
with UNet2D.apply, at the tiny configs the JAX tests use. The f32 bound is
the one tests/test_import_diffusers.py uses for eps parity."""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.diffusion import make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, load_npz, save_npz, torch_to_flax

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32")

CONFIGS = {
    "default": {},
    "pallas_gn_conv": dict(use_pallas_gn_conv=True),  # the JAX kernel in interpret mode
    "slice_flags": dict(use_pallas_gn=True, use_pallas_gn_conv=True, attention_impl="flash"),
    "split_skip_conv": dict(split_skip_conv=True),
    "torch_pad_downsample": dict(torch_pad_downsample=True),
    "groups4": dict(norm_num_groups=4),
}


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _pair(overrides, x, t, cond=None):
    kw = dict(TINY, **overrides)
    jmodel = JaxUNet2D(JaxModelConfig(**kw))
    args = (x, t) if cond is None else (x, t, cond)
    params = jmodel.init(jax.random.key(0), *args)
    want = np.asarray(jmodel.apply(params, *args))
    cfg = ModelConfig(**kw)
    model = UNet2D(cfg, device="cpu")
    model.load_state_dict(flax_to_torch(_flat(params), cfg))
    return model, params, want


def _inputs(seed=0, batch=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 500, 977, 0][:batch], np.int32)
    return x, t


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_eps_parity_f32(name):
    x, t = _inputs()
    model, _, want = _pair(CONFIGS[name], x, t)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= 2e-3, f"{name}: max abs err {err}"


@pytest.mark.parametrize("with_cond", [True, False])
def test_eps_parity_conditional(with_cond):
    """cond_channels > 0: the conditioning is concatenated to the input,
    zeros when it is not given."""
    x, t = _inputs(1)
    cond = np.random.default_rng(2).normal(size=(2, 16, 16, 2)).astype(np.float32)
    overrides = dict(cond_channels=2)
    if with_cond:
        model, _, want = _pair(overrides, x, t, cond)
        args = (torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(cond))
    else:
        model, _, want = _pair(overrides, x, t)
        args = (torch.from_numpy(x), torch.from_numpy(t))
    with torch.no_grad():
        got = model(*args).numpy()
    assert np.abs(got - want).max() <= 2e-3


@pytest.mark.parametrize("name", ["default", "slice_flags", "split_skip_conv"])
def test_eps_parity_bf16(name):
    """bf16 activations over f32 params on both sides: agreement to bf16
    rounding, the bound tests/test_unet_fused_gn_conv.py uses."""
    x, t = _inputs(3, batch=1)
    model, _, want = _pair(dict(CONFIGS[name], dtype="bfloat16"), x, t)
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0.05, atol=0.05)


def test_scalar_timestep_broadcasts():
    x, _ = _inputs(4)
    model, params, _ = _pair({}, x, np.array([7, 7], np.int32))
    want = np.asarray(JaxUNet2D(JaxModelConfig(**TINY)).apply(params, x, np.int32(7)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), 7).numpy()
    assert np.abs(got - want).max() <= 2e-3


def test_plain_flag_is_the_same_function_on_cpu():
    """plain=True (the comparison path for the kernels on the card) gives
    bit-identical results on the CPU, where the wrappers already run the
    plain versions."""
    cfg = ModelConfig(**TINY)
    a = UNet2D(cfg, device="cpu", generator=torch.Generator().manual_seed(1))
    b = UNet2D(cfg, device="cpu", plain=True)
    b.load_state_dict(a.state_dict())
    x = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        assert torch.equal(a(x, torch.tensor([5, 9])), b(x, torch.tensor([5, 9])))


def test_roundtrip_is_exact(tmp_path):
    x, t = _inputs()
    _, params, _ = _pair({}, x, t)
    flat = _flat(params)
    back = torch_to_flax(flax_to_torch(flat, ModelConfig(**TINY)))
    assert back.keys() == flat.keys()
    for k in flat:
        assert back[k].dtype == flat[k].dtype and np.array_equal(back[k], flat[k]), k
    save_npz(str(tmp_path / "params.npz"), back)
    loaded = load_npz(str(tmp_path / "params.npz"))
    assert loaded.keys() == flat.keys()
    assert all(np.array_equal(loaded[k], flat[k]) for k in flat)


def test_param_shapes_match_the_flax_tree():
    """Every torch parameter has its flax counterpart, same count, and the
    default initializer gives finite outputs."""
    x, t = _inputs()
    _, params, _ = _pair({}, x, t)
    model = UNet2D(ModelConfig(**TINY), device="cpu", generator=torch.Generator().manual_seed(0))
    assert set(torch_to_flax(model.state_dict())) == set(_flat(params))
    assert sum(p.numel() for p in model.parameters()) == sum(
        v.size for v in _flat(params).values())
    with torch.no_grad():
        assert torch.isfinite(model(torch.from_numpy(x), torch.from_numpy(t))).all()


def test_leftover_key_raises():
    x, t = _inputs()
    _, params, _ = _pair({}, x, t)
    flat = _flat(params)
    flat["params/extra_block/conv/kernel"] = np.zeros((3, 3, 8, 8), np.float32)
    with pytest.raises(ValueError, match="not consumed"):
        flax_to_torch(flat, ModelConfig(**TINY))


def test_missing_key_and_bad_shape_raise():
    x, t = _inputs()
    _, params, _ = _pair({}, x, t)
    flat = _flat(params)
    missing = dict(flat)
    del missing["params/mid_attn/qkv/bias"]
    with pytest.raises(KeyError, match="lacks"):
        flax_to_torch(missing, ModelConfig(**TINY))
    bad = dict(flat)
    bad["params/conv_in/bias"] = np.zeros((9,), np.float32)
    with pytest.raises(ValueError, match="shape"):
        flax_to_torch(bad, ModelConfig(**TINY))


def test_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        UNet2D(ModelConfig(**TINY), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_schedule(device="cuda")
