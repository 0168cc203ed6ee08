"""The port's schedule and samplers against drivescenegen_tpu.diffusion:
coefficient arrays, timestep grids, and whole sampling chains on the tiny
UNet with JAX's own random draws fed to the torch side."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from drivescenegen_tpu.config import DiffusionConfig as JaxDiffusionConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.diffusion import ddim_sample as jax_ddim_sample
from drivescenegen_tpu.diffusion import ddim_timesteps as jax_ddim_timesteps
from drivescenegen_tpu.diffusion import ddpm_sample as jax_ddpm_sample
from drivescenegen_tpu.diffusion import ddpm_timesteps as jax_ddpm_timesteps
from drivescenegen_tpu.diffusion import make_schedule as jax_make_schedule
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_torch.config import DiffusionConfig, ModelConfig
from drivescenegen_torch.diffusion import (
    ddim_sample,
    ddim_timesteps,
    ddpm_sample,
    ddpm_timesteps,
    make_schedule,
)
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_to_torch

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32")
SHAPE = (1, 16, 16, 3)


@pytest.fixture(scope="module")
def schedules():
    return jax_make_schedule(), make_schedule(device="cpu")


@pytest.fixture(scope="module")
def tiny_models():
    jmodel = JaxUNet2D(JaxModelConfig(**TINY))
    params = jmodel.init(jax.random.key(0), jnp.zeros(SHAPE), jnp.zeros((1,), jnp.int32))
    flat = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    model = UNet2D(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(flax_to_torch(flat, ModelConfig(**TINY)))
    return jax.jit(lambda x, t: jmodel.apply(params, x, t)), model


# XLA's CPU cumprod is a parallel prefix scan, torch's a sequential product:
# the float32 roundings fall in another order. Over the cosine schedule's
# 1000 factors that reaches 1.25e-6 relative; the linear ones stay in 1e-6.
@pytest.mark.parametrize("beta_schedule,rtol", [("linear", 1e-6), ("scaled_linear", 1e-6),
                                                ("squaredcos_cap_v2", 2e-6)])
def test_alphas_cumprod_match(beta_schedule, rtol):
    want = np.asarray(jax_make_schedule(JaxDiffusionConfig(beta_schedule=beta_schedule)).alphas_cumprod)
    s = make_schedule(DiffusionConfig(beta_schedule=beta_schedule), device="cpu")
    got = s.alphas_cumprod.numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


def test_add_noise_and_pred_x0_match(schedules, rng):
    js, ts = schedules
    x0 = rng.uniform(-1, 1, size=(3, 4, 4, 3)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    t = np.array([0, 400, 999])
    want = np.asarray(js.add_noise(x0, noise, t))
    got = ts.add_noise(torch.from_numpy(x0), torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    back = ts.pred_x0_from_eps(got, torch.from_numpy(noise), torch.from_numpy(t))
    np.testing.assert_allclose(back.numpy(), np.asarray(js.pred_x0_from_eps(want, noise, t)),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind,n", [("ddpm", 750), ("leading", 50), ("trailing", 16),
                                    ("trailing", 30), ("leading", 1000)])
def test_timesteps_equal(schedules, kind, n):
    js, ts = schedules
    if kind == "ddpm":
        want, got = jax_ddpm_timesteps(js, n), ddpm_timesteps(ts, n)
    else:
        want, got = jax_ddim_timesteps(js, n, spacing=kind), ddim_timesteps(ts, n, spacing=kind)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if kind == "ddpm":  # integer stride 1: diffusers' 749..0
        assert got[0] == 749 and got[-1] == 0


def _jax_draws(key, n):
    """The x_T and per-step noise JAX's _sample_loop draws from `key`."""
    x_key, loop_key = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(x_key, SHAPE, jnp.float32))
    noise = [np.asarray(jax.random.normal(jax.random.fold_in(loop_key, i), SHAPE, jnp.float32))
             for i in range(n)]
    return torch.from_numpy(x_T.copy()), torch.from_numpy(np.stack(noise)) if n else None


@pytest.mark.parametrize("spacing", ["leading", "trailing"])
def test_ddim_eta0_end_to_end(schedules, tiny_models, spacing):
    js, ts = schedules
    jfn, model = tiny_models
    key = jax.random.key(11)
    want = np.asarray(jax_ddim_sample(jfn, js, SHAPE, key, 10, eta=0.0, spacing=spacing))
    x_T, _ = _jax_draws(key, 0)  # eta=0 draws no per-step noise
    with torch.no_grad():
        got = ddim_sample(model, ts, SHAPE, num_inference_steps=10, spacing=spacing,
                          x_T=x_T, noise=lambda i: None)
    assert np.abs(got.numpy() - want).max() <= 2e-3


def test_ddim_eta1_with_injected_noise(schedules, tiny_models):
    js, ts = schedules
    jfn, model = tiny_models
    key = jax.random.key(12)
    want = np.asarray(jax_ddim_sample(jfn, js, SHAPE, key, 6, eta=1.0))
    x_T, noise = _jax_draws(key, 6)
    with torch.no_grad():
        got = ddim_sample(model, ts, SHAPE, num_inference_steps=6, eta=1.0, x_T=x_T, noise=noise)
    assert np.abs(got.numpy() - want).max() <= 2e-3


def test_ddpm_with_injected_noise(schedules, tiny_models):
    js, ts = schedules
    jfn, model = tiny_models
    key = jax.random.key(13)
    want = np.asarray(jax_ddpm_sample(jfn, js, SHAPE, key, 5))
    x_T, noise = _jax_draws(key, 5)
    with torch.no_grad():
        got = ddpm_sample(model, ts, SHAPE, num_inference_steps=5, x_T=x_T,
                          noise=lambda i: noise[i])
    assert np.abs(got.numpy() - want).max() <= 2e-3


def test_generator_sampling_is_deterministic(schedules):
    _, ts = schedules

    def fn(x, t):
        return 0.3 * x

    def run(seed):
        return ddpm_sample(fn, ts, (1, 4, 4, 3), torch.Generator().manual_seed(seed), 20)

    a, b, c = run(3), run(3), run(4)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.isfinite(a).all() and a.abs().max() <= 1.0 + 1e-6


def test_sampling_needs_a_generator_or_the_draws(schedules):
    _, ts = schedules
    with pytest.raises(ValueError, match="Generator"):
        ddim_sample(lambda x, t: x, ts, (1, 4, 4, 3), num_inference_steps=2)
