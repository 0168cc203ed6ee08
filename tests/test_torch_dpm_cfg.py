"""The port's DPM-Solver++(2M) samplers, classifier-free guidance,
conditional training and their CLIs against the JAX package, on the tiny
f32 configs of the other port tests, with JAX's own random draws fed to
the torch side; and the repairs of the port's faults F1 (the kernels'
limits checked at construction, --plain) and F3 (the eval PNG truncated
as JAX truncates it)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from PIL import Image

from drivescenegen_tpu.config import Config as JaxConfig
from drivescenegen_tpu.config import DiffusionConfig as JaxDiffusionConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.config import TrainConfig as JaxTrainConfig
from drivescenegen_tpu.config import save_config as jax_save_config
from drivescenegen_tpu.diffusion import dpmpp_2m_sample as jax_dpmpp_2m_sample
from drivescenegen_tpu.diffusion import dpmpp_2m_sde_sample as jax_dpmpp_2m_sde_sample
from drivescenegen_tpu.diffusion import make_schedule as jax_make_schedule
from drivescenegen_tpu.diffusion.cfg import apply_cond_dropout as jax_apply_cond_dropout
from drivescenegen_tpu.diffusion.cfg import make_guided_denoise as jax_make_guided_denoise
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_tpu.scripts import train as jax_train_cli
from drivescenegen_tpu.training import create_optimizer as jax_create_optimizer
from drivescenegen_tpu.training import init_train_state as jax_init_train_state
from drivescenegen_tpu.training import make_train_step as jax_make_train_step
from drivescenegen_torch import ops
from drivescenegen_torch.config import Config, ModelConfig, TrainConfig, save_config
from drivescenegen_torch.diffusion import (
    apply_cond_dropout,
    dpmpp_2m_coefficients,
    dpmpp_2m_sample,
    dpmpp_2m_sde_sample,
    make_guided_denoise,
    make_schedule,
)
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, save_npz, torch_to_flax
from drivescenegen_torch.models.unet2d import kernel_limit_errors
from drivescenegen_torch.ops import build
from drivescenegen_torch.scripts import generation, train
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32")
COND_TINY = dict(TINY, in_channels=1, out_channels=1, cond_channels=2, norm_num_groups=4)
SHAPE = (1, 16, 16, 3)
# The end-to-end bound of the DDIM chains (tests/test_torch_diffusion.py).
CHAIN_TOL = 2e-3
# Per-leaf gradient bound of tests/test_torch_training.py.
GRAD_REL = 2e-3
# The published config-5 model section (drivescenegen_tpu/configs/
# config5_cond_128n.yaml) and config-1's (config1_map64_cpu.yaml).
CONFIG5 = dict(sample_size=128, in_channels=1, out_channels=1, cond_channels=2)
CONFIG1 = dict(sample_size=64, in_channels=1, out_channels=1, block_out_channels=(32, 64),
               layers_per_block=1, norm_num_groups=8, attention_head_dim=8, dtype="float32")


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def schedules():
    return jax_make_schedule(), make_schedule(device="cpu")


@pytest.fixture(scope="module")
def tiny_models():
    jmodel = JaxUNet2D(JaxModelConfig(**TINY))
    params = jmodel.init(jax.random.key(0), jnp.zeros(SHAPE), jnp.zeros((1,), jnp.int32))
    model = UNet2D(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(flax_to_torch(_flat(params), ModelConfig(**TINY)))
    return jax.jit(lambda x, t: jmodel.apply(params, x, t)), model


@pytest.fixture(scope="module")
def cond_models():
    """The conditional tiny model on both sides, same weights."""
    jmodel = JaxUNet2D(JaxModelConfig(**COND_TINY))
    params = jmodel.init(jax.random.key(3), jnp.zeros((1, 16, 16, 1)), jnp.zeros((1,), jnp.int32))
    model = UNet2D(ModelConfig(**COND_TINY), device="cpu")
    model.load_state_dict(flax_to_torch(_flat(params), ModelConfig(**COND_TINY)))
    return jmodel, params, model


# ------------------------------------------------------------- samplers


class _Captured(Exception):
    pass


def _jax_scan_inputs(monkeypatch, sampler, schedule, n, spacing):
    """The per-step arrays the JAX sampler scans over, caught at its
    jax.lax.scan call (the sampler computes them before the loop)."""
    seen = {}

    def catch(body, init, xs, **kw):
        seen["xs"] = [np.asarray(a) for a in xs]
        raise _Captured

    monkeypatch.setattr(jax.lax, "scan", catch)
    with pytest.raises(_Captured):
        sampler(lambda x, t: x, schedule, SHAPE, jax.random.key(0), n, spacing=spacing)
    return seen["xs"]


@pytest.mark.parametrize("n", [1, 2, 6, 20, 25])
@pytest.mark.parametrize("spacing", ["leading", "trailing"])
@pytest.mark.parametrize("sde", [False, True], ids=["2m", "sde"])
def test_coefficients_match_jax(monkeypatch, sde, spacing, n):
    """c_x, c_d (c_n), w_c and w_p against the arrays the JAX sampler
    scans, both computed in f32 from the same alphas_cumprod, within 1e-6
    relative. c_d, w_c and w_p go through h = lambda_p - lambda_c, and
    torch's and XLA's f32 log may round one ulp apart: a difference of
    that size in h (a few tenths) moves them by up to ~1e-5 relative, so
    they are held to 1e-6 plus that propagated ulp. The final step is exact
    (c_x = 0, c_d = 1, c_n = 0, first order) and nothing is NaN."""
    js = jax_make_schedule()
    ts = make_schedule(device="cpu")
    ts.alphas_cumprod = torch.from_numpy(np.asarray(js.alphas_cumprod).copy())
    got = dpmpp_2m_coefficients(ts, n, spacing, sde=sde)
    if sde:
        t, _, c_x, c_d, c_n, w_c, w_p = _jax_scan_inputs(monkeypatch, jax_dpmpp_2m_sde_sample,
                                                         js, n, spacing)
        want = dict(c_x=c_x, c_d=c_d, c_n=c_n, w_c=w_c, w_p=w_p)
    else:
        t, c_x, c_d, w_c, w_p = _jax_scan_inputs(monkeypatch, jax_dpmpp_2m_sample, js, n, spacing)
        want = dict(c_x=c_x, c_d=c_d, w_c=w_c, w_p=w_p)
    np.testing.assert_array_equal(got["timesteps"].numpy(), t)
    assert set(got) == set(want) | {"timesteps"}
    acp = np.asarray(js.alphas_cumprod)[t].astype(np.float64)
    lam = 0.5 * np.log(acp / (1 - acp))
    h = np.diff(lam)  # the finite h: every step but the last
    # log(alpha) and log(sigma) one f32 ulp each, at both ends of h, and h
    # enters w_p through h_{i-1} / h_i.
    ulp_rel = 2 * 4 * float(np.spacing(np.float32(np.abs(lam).max()))) / h.min() if n > 1 else 0.0
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == np.float32 and np.isfinite(g).all(), k
        rtol = 1e-6 if k in ("c_x", "c_n") else 1e-6 + ulp_rel
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0, err_msg=k)
    assert got["c_x"][-1] == 0 and got["c_d"][-1] == 1 and got["w_c"][-1] == 1
    assert got["w_p"][0] == 0 and got["w_p"][-1] == 0
    if sde:
        assert got["c_n"][-1] == 0
    if n > 2:
        assert (got["w_p"][1:-1] < 0).all()  # the middle steps are second order


def _jax_draws(key, n):
    """x_T and the per-step z the JAX samplers draw from `key`."""
    x_key, loop_key = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(x_key, SHAPE, jnp.float32))
    z = [np.asarray(jax.random.normal(jax.random.fold_in(loop_key, i), SHAPE, jnp.float32))
         for i in range(n)]
    return _t(x_T), _t(np.stack(z)) if n else None


@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("spacing", ["leading", "trailing"])
def test_dpmpp_2m_end_to_end(schedules, tiny_models, spacing, n):
    js, ts = schedules
    jfn, model = tiny_models
    key = jax.random.key(21)
    want = np.asarray(jax_dpmpp_2m_sample(jfn, js, SHAPE, key, n, spacing=spacing))
    x_T, _ = _jax_draws(key, 0)
    with torch.no_grad():
        got = dpmpp_2m_sample(model, ts, SHAPE, num_inference_steps=n, spacing=spacing, x_T=x_T)
    assert np.isfinite(got.numpy()).all()
    assert np.abs(got.numpy() - want).max() <= CHAIN_TOL


@pytest.mark.parametrize("n", [1, 6])
@pytest.mark.parametrize("spacing", ["leading", "trailing"])
def test_dpmpp_2m_sde_with_injected_noise(schedules, tiny_models, spacing, n):
    """Fed JAX's x_T and its draw fold_in(loop_key, i) at every step, the
    last included."""
    js, ts = schedules
    jfn, model = tiny_models
    key = jax.random.key(22)
    want = np.asarray(jax_dpmpp_2m_sde_sample(jfn, js, SHAPE, key, n, spacing=spacing))
    x_T, z = _jax_draws(key, n)
    asked = []

    def noise(i):
        asked.append(i)
        return z[i]

    with torch.no_grad():
        got = dpmpp_2m_sde_sample(model, ts, SHAPE, num_inference_steps=n, spacing=spacing,
                                  x_T=x_T, noise=noise)
    assert asked == list(range(n))
    assert np.abs(got.numpy() - want).max() <= CHAIN_TOL


def test_dpm_generator_draws_x_T_then_one_z_per_step(schedules):
    """Without x_T or noise, the generator draws x_T first and then one z
    per step in step order; the ODE solver draws x_T only."""
    _, ts = schedules

    def fn(x, t):
        return 0.3 * x

    gen = torch.Generator().manual_seed(5)
    draws = [torch.randn((1, 4, 4, 3), generator=gen) for _ in range(4)]
    got = dpmpp_2m_sde_sample(fn, ts, (1, 4, 4, 3), torch.Generator().manual_seed(5), 3)
    want = dpmpp_2m_sde_sample(fn, ts, (1, 4, 4, 3), num_inference_steps=3, x_T=draws[0],
                               noise=torch.stack(draws[1:]))
    assert torch.equal(got, want)
    ode = dpmpp_2m_sample(fn, ts, (1, 4, 4, 3), torch.Generator().manual_seed(5), 3)
    assert torch.equal(ode, dpmpp_2m_sample(fn, ts, (1, 4, 4, 3), num_inference_steps=3,
                                            x_T=draws[0]))
    assert ode.abs().max() <= 1.0 and got.abs().max() <= 1.0
    with pytest.raises(ValueError, match="Generator"):
        dpmpp_2m_sde_sample(fn, ts, (1, 4, 4, 3), num_inference_steps=3, x_T=draws[0])


# ------------------------------------------------------------- guidance


@pytest.mark.parametrize("g", [0.0, 1.0, 3.0])
def test_guided_eps_matches_jax(cond_models, g):
    jmodel, params, model = cond_models
    rng = np.random.default_rng(int(g) + 30)
    x = rng.normal(size=(2, 16, 16, 1)).astype(np.float32)
    cond = rng.uniform(-1, 1, size=(2, 16, 16, 2)).astype(np.float32)
    want = np.asarray(jax_make_guided_denoise(jmodel.apply, params, jnp.asarray(cond), g)(
        jnp.asarray(x), jnp.int32(417)))
    calls = []

    def counted(x_, t_, c_):
        calls.append(x_.shape[0])
        return model(x_, t_, c_)

    with torch.no_grad():
        got = make_guided_denoise(counted, _t(cond), g)(_t(x), torch.tensor(417))
    assert calls == ([2] if g == 1.0 else [4])  # no batch doubling at g = 1
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-4


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_cond_dropout_with_jax_mask_is_exact(p):
    cond = np.random.default_rng(8).uniform(-1, 1, size=(16, 4, 4, 2)).astype(np.float32)
    key = jax.random.key(9)
    want = np.asarray(jax_apply_cond_dropout(jnp.asarray(cond), key, p))
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - p, (16,)))
    got = apply_cond_dropout(_t(cond), p, keep=_t(keep))
    np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < (~keep).sum() < 16
    drawn = apply_cond_dropout(_t(cond), p, torch.Generator().manual_seed(0))
    per_sample = drawn.reshape(16, -1).abs().sum(dim=1)
    assert all(s == 0 or torch.equal(drawn[i], _t(cond)[i]) for i, s in enumerate(per_sample))


def test_cond_dropout_off_returns_cond():
    cond = torch.ones(4, 2, 2, 2)
    assert apply_cond_dropout(cond, 0.0) is cond
    assert apply_cond_dropout(cond, -1.0, keep=torch.zeros(4, dtype=torch.bool)) is cond


# ------------------------------------------------------------- training


def test_three_conditional_train_steps_match_jax():
    """make_train_step on a cond_channels=2 model against the JAX step
    (cond-dropout 0.5, so that some samples drop), fed the JAX step's own
    noise, t and keep mask; the bounds of the unconditional test in
    tests/test_torch_training.py."""
    p_drop = 0.5
    jt = JaxTrainConfig(batch_size=4, learning_rate=1e-3, lr_warmup_steps=2, ema_decay=0.999,
                        cond_dropout=p_drop)
    jmodel = JaxUNet2D(JaxModelConfig(**COND_TINY))
    jsched = jax_make_schedule(JaxDiffusionConfig())
    tx, lr = jax_create_optimizer(jt, total_steps=10)
    jstate = jax_init_train_state(jmodel, tx, jax.random.key(0), (16, 16, 1), ema=True)
    jstep = jax.jit(jax_make_train_step(jmodel, jsched, tx, lr, cond_dropout=p_drop,
                                        ema_decay=jt.ema_decay))

    cfg = ModelConfig(**COND_TINY)
    tcfg = TrainConfig(batch_size=4, learning_rate=1e-3, lr_warmup_steps=2, ema_decay=0.999,
                       cond_dropout=p_drop)
    model = UNet2D(cfg, device="cpu", for_training=True)
    model.load_state_dict(flax_to_torch(_flat(jstate.params), cfg))
    opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
    state = init_train_state(model, opt, ema=True)
    step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)

    rng = np.random.default_rng(7)
    batch = rng.integers(0, 256, size=(4, 16, 16, 3), dtype=np.uint8)  # [R, G | B]
    key = jax.random.key(1)
    dropped = 0
    for i in range(3):
        noise_key, t_key, drop_key, _ = jax.random.split(jax.random.fold_in(key, int(jstate.step)),
                                                         4)
        noise = np.asarray(jax.random.normal(noise_key, (4, 16, 16, 1), jnp.float32))
        t = np.asarray(jax.random.randint(t_key, (4,), 0, 1000))
        keep = np.asarray(jax.random.bernoulli(drop_key, 1.0 - p_drop, (4,)))
        dropped += int((~keep).sum())
        jstate, jm = jstep(jstate, jnp.asarray(batch), key)
        state, m = step(state, _t(batch), _t(noise), _t(t), _t(keep))
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-7)
        for tree, ours in ((jstate.params, model.state_dict()),
                           (jstate.ema_params, state.ema_params)):
            want, have = _flat(tree), torch_to_flax(ours)
            diff = np.concatenate([np.abs(have[k] - want[k]).ravel() for k in want])
            assert diff.max() <= 0.25 * jt.learning_rate, diff.max()
            assert np.mean(diff <= 1e-6) >= 0.99, np.mean(diff <= 1e-6)
    assert 0 < dropped < 12  # the mask both kept and dropped conditioning


def test_conditional_step_draws_its_mask_after_noise_and_t():
    """Without draws handed in, noise, t and the keep mask come from the
    step's generator in that order: handing in the three as drawn gives
    the same step."""
    from drivescenegen_torch.utils import prng

    cfg = ModelConfig(**COND_TINY)
    tcfg = TrainConfig(batch_size=4, cond_dropout=0.5, lr_warmup_steps=0)
    batch = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 16, 16, 3),
                                                               dtype=np.uint8))
    gen = prng.for_step(prng.purpose_seed(tcfg.seed, "train"), 0)
    noise = torch.randn((4, 16, 16, 1), generator=gen)
    t = torch.randint(0, 1000, (4,), generator=gen)
    keep = torch.rand(4, generator=gen) < 0.5
    losses = []
    for draws in ((), (noise, t, keep)):
        model = UNet2D(cfg, device="cpu", for_training=True,
                       generator=torch.Generator().manual_seed(0))
        opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
        _, m = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)(
            init_train_state(model, opt), batch, *draws)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]
    with pytest.raises(ValueError, match="channels"):
        make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)(
            init_train_state(model, opt), batch[..., :1])


@pytest.mark.parametrize("given", ["noise", "t", "noise_t"])
def test_conditional_step_mask_is_the_third_draw_whatever_is_handed_in(given):
    """Handing in some of noise and t leaves the keep mask the generator's
    third draw, as when nothing is handed in."""
    from drivescenegen_torch.utils import prng

    cfg = ModelConfig(**COND_TINY)
    tcfg = TrainConfig(batch_size=4, cond_dropout=0.5, lr_warmup_steps=0)
    batch = torch.from_numpy(np.random.default_rng(4).integers(0, 256, (4, 16, 16, 3),
                                                               dtype=np.uint8))
    gen = prng.for_step(prng.purpose_seed(tcfg.seed, "train"), 0)
    torch.randn((4, 16, 16, 1), generator=gen)
    torch.randint(0, 1000, (4,), generator=gen)
    keep = torch.rand(4, generator=gen) < 0.5
    rng = np.random.default_rng(5)
    noise = _t(rng.normal(size=(4, 16, 16, 1)).astype(np.float32))
    t = _t(rng.integers(0, 1000, size=(4,)))
    kwargs = {"noise": noise if "noise" in given else None, "t": t if "t" in given else None}
    losses = []
    for extra in ({}, {"keep": keep}):
        model = UNet2D(cfg, device="cpu", for_training=True,
                       generator=torch.Generator().manual_seed(0))
        opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
        step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)
        draws = dict(kwargs, **extra)
        if "keep" in extra:  # the generator's own noise and t where none was given
            g2 = prng.for_step(prng.purpose_seed(tcfg.seed, "train"), 0)
            n_d = torch.randn((4, 16, 16, 1), generator=g2)
            t_d = torch.randint(0, 1000, (4,), generator=g2)
            draws["noise"] = n_d if draws["noise"] is None else draws["noise"]
            draws["t"] = t_d if draws["t"] is None else draws["t"]
        _, m = step(init_train_state(model, opt), batch, **draws)
        losses.append(float(m["loss"]))
    assert losses[0] == losses[1]


# ------------------------------------------------------------------ CLIs


@pytest.fixture(scope="module")
def cond_model_dir(tmp_path_factory, cond_models):
    """A conditional model directory (config.yaml from the JAX package's
    writer, params.npz) and a directory of three cond PNGs."""
    _, params, _ = cond_models
    d = tmp_path_factory.mktemp("cond_model")
    jax_save_config(JaxConfig(model=JaxModelConfig(**COND_TINY)), str(d / "config.yaml"))
    save_npz(str(d / "params.npz"), _flat(params))
    maps = tmp_path_factory.mktemp("maps")
    rng = np.random.default_rng(12)
    for i in range(3):
        Image.fromarray(rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)).save(
            maps / f"{i:02d}.png")
    return str(d), maps


@pytest.mark.parametrize("sampler,default_steps", [("dpm", 20), ("sde", 25)])
def test_conditional_generation_cli(cond_model_dir, tmp_path, monkeypatch, sampler,
                                    default_steps):
    model_dir, maps = cond_model_dir
    real = {"dpm": generation.dpmpp_2m_sample, "sde": generation.dpmpp_2m_sde_sample}[sampler]
    seen = []

    def spy(denoise, schedule, shape, gen, steps, **kw):
        seen.append((shape, steps, kw["spacing"]))
        return real(denoise, schedule, shape, gen, steps, **kw)

    monkeypatch.setattr(generation, {"dpm": "dpmpp_2m_sample", "sde": "dpmpp_2m_sde_sample"}[
        sampler], spy)
    rate = generation.main(["--model_dir", model_dir, "--output_dir", str(tmp_path), "--device",
                            "cpu", "--sampler", sampler, "--cond_dir", str(maps), "--guidance",
                            "3", "--batch_size", "2", "--num_batches", "2", "--seed", "4"])
    assert rate > 0
    assert seen == [((2, 16, 16, 1), default_steps, "trailing")] * 2
    names = sorted(os.listdir(tmp_path))
    assert names == [f"loop_{n:03d}_batch_{i:03d}.png" for n in range(2) for i in range(2)]
    cond_pngs = sorted(os.listdir(maps))
    for n in range(2):
        for i in range(2):
            img = np.asarray(Image.open(tmp_path / f"loop_{n:03d}_batch_{i:03d}.png"))
            assert img.shape == (16, 16, 3) and img.dtype == np.uint8
            src = np.asarray(Image.open(maps / cond_pngs[(n * 2 + i) % 3]))
            np.testing.assert_array_equal(img[..., :2], src[..., :2])


def test_conditional_generation_cli_is_the_guided_sampler(cond_model_dir, tmp_path):
    """The PNG's sample channel is round(clip(x/2 + 0.5) * 255) of the
    guided DPM chain for the batch's seed and cond maps."""
    model_dir, maps = cond_model_dir
    generation.main(["--model_dir", model_dir, "--output_dir", str(tmp_path), "--device", "cpu",
                     "--sampler", "dpm", "--steps", "3", "--cond_dir", str(maps), "--guidance",
                     "2", "--batch_size", "2", "--num_batches", "1", "--seed", "6"])
    cfg = Config()
    model, schedule = generation.load_model_for_sampling(cfg, model_dir, "cpu")
    files = sorted(str(maps / f) for f in os.listdir(maps))
    cond = generation.cond_batch(files, 0, 2, 16, 2, "cpu")
    with torch.no_grad():
        x = dpmpp_2m_sample(make_guided_denoise(model, cond, 2.0), schedule, (2, 16, 16, 1),
                            generation.batch_generator(6, 0, "cpu"), 3)
    want = generation.quantize(x)
    for i in range(2):
        got = np.asarray(Image.open(tmp_path / f"loop_000_batch_{i:03d}.png"))
        np.testing.assert_array_equal(got[..., 2:], want[i])


def test_generation_cli_plain_runs_on_the_cpu(cond_model_dir, tmp_path):
    model_dir, maps = cond_model_dir
    generation.main(["--model_dir", model_dir, "--output_dir", str(tmp_path), "--device", "cpu",
                     "--plain", "--sampler", "ddim", "--steps", "2", "--batch_size", "1",
                     "--num_batches", "1", "--cond_dir", str(maps)])
    assert os.listdir(tmp_path) == ["loop_000_batch_000.png"]
    assert np.asarray(Image.open(tmp_path / "loop_000_batch_000.png")).shape == (16, 16, 3)


def test_generation_cli_writes_a_one_channel_sample_as_gray(tmp_path):
    """An unconditional out_channels 1 model (config-1's, or config-5 run
    without --cond_dir): PIL takes no [H, W, 1] array, so the sample is
    written as a gray PNG of the rounded DPM chain."""
    mcfg = ModelConfig(**dict(TINY, in_channels=1, out_channels=1))
    model = UNet2D(mcfg, device="cpu", generator=torch.Generator().manual_seed(0)).eval()
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    save_config(Config(model=mcfg), str(model_dir / "config.yaml"))
    save_npz(str(model_dir / "params.npz"), torch_to_flax(model.state_dict()))
    generation.main(["--model_dir", str(model_dir), "--output_dir", str(tmp_path / "gen"),
                     "--device", "cpu", "--sampler", "dpm", "--steps", "2", "--batch_size", "1",
                     "--num_batches", "1", "--seed", "3"])
    img = Image.open(tmp_path / "gen" / "loop_000_batch_000.png")
    with torch.no_grad():
        x = dpmpp_2m_sample(model, make_schedule(device="cpu"), (1, 16, 16, 1),
                            generation.batch_generator(3, 0, "cpu"), 2)
    assert img.mode == "L"
    np.testing.assert_array_equal(np.asarray(img), generation.quantize(x)[0, ..., 0])


def test_conditional_train_cli(tmp_path):
    corpus = tmp_path / "data"
    corpus.mkdir()
    rng = np.random.default_rng(13)
    for i in range(6):
        Image.fromarray(rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)).save(
            corpus / f"{i:03d}.png")
    cfg = {"model": dict(COND_TINY, block_out_channels=[8, 16], dtype="bfloat16"),
           "train": dict(batch_size=2, num_epochs=1, log_every=1, eval_inference_steps=2,
                         lr_warmup_steps=2, ema_decay=0.999, cond_dropout=0.5)}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    out = tmp_path / "run"
    ops.reset_launch_counts()
    state = train.main(["--cfg_file", str(path), "--dataset_glob", str(corpus / "*.png"),
                        "--output_dir", str(out), "--device", "cpu", "--max_steps", "3"])
    assert state.step == 3 and state.model.cfg.cond_channels == 2
    assert set(ops.launch_counts().values()) == {0}
    assert os.listdir(out / "samples") == ["000.png"]
    assert np.asarray(Image.open(out / "samples" / "000.png")).shape == (16, 16)  # gray, 1 ch
    gen_out = tmp_path / "gen"
    generation.main(["--model_dir", str(out), "--output_dir", str(gen_out), "--device", "cpu",
                     "--sampler", "sde", "--steps", "2", "--cond_dir", str(corpus),
                     "--batch_size", "1", "--num_batches", "1"])
    assert np.asarray(Image.open(gen_out / "loop_000_batch_000.png")).shape == (16, 16, 3)


# ------------------------------------------------------------ F1 and F3


def test_kernel_limits_name_every_breach_of_config1():
    """config1_map64_cpu's model section breaks the conv's channel limits
    and, through its f32 dtype, all three kernels; its stats shapes are
    within the stats kernel's limits, and its head dim of 8 within the
    attention kernels', forward and backward (head dim 8 has its own
    kernel of each). The limits are those read from the .cu sources."""
    errors = kernel_limit_errors(ModelConfig(**CONFIG1))
    text = "\n".join(errors)
    assert "silu_conv3x3, gn_mul_add and attention take bfloat16" in text
    ck = build.source_int("gn_silu_conv", "CK")
    assert f"silu_conv3x3: the kernel takes C % {ck} == 0" in text
    assert build.source_int("flash_attention_d8", "D") == 8
    assert not any(e.startswith("attention:") for e in errors)
    assert not any(e.startswith("gn_mul_add") for e in errors)
    assert len(errors) == len(set(errors))
    training = kernel_limit_errors(ModelConfig(**CONFIG1), for_training=True)
    assert [e.split(":")[0] for e in training] == [
        "the attention and GroupNorm kernels take bfloat16 activations, got dtype float32"]
    assert build.source_int("flash_attention_bwd_d8", "D") == 8
    assert not any(e.startswith("attention backward") for e in training)


@pytest.mark.parametrize("overrides", [{}, CONFIG5], ids=["default", "config5"])
@pytest.mark.parametrize("for_training", [False, True])
def test_kernel_limits_take_the_published_models(overrides, for_training):
    assert kernel_limit_errors(ModelConfig(**overrides), for_training) == []


def test_kernel_limits_name_the_stats_kernel():
    """Skip concats of 4096 channels: within the conv's limits, beyond the
    stats kernel's largest C."""
    errors = kernel_limit_errors(ModelConfig(block_out_channels=(64, 128, 256, 2048)))
    max_c = build.source_int("group_norm", "MAX_C")
    assert errors == [f"gn_mul_add: the kernel takes C % 8 == 0 and C <= {max_c}, got C=4096"]


@pytest.mark.parametrize("for_training", [False, True])
def test_cuda_model_outside_the_limits_raises_at_construction(monkeypatch, for_training):
    """On CUDA the constructor refuses config1 before it allocates
    anything, naming each limit and plain=True (the card itself is not
    touched: its availability is faked)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="plain=True") as err:
        UNet2D(ModelConfig(**CONFIG1), device="cuda", for_training=for_training)
    for line in kernel_limit_errors(ModelConfig(**CONFIG1), for_training):
        assert line in str(err.value)


def test_eval_png_truncates_as_jax(monkeypatch, tmp_path):
    """save_sample_image on a fixed sample: the PNG bytes the JAX
    package's save_sample_image writes for the same array, where rounding
    would differ (0.999 * 255 = 254.7 -> 254)."""
    x01 = np.array([0.7, 0.999, 0.5, 0.0, 1.0, 0.2, 0.37, 0.8039], np.float32)
    fixed = np.tile(x01, 32).reshape(1, 16, 16, 1) * 2 - 1
    mcfg = dict(TINY, in_channels=1, out_channels=1)
    monkeypatch.setattr(jax_train_cli, "_SAMPLE_FN_CACHE", {})
    monkeypatch.setattr(jax_train_cli, "ddim_sample", lambda *a, **k: jnp.asarray(fixed))
    jax_train_cli.save_sample_image(None, None, None, JaxConfig(model=JaxModelConfig(**mcfg)),
                                    str(tmp_path / "jax"), 0, sampler="ddim", steps=2)
    monkeypatch.setattr(train, "ddim_sample", lambda *a, **k: torch.from_numpy(fixed))
    train.save_sample_image(None, make_schedule(device="cpu"), Config(model=ModelConfig(**mcfg)),
                            str(tmp_path / "torch"), 0, sampler="ddim", steps=2)
    want = np.asarray(Image.open(tmp_path / "jax" / "000.png"))
    got = np.asarray(Image.open(tmp_path / "torch" / "000.png"))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and got.shape == (16, 16)
    assert 254 in got and 255 in got  # 0.999 truncates to 254; 1.0 stays 255
