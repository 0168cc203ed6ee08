"""Dropout in the port's training arm against the JAX module: the JAX
UNet2D with dropout=0.1 and deterministic=False, its keep masks caught at
jax.random.bernoulli and handed to the port's forward; the gradients under
those masks; the sampling arm, which dropout leaves unchanged; and the
train step's draw order (noise, t, then the masks, one per ResnetBlock),
at the tiny config of tests/test_torch_unet.py. f32 bound as there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_torch.config import ModelConfig, TrainConfig
from drivescenegen_torch.diffusion import make_schedule
from drivescenegen_torch.models import DropoutMasks, UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, torch_to_flax
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step
from drivescenegen_torch.utils import prng

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32", dropout=0.1)
EPS_TOL = 2e-3  # tests/test_torch_unet.py's f32 eps bound
GRAD_REL = 2e-3  # tests/test_torch_training.py's per-leaf gradient bound
N_RESNETS = 2 * 1 + 2 + 2 * 2  # down blocks, mid, up blocks of TINY


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(2, 16, 16, 3)).astype(np.float32), np.array([3, 500], np.int32)


def _jax_masks(monkeypatch, fn, *args):
    """jax.jit(fn)(*args), and the keep masks every jax.random.bernoulli
    call inside fn drew, in order: caught while fn traces and returned
    beside its result."""
    caught, draw = [], jax.random.bernoulli

    def recording(*a, **kw):
        m = draw(*a, **kw)
        caught.append(m)
        return m

    def with_masks(*a):
        caught.clear()
        return fn(*a), list(caught)

    monkeypatch.setattr(jax.random, "bernoulli", recording)
    out, masks = jax.jit(with_masks)(*args)
    monkeypatch.setattr(jax.random, "bernoulli", draw)
    return out, [np.array(m) for m in masks]


def _setup(overrides):
    """The JAX module and the port's training arm on the same weights,
    drawn by the port (a JAX init outside jit compiles op by op, which
    costs tens of seconds), and the inputs."""
    kw = dict(TINY, **overrides)
    x, t = _inputs()
    cfg = ModelConfig(**kw)
    model = UNet2D(cfg, device="cpu", for_training=True, generator=torch.Generator().manual_seed(0))
    params = unflatten_dict({k: jnp.asarray(v) for k, v in
                             torch_to_flax(model.state_dict()).items()}, sep="/")
    return JaxUNet2D(JaxModelConfig(**kw)), params, model, x, t


@pytest.mark.parametrize("overrides", [{}, {"split_skip_conv": True}],
                         ids=["default", "split_skip_conv"])
def test_training_forward_matches_jax_on_its_masks(overrides, monkeypatch):
    jmodel, params, model, x, t = _setup(overrides)
    want, masks = _jax_masks(monkeypatch, lambda p: jmodel.apply(
        p, x, t, deterministic=False, rngs={"dropout": jax.random.key(3)}), params)
    want = np.asarray(want)
    assert len(masks) == N_RESNETS and all(m.dtype == bool for m in masks)
    dropout = DropoutMasks(0.1, masks=[torch.from_numpy(m) for m in masks])
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t), dropout=dropout).numpy()
    assert dropout.drawn == N_RESNETS
    err = np.abs(got - want).max()
    assert err <= EPS_TOL, err
    with torch.no_grad():
        plain = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(plain - want).max() > 10 * EPS_TOL  # the masks changed the output


def test_gradients_match_jax_under_its_masks(monkeypatch):
    jmodel, params, model, x, t = _setup({})
    target = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)

    def loss_fn(p):
        out = jmodel.apply(p, x, t, deterministic=False, rngs={"dropout": jax.random.key(5)})
        return jnp.mean((out - target) ** 2)

    (want_loss, want_grads), masks = _jax_masks(monkeypatch, jax.value_and_grad(loss_fn),
                                                params)
    dropout = DropoutMasks(0.1, masks=[torch.from_numpy(m) for m in masks])
    out = model(torch.from_numpy(x), torch.from_numpy(t), dropout=dropout)
    loss = torch.mean((out - torch.from_numpy(target)) ** 2)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = torch_to_flax({n: p.grad for n, p in model.named_parameters()})
    for k, w in _flat(want_grads).items():
        assert np.abs(got[k] - w).max() <= GRAD_REL * np.abs(w).max(), k


def test_sampling_arm_is_unchanged_by_dropout():
    """The sampling arm is deterministic: with dropout 0.1 it computes the
    JAX module's deterministic forward, and its dropout-free twin's."""
    jmodel, params, _, x, t = _setup({})
    want = np.asarray(jax.jit(jmodel.apply)(params, x, t))
    out = {}
    for rate in (0.1, 0.0):
        cfg = ModelConfig(**dict(TINY, dropout=rate))
        model = UNet2D(cfg, device="cpu")
        model.load_state_dict(flax_to_torch(_flat(params), cfg))
        with torch.no_grad():
            out[rate] = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.array_equal(out[0.1], out[0.0])
    assert np.abs(out[0.1] - want).max() <= EPS_TOL


def test_train_step_draws_noise_t_then_the_masks():
    """With nothing handed in, a dropout step draws noise, t, then one mask
    per ResnetBlock in forward order from the step's generator: handing in
    those draws, replayed from the same generator, gives the same step bit
    for bit."""
    cfg = ModelConfig(**TINY)
    tcfg = TrainConfig(batch_size=2, learning_rate=1e-3, lr_warmup_steps=0)
    x, _ = _inputs(1)
    shapes = []

    class Recording(DropoutMasks):
        def apply(self, h):
            shapes.append(tuple(h.shape))
            return super().apply(h)

    def run(**draws):
        model = UNet2D(cfg, device="cpu", for_training=True,
                       generator=torch.Generator().manual_seed(0))
        opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
        state = init_train_state(model, opt)
        step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)
        state, m = step(state, torch.from_numpy(x), **draws)
        return m, [p.detach().clone() for p in model.parameters()]

    with torch.no_grad():
        UNet2D(cfg, device="cpu", for_training=True)(
            torch.from_numpy(x), torch.zeros(2, dtype=torch.long),
            dropout=Recording(0.1, torch.Generator().manual_seed(0)))
    assert len(shapes) == N_RESNETS
    gen = prng.for_step(prng.purpose_seed(tcfg.seed, "train"), 0)
    noise = torch.randn(x.shape, generator=gen)
    t = torch.randint(0, 1000, (2,), generator=gen)
    masks = [torch.rand(s, generator=gen) < 0.9 for s in shapes]
    m_a, p_a = run()
    m_b, p_b = run(noise=noise, t=t, dropout_masks=masks)
    assert float(m_a["loss"]) == float(m_b["loss"])
    assert all(torch.equal(a, b) for a, b in zip(p_a, p_b))
