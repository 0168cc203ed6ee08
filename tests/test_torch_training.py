"""The port's training path on the CPU against the JAX package: the
training arm's loss and gradients against jax.value_and_grad of the JAX
UNet, three train steps against make_train_step fed JAX's own noise and t,
the optax schedule and clipping, the uint8 normalization, the dataset's
order and arrays, checkpoints and resume, and the train CLI, at the tiny
config tests/test_training.py uses."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict
from PIL import Image

from drivescenegen_tpu.config import DiffusionConfig as JaxDiffusionConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.config import TrainConfig as JaxTrainConfig
from drivescenegen_tpu.data import dataset as jax_dataset
from drivescenegen_tpu.diffusion import make_schedule as jax_make_schedule
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_tpu.training import create_optimizer as jax_create_optimizer
from drivescenegen_tpu.training import init_train_state as jax_init_train_state
from drivescenegen_tpu.training import make_train_step as jax_make_train_step
from drivescenegen_tpu.utils import prng as jax_prng
from drivescenegen_torch import ops
from drivescenegen_torch.config import ModelConfig, TrainConfig
from drivescenegen_torch.data import dataset
from drivescenegen_torch.diffusion import make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import flax_to_torch, load_npz, torch_to_flax
from drivescenegen_torch.scripts import generation, train
from drivescenegen_torch.training import (
    create_optimizer,
    init_train_state,
    make_train_step,
)
from drivescenegen_torch.training import checkpoint
from drivescenegen_torch.training.trainer import (
    clip_by_global_norm_,
    diffusion_loss,
    global_norm,
    lr_schedule_fn,
    normalize_batch,
)
from drivescenegen_torch.utils import prng
from drivescenegen_torch.utils.logging import MetricWriter

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=4, attention_head_dim=8, dtype="float32")
# Per-leaf gradient bound, f32 on both sides: 2e-3 x the leaf's largest value.
GRAD_REL = 2e-3


def _flat(params):
    return {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}


def _t(a):
    return torch.from_numpy(np.array(a))


def _jax_draws(key, step, shape):
    """The noise and t the JAX train step draws at `step`
    (drivescenegen_tpu/training/trainer.py:102-116)."""
    noise_key, t_key, _, _ = jax.random.split(jax.random.fold_in(key, step), 4)
    noise = jax.random.normal(noise_key, shape, jnp.float32)
    t = jax.random.randint(t_key, (shape[0],), 0, 1000)
    return np.asarray(noise), np.asarray(t)


def _port_model(params, overrides=None):
    cfg = ModelConfig(**dict(TINY, **(overrides or {})))
    model = UNet2D(cfg, device="cpu", for_training=True)
    model.load_state_dict(flax_to_torch(_flat(params), cfg))
    return model


@pytest.mark.parametrize("overrides", [{}, {"attention_impl": "flash"}, {"split_skip_conv": True},
                                       {"torch_pad_downsample": True}],
                         ids=["default", "flash", "split_skip_conv", "torch_pad_downsample"])
def test_loss_and_every_gradient_match_jax(overrides):
    kw = dict(TINY, **overrides)
    jmodel = JaxUNet2D(JaxModelConfig(**kw))
    jsched = jax_make_schedule(JaxDiffusionConfig())
    rng = np.random.default_rng(0)
    x0 = (rng.normal(size=(2, 16, 16, 3)) * 0.5).astype(np.float32)
    params = jmodel.init(jax.random.key(0), jnp.asarray(x0), jnp.zeros((2,), jnp.int32))
    noise, t = _jax_draws(jax.random.key(1), 0, x0.shape)

    def loss_fn(p):
        noisy = jsched.add_noise(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(t))
        return jnp.mean((jmodel.apply(p, noisy, jnp.asarray(t)).astype(jnp.float32) - noise) ** 2)

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    model = _port_model(params, overrides)
    loss = diffusion_loss(model, make_schedule(device="cpu"), _t(x0), _t(noise), _t(t).long())
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    got = torch_to_flax({n: p.grad for n, p in model.named_parameters()})
    want = _flat(want_grads)
    assert got.keys() == want.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= GRAD_REL * np.abs(want[k]).max(), k


def test_three_train_steps_match_jax():
    """make_train_step against the JAX step, warmup 2 (lr 0, peak/2, peak)
    and EMA on, fed the JAX step's own noise and t. Loss, grad_norm and lr
    agree to f32 rounding; the clipped gradients leaf by leaf; params and
    EMA to a small share of one step's lr: Adam divides each gradient by
    its own running RMS, so an element whose gradient is near 0 can move by
    a sizeable part of lr on either side from a rounding difference."""
    jt = JaxTrainConfig(batch_size=2, learning_rate=1e-3, lr_warmup_steps=2, ema_decay=0.999)
    jmodel = JaxUNet2D(JaxModelConfig(**TINY))
    jsched = jax_make_schedule(JaxDiffusionConfig())
    tx, lr = jax_create_optimizer(jt, total_steps=10)
    jstate = jax_init_train_state(jmodel, tx, jax.random.key(0), (16, 16, 3), ema=True)
    jstep = jax.jit(jax_make_train_step(jmodel, jsched, tx, lr, ema_decay=jt.ema_decay))

    tcfg = TrainConfig(batch_size=2, learning_rate=1e-3, lr_warmup_steps=2, ema_decay=0.999)
    model = _port_model(jstate.params)
    opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
    state = init_train_state(model, opt, ema=True)
    step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)

    batch = (np.random.default_rng(7).normal(size=(2, 16, 16, 3)) * 0.5).astype(np.float32)
    key = jax.random.key(1)

    @jax.jit
    @jax.grad
    def grad_fn(p, noise, t):
        noisy = jsched.add_noise(jnp.asarray(batch), noise, t)
        return jnp.mean((jmodel.apply(p, noisy, t) - noise) ** 2)

    for i in range(3):
        noise, t = _jax_draws(key, int(jstate.step), batch.shape)
        grads = grad_fn(jstate.params, jnp.asarray(noise), jnp.asarray(t))
        clipped, _ = optax.clip_by_global_norm(jt.grad_clip_norm).update(grads, None)
        jstate, jm = jstep(jstate, jnp.asarray(batch), key)
        state, m = step(state, _t(batch), _t(noise), _t(t))
        assert state.step == int(jstate.step) == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
        np.testing.assert_allclose(m["lr"], float(jm["lr"]), rtol=1e-7)
        assert float(jm["grad_norm"]) > jt.grad_clip_norm  # the clip is exercised
        got = torch_to_flax({n: p.grad for n, p in model.named_parameters()})
        for k, w in _flat(clipped).items():
            assert np.abs(got[k] - w).max() <= GRAD_REL * np.abs(w).max(), k
        for tree, ours in ((jstate.params, model.state_dict()),
                           (jstate.ema_params, state.ema_params)):
            want, have = _flat(tree), torch_to_flax(ours)
            diff = np.concatenate([np.abs(have[k] - want[k]).ravel() for k in want])
            assert diff.max() <= 0.25 * jt.learning_rate, diff.max()
            assert np.mean(diff <= 1e-6) >= 0.99, np.mean(diff <= 1e-6)


@pytest.mark.parametrize("warmup,total", [(2, 10), (500, 10000), (0, 5), (7, 3)])
def test_lr_schedule_matches_optax(warmup, total):
    tcfg = TrainConfig(learning_rate=3e-4, lr_warmup_steps=warmup)
    want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, warmup, max(total, warmup + 1), 0.0)
    ours = lr_schedule_fn(tcfg, total)
    assert ours(0) == float(want(0))
    for count in sorted({0, 1, warmup - 1, warmup, warmup + 1, total // 2, total - 1, total,
                         total + 5}):
        if count >= 0:
            np.testing.assert_allclose(ours(count), float(want(count)), rtol=1e-6, atol=1e-12)


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_clip_matches_optax_below_and_above_max(scale):
    rng = np.random.default_rng(3)
    leaves = [(rng.normal(size=s) * scale).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    want, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(a) for a in leaves], None)
    grads = [_t(a) for a in leaves]
    norm = global_norm(grads)
    np.testing.assert_allclose(float(norm), float(optax.global_norm(leaves)), rtol=1e-6)
    clip_by_global_norm_(grads, 1.0, norm)
    for g, w in zip(grads, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    if scale < 1:
        assert all(np.array_equal(g.numpy(), a) for g, a in zip(grads, leaves))


def test_adamw_update_matches_optax():
    """Three AdamW updates from the same params and gradients, at a nonzero
    lr: torch.optim.AdamW's decoupled decay is optax's add_decayed_weights
    then scale_by_learning_rate. The two associate differently (p(1 - lr
    wd) against p - lr wd p; sqrt(v) / sqrt(1 - b2^t) against
    sqrt(v / (1 - b2^t))), so they agree to f32 rounding of each update,
    1e-4 of lr, not bit for bit."""
    rng = np.random.default_rng(4)
    p0 = rng.normal(size=(6, 5)).astype(np.float32)
    grads = [rng.normal(size=(6, 5)).astype(np.float32) for _ in range(3)]
    tx = optax.adamw(1e-2, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01)
    jp, js = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    tp = torch.nn.Parameter(_t(p0))
    opt = torch.optim.AdamW([tp], lr=1e-2, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.01)
    for g in grads:
        upd, js = tx.update(jnp.asarray(g), js, jp)
        jp = optax.apply_updates(jp, upd)
        tp.grad = _t(g)
        opt.step()
    np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=0, atol=1e-4 * 1e-2)


def test_uint8_batch_is_normalized_on_device_and_trains_the_same():
    raw = np.random.default_rng(5).integers(0, 256, size=(2, 16, 16, 3), dtype=np.uint8)
    want = np.asarray(jnp.asarray(raw).astype(jnp.float32) / 127.5 - 1.0)
    np.testing.assert_array_equal(normalize_batch(_t(raw)).numpy(), want)
    tcfg = TrainConfig(batch_size=2, lr_warmup_steps=0)
    results = []
    for batch in (_t(raw), _t(want)):
        model = UNet2D(ModelConfig(**TINY), device="cpu", for_training=True,
                       generator=torch.Generator().manual_seed(0))
        opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
        state, m = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)(
            init_train_state(model, opt), batch)
        results.append((float(m["loss"]), torch_to_flax(model.state_dict())))
    assert results[0][0] == results[1][0]
    assert all(np.array_equal(results[0][1][k], results[1][1][k]) for k in results[0][1])


def test_step_draws_are_reproducible_per_seed_and_step():
    tcfg = TrainConfig(batch_size=2)
    losses = []
    for _ in range(2):
        model = UNet2D(ModelConfig(**TINY), device="cpu", for_training=True,
                       generator=prng.for_purpose(tcfg.seed, "init"))
        opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
        state = init_train_state(model, opt)
        step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)
        losses.append([float(step(state, torch.zeros(2, 16, 16, 3))[1]["loss"]) for _ in range(2)])
    assert losses[0] == losses[1] and losses[0][0] != losses[0][1]


def test_purpose_ids_are_the_jax_packages():
    for purpose in ("init", "train", "noise", "timesteps"):
        assert prng.purpose_id(purpose) == jax_prng._purpose_id(purpose)


def test_conditional_training_names_the_next_slice():
    """Conditional training is ported (tests/test_torch_dpm_cfg.py holds it
    to JAX): a cond_channels=2 step runs on its [cond | target] batch. So
    is dropout > 0 (tests/test_torch_dropout.py holds it to JAX): its step
    runs and draws a mask for each ResnetBlock."""
    tcfg = TrainConfig(batch_size=1)
    model = UNet2D(ModelConfig(**dict(TINY, cond_channels=2)), device="cpu", for_training=True)
    opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
    step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg)
    state, m = step(init_train_state(model, opt), torch.zeros(1, 16, 16, 5))
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    model = UNet2D(ModelConfig(**dict(TINY, dropout=0.1)), device="cpu", for_training=True)
    opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
    state, m = step(init_train_state(model, opt), torch.zeros(1, 16, 16, 3))
    assert state.step == 1 and np.isfinite(float(m["loss"]))
    with pytest.raises(IndexError):  # one mask short: every ResnetBlock takes one
        step(state, torch.zeros(1, 16, 16, 3), dropout_masks=[torch.ones(1, 16, 16, 8).bool()])


# ------------------------------------------------------------- dataset


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(6)
    for i in range(7):
        Image.fromarray(rng.integers(0, 256, size=(20, 20, 3), dtype=np.uint8)).save(
            d / f"{i:03d}.png")
    return str(d / "*.png")


@pytest.mark.parametrize("raw", [True, False])
def test_dataset_arrays_match_jax(corpus, raw):
    ours = dataset.RasterDataset(corpus, img_res=16, raw=raw)
    theirs = jax_dataset.RasterDataset(corpus, img_res=16, raw=raw)
    assert ours.files == theirs.files and ours.raw == theirs.raw == raw
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_array_equal(dataset.decoded_corpus(ours),
                                  np.stack([theirs[i] for i in range(len(theirs))]))


def test_sample_order_matches_jax(corpus):
    ours = dataset.RasterDataset(corpus, img_res=16, raw="auto")
    theirs = jax_dataset.RasterDataset(corpus, img_res=16, raw="auto")
    got = dataset.batch_iterator(ours, 3, seed=11, num_epochs=3, num_threads=1)
    want = jax_dataset.batch_iterator(theirs, 3, seed=11, num_epochs=3, num_threads=1)
    pairs = list(zip(got, want))
    assert len(pairs) == 6
    assert all(a.dtype == np.uint8 and np.array_equal(a, b) for a, b in pairs)
    ia, ib = dataset.index_batches(7, 3, seed=11), jax_dataset.index_batches(7, 3, seed=11)
    for _ in range(8):
        assert np.array_equal(next(ia), next(ib))


def test_dataset_to_device_gathers_the_batches(corpus):
    ds = dataset.RasterDataset(corpus, img_res=16, raw="auto")
    data = dataset.dataset_to_device(ds, "cpu")
    assert data.dtype == torch.uint8 and tuple(data.shape) == (7, 16, 16, 3)
    idx = next(dataset.index_batches(7, 3, seed=2))
    host = next(dataset.batch_iterator(ds, 3, seed=2, num_threads=1))
    assert np.array_equal(data[torch.from_numpy(idx)].numpy(), host)


# ---------------------------------------------------------- checkpoints


def _tiny_state(ema=True):
    tcfg = TrainConfig(batch_size=2, lr_warmup_steps=1, ema_decay=0.99 if ema else 0.0)
    model = UNet2D(ModelConfig(**TINY), device="cpu", for_training=True,
                   generator=torch.Generator().manual_seed(0))
    opt, lr_fn = create_optimizer(tcfg, 20, model.parameters())
    return init_train_state(model, opt, ema=ema), make_train_step(make_schedule(device="cpu"),
                                                                   lr_fn, tcfg)


def test_checkpoint_round_trip_and_resume(tmp_path):
    batch = torch.randn(2, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    a, step = _tiny_state()
    for _ in range(2):
        step(a, batch)
    checkpoint.save_checkpoint(str(tmp_path), a)
    b, _ = _tiny_state()
    checkpoint.restore_checkpoint(str(tmp_path), b)
    assert b.step == 2
    for x, y in zip(a.model.state_dict().values(), b.model.state_dict().values()):
        assert torch.equal(x, y)
    assert all(torch.equal(a.ema_params[k], b.ema_params[k]) for k in a.ema_params)
    _, ma = step(a, batch)
    _, mb = step(b, batch)
    assert float(ma["loss"]) == float(mb["loss"]) and b.step == 3
    for x, y in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(x, y)


def test_checkpoints_keep_the_newest(tmp_path):
    state, _ = _tiny_state(ema=False)
    assert checkpoint.latest_step(str(tmp_path)) is None
    for s in (1, 2, 3, 4):
        state.step = s
        checkpoint.save_checkpoint(str(tmp_path), state, max_to_keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000003.pt", "step_00000004.pt"]
    assert checkpoint.latest_step(str(tmp_path)) == 4


def test_restore_without_ema_seeds_it_from_params(tmp_path):
    plain, _ = _tiny_state(ema=False)
    checkpoint.save_checkpoint(str(tmp_path), plain)
    with_ema, _ = _tiny_state(ema=True)
    for v in with_ema.ema_params.values():
        v.zero_()
    checkpoint.restore_checkpoint(str(tmp_path), with_ema)
    params = dict(with_ema.model.named_parameters())
    assert all(torch.equal(v, params[k]) for k, v in with_ema.ema_params.items())


def test_params_export_loads_in_the_generation_cli(tmp_path):
    state, _ = _tiny_state()
    path = checkpoint.save_params_only(str(tmp_path), state.ema_params)
    flat = load_npz(path)
    assert all(k.startswith("params/") for k in flat)
    model = UNet2D(ModelConfig(**TINY), device="cpu")
    model.load_state_dict(flax_to_torch(flat, ModelConfig(**TINY)))
    for k, v in state.ema_params.items():
        assert torch.equal(model.state_dict()[k], v)


# ------------------------------------------------------------------ CLI


def _cfg_file(tmp_path, **train):
    cfg = {"model": dict(TINY, block_out_channels=[8, 16], dtype="bfloat16"),
           "train": dict(dict(batch_size=2, num_epochs=1, log_every=1, eval_inference_steps=2,
                              lr_warmup_steps=2, ema_decay=0.9999), **train)}
    path = tmp_path / "cfg.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_train_cli_trains_resumes_and_exports(corpus, tmp_path):
    out = tmp_path / "run"
    args = ["--cfg_file", _cfg_file(tmp_path), "--dataset_glob", corpus, "--output_dir", str(out),
            "--device", "cpu"]
    ops.reset_launch_counts()
    state = train.main(args + ["--max_steps", "3"])
    assert state.step == 3
    assert set(ops.launch_counts().values()) == {0}  # CPU tensors: plain versions only
    assert sorted(os.listdir(out)) == ["checkpoints", "config.yaml", "logs", "params.npz",
                                       "samples"]
    assert os.listdir(out / "checkpoints") == ["step_00000003.pt"]
    assert os.listdir(out / "samples") == ["000.png"]
    records = [json.loads(line) for line in open(out / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3]
    assert records[0]["lr"] == 0.0 and all(np.isfinite(r["loss"]) for r in records)
    state = train.main(args + ["--max_steps", "5", "--resume"])
    assert state.step == 5 and checkpoint.latest_step(str(out / "checkpoints")) == 5
    gen_out = tmp_path / "gen"
    rate = generation.main(["--model_dir", str(out), "--output_dir", str(gen_out), "--device",
                            "cpu", "--sampler", "ddim", "--steps", "2", "--batch_size", "1",
                            "--num_batches", "1"])
    assert rate > 0 and os.listdir(gen_out) == ["loop_000_batch_000.png"]
    img = np.asarray(Image.open(gen_out / "loop_000_batch_000.png"))
    assert img.shape == (16, 16, 3) and img.dtype == np.uint8


def test_train_cli_stop_file_saves_and_exits(corpus, tmp_path):
    out = tmp_path / "run"
    out.mkdir()
    (out / "STOP").write_text("")
    state = train.main(["--cfg_file", _cfg_file(tmp_path), "--dataset_glob", corpus,
                        "--output_dir", str(out), "--device", "cpu", "--max_steps", "3"])
    assert state.step == 1
    assert checkpoint.latest_step(str(out / "checkpoints")) == 1
    assert (out / "params.npz").exists()


@pytest.mark.parametrize("extra", [["--init_from", "x"], ["--profile_steps", "-2"],
                                   ["--supervise", "1"]])
def test_train_cli_later_options_exit_with_a_message(extra, corpus, tmp_path, monkeypatch):
    """The options a later slice brought (tests/test_torch_train_cli.py runs
    them) exit with a message on a wrong use: a donor with no checkpoint, a
    negative count, --supervise under torchrun."""
    why = {"--init_from": "--init_from: no checkpoint", "--profile_steps": "count >= 0",
           "--supervise": "outer process"}[extra[0]]
    if extra[0] == "--init_from":
        extra = ["--init_from", str(tmp_path / "x")]
    if extra[0] == "--supervise":
        monkeypatch.setenv("WORLD_SIZE", "2")  # as torchrun sets it
    with pytest.raises(SystemExit, match=why):
        train.main(["--device", "cpu", "--output_dir", str(tmp_path / "run"), "--cfg_file",
                    _cfg_file(tmp_path), "--dataset_glob", corpus] + extra)


def test_metric_writer_appends_jsonl(tmp_path):
    w = MetricWriter(str(tmp_path), use_tensorboard=False)
    w.write(3, {"loss": torch.tensor(0.5), "lr": 1e-4})
    w.close()
    rec = json.loads((tmp_path / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["loss"] == 0.5 and rec["lr"] == 1e-4
