"""The port's generation CLI on the CPU, on a tiny model directory written
by the JAX package (config.yaml through its config writer, params.npz from
a JAX init)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

from drivescenegen_tpu.config import Config as JaxConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.config import save_config
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_torch.config import load_config
from drivescenegen_torch.diffusion import ddim_sample
from drivescenegen_torch.models.convert import save_npz
from drivescenegen_torch.scripts import generation

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32")


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("model")
    mcfg = JaxModelConfig(**TINY)
    save_config(JaxConfig(model=mcfg), str(d / "config.yaml"))
    params = JaxUNet2D(mcfg).init(jax.random.key(0), jnp.zeros((1, 16, 16, 3)),
                                  jnp.zeros((1,), jnp.int32))
    save_npz(str(d / "params.npz"),
             {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()})
    return str(d)


def _run(model_dir, out, *extra):
    return generation.main(["--model_dir", model_dir, "--output_dir", str(out), "--device", "cpu",
                            "--sampler", "ddim", "--steps", "3", "--batch_size", "2",
                            "--num_batches", "2", "--seed", "5", *extra])


def test_cli_writes_named_uint8_pngs(model_dir, tmp_path):
    rate = _run(model_dir, tmp_path)
    assert rate > 0
    names = sorted(os.listdir(tmp_path))
    assert names == [f"loop_{n:03d}_batch_{i:03d}.png" for n in range(2) for i in range(2)]
    for name in names:
        img = np.asarray(Image.open(tmp_path / name))
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8


def test_cli_quantizes_the_sampler_output(model_dir, tmp_path):
    """PNG == round(clip(x/2 + 0.5, 0, 1) * 255) of the sampler's output for
    the same seed and batch."""
    _run(model_dir, tmp_path)
    cfg = load_config()
    model, schedule = generation.load_model_for_sampling(cfg, model_dir, "cpu")
    assert cfg.model.block_out_channels == (8, 16)  # spliced from config.yaml
    with torch.no_grad():
        x = ddim_sample(model, schedule, (2, 16, 16, 3), generation.batch_generator(5, 1, "cpu"), 3)
    want = np.round(np.clip(x.numpy() / 2 + 0.5, 0.0, 1.0) * 255).astype(np.uint8)
    for i in range(2):
        got = np.asarray(Image.open(tmp_path / f"loop_001_batch_{i:03d}.png"))
        np.testing.assert_array_equal(got, want[i])


def test_cli_ddpm_sampler(model_dir, tmp_path):
    generation.main(["--model_dir", model_dir, "--output_dir", str(tmp_path), "--device", "cpu",
                     "--sampler", "ddpm", "--steps", "2", "--batch_size", "1", "--num_batches", "1"])
    assert os.listdir(tmp_path) == ["loop_000_batch_000.png"]


@pytest.mark.parametrize("extra", [["--sampler", "dpm", "--cond_dir", "maps"],
                                   ["--sampler", "sde", "--cond_dir", "maps"],
                                   ["--cond_dir", "maps"]])
def test_cli_later_slices_exit_with_a_message(model_dir, tmp_path, extra):
    """The DPM-Solver++ samplers and conditional mode are ported
    (tests/test_torch_dpm_cfg.py); conditioning an unconditional model
    exits with a message, whatever the sampler."""
    with pytest.raises(SystemExit, match="cond_channels=0"):
        generation.main(["--model_dir", model_dir, "--output_dir", str(tmp_path),
                         "--device", "cpu", *extra])


def test_cli_without_weights_exits(tmp_path):
    with pytest.raises(SystemExit, match="params.npz"):
        generation.main(["--model_dir", str(tmp_path), "--output_dir", str(tmp_path / "o"),
                         "--device", "cpu", "--sampler", "ddim"])
