"""tools/params_bridge.py: a model directory carried between the JAX
package's orbax export (params/) and the port's params.npz, both ways
bitwise, and each package's generation CLI sampling the other's bridged
directory. The tiny model of PR 1's tests, f32."""

import importlib.util
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from drivescenegen_tpu.config import Config as JaxConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.config import save_config as jax_save_config
from drivescenegen_tpu.diffusion import ddim_sample as jax_ddim_sample
from drivescenegen_tpu.diffusion import make_schedule as jax_make_schedule
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_tpu.scripts import generation as jax_generation
from drivescenegen_tpu.training.checkpoint import save_params_only as jax_save_params_only
from drivescenegen_torch.config import Config, ModelConfig, load_config, save_config
from drivescenegen_torch.diffusion import ddim_sample
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import load_npz, save_npz, torch_to_flax
from drivescenegen_torch.scripts import generation

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32")
SHAPE = (2, 16, 16, 3)


def _load_bridge():
    spec = importlib.util.spec_from_file_location("params_bridge",
                                                  ROOT / "tools" / "params_bridge.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


bridge = _load_bridge()


@pytest.fixture(scope="module")
def jax_dir(tmp_path_factory):
    """A JAX model directory as its train CLI exports one: config.yaml and
    the orbax params/ of a JAX init."""
    d = tmp_path_factory.mktemp("jax_model")
    mcfg = JaxModelConfig(**TINY)
    jax_save_config(JaxConfig(model=mcfg), str(d / "config.yaml"))
    params = jax.jit(JaxUNet2D(mcfg).init)(jax.random.key(3), jnp.zeros((1, 16, 16, 3)),
                                           jnp.zeros((1,), jnp.int32))
    jax_save_params_only(str(d), params)
    return str(d), params


@pytest.fixture(scope="module")
def port_dir(tmp_path_factory):
    """A port model directory: config.yaml and params.npz of seeded torch
    weights."""
    d = tmp_path_factory.mktemp("port_model")
    mcfg = ModelConfig(**TINY)
    save_config(Config(model=mcfg), str(d / "config.yaml"))
    model = UNet2D(mcfg, device="cpu", generator=torch.Generator().manual_seed(4))
    with torch.no_grad():  # non-zero biases and norms, so every leaf is checked
        for p in model.parameters():
            p.add_(0.1 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    save_npz(str(d / "params.npz"), torch_to_flax(model.state_dict()))
    return str(d)


@pytest.fixture(scope="module")
def bridged_npz(jax_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("bridged_npz")
    bridge.main(["to-npz", "--src", jax_dir[0], "--dst", str(d)])
    return str(d)


@pytest.fixture(scope="module")
def bridged_orbax(port_dir, tmp_path_factory):
    d = tmp_path_factory.mktemp("bridged_orbax")
    bridge.main(["to-orbax", "--src", port_dir, "--dst", str(d)])
    return str(d)


def _assert_flat_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert np.array_equal(a[k], b[k]), k


def test_orbax_npz_orbax_is_bitwise(jax_dir, bridged_npz, tmp_path):
    src, params = jax_dir
    back = tmp_path / "back"
    bridge.main(["to-orbax", "--src", bridged_npz, "--dst", str(back)])
    want = {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()}
    _assert_flat_equal(load_npz(os.path.join(bridged_npz, "params.npz")), want)
    again = flatten_dict(bridge.restore_orbax(str(back / "params")), sep="/")
    _assert_flat_equal(again, want)
    for d in (bridged_npz, back):
        assert (Path(d) / "config.yaml").read_bytes() == (Path(src) / "config.yaml").read_bytes()


def test_npz_orbax_npz_is_bitwise(port_dir, bridged_orbax, tmp_path):
    bridge.main(["to-npz", "--src", bridged_orbax, "--dst", str(tmp_path)])
    _assert_flat_equal(load_npz(str(tmp_path / "params.npz")),
                       load_npz(os.path.join(port_dir, "params.npz")))
    assert not [f for f in os.listdir(tmp_path) if "tmp" in f]  # renamed into place


def test_port_forward_on_bridged_jax_tree(jax_dir, bridged_npz):
    src, params = jax_dir
    cfg = load_config()
    model, _ = generation.load_model_for_sampling(cfg, bridged_npz, "cpu")
    assert cfg.model.block_out_channels == (8, 16)
    rng = np.random.default_rng(0)
    x = rng.normal(size=SHAPE).astype(np.float32)
    t = np.array([3, 711])
    want = np.asarray(jax.jit(JaxUNet2D(JaxModelConfig(**TINY)).apply)(params, x,
                                                                     t.astype(np.int32)))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(t)).numpy()
    assert np.abs(got - want).max() <= 2e-3


def test_ddim10_on_bridged_tree_with_jax_x_T(jax_dir, bridged_npz):
    src, params = jax_dir
    jmodel = JaxUNet2D(JaxModelConfig(**TINY))
    key = jax.random.key(21)
    want = np.asarray(jax_ddim_sample(jax.jit(lambda x, t: jmodel.apply(params, x, t)),
                                      jax_make_schedule(), SHAPE, key, 10, eta=0.0))
    x_key, _ = jax.random.split(key)  # the draw JAX's _sample_loop makes
    x_T = torch.from_numpy(np.asarray(jax.random.normal(x_key, SHAPE, jnp.float32)).copy())
    cfg = load_config()
    model, schedule = generation.load_model_for_sampling(cfg, bridged_npz, "cpu")
    with torch.no_grad():
        got = ddim_sample(model, schedule, SHAPE, num_inference_steps=10, x_T=x_T,
                          noise=lambda i: None)
    assert np.abs(got.numpy() - want).max() <= 2e-3


def _pngs(d):
    return sorted(f for f in os.listdir(d) if f.endswith(".png"))


def test_port_cli_samples_the_bridged_jax_dir(bridged_npz, tmp_path):
    generation.main(["--model_dir", bridged_npz, "--output_dir", str(tmp_path), "--device", "cpu",
                     "--sampler", "ddim", "--steps", "2", "--batch_size", "2",
                     "--num_batches", "1"])
    assert _pngs(tmp_path) == ["loop_000_batch_000.png", "loop_000_batch_001.png"]


def test_jax_cli_samples_the_bridged_port_dir(bridged_orbax, tmp_path):
    jax_generation.main(["--model_dir", bridged_orbax, "--output_dir", str(tmp_path),
                         "--sampler", "ddim", "--steps", "2", "--batch_size", "8",
                         "--num_batches", "1"])
    assert _pngs(tmp_path) == [f"loop_000_batch_{i:03d}.png" for i in range(8)]


def test_port_cli_names_the_bridge_for_an_orbax_dir(jax_dir, tmp_path):
    with pytest.raises(SystemExit, match="params_bridge.py to-npz"):
        generation.main(["--model_dir", jax_dir[0], "--output_dir", str(tmp_path),
                         "--device", "cpu", "--sampler", "ddim"])


@pytest.mark.parametrize("command,missing", [("to-npz", "orbax params"),
                                             ("to-orbax", "params.npz")])
def test_bridge_refuses_a_dir_without_its_weights(tmp_path, command, missing):
    with pytest.raises(SystemExit, match=missing):
        bridge.main([command, "--src", str(tmp_path), "--dst", str(tmp_path / "out")])
