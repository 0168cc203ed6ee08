"""The port's fused end-to-end CLI (scripts/end_to_end.py) on the CPU, on a
tiny model directory written from a JAX init (config.yaml through the JAX
package's config writer, params.npz through the converter): every
sampler, PNGs pixel-equal to the port's generation CLI, --resume, the
refusal of conditional models, and the stats keys of the JAX package's
CLI. The JAX package's side runs with its native_graph.available patched
to False (tests/test_torch_stage2.py says why)."""

import glob
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

from drivescenegen_torch import diffusion
from drivescenegen_torch.models.convert import save_npz
from drivescenegen_torch.scripts import end_to_end, generation
from drivescenegen_tpu.config import Config as JaxConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.config import save_config
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_tpu.vectorize import native_graph as j_native

TINY = dict(sample_size=16, block_out_channels=(8, 16), layers_per_block=1,
            norm_num_groups=2, attention_head_dim=8, dtype="float32")
# Random weights sample noise, which the vectorizer rejects at its
# lane-mask density gate: every scene is accounted for, none reaches the
# graph passes.
STEPS, SCENES, BATCH = 2, 3, 2


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(JaxUNet2D(JaxModelConfig(**TINY)).init)(
        jax.random.key(0), jnp.zeros((1, 16, 16, 3)), jnp.zeros((1,), jnp.int32))


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory, jax_params):
    d = tmp_path_factory.mktemp("model")
    save_config(JaxConfig(model=JaxModelConfig(**TINY)), str(d / "config.yaml"))
    save_npz(str(d / "params.npz"),
             {k: np.asarray(v) for k, v in flatten_dict(jax_params, sep="/").items()})
    return str(d)


def _e2e(model_dir, out, *extra):
    return end_to_end.main(["--model_dir", model_dir, "--output_dir", str(out), "--device",
                            "cpu", "--num_scenes", str(SCENES), "--batch_size", str(BATCH),
                            "--steps", str(STEPS), "--n_workers", "1", "--seed", "5", *extra])


def _pngs(directory):
    return {os.path.basename(p): np.asarray(Image.open(p))
            for p in sorted(glob.glob(os.path.join(directory, "*.png")))}


@pytest.mark.parametrize("sampler", ["ddim", "ddpm", "dpm", "sde"])
def test_each_sampler_writes_the_generation_clis_pngs(model_dir, tmp_path, sampler):
    stats, timings = _e2e(model_dir, tmp_path / "e2e", "--sampler", sampler)
    assert stats["n_images"] == SCENES
    assert stats["n_ok"] + stats["n_rejected"] + stats["n_failed"] == SCENES
    assert stats["sampler"] == f"{sampler}-{STEPS}"
    assert timings["n_batches"] == 2 and timings["n_resumed"] == 0
    assert json.loads((tmp_path / "e2e" / "vectorization_stats.json").read_text()) == stats
    for sub in ("vectorized", "graph", "agent", "vectorized_pics"):
        assert (tmp_path / "e2e" / sub).is_dir()

    generation.main(["--model_dir", model_dir, "--output_dir", str(tmp_path / "gen"),
                     "--device", "cpu", "--sampler", sampler, "--steps", str(STEPS),
                     "--batch_size", str(BATCH), "--num_batches", "2", "--seed", "5"])
    fused, two_stage = _pngs(tmp_path / "e2e" / "diffusion"), _pngs(tmp_path / "gen")
    assert sorted(fused) == sorted(two_stage)[:SCENES]
    for name, img in fused.items():
        assert img.shape == (16, 16, 3) and img.dtype == np.uint8
        np.testing.assert_array_equal(img, two_stage[name], err_msg=name)


def test_resume_skips_sampling(model_dir, tmp_path, monkeypatch):
    out = tmp_path / "e2e"
    first, _ = _e2e(model_dir, out)
    pngs = {p: open(p, "rb").read() for p in glob.glob(str(out / "diffusion" / "*.png"))}
    assert len(pngs) == SCENES

    def boom(*args, **kwargs):
        raise AssertionError("sampler called despite a complete run on disk")

    monkeypatch.setattr(diffusion, "ddim_sample", boom)
    again, timings = _e2e(model_dir, out, "--resume")
    assert timings["n_resumed"] == timings["n_batches"] == 2
    for key in ("n_images", "n_ok", "n_rejected", "n_failed"):
        assert again[key] == first[key]
    for p, data in pngs.items():
        assert open(p, "rb").read() == data, f"{p} changed on resume"


def test_resume_samples_a_missing_batch(model_dir, tmp_path):
    out = tmp_path / "e2e"
    _e2e(model_dir, out)
    before = _pngs(out / "diffusion")
    os.remove(out / "diffusion" / "loop_001_batch_000.png")
    stats, timings = _e2e(model_dir, out, "--resume")
    assert timings["n_resumed"] == 1 and stats["n_images"] == SCENES
    after = _pngs(out / "diffusion")
    assert sorted(after) == sorted(before)
    for name in before:
        np.testing.assert_array_equal(after[name], before[name])


@pytest.mark.parametrize("section", ["  cond_channels: 2\n", "  out_channels: 1\n"])
def test_conditional_or_one_channel_models_are_refused(model_dir, tmp_path, monkeypatch, section):
    from drivescenegen_tpu.scripts import end_to_end as jax_end_to_end

    monkeypatch.setenv("DSG_COMPILE_CACHE", str(tmp_path / "xla"))
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("model:\n" + section)
    argv = ["--cfg_file", str(cfg), "--model_dir", model_dir, "--output_dir", str(tmp_path)]
    for main in (end_to_end.main, jax_end_to_end.main):
        with pytest.raises(SystemExit, match="unconditional 3-channel models only"):
            main(argv + (["--device", "cpu"] if main is end_to_end.main else []))


def test_a_conditional_model_dir_is_refused(tmp_path):
    """The model section spliced from the model directory is checked too."""
    from drivescenegen_torch.config import Config, ModelConfig
    from drivescenegen_torch.config import save_config as save_port_config
    from drivescenegen_torch.models import UNet2D
    from drivescenegen_torch.models.convert import torch_to_flax

    d = tmp_path / "model"
    d.mkdir()
    mcfg = ModelConfig(**TINY, cond_channels=2, in_channels=5)
    save_port_config(Config(model=mcfg), str(d / "config.yaml"))
    save_npz(str(d / "params.npz"), torch_to_flax(UNet2D(mcfg, device="cpu").state_dict()))
    with pytest.raises(SystemExit, match="cond_channels=2"):
        _e2e(str(d), tmp_path / "e2e")


def test_runs_on_the_card_unless_told(model_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        end_to_end.main(["--model_dir", model_dir, "--output_dir", str(tmp_path)])


def test_stats_keys_equal_jax(model_dir, jax_params, tmp_path, monkeypatch):
    """The JAX package's CLI on the same weights (exported with its orbax
    writer) writes a vectorization_stats.json with the port's keys and
    the same counts. A lane-mask gate below 0 rejects every scene, so the
    JAX package's spawned workers, which the patch does not reach, never
    load its native library."""
    from drivescenegen_tpu.scripts import end_to_end as jax_end_to_end
    from drivescenegen_tpu.training.checkpoint import save_params_only

    monkeypatch.setattr(j_native, "available", lambda: False)
    monkeypatch.setenv("DSG_COMPILE_CACHE", str(tmp_path / "xla"))
    jax_dir = tmp_path / "jax_model"
    jax_dir.mkdir()
    save_config(JaxConfig(model=JaxModelConfig(**TINY)), str(jax_dir / "config.yaml"))
    save_params_only(str(jax_dir), jax_params)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("vectorize:\n  noise_mask_frac: -1.0\n")
    # Batch 8: the JAX CLI rounds the batch to its 8-device test mesh.
    argv = ["--cfg_file", str(cfg), "--num_scenes", str(SCENES), "--batch_size", "8",
            "--steps", str(STEPS), "--n_workers", "1", "--seed", "5"]
    jax_end_to_end.main(["--model_dir", str(jax_dir), "--output_dir", str(tmp_path / "jax"),
                         *argv])
    port, _ = end_to_end.main(["--model_dir", model_dir, "--output_dir", str(tmp_path / "port"),
                               "--device", "cpu", *argv])
    assert port["n_rejected"] == SCENES
    ref = json.loads((tmp_path / "jax" / "vectorization_stats.json").read_text())
    assert list(port) == list(ref)
    for key in ("n_images", "n_ok", "n_rejected", "n_failed", "sampler", "eta", "spacing",
                "seed", "batch_size", "n_workers", "img_res", "gates"):
        assert port[key] == ref[key], key
