"""The port's config-5 agent evaluation (scripts/eval_cond_agents.py)
against the JAX package's: match_agents on random sets, and both CLIs'
JSON on the same GT rasters with the same sampled B channels handed to
each side's DDIM; then the port's CLI end to end on a tiny conditional
model on the CPU."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from PIL import Image

import drivescenegen_tpu.diffusion as jax_diffusion
import drivescenegen_torch.diffusion as torch_diffusion
from drivescenegen_tpu.config import Config as JaxConfig
from drivescenegen_tpu.config import ModelConfig as JaxModelConfig
from drivescenegen_tpu.config import save_config as jax_save_config
from drivescenegen_tpu.models import UNet2D as JaxUNet2D
from drivescenegen_tpu.scripts import eval_cond_agents as jax_eval
from drivescenegen_tpu.training.checkpoint import save_params_only as jax_save_params_only
from drivescenegen_torch.data.preprocess import decode_scenario
from drivescenegen_torch.data.synthetic import make_synthetic_scenario
from drivescenegen_torch.models.convert import save_npz
from drivescenegen_torch.ops.raster import rasterize_scenario
from drivescenegen_torch.scripts import eval_cond_agents

RES, N, BSZ = 128, 10, 4  # batches of 4, 4 and a short 2
TINY_COND = dict(sample_size=RES, in_channels=1, out_channels=1, cond_channels=2,
                 block_out_channels=(8, 16), layers_per_block=1, norm_num_groups=2,
                 attention_head_dim=8, dtype="float32")


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """GT rasters of synthetic scenes (the port's rasterizer on the CPU),
    and one tiny conditional model written for both packages: config.yaml,
    the orbax params/ and params.npz of a JAX init."""
    root = tmp_path_factory.mktemp("eval")
    ras = root / "ras"
    ras.mkdir()
    for i in range(N):
        info = decode_scenario(make_synthetic_scenario(100 + i, rich=True))
        img = rasterize_scenario(info, img_res=RES, device="cpu")
        Image.fromarray(np.round(img * 255).astype(np.uint8)).save(ras / f"{i:03d}.png")
    model_dir = root / "model"
    model_dir.mkdir()
    mcfg = JaxModelConfig(**TINY_COND)
    jax_save_config(JaxConfig(model=mcfg), str(model_dir / "config.yaml"))
    params = jax.jit(JaxUNet2D(mcfg).init)(jax.random.key(0), jnp.zeros((1, RES, RES, 1)),
                                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, RES, RES, 2)))
    jax_save_params_only(str(model_dir), params)
    save_npz(str(model_dir / "params.npz"),
             {k: np.asarray(v) for k, v in flatten_dict(params, sep="/").items()})
    return str(ras), str(model_dir)


def _random_agents(rng, n):
    return [list(rng.uniform(-20, 20, size=2)) + [0.0] * 7 for _ in range(n)]


@pytest.mark.parametrize("seed", range(4))
def test_match_agents_equals_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        gt = _random_agents(rng, rng.integers(0, 12))
        pred = _random_agents(rng, rng.integers(0, 12))
        assert eval_cond_agents.match_agents(gt, pred) == jax_eval.match_agents(gt, pred)
        assert eval_cond_agents.match_agents(gt, pred, 8.0) == jax_eval.match_agents(gt, pred, 8.0)


def _handed_samples(ras_dir):
    """B channels for guidance 1 and 3, in [-1, 1]: the GT agents, some
    images' shifted by 6 px (they miss the 3 m match radius at 0.625 m/px)
    or blanked, so precision and recall are neither 0 nor 1."""
    gt_b = np.stack([np.asarray(Image.open(os.path.join(ras_dir, f)).convert("RGB"))[..., 2]
                     for f in sorted(os.listdir(ras_dir))]).astype(np.float32) / 255.0
    out = []
    for k in range(2):
        b = gt_b * 2 - 1
        for i in range(N):
            if i % 3 == k:
                b[i] = np.roll(b[i], 6, axis=1)
            if i % 4 == 3 - k:
                b[i] = -1.0
        out.append(b[..., None])
    return out


def _fake_ddim(samples, to_tensor, calls):
    """A DDIM that returns the handed samples: call c is batch c % 3 of
    guidance c // 3, the rows the caller's shape asks for, zero-padded
    past the last real row."""
    def ddim(denoise, schedule, shape, generator, *args, **kwargs):
        g, b = divmod(len(calls), -(-N // BSZ))
        calls.append((shape[0], generator))
        rows = samples[g][b * BSZ: b * BSZ + shape[0]]
        rows = np.concatenate([rows, np.zeros((shape[0] - len(rows), *rows.shape[1:]),
                                              np.float32)])
        return to_tensor(rows)
    return ddim


def _args(setup, json_out):
    ras, model_dir = setup
    return ["--cfg_file", os.path.join(model_dir, "config.yaml"), "--model_dir", model_dir,
            "--raster_dir", ras, "--guidance", "1,3", "--batch_size", str(BSZ), "--steps", "2",
            "--seed", "7", "--json_out", str(json_out)]


def test_cli_json_equals_jax_on_the_same_samples(setup, tmp_path, monkeypatch):
    samples = _handed_samples(setup[0])
    jax_calls, port_calls = [], []
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)  # call the fake batch by batch
    monkeypatch.setattr(jax_diffusion, "ddim_sample",
                        _fake_ddim(samples, jnp.asarray, jax_calls))
    jax_eval.main(_args(setup, tmp_path / "jax.json"))
    monkeypatch.undo()
    monkeypatch.setattr(torch_diffusion, "ddim_sample",
                        _fake_ddim(samples, torch.from_numpy, port_calls))
    eval_cond_agents.main(_args(setup, tmp_path / "port.json") + ["--device", "cpu"])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert got == want
    res = got["results"]
    assert got["n_images"] == N and got["n_gt_agents"] > 0
    assert 0 < res["guidance_1"]["recall"] < 1 and 0 < res["guidance_3"]["precision"] <= 1
    # JAX pads the short batch to one compiled shape; the port samples its
    # real rows only, batch i seeded from --seed and its first index.
    assert [n for n, _ in jax_calls] == [4, 4, 4] * 2
    assert [n for n, _ in port_calls] == [4, 4, 2] * 2
    assert [g.initial_seed() for _, g in port_calls] == [7 * 1_000_003 + i for i in (0, 4, 8)] * 2


def test_cli_runs_end_to_end_on_the_cpu(setup, tmp_path, capsys):
    out = eval_cond_agents.main(_args(setup, tmp_path / "e2e.json") + ["--device", "cpu"])
    assert json.loads((tmp_path / "e2e.json").read_text()) == out
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == out
    assert out["n_images"] == N and set(out["results"]) == {"guidance_1", "guidance_3"}
    for r in out["results"].values():
        assert set(r) == {"precision", "recall", "f1", "mean_center_err_m", "n_pred"}
        assert all(np.isfinite(v) for v in r.values())


def test_cli_refuses_an_unconditional_model(setup, tmp_path):
    cfg = tmp_path / "uncond.yaml"
    cfg.write_text("model:\n  cond_channels: 0\n")
    with pytest.raises(SystemExit, match="conditional model"):
        eval_cond_agents.main(["--cfg_file", str(cfg), "--raster_dir", setup[0],
                               "--device", "cpu"])
