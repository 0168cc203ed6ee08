"""The port's CLIs on a mesh with a model axis of 2, on the CPU over gloo
(torchrun): the train CLI at model 2 writes a checkpoint that resumes at
model 1, and the reverse, the two runs within TOL of each other and every
checkpoint and params.npz holding the whole model; the generation CLI at
model 2 on 2 ranks writes the one-process run's PNGs byte for byte.
TOL is tests/test_torch_tensor_parallel.py's f32 bound, 1e-5: the runs
differ only in the order of the sums (lr 1e-4 here, at which resumed runs
agree to ~4e-6)."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.models.convert import torch_to_flax
from drivescenegen_torch.config import load_config
from drivescenegen_torch.scripts import generation, train

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
DRYRUN = dict(sample_size=16, block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=2,
              attention_head_dim=8, dtype="float32")
TOL = 1e-5


def _torchrun(args, n, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    for k in DIST_ENV:
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), *args]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return out.stdout + out.stderr


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(11)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
            d / f"{i:02d}.png")
    return str(d / "*.png")


def _cfg(path, corpus, out, model):
    cfg = {"model": DRYRUN, "mesh": {"data": -1, "model": model},
           "train": dict(batch_size=4, learning_rate=1e-4, lr_warmup_steps=0, ema_decay=0.99,
                         log_every=1, eval_inference_steps=2, dataset_glob=corpus,
                         output_dir=out, device_data="on")}
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _train(tmp_path, corpus, name, model, steps, resume=False):
    out = str(tmp_path / name)
    cfg = _cfg(tmp_path / f"{name}_{model}.yaml", corpus, out, model)
    args = ["--cfg_file", cfg, "--max_steps", str(steps), "--device", "cpu"] + (
        ["--resume"] if resume else [])
    if model == 1:
        train.main(args)
        return out, ""
    return out, _torchrun(["-m", "drivescenegen_torch.scripts.train", *args], model)


def _ckpt(out, step):
    return torch.load(os.path.join(out, "checkpoints", f"step_{step:08d}.pt"))


def test_checkpoints_resume_across_the_model_axis(tmp_path, corpus):
    """Step 1 at model 2 then, resumed, step 2 at model 1 (run a), and the
    reverse (run b): the two agree within TOL at each step, params, EMA
    and AdamW's moments, and every checkpoint holds the whole model (the
    one-process run's keys and shapes, the moments included), as does
    params.npz. (A resumed run starts the data stream again, so both
    resumed runs see the first batch twice.)"""
    run_a, log = _train(tmp_path, corpus, "a", 2, 1)
    assert "mesh: {'data': 1, 'model': 2} on cpu (torch.distributed); tensor parallel" in log
    run_b, _ = _train(tmp_path, corpus, "b", 1, 1)
    one = [_ckpt(run_b, 1)]
    first = _ckpt(run_a, 1)
    for key in ("params", "ema_params"):
        assert {k: v.shape for k, v in first[key].items()} == \
            {k: v.shape for k, v in one[0][key].items()}
        assert max((first[key][k] - one[0][key][k]).abs().max().item() for k in first[key]) <= TOL
    for idx, st in first["opt_state"]["state"].items():
        assert st["exp_avg"].shape == one[0]["opt_state"]["state"][idx]["exp_avg"].shape
    npz = [np.load(os.path.join(r, "params.npz")) for r in (run_a, run_b)]
    assert sorted(npz[0].files) == sorted(npz[1].files)
    assert max(np.abs(npz[0][k] - npz[1][k]).max() for k in npz[0].files) <= TOL
    _train(tmp_path, corpus, "a", 1, 2, resume=True)
    _, log = _train(tmp_path, corpus, "b", 2, 2, resume=True)
    assert "resumed from step 1" in log
    a, b = _ckpt(run_a, 2), _ckpt(run_b, 2)
    assert a["step"] == b["step"] == 2
    for key in ("params", "ema_params"):
        diff = max((a[key][k] - b[key][k]).abs().max().item() for k in b[key])
        assert diff <= TOL, (key, diff)
    for idx, st in b["opt_state"]["state"].items():
        for m in ("exp_avg", "exp_avg_sq"):
            scale = st[m].abs().max().item()
            assert (a["opt_state"]["state"][idx][m] - st[m]).abs().max().item() <= TOL * scale


def test_generation_at_model_two_writes_the_one_process_pngs(tmp_path):
    """Two ranks on a mesh of model 2 (parameters replicated, one row
    block): the model-index-0 rank writes the PNGs, byte for byte the
    one-process run's."""
    from drivescenegen_torch.config import load_config, save_config
    from drivescenegen_torch.models.convert import save_npz

    cfg = load_config(None, {"model": DRYRUN})
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    save_config(cfg, str(model_dir / "config.yaml"))
    net = UNet2D(cfg.model, device="cpu", generator=torch.Generator().manual_seed(2))
    save_npz(str(model_dir / "params.npz"), torch_to_flax(net.state_dict()))
    tp_cfg = tmp_path / "tp.yaml"
    tp_cfg.write_text(yaml.safe_dump({"mesh": {"data": -1, "model": 2}}))
    common = ["--model_dir", str(model_dir), "--sampler", "sde", "--steps", "3",
              "--num_batches", "2", "--batch_size", "3", "--seed", "5", "--device", "cpu"]
    _torchrun(["-m", "drivescenegen_torch.scripts.generation", "--cfg_file", str(tp_cfg),
               "--output_dir", str(tmp_path / "two"), *common], 2)
    generation.main(["--output_dir", str(tmp_path / "one"), *common])
    names = sorted(os.listdir(tmp_path / "one"))
    assert len(names) == 6 and sorted(os.listdir(tmp_path / "two")) == names
    for name in names:
        a, b = (open(tmp_path / d / name, "rb").read() for d in ("two", "one"))
        assert a == b, name


def test_the_supervisor_launches_every_rank_of_the_mesh():
    cfg = load_config(None, {"mesh": {"data": 2, "model": 2}})
    cmd, _ = train.supervised_commands(["--max_steps", "4"], cfg, "cpu")
    assert cmd[:6] == [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc_per_node", "4"]
    cfg = load_config(None, {"mesh": {"data": -1, "model": 2}})
    assert train.supervised_commands([], cfg, "cpu")[0][5] == "2"
