"""Data parallelism in the port (parallel/mesh.py) on the CPU over gloo:
make_mesh's resolution and errors; a one-rank process group's train step
bit-identical to the step without one; a 2-rank train step (torchrun, the
train CLI) equal to the one-process step within 1e-6 in loss and params,
the one-process step being the one tests/test_torch_training.py holds to
JAX; batch_source's rows of the global batch in every data mode; a
2-rank generation run whose PNGs are byte-equal to the one-process run's;
and the same of the end-to-end CLI, with a resume.
The card's host has one GPU and NCCL refuses two ranks on one, so two
ranks run here only."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from drivescenegen_torch.config import MeshConfig, ModelConfig, TrainConfig
from drivescenegen_torch.data.dataset import RasterDataset
from drivescenegen_torch.diffusion import make_schedule
from drivescenegen_torch.models import UNet2D
from drivescenegen_torch.parallel import Mesh, batch_sharding, make_mesh, replicated, shard_batch
from drivescenegen_torch.scripts import generation, train
from drivescenegen_torch.training import create_optimizer, init_train_state, make_train_step

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(sample_size=16, block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4,
            attention_head_dim=8, dtype="float32")
DIST_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


@pytest.fixture()
def no_torchrun_env(monkeypatch):
    for k in DIST_ENV:
        monkeypatch.delenv(k, raising=False)


def test_make_mesh_without_torchrun_is_one_rank(no_torchrun_env):
    mesh = make_mesh(MeshConfig(), "cpu")
    assert (mesh.shape, mesh.rank, mesh.world, mesh.distributed) == (
        {"data": 1, "model": 1}, 0, 1, False)
    assert mesh.device == torch.device("cpu") and mesh.rows(5) == slice(0, 5)
    mesh.barrier()
    mesh.close()


def test_make_mesh_errors(no_torchrun_env, monkeypatch):
    with pytest.raises(ValueError, match="the model axis 2 does not divide the world of 1"):
        make_mesh(MeshConfig(model=2), "cpu")
    with pytest.raises(ValueError, match="needs 2 processes, the world has 1"):
        make_mesh(MeshConfig(data=2), "cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(MeshConfig(), "cuda")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(RuntimeError, match="must all be set"):
        make_mesh(MeshConfig(), "cpu")


def test_rows_and_placement():
    mesh = Mesh({"data": 4, "model": 1}, rank=2, world=4)
    assert mesh.rows(8) == batch_sharding(mesh, 8) == slice(4, 6)
    with pytest.raises(ValueError, match="not divisible"):
        mesh.rows(6)
    batch = np.arange(16).reshape(8, 2)
    assert torch.equal(shard_batch(mesh, batch), torch.tensor([[8, 9], [10, 11]]))
    assert torch.equal(replicated(mesh, batch), torch.from_numpy(batch))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _step_params(mesh, batch):
    cfg = ModelConfig(**TINY)
    tcfg = TrainConfig(batch_size=4, learning_rate=1e-3, lr_warmup_steps=0, ema_decay=0.99,
                       cond_dropout=0.0)
    model = UNet2D(cfg, device="cpu", for_training=True,
                   generator=torch.Generator().manual_seed(0))
    opt, lr_fn = create_optimizer(tcfg, 10, model.parameters())
    state = init_train_state(model, opt, ema=True)
    step = make_train_step(make_schedule(device="cpu"), lr_fn, tcfg, mesh)
    for _ in range(2):
        state, m = step(state, batch)
    return float(m["loss"]), [p.detach().clone() for p in model.parameters()], state.ema_params


def test_one_rank_process_group_step_is_bit_identical(no_torchrun_env, monkeypatch):
    """The world-of-one path through the process group (the gradient
    all_reduce included) computes the step of no process group bit for
    bit, as phase 14 of chip_smoke.py checks over NCCL on the card."""
    batch = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (4, 16, 16, 3),
                                                               dtype=np.uint8))
    want = _step_params(None, batch)
    for k, v in dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost",
                     MASTER_PORT=str(_free_port())).items():
        monkeypatch.setenv(k, v)
    mesh = make_mesh(MeshConfig(), "cpu")
    try:
        assert mesh.distributed and torch.distributed.get_backend() == "gloo"
        got = _step_params(mesh, batch)
    finally:
        mesh.close()
    assert got[0] == want[0]
    assert all(torch.equal(a, b) for a, b in zip(got[1], want[1]))
    assert all(torch.equal(got[2][k], want[2][k]) for k in want[2])


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(8)
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(
            d / f"{i:02d}.png")
    return str(d / "*.png")


def _cfg(tmp_path, name, **train_kw):
    # lr 1e-4: Adam's first update of an element is lr * g / (|g| + eps),
    # whose slope at g ~ eps is lr / (4 eps), so the f32 gradient sums of
    # two ranks, up to ~1e-10 from one process's, can move it by
    # lr / (4 eps) * 1e-10 = 2.5e-7. A step that skipped the all_reduce
    # moves elements by up to 2 lr.
    cfg = {"model": TINY,
           "train": dict(dict(batch_size=4, learning_rate=1e-4, lr_warmup_steps=0,
                              ema_decay=0.99, log_every=1, eval_inference_steps=2), **train_kw)}
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _torchrun(args, n=2, timeout=300):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    for k in DIST_ENV:
        env.pop(k, None)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
           str(n), "-m", *args]
    out = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    assert out.returncode == 0, (out.stdout + out.stderr)[-4000:]
    return out.stdout + out.stderr


@pytest.fixture(scope="module")
def two_rank_run(corpus, tmp_path_factory):
    """One train step of the train CLI on 2 gloo ranks and in one process,
    on the same config and corpus."""
    tmp = tmp_path_factory.mktemp("dp")
    cfg = _cfg(tmp, "cfg.yaml", dataset_glob=corpus, device_data="on")
    runs = {}
    for n in (2, 1):
        out = str(tmp / f"run{n}")
        args = ["--cfg_file", cfg, "--output_dir", out, "--max_steps", "1", "--device", "cpu"]
        if n == 2:
            log = _torchrun(["drivescenegen_torch.scripts.train"] + args)
        else:
            train.main(args)
            log = ""
        runs[n] = (out, log)
    return runs


def test_two_rank_train_step_equals_the_one_process_step(two_rank_run):
    (out2, log), (out1, _) = two_rank_run[2], two_rank_run[1]
    assert "mesh: {'data': 2, 'model': 1} on cpu (torch.distributed)" in log
    loss = [json.loads(open(os.path.join(o, "logs", "metrics.jsonl")).readline())["loss"]
            for o in (out2, out1)]
    assert abs(loss[0] - loss[1]) <= 1e-6, loss
    ck = [torch.load(os.path.join(o, "checkpoints", "step_00000001.pt")) for o in (out2, out1)]
    assert ck[0]["step"] == ck[1]["step"] == 1 and ck[0]["params"].keys() == ck[1]["params"].keys()
    assert not any(k.startswith("module.") for k in ck[0]["params"])
    for key in ("params", "ema_params"):
        diff = max((ck[0][key][k] - ck[1][key][k]).abs().max().item() for k in ck[1][key])
        assert diff <= 1e-6, (key, diff)
    assert os.listdir(os.path.join(out2, "checkpoints")) == ["step_00000001.pt"]


@pytest.mark.parametrize("mode", ["resident", "hybrid", "streamed"])
def test_each_rank_takes_its_rows_of_the_global_batch(corpus, mode):
    """batch_source on rank r of 2 gives rows [r * B/2, (r + 1) * B/2) of
    the one-rank global batch, in every data mode (hybrid: 8 of 16 samples
    resident; its global batch straddles pool and tail on neither rank)."""
    tcfg = TrainConfig(batch_size=4, seed=3, device_data_budget_gb=8 * 768 / 1024 ** 3)
    ds = RasterDataset(corpus, img_res=16, raw=True)
    one, _ = train.batch_source(mode, ds, tcfg, Mesh())
    ranks = [train.batch_source(mode, ds, tcfg, Mesh({"data": 2, "model": 1}, r, 2))[0]
             for r in (0, 1)]
    for _ in range(6):
        want = one()
        assert want.shape == (4, 16, 16, 3) and want.dtype == torch.uint8
        assert torch.equal(torch.cat([r() for r in ranks]), want)


def test_two_rank_generation_pngs_equal_the_one_process_run(two_rank_run, tmp_path):
    """A 2-rank SDE run (x_T and a noise draw every step) writes the
    one-process run's PNGs byte for byte; batch 5 rounds to 4 on 2 ranks."""
    model_dir = two_rank_run[1][0]
    common = ["--model_dir", model_dir, "--sampler", "sde", "--steps", "3", "--num_batches", "2",
              "--seed", "7", "--device", "cpu"]
    log = _torchrun(["drivescenegen_torch.scripts.generation", "--output_dir",
                     str(tmp_path / "two"), "--batch_size", "5", *common])
    assert "rounded batch to 4 (data axis 2)" in log
    generation.main(["--output_dir", str(tmp_path / "one"), "--batch_size", "4", *common])
    names = sorted(os.listdir(tmp_path / "one"))
    assert names == [f"loop_{n:03d}_batch_{i:03d}.png" for n in range(2) for i in range(4)]
    assert sorted(os.listdir(tmp_path / "two")) == names
    for name in names:
        a, b = (open(tmp_path / d / name, "rb").read() for d in ("two", "one"))
        assert a == b, name


def test_two_rank_end_to_end_equals_the_one_process_run(tmp_path):
    """The end-to-end CLI on 2 ranks: each samples its rows, rank 0
    gathers them and runs the host side. Its PNGs, graphs and stats
    (timings aside) are the one-process run's; a --resume rerun resumes
    every batch on rank 0, and rank 1 samples none."""
    from drivescenegen_torch.config import load_config, save_config
    from drivescenegen_torch.models.convert import save_npz, torch_to_flax
    from drivescenegen_torch.scripts import end_to_end

    cfg = load_config(None, {"model": dict(TINY, sample_size=32)})
    model_dir = tmp_path / "model"
    model_dir.mkdir()
    save_config(cfg, str(model_dir / "config.yaml"))
    model = UNet2D(cfg.model, device="cpu", generator=torch.Generator().manual_seed(1))
    save_npz(str(model_dir / "params.npz"), torch_to_flax(model.state_dict()))
    common = ["--model_dir", str(model_dir), "--num_scenes", "6", "--batch_size", "4",
              "--sampler", "sde", "--steps", "2", "--n_workers", "1", "--device", "cpu"]
    _torchrun(["drivescenegen_torch.scripts.end_to_end", "--output_dir", str(tmp_path / "two"),
               *common])
    end_to_end.main(["--output_dir", str(tmp_path / "one"), *common])
    timing = ("sampling_wall_s", "wall_time_s", "scenes_per_s", "ok_scenes_per_s")
    stats = []
    for d in ("two", "one"):
        with open(tmp_path / d / "vectorization_stats.json") as f:
            stats.append({k: v for k, v in json.load(f).items() if k not in timing})
    assert stats[0] == stats[1] and stats[0]["n_images"] == 6
    assert len(os.listdir(tmp_path / "one" / "diffusion")) == 6
    for sub in ("diffusion", "vectorized", "graph", "agent"):  # random weights: all rejected
        names = sorted(os.listdir(tmp_path / "one" / sub))
        assert sorted(os.listdir(tmp_path / "two" / sub)) == names
        for name in names:
            a, b = (open(tmp_path / d / sub / name, "rb").read() for d in ("two", "one"))
            assert a == b, (sub, name)
    log = _torchrun(["drivescenegen_torch.scripts.end_to_end", "--output_dir",
                     str(tmp_path / "two"), "--resume", *common])
    assert "resumed 2/2 batches from disk" in log
