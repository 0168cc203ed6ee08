"""The port's train CLI, the options of its data-parallel slice: the
supervisor (tests/test_training.py:117-183 mirrored, and the command it
launches), --init_from, --profile_steps, the hybrid device-data mode and
fault F5's repair (device_data "auto" over the budget goes hybrid, as the
JAX trainer does: tests/test_dataset.py:193 mirrored), and the sidecar
prebuild, on the CPU at a tiny config."""

import glob
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from drivescenegen_torch.config import load_config
from drivescenegen_torch.data import dataset
from drivescenegen_torch.models.convert import flax_to_torch, load_npz
from drivescenegen_torch.scripts import train
from drivescenegen_torch.scripts.train import supervise, supervised_commands

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(sample_size=16, block_out_channels=[8, 16], layers_per_block=1, norm_num_groups=4,
            attention_head_dim=8, dtype="float32")


def test_supervise_retries_until_success(tmp_path):
    marker = tmp_path / "attempts"
    cmd = [sys.executable, "-c",
           "import os,sys; p=%r; n=int(open(p).read()) if os.path.exists(p) "
           "else 0; open(p,'w').write(str(n+1)); sys.exit(0 if n>=2 else 1)" % str(marker)]
    rc = supervise(cmd, retries=5, health_check=lambda: True, sleep_s=0.01)
    assert rc == 0
    assert marker.read_text() == "3"  # two crashes + one success


def test_supervise_gives_up_after_budget(tmp_path):
    cmd = [sys.executable, "-c", "import sys; sys.exit(3)"]
    assert supervise(cmd, retries=2, health_check=lambda: True, sleep_s=0.01) == 3


def test_supervise_kills_hung_child_on_stalled_progress(tmp_path):
    logs = tmp_path / "logs"
    logs.mkdir()
    (logs / "drivescenegen.log").write_text("step 1\n")
    t0 = time.time()
    cmd = [sys.executable, "-c", "import time; time.sleep(600)"]
    rc = supervise(cmd, retries=0, health_check=lambda: True, progress_path=str(logs),
                   stall_s=0.5)
    assert rc == -9
    assert time.time() - t0 < 120  # killed by the watchdog, not wait()


def test_supervise_waits_while_progress_advances(tmp_path):
    logs = tmp_path / "logs"
    logs.mkdir()
    cmd = [sys.executable, "-c",
           "import pathlib,time\n"
           "p = pathlib.Path(%r)/'drivescenegen.log'\n"
           "for i in range(3):\n"
           "    p.write_text(str(i)); time.sleep(0.2)\n" % str(logs)]
    rc = supervise(cmd, retries=0, health_check=lambda: True, progress_path=str(logs),
                   stall_s=3600.0)
    assert rc == 0


def test_supervise_refuses_to_run_under_torchrun(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(SystemExit, match="outer process"):
        supervise([sys.executable, "-c", "pass"], retries=0, health_check=lambda: True)


@pytest.mark.parametrize("data,launcher", [
    (-1, ["-m", "drivescenegen_torch.scripts.train"]),
    (1, ["-m", "drivescenegen_torch.scripts.train"]),
    (3, ["-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "3", "-m",
         "drivescenegen_torch.scripts.train"])])
def test_the_supervisor_launches_the_whole_data_parallel_group(data, launcher):
    cfg = load_config(None, {"mesh": {"data": data}})
    cmd, resume = supervised_commands(["--cfg_file", "c.yaml", "--supervise", "2",
                                       "--supervise=3", "--max_steps", "4"], cfg, "cpu")
    assert cmd == [sys.executable, *launcher, "--cfg_file", "c.yaml", "--max_steps", "4"]
    assert resume == cmd + ["--resume"]
    assert supervised_commands(["--resume"], cfg, "cpu")[1] == \
        supervised_commands(["--resume"], cfg, "cpu")[0]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    rng = np.random.default_rng(5)
    for i in range(16):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return str(d / "*.png")


def _cfg(tmp_path, corpus, name="cfg.yaml", **train_kw):
    cfg = {"model": TINY,
           "train": dict(dict(batch_size=4, ema_decay=0.0, log_every=1, eval_inference_steps=2,
                              dataset_glob=corpus, output_dir=str(tmp_path / "out")), **train_kw)}
    path = tmp_path / name
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def _log(out_dir) -> str:
    return open(os.path.join(out_dir, "logs", "drivescenegen.log")).read()


def test_auto_over_the_budget_goes_hybrid(corpus, tmp_path):
    """Fault F5: device_data "auto" with a corpus over device_data_budget_gb
    host-fed every batch; it now keeps a budget-sized pool resident and
    streams the rest, as the JAX trainer does."""
    out = tmp_path / "out"
    cfg = _cfg(tmp_path, corpus, device_data="auto",
               device_data_budget_gb=8 * 768 / 1024 ** 3)  # 8 of 16 samples
    state = train.main(["--cfg_file", cfg, "--max_steps", "3", "--device", "cpu"])
    assert state.step == 3
    log = _log(out)
    assert "hybrid device data: corpus 0.00 GB > budget 0.00 GB; streaming the tail" in log
    assert "hybrid: pool 8, tail 8; a batch is 2 pool + 2 tail rows" in log


def test_train_hybrid_device_data_runs(corpus, tmp_path):
    out = tmp_path / "out"
    cfg = _cfg(tmp_path, corpus, device_data="hybrid", device_data_budget_gb=5 * 768 / 1024 ** 3)
    train.main(["--cfg_file", cfg, "--max_steps", "4", "--device", "cpu"])
    records = [json.loads(line) for line in open(out / "logs" / "metrics.jsonl")]
    assert [r["step"] for r in records] == [1, 2, 3, 4]
    assert all(np.isfinite(r["loss"]) for r in records)
    assert (out / "params.npz").exists()
    fits = _cfg(tmp_path, corpus, "fits.yaml", device_data="hybrid")
    with pytest.raises(SystemExit, match="use device_data: on"):
        train.main(["--cfg_file", fits, "--max_steps", "1", "--device", "cpu", "--output_dir",
                    str(tmp_path / "fits")])


def test_init_from_warm_starts_params_with_a_fresh_optimizer(corpus, tmp_path):
    """The donor trains without EMA, so its export is its params. The
    warm start's first step has lr 0 (warmup), so its params stay the
    donor's; its optimizer and step start afresh, and its EMA is seeded
    from the donor's params. Once the run has checkpoints, --resume wins."""
    donor = tmp_path / "donor"
    cfg = _cfg(tmp_path, corpus, learning_rate=1e-3, lr_warmup_steps=0)
    train.main(["--cfg_file", cfg, "--output_dir", str(donor), "--max_steps", "3", "--device",
                "cpu"])
    warm = tmp_path / "warm"
    cfg_warm = _cfg(tmp_path, corpus, "warm.yaml", ema_decay=0.99, lr_warmup_steps=2)
    args = ["--cfg_file", cfg_warm, "--output_dir", str(warm), "--device", "cpu", "--init_from",
            str(donor)]
    state = train.main(args + ["--max_steps", "1"])
    assert state.step == 1
    assert "warm-started params from" in _log(warm) and "donor step 3" in _log(warm)
    export = flax_to_torch(load_npz(str(donor / "params.npz")), load_config(cfg).model)
    ck = torch.load(warm / "checkpoints" / "step_00000001.pt")
    assert ck["step"] == 1
    assert all(torch.equal(ck["params"][k], v) for k, v in export.items())
    assert all(torch.equal(ck["ema_params"][k], v) for k, v in export.items())
    assert {int(s["step"]) for s in ck["opt_state"]["state"].values()} == {1}
    state = train.main(args + ["--max_steps", "2", "--resume"])
    assert state.step == 2 and "resumed from step 1" in _log(warm)


def test_profile_steps_writes_a_trace(corpus, tmp_path):
    out = tmp_path / "out"
    train.main(["--cfg_file", _cfg(tmp_path, corpus), "--max_steps", "4", "--device", "cpu",
                "--profile_steps", "2"])
    traces = glob.glob(str(out / "trace" / "*.json"))
    assert len(traces) == 1
    spans = [e["name"] for e in json.load(open(traces[0]))["traceEvents"]
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    # steps 2 and 3: the trainer's span once a step, under one fixed name
    assert spans.count("train.step") == 2 and spans.count("feed.next_batch") == 2
    assert not [n for n in spans if n.startswith("train_step")]
    assert "profiler trace of steps 2-3" in _log(out)


def test_a_supervised_run_trains_in_its_child(corpus, tmp_path):
    cfg = _cfg(tmp_path, corpus, device_data="on")
    env_cmd = ["--cfg_file", cfg, "--max_steps", "2", "--device", "cpu", "--supervise", "1"]
    with pytest.raises(SystemExit) as done:
        train.main(env_cmd)
    assert done.value.code == 0
    assert os.listdir(tmp_path / "out" / "checkpoints") == ["step_00000002.pt"]


def test_the_sidecar_prebuild_module(corpus, tmp_path):
    cfg = _cfg(tmp_path, corpus)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [ROOT,
                                                                    os.environ.get("PYTHONPATH")])))
    out = subprocess.run([sys.executable, "-m", "drivescenegen_torch.data.dataset", "--cfg_file",
                          cfg], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "sidecar ready: (16, 16, 16, 3) uint8" in out.stdout
    ds = dataset.RasterDataset(corpus, img_res=16, raw="auto")
    assert os.path.exists(dataset.sidecar_path(ds.files, 16, 3, np.uint8))
