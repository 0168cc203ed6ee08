"""The port's pipeline demo (scripts/run_demo.py) on the CPU at a tiny size:
the six CLIs chained, every stage's artifacts on disk, the stage times
returned, and the refusal to run without a card unless --device cpu."""

import glob
import json
import os

import pytest
import torch

from drivescenegen_torch.scripts import run_demo

SCENES, RES = 8, 32


def test_demo_runs_every_stage(tmp_path):
    wd = tmp_path / "demo"
    times = run_demo.main(["--work_dir", str(wd), "--device", "cpu", "--n_scenarios", str(SCENES),
                           "--train_steps", "2", "--steps", "2", "--gen_batches", "1",
                           "--img_res", str(RES)])
    stages = ["preprocess", "rasterize", "train", "generate", "vectorize_generated", "vectorize",
              "gt_export", "metrics_roundtrip"]
    assert set(stages) <= set(times) <= set(stages) | {"metrics_generated"}
    assert all(t >= 0 for t in times.values())

    def n(pattern):
        return len(glob.glob(os.path.join(wd, pattern)))

    assert n("preprocessed/sample_*.pkl") == SCENES
    assert n("preprocessed/processed_scenarios_20s.pkl") == 1
    assert n("rasterized/GT_70k_s80_dxdy_agents_img/*.png") == SCENES
    assert n("model/params.npz") == n("model/config.yaml") == 1
    assert n("generated/*.png") == 8
    for d in ("vec_gen", "vec"):
        stats = json.loads((wd / d / "vectorization_stats.json").read_text())
        assert stats["n_images"] == 8 and stats["n_ok"] + stats["n_rejected"] + stats["n_failed"] == 8
    assert n("vec/graph/*_graph.pickle") > 0
    for sub in ("graph", "track", "scenario"):
        assert n(f"gt/{sub}/*") == SCENES
    assert n("gt/metrics_world/stats.npy") == 1
    assert n(f"vec/metrics_px{RES}_r80/stats.npy") == 1


def test_demo_needs_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_demo.main(["--work_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
