"""The port's GT graph export, map metrics and metrics CLI against the JAX
package's on the CPU, on a round trip: GT graphs exported from the
synthetic scenes behind tests/fixtures/torch_stage2/, and the graphs the
port's vectorization CLI makes of that fixture's rasters.

Both sides run the same numpy/scipy/networkx code on the same graphs:
exports compare exactly, statistics and the CLI's JSON within rtol 1e-12.
The JAX CLI never reaches random.sample (num_samples >= the graph count).
"""

import json
import os
import pickle
import shutil
import sys

import numpy as np
import pytest

from drivescenegen_torch.data import graph_export as t_export
from drivescenegen_torch.eval import map_metrics as t_mm
from drivescenegen_torch.scripts import compute_map_metrics as t_cli
from drivescenegen_torch.scripts import vectorization as t_vec
from drivescenegen_torch.utils import io as t_io
from drivescenegen_tpu.data import graph_export as j_export
from drivescenegen_tpu.data import preprocess as j_pre
from drivescenegen_tpu.data import synthetic as j_syn
from drivescenegen_tpu.data import tfrecord as j_tfr
from drivescenegen_tpu.eval import map_metrics as j_mm
from drivescenegen_tpu.scripts import compute_map_metrics as j_cli
from drivescenegen_tpu.utils import io as j_io

HERE = os.path.dirname(__file__)
STAGE2 = os.path.join(HERE, "fixtures", "torch_stage2")
WOMD = os.path.join(HERE, "fixtures", "womd_mini.tfrecord")
SEEDS = (0, 1, 2, 3)  # the synthetic scenes tests/fixtures/torch_stage2/ rasterizes
RTOL = 1e-12


def graph_items(g):
    return list(g.nodes(data=True)), list(g.edges(data=True))


def load(path):
    with open(path, "rb") as f:
        return pickle.load(f)


def assert_same_tree(a, b):
    """Two export directories: the same files, the same pickled content."""
    names = sorted(os.path.relpath(os.path.join(r, f), a) for r, _, fs in os.walk(a) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), b) for r, _, fs in os.walk(b)
                           for f in fs)
    for name in names:
        x, y = load(os.path.join(a, name)), load(os.path.join(b, name))
        if name.startswith("graph"):
            assert graph_items(x) == graph_items(y), name
        else:
            assert pickle.dumps(x) == pickle.dumps(y), name


@pytest.fixture(scope="module")
def round_trip(tmp_path_factory):
    """gt/ (export of the fixture's scenes) and gen/ (the port's
    vectorization CLI on the fixture's rasters)."""
    root = tmp_path_factory.mktemp("rt")
    for i, seed in enumerate(SEEDS):
        info = j_pre.decode_scenario(j_syn.make_synthetic_scenario(seed))
        t_export.export_scenario(info, str(root / "gt"), i)
    totals = t_vec.main(["--load_path", STAGE2, "--save_path", str(root / "gen"),
                         "--n_workers", "1", "--device", "cpu"])
    assert totals["n_ok"] == len(SEEDS)
    return root


def test_graph_export_matches(tmp_path):
    infos = [j_pre.decode_scenario(d) for d in j_tfr.read_tfrecord_python(WOMD)]
    infos += [j_pre.decode_scenario(j_syn.make_synthetic_scenario(s, rich=True)) for s in SEEDS]
    for i, info in enumerate(infos):
        t_export.export_scenario(info, str(tmp_path / "t"), i)
        j_export.export_scenario(info, str(tmp_path / "j"), i)
        assert graph_items(t_export.build_graph(info["lane"])) == \
            graph_items(j_export.build_graph(info["lane"]))
    assert_same_tree(tmp_path / "t", tmp_path / "j")

    n = t_export.process_tfrecords([WOMD], str(tmp_path / "tp"), max_scenarios=2)
    assert n == j_export.process_tfrecords([WOMD], str(tmp_path / "jp"), max_scenarios=2,
                                           backend="python") == 2
    assert_same_tree(tmp_path / "tp", tmp_path / "jp")


@pytest.mark.parametrize("side", ["gt", "gen"])
def test_compute_stats_matches(round_trip, side):
    frame = {} if side == "gt" else {"map_range": 80.0, "map_res": 256}
    files = sorted((round_trip / side / "graph").iterdir())
    assert len(files) == len(SEEDS)
    for f in files:
        g = load(f)
        kw = frame or {"map_range": None, "map_res": None}
        for got, want in zip(t_mm.compute_stats(g, **kw), j_mm.compute_stats(g, **kw)):
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_compute_map_stats_and_metrics_match(round_trip, tmp_path):
    sides = {}
    for side, frame in (("gt", (None, None)), ("gen", (80.0, 256))):
        files = sorted(str(p) for p in (round_trip / side / "graph").iterdir())
        got = t_mm.compute_map_stats(files, str(tmp_path / f"t_{side}"), *frame, verbose=False)
        want = j_mm.compute_map_stats(files, str(tmp_path / f"j_{side}"), *frame, verbose=False)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
        for name in ("stats", "degrees", "spectrum"):
            np.testing.assert_allclose(np.load(tmp_path / f"t_{side}" / f"{name}.npy"),
                                       np.load(tmp_path / f"j_{side}" / f"{name}.npy"),
                                       rtol=RTOL, atol=0)
        sides[side] = got
    got = t_mm.compute_map_metrics(*sides["gt"], *sides["gen"], verbose=False)
    want = j_mm.compute_map_metrics(*sides["gt"], *sides["gen"], verbose=False)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=0)
    assert np.all(np.isfinite(got[0]))


def _json_close(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _json_close(a[k], b[k])
        elif isinstance(a[k], float):
            np.testing.assert_allclose(a[k], b[k], rtol=RTOL, atol=0)
        else:
            assert a[k] == b[k], k


@pytest.mark.parametrize("world", [False, True], ids=["pixel", "world"])
def test_metrics_cli_json_matches(round_trip, tmp_path, monkeypatch, world):
    # Each CLI caches its stats beside the graphs: each gets its own copy.
    for side in ("t", "j"):
        for d in ("gt", "gen"):
            shutil.copytree(round_trip / d, tmp_path / side / d)
    args = ["--map_range", "80", "--map_res", "256", "--num_samples", "8"]
    if world:
        args.append("--gen_world_frame")
    got = t_cli.main(["--gt_dir", str(tmp_path / "t" / "gt"), "--gen_dir",
                      str(tmp_path / "t" / "gen"), "--json_out", str(tmp_path / "t.json"), *args])
    monkeypatch.setattr(sys, "argv", ["x", "--gt_dir", str(tmp_path / "j" / "gt"), "--gen_dir",
                                      str(tmp_path / "j" / "gen"), "--json_out",
                                      str(tmp_path / "j.json"), *args])
    j_cli.main()
    want = json.loads((tmp_path / "j.json").read_text())
    assert json.loads((tmp_path / "t.json").read_text()) == got
    _json_close(got, want)
    assert got["n_gen_images"] == got["n_gen_graphs"] == len(SEEDS)
    assert got["n_rejected"] == got["n_failed"] == 0
    assert all(np.isfinite(v) for v in got["frechet"].values())


def test_metrics_cli_recomputes_a_stale_cache(round_trip, tmp_path):
    for d in ("gt", "gen"):
        shutil.copytree(round_trip / d, tmp_path / d)
    # A cache written before OrientationR existed (6 rows), world mode.
    legacy = tmp_path / "gt" / "metrics_world"
    legacy.mkdir()
    np.save(legacy / "stats.npy", np.zeros((6, 2)))
    np.save(legacy / "degrees.npy", np.zeros(4))
    np.save(legacy / "spectrum.npy", np.zeros(4))
    args = ["--gt_dir", str(tmp_path / "gt"), "--gen_dir", str(tmp_path / "gt"),
            "--gen_world_frame", "--num_samples", "8"]
    res = t_cli.main(args)
    assert np.load(legacy / "stats.npy").shape[0] == len(t_mm.STATS_NAMES)
    assert all(v == 0.0 for v in res["frechet"].values())  # gt against itself, recomputed
    assert t_cli.main(args) == res  # read back from the fresh cache
    with pytest.raises(SystemExit, match="no graph pickles"):
        t_cli.main(["--gt_dir", str(tmp_path / "none"), "--gen_dir", str(tmp_path / "gt")])


def test_filename_cache_matches(round_trip, tmp_path):
    shutil.copytree(round_trip / "gt", tmp_path / "gt")
    got = t_io.get_all_filenames(str(tmp_path), "gt")
    assert t_io.get_cache_name(str(tmp_path), "gt") == j_io.get_cache_name(str(tmp_path), "gt")
    assert sorted(got) == sorted(j_io.get_all_filenames(str(tmp_path), "gt", refresh=True))
    (tmp_path / "gt" / "extra").mkdir()
    assert len(t_io.get_all_filenames(str(tmp_path), "gt")) == len(got)  # cached
    assert len(t_io.get_all_filenames(str(tmp_path), "gt", refresh=True)) == len(got) + 1
