"""The port's validate_waymo, visualization and visualize CLI against the
JAX package's: the validator's stdout and exit code on the real-schema
fixture shard (tests/test_womd_fixture.py), and the figures' Agg RGBA
arrays on decoded scenarios."""

import os
import pickle

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
from PIL import Image  # noqa: E402

from drivescenegen_tpu import visualization as jax_visualization  # noqa: E402
from drivescenegen_tpu.scripts import validate_waymo as jax_validate  # noqa: E402
from drivescenegen_tpu.scripts import visualize as jax_visualize  # noqa: E402
from drivescenegen_torch import visualization  # noqa: E402
from drivescenegen_torch.data import tfrecord  # noqa: E402
from drivescenegen_torch.data.preprocess import decode_scenario  # noqa: E402
from drivescenegen_torch.data.synthetic import (  # noqa: E402
    make_synthetic_scenario,
    make_synthetic_tfrecord,
)
from drivescenegen_torch.scripts import validate_waymo, visualize  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "womd_mini.tfrecord")


def _run(main, argv, capsys):
    with pytest.raises(SystemExit) as e:
        main(argv)
    return e.value.code, capsys.readouterr().out


@pytest.fixture(scope="module")
def synthetic_shard(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("shard") / "synthetic.tfrecord")
    make_synthetic_tfrecord(path, 4, seed=1)
    return path


@pytest.mark.parametrize("shard,extra,rc", [
    ("fixture", [], 0),
    # The fixture's one lane lies ~100 m from the ego at t = 10, outside the
    # 40 m half range: the raster holds no lane pixel, in both packages.
    ("fixture", ["--rasterize"], 1),
    ("fixture", ["--n", "1"], 0),
    ("fixture", ["--n", "0"], 1),
    ("synthetic", ["--rasterize"], 0),
])
def test_validate_waymo_equals_jax(capsys, synthetic_shard, shard, extra, rc):
    argv = ["--shard", FIXTURE if shard == "fixture" else synthetic_shard, "--n", "4", *extra]
    want = _run(jax_validate.main, argv, capsys)
    got = _run(validate_waymo.main, argv + ["--device", "cpu"], capsys)
    assert got == want and got[0] == rc
    if shard == "fixture" and not extra:
        assert "checked 3 scenarios, 0 with problems" in got[1]
    if shard == "fixture" and extra == ["--rasterize"]:
        assert got[1].count("BAD: rasterization produced only 0 lane px") == 3


def test_validate_scenario_flags_the_same_problems():
    info = decode_scenario(next(iter(tfrecord.read_tfrecord(FIXTURE))))
    info["scenario_id"] = ""
    info["sdc_track_index"] = 10_000
    info["tracks_info"]["trajs"] = info["tracks_info"]["trajs"][:, :50].copy()
    info["tracks_info"]["trajs"][..., 10] = 7
    got = validate_waymo.validate_scenario(info)
    assert got == jax_validate.validate_scenario(info) and len(got) == 4


@pytest.fixture(scope="module")
def scenarios():
    infos = [decode_scenario(r) for r in tfrecord.read_tfrecord(FIXTURE)]
    return infos[:2] + [decode_scenario(make_synthetic_scenario(3, rich=True))]


def _rgba(draw):
    fig = plt.figure(figsize=(4, 4), dpi=50)
    draw()
    fig.canvas.draw()
    arr = np.asarray(fig.canvas.buffer_rgba()).copy()
    plt.close(fig)
    return arr


@pytest.mark.parametrize("t_step", [10, 25])
def test_animation_frame_equals_jax(scenarios, t_step):
    for info in scenarios:
        want = _rgba(lambda: jax_visualization.animate_scenario(t_step, 0.1, 10, info))
        got = _rgba(lambda: visualization.animate_scenario(t_step, 0.1, 10, info))
        assert got.shape == want.shape and np.array_equal(got, want)
        assert len(np.unique(got.reshape(-1, 4), axis=0)) > 3  # something was drawn


def test_static_map_equals_jax(scenarios):
    for info in scenarios:
        want = _rgba(lambda: jax_visualization.plot_static_map(info))
        assert np.array_equal(_rgba(lambda: visualization.plot_static_map(info)), want)


def test_polygon_completion_equals_jax(rng):
    poly = rng.uniform(-10, 10, size=(5, 3))
    np.testing.assert_array_equal(visualization.polygon_completion(poly),
                                  jax_visualization.polygon_completion(poly))


def test_visualize_cli_stills_equal_jax(scenarios, tmp_path):
    src = tmp_path / "pre"
    src.mkdir()
    for i, info in enumerate(scenarios):
        with open(src / f"sample_{i:03d}.pkl", "wb") as f:
            pickle.dump(info, f)
    for name, main in (("jax", jax_visualize.main), ("port", visualize.main)):
        main(["--load_path", str(src), "--save_dir", str(tmp_path / name), "--limit", "3",
              "--still"])
    names = sorted(os.listdir(tmp_path / "port"))
    assert names == [f"sample_{i:03d}.png" for i in range(3)]
    assert sorted(os.listdir(tmp_path / "jax")) == names
    for n in names:
        got = np.asarray(Image.open(tmp_path / "port" / n))
        assert np.array_equal(got, np.asarray(Image.open(tmp_path / "jax" / n)))


def test_visualize_cli_without_pickles_exits(tmp_path):
    with pytest.raises(SystemExit, match="no scenario pickles"):
        visualize.main(["--load_path", str(tmp_path)])


def test_visualize_scenario_gif_equals_jax(scenarios, tmp_path):
    frames = {}
    for name, mod in (("jax", jax_visualization), ("port", visualization)):
        path = str(tmp_path / f"{name}.gif")
        mod.visualize_scenario(scenarios[2], t_steps=3, save_path=path)
        frames[name] = []
        with Image.open(path) as gif:
            for i in range(gif.n_frames):
                gif.seek(i)
                frames[name].append(np.asarray(gif.convert("RGBA")))
    assert len(frames["port"]) == 3
    assert all(np.array_equal(a, b) for a, b in zip(frames["port"], frames["jax"]))

