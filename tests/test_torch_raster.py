"""The port's rasterizer (ops/raster.py, PyTorch) and rasterization CLI
against the JAX package's on the CPU.

Tolerances. The port runs the JAX rasterizer's operations one for one in
float32 (the splat adds each pixel's samples in the JAX scatter's order),
so against the JAX functions run op by op (jax.disable_jit) the float
rasters agree within 1e-5 (they are equal in practice). Under jit, XLA
contracts the lane interpolation into fused multiply-adds, which moves
sample positions by an ulp: the JAX package's own jitted and op-by-op
rasters differ by up to ~1e-5 in R/G and ten times that in occupancy mode
(which scales R/G by 10). Against the jitted functions, which the JAX CLI
runs, the uint8 rasters agree within 1 level.
"""

import glob
import os
import pickle
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from drivescenegen_torch.ops import raster as t_raster
from drivescenegen_torch.scripts import data_rasterization as t_cli
from drivescenegen_tpu.data import preprocess as j_pre
from drivescenegen_tpu.data import synthetic as j_syn
from drivescenegen_tpu.data import tfrecord as j_tfr
from drivescenegen_tpu.ops import raster as j_raster
from drivescenegen_tpu.scripts import data_rasterization as j_cli

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "womd_mini.tfrecord")
FLOAT_ATOL = 1e-5
UINT8_LEVELS = 1
MODES = {
    "agents_t1": {},
    "agents_t10": {"agent_time_index": 10},
    "no_agents": {"with_agent": False},
    "occupancy": {"mode": "occupancy"},
}


def scenes(source):
    if source == "fixture":
        return [j_pre.decode_scenario(d) for d in j_tfr.read_tfrecord_python(FIXTURE)]
    rich = source == "rich"
    return [j_pre.decode_scenario(j_syn.make_synthetic_scenario(s, rich=rich)) for s in (0, 5)]


def to_uint8(img):
    return np.clip(np.asarray(img) * 255.0, 0, 255).astype(np.uint8)


def assert_rasters(got, eager, jitted):
    assert got.dtype == np.float32 and got.shape == eager.shape == jitted.shape
    np.testing.assert_allclose(got, eager, rtol=0, atol=FLOAT_ATOL)
    levels = np.abs(to_uint8(got).astype(int) - to_uint8(jitted).astype(int))
    assert levels.max() <= UINT8_LEVELS


def random_lanes(seed, P=24, L=20, half=40.0):
    """Lane features as rasterize_scenario hands them over, plus points off
    the image, other polyline types and ragged masks."""
    rng = np.random.default_rng(seed)
    feats = np.zeros((P, L, 9), np.float32)
    start = rng.uniform(-1.3 * half, 1.3 * half, (P, 1, 2))
    step = rng.normal(0, 1.5, (P, L, 2)).cumsum(axis=1)
    feats[..., 0:2] = start + step
    feats[..., 3:5] = rng.uniform(0, 0.99, (P, L, 2))
    feats[..., 6] = rng.choice([1.0, 2.0, 2.0, 2.0, 7.0], size=(P, 1))
    lengths = rng.integers(0, L + 1, P)
    masks = np.arange(L)[None, :] < lengths[:, None]
    feats[..., 8] = masks
    return feats, masks


@pytest.mark.parametrize("seed", range(3))
def test_lane_channels(seed):
    feats, masks = random_lanes(seed)
    for res, k in ((64, 8), (48, 3)):
        got = t_raster.rasterize_lane_channels(torch.from_numpy(feats), torch.from_numpy(masks),
                                               40.0, H=res, W=res, interp_k=k).numpy()
        args = (jnp.asarray(feats), jnp.asarray(masks), 40.0)
        with jax.disable_jit():
            eager = np.asarray(j_raster.rasterize_lane_channels(*args, H=res, W=res, interp_k=k))
        jitted = np.asarray(j_raster.rasterize_lane_channels(*args, H=res, W=res, interp_k=k))
        assert_rasters(got, eager, jitted)


def test_segment_sum_adds_in_order():
    rng = np.random.default_rng(0)
    idx = torch.from_numpy(rng.integers(0, 50, 4000))
    vals = torch.from_numpy(rng.uniform(0, 1, (4000, 3)).astype(np.float32))
    vals[::7, -1] = 0.0  # weight-0 rows add nothing
    out = t_raster._segment_sum(idx, vals, 64).numpy()
    want = np.zeros((64, 3), np.float32)
    for i, row in zip(idx.numpy(), vals.numpy()):
        if row[-1] != 0:
            want[i] += row
    assert np.array_equal(out, want)


@pytest.mark.parametrize("seed", range(3))
def test_agent_channel(seed):
    rng = np.random.default_rng(seed)
    A, G, res = 12, 300, 64
    boxes = np.zeros((A, 7), np.float32)
    boxes[:, 0:2] = rng.uniform(-45, 45, (A, 2))
    boxes[:, 2] = rng.uniform(3, 9, A)
    boxes[:, 3] = rng.uniform(1.5, 3, A)
    boxes[:, 4] = rng.uniform(-np.pi, np.pi, A)
    boxes[:, 5] = rng.uniform(0.5, 0.7, A)
    boxes[:, 6] = rng.random(A) < 0.8
    gate = rng.uniform(-45, 45, (G, 2)).astype(np.float32)
    gate_valid = (rng.random(G) < 0.9).astype(np.float32)
    got = t_raster.rasterize_agent_channel(torch.from_numpy(boxes), torch.from_numpy(gate),
                                           torch.from_numpy(gate_valid), 40.0, H=res, W=res).numpy()
    args = (jnp.asarray(boxes), jnp.asarray(gate), jnp.asarray(gate_valid), 40.0)
    with jax.disable_jit():
        eager = np.asarray(j_raster.rasterize_agent_channel(*args, H=res, W=res))
    jitted = np.asarray(j_raster.rasterize_agent_channel(*args, H=res, W=res))
    assert got.any()
    assert_rasters(got, eager, jitted)


def test_agent_channel_full_budget_with_host_cos_sin():
    """All 128 agents at 256² in one broadcast; cos/sin handed in, as
    rasterize_scenario hands in the host's, give the raster that cos/sin
    taken on the boxes' device give (exactly, both on the CPU here), and
    both match JAX."""
    rng = np.random.default_rng(7)
    A, G, res = 128, 2000, 256
    boxes = np.zeros((A, 7), np.float32)
    boxes[:, 0:2] = rng.uniform(-42, 42, (A, 2))
    boxes[:, 2] = rng.uniform(3, 9, A)
    boxes[:, 3] = rng.uniform(1.5, 3, A)
    boxes[:, 4] = rng.uniform(-np.pi, np.pi, A)
    boxes[:, 5] = rng.uniform(0.5, 0.7, A)
    boxes[:, 6] = rng.random(A) < 0.9
    gate = rng.uniform(-42, 42, (G, 2)).astype(np.float32)
    gate_valid = np.ones(G, np.float32)
    tb, tg, tv = (torch.from_numpy(a) for a in (boxes, gate, gate_valid))
    heading = tb[:, 4]
    cos_sin = torch.stack([torch.cos(heading), torch.sin(heading)], dim=1)
    given = t_raster.rasterize_agent_channel(tb, tg, tv, 40.0, H=res, W=res, cos_sin=cos_sin)
    taken = t_raster.rasterize_agent_channel(tb, tg, tv, 40.0, H=res, W=res)
    assert np.array_equal(given.numpy(), taken.numpy())
    args = (jnp.asarray(boxes), jnp.asarray(gate), jnp.asarray(gate_valid), 40.0)
    with jax.disable_jit():
        eager = np.asarray(j_raster.rasterize_agent_channel(*args, H=res, W=res))
    jitted = np.asarray(j_raster.rasterize_agent_channel(*args, H=res, W=res))
    assert (given.numpy() > 0).sum() > 1000
    assert_rasters(given.numpy(), eager, jitted)


@pytest.mark.parametrize("source", ["plain", "rich", "fixture"])
def test_agent_boxes_from_tracks(source):
    for info in scenes(source):
        trajs = np.asarray(info["tracks_info"]["trajs"], np.float32)
        for t in (1, 10, 90):
            for cap in (2, 128):
                got = t_raster.agent_boxes_from_tracks(trajs, cap, t)
                assert np.array_equal(got, j_raster.agent_boxes_from_tracks(trajs, cap, t))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("source", ["plain", "rich", "fixture"])
def test_rasterize_scenario(source, mode):
    kw = MODES[mode]
    for info in scenes(source):
        got = t_raster.rasterize_scenario(info, img_res=64, device="cpu", **kw)
        with jax.disable_jit():
            eager = j_raster.rasterize_scenario(info, img_res=64, **kw)
        assert_rasters(got, eager, j_raster.rasterize_scenario(info, img_res=64, **kw))


def test_rasterize_scenario_full_size():
    info = scenes("rich")[1]
    got = t_raster.rasterize_scenario(info, device="cpu")
    with jax.disable_jit():
        eager = j_raster.rasterize_scenario(info)
    assert got.shape == (256, 256, 3)
    assert_rasters(got, eager, j_raster.rasterize_scenario(info))


def test_rasterize_scenario_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_raster.rasterize_scenario(scenes("plain")[0])


@pytest.fixture(scope="module")
def pickles(tmp_path_factory):
    d = tmp_path_factory.mktemp("pre")
    infos = [j_pre.decode_scenario(j_syn.make_synthetic_scenario(s, rich=True)) for s in range(3)]
    infos.append(scenes("fixture")[0])
    for i, info in enumerate(infos):
        with open(d / f"sample_{i}.pkl", "wb") as f:
            pickle.dump(info, f)
    cfg = d / "cfg.yaml"
    cfg.write_text("raster:\n  img_res: 64\n")
    return d, cfg


def _outputs(save_path):
    pngs = {os.path.basename(p): np.asarray(Image.open(p))
            for p in sorted(glob.glob(os.path.join(save_path, "GT_70k_s80_dxdy_agents_img", "*")))}
    vecs = {os.path.basename(p): np.load(p)
            for p in sorted(glob.glob(os.path.join(save_path, "vector_tensor", "*")))}
    return pngs, vecs


@pytest.fixture(scope="module")
def jax_cli_outputs(pickles, tmp_path_factory):
    d, cfg = pickles
    out = tmp_path_factory.mktemp("jax_cli")
    argv = sys.argv
    try:
        sys.argv = ["x", "--load_path", str(d), "--save_path", str(out), "--cfg_file", str(cfg),
                    "--n_workers", "1", "--augment", "rot180", "--save_vector_tensor"]
        j_cli.main()
    finally:
        sys.argv = argv
    return _outputs(out)


@pytest.mark.parametrize("n_workers", [1, 2])
def test_rasterization_cli_matches_the_jax_cli(pickles, jax_cli_outputs, tmp_path, n_workers):
    d, cfg = pickles
    res = t_cli.main(["--load_path", str(d), "--save_path", str(tmp_path), "--cfg_file", str(cfg),
                      "--n_workers", str(n_workers), "--augment", "rot180",
                      "--save_vector_tensor", "--device", "cpu"])
    pngs, vecs = _outputs(tmp_path)
    j_pngs, j_vecs = jax_cli_outputs
    assert res["n_png"] == len(pngs) == len(j_pngs) == 8 and len(vecs) == len(j_vecs) > 0
    # Scene k of the sorted pickles is file i of shard p: round robin over
    # the workers (the JAX CLI ran one worker).
    for k in range(4):
        p, i = k % n_workers, k // n_workers
        for sfx in ("", "_rot"):
            got, want = pngs[f"{p}_{i}{sfx}.png"], j_pngs[f"0_{k}{sfx}.png"]
            assert got.shape == want.shape == (64, 64, 3)
            assert np.abs(got.astype(int) - want.astype(int)).max() <= UINT8_LEVELS
        if f"0_{k}_vector.npy" in j_vecs:
            assert np.array_equal(vecs[f"{p}_{i}_vector.npy"], j_vecs[f"0_{k}_vector.npy"])


def test_rasterization_cli_refusals(pickles, tmp_path, monkeypatch):
    d, cfg = pickles
    occupancy = tmp_path / "occupancy.yaml"
    occupancy.write_text("raster:\n  img_res: 64\n  mode: occupancy\n")
    with pytest.raises(SystemExit, match="requires an RGB raster mode"):
        t_cli.main(["--load_path", str(d), "--save_path", str(tmp_path), "--save_sidecar",
                    "--cfg_file", str(occupancy), "--device", "cpu"])
    with pytest.raises(SystemExit, match="no scenario pickles"):
        t_cli.main(["--load_path", str(tmp_path / "none"), "--save_path", str(tmp_path),
                    "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_cli.main(["--load_path", str(d), "--save_path", str(tmp_path)])
