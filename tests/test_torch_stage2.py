"""Stage 2 of the port against the JAX package on the CPU: the lane mask,
the morphology, the packed skeletons, vectorize(), the native graph
library's build, the vectorization CLI and the committed fixture
(tests/torch_stage2_fixture.py).

Every comparison is exact: the mask and the morphology are integer
functions, and the host graph passes are the same numpy/scipy code on the
same bytes. The JAX package's side runs with its native_graph.available
patched to False, so these tests never build the JAX package's library
(its Python path is tied to the native one by tests/test_native_graph.py);
the port's side runs its own native library.
"""

import glob
import json
import os
import pickle
import shutil
import sys
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch
from PIL import Image

from drivescenegen_torch.config import VectorizeConfig
from drivescenegen_torch.ops import lane_mask as t_lane_mask
from drivescenegen_torch.ops import morphology as t_morph
from drivescenegen_torch.ops import stage2 as t_stage2
from drivescenegen_torch.scripts import vectorization as t_vec
from drivescenegen_torch.vectorize import native_graph as t_native
from drivescenegen_tpu.config import VectorizeConfig as JaxVectorizeConfig
from drivescenegen_tpu.ops import lane_mask as j_lane_mask
from drivescenegen_tpu.ops import morphology as j_morph
from drivescenegen_tpu.scripts import vectorization as j_vec
from drivescenegen_tpu.vectorize import native_graph as j_native
from drivescenegen_tpu.vectorize.image_utils import get_lane_mask

sys.path.insert(0, str(Path(__file__).resolve().parent))
from torch_stage2_fixture import (  # noqa: E402
    FIXTURE,
    SEEDS,
    jax_rasters,
    png_name,
    vectorize_record,
)

FIXTURE_PNGS = [FIXTURE / png_name(s) for s in SEEDS]


@pytest.fixture(autouse=True)
def jax_python_graph_path(monkeypatch):
    monkeypatch.setattr(j_native, "available", lambda: False)


def _port_mask(q):
    return t_lane_mask.lane_mask_batch(torch.from_numpy(q)).numpy()


def _jax_mask(q):
    return np.asarray(j_lane_mask.lane_mask_batch(jnp.asarray(q)))


def _host_masks(q):
    return np.stack([get_lane_mask(im.astype(np.float32) / 255.0) for im in q])


def _assert_masks_agree(q):
    port = _port_mask(q)
    assert port.dtype == np.bool_ and port.shape == q.shape[:3]
    np.testing.assert_array_equal(port, _jax_mask(q))
    np.testing.assert_array_equal(port, _host_masks(q))


# ------------------------------------------------------------ lane mask


@pytest.mark.parametrize("threshold", [0.1, 0.05, 0.2])
def test_lane_mask_tables_equal_jax(threshold):
    for port, ref in zip(t_lane_mask._tables(threshold), j_lane_mask._tables(threshold)):
        np.testing.assert_array_equal(port, ref)


@pytest.mark.parametrize("seed", [0, 1])
def test_lane_mask_random_images(seed):
    rng = np.random.default_rng(seed)
    imgs = []
    for _ in range(6):  # a background with sparse lanes, as rasters look
        img = np.full((64, 64, 3), 128, np.uint8)
        n = rng.integers(50, 500)
        ys, xs = rng.integers(0, 64, n), rng.integers(0, 64, n)
        img[ys, xs, 0] = rng.integers(0, 256, n)
        img[ys, xs, 1] = rng.integers(0, 256, n)
        imgs.append(img)
    imgs.append(rng.integers(0, 256, (64, 64, 3)).astype(np.uint8))  # pure noise
    _assert_masks_agree(np.stack(imgs))


def test_lane_mask_float64_boundary():
    """|153/255 - 128/256| == 0.1 in real arithmetic; the host's float64
    comparison calls the pixel lane."""
    img = np.full((32, 32, 3), 128, np.uint8)
    img[3, 4, 0] = 153
    assert _host_masks(img[None])[0, 3, 4]
    _assert_masks_agree(img[None])


@pytest.mark.parametrize("mode", [0, 77, 128, 153, 204, 255])
def test_lane_mask_every_value_against_mode(mode):
    vals = np.arange(256, dtype=np.uint8).reshape(16, 16)
    img = np.full((48, 48, 3), mode, np.uint8)
    img[:16, :16, 0] = vals
    img[16:32, 16:32, 1] = vals
    _assert_masks_agree(img[None])


@pytest.mark.parametrize("low,high", [(60, 200), (0, 255), (127, 128)])
def test_lane_mask_first_max_ties(low, high):
    """np.argmax takes the first maximum: an exact tie resolves to the
    smaller value on every path."""
    img = np.zeros((4, 8, 3), np.uint8)
    img[:2, :, 0] = low
    img[2:, :, 0] = high
    img[:2, :, 1] = high
    img[2:, :, 1] = low
    _assert_masks_agree(img[None])


@pytest.mark.parametrize("shape", [(1, 16, 16, 3), (3, 33, 17, 3), (2, 7, 40, 4)])
def test_lane_mask_odd_shapes(shape):
    rng = np.random.default_rng(7)
    _assert_masks_agree(rng.integers(0, 256, shape).astype(np.uint8))


# ------------------------------------------------------------ morphology


def _random_masks(seed, n=4, size=64, p=0.5):
    rng = np.random.default_rng(seed)
    m = rng.random((n, size, size)) < p
    return np.stack([ndi.binary_closing(ndi.binary_opening(x)) for x in m])


def _jax_skeletons(masks, max_iters=64):
    return np.asarray(jax.vmap(lambda x: j_morph.skeletonize(x, max_iters))(jnp.asarray(masks)))


def test_thinning_tables_equal_jax_subiterations():
    """Every 3x3 neighbourhood of a foreground pixel, both sub-iterations:
    the port's keep tables against JAX's _thin_subiter at the centre."""
    codes = np.arange(256)
    patches = np.zeros((256, 3, 3), np.uint8)
    patches[:, 1, 1] = 1
    for k, (di, dj) in enumerate(t_morph._RING):
        patches[:, 1 + di, 1 + dj] = (codes >> k) & 1
    keep = t_morph._thin_tables().numpy()
    for s, first in enumerate((True, False)):
        out = jax.vmap(lambda x: j_morph._thin_subiter(x, first))(jnp.asarray(patches))
        np.testing.assert_array_equal(keep[s], np.asarray(out)[:, 1, 1])


@pytest.mark.parametrize("seed,p", [(0, 0.5), (1, 0.6), (2, 0.4)])
def test_skeletonize_batch_random_masks(seed, p):
    masks = _random_masks(seed, p=p)
    port = t_morph.skeletonize_batch(torch.from_numpy(masks)).numpy()
    assert port.dtype == np.bool_
    np.testing.assert_array_equal(port, np.asarray(j_morph.skeletonize_batch(jnp.asarray(masks))))


def test_skeletonize_batch_lane_masks_of_rasters():
    """Lane masks of the JAX rasterizer's synthetic scenes, transposed to
    [x][y] as the pipelines do."""
    masks = np.ascontiguousarray(_jax_mask(jax_rasters()).transpose(0, 2, 1))
    port = t_morph.skeletonize_batch(torch.from_numpy(masks)).numpy()
    np.testing.assert_array_equal(port, np.asarray(j_morph.skeletonize_batch(jnp.asarray(masks))))
    assert port.sum() > 1000


@pytest.mark.parametrize("max_iters", [1, 3])
@pytest.mark.parametrize("check_every", [0, 2])
def test_skeletonize_stops_at_max_iters(max_iters, check_every):
    masks = _random_masks(3, size=48, p=0.7)
    ref = _jax_skeletons(masks, max_iters)
    assert not np.array_equal(ref, _jax_skeletons(masks)), "the cap must bite"
    port = t_morph.skeletonize_batch(torch.from_numpy(masks), max_iters, check_every)
    np.testing.assert_array_equal(port.numpy(), ref)


@pytest.mark.parametrize("check_every", [1, 8, 100])
def test_skeletonize_convergence_checks_change_nothing(check_every):
    masks = _random_masks(4)
    port = t_morph.skeletonize_batch(torch.from_numpy(masks), check_every=check_every)
    np.testing.assert_array_equal(port.numpy(), _jax_skeletons(masks))


def test_skeletonize_single_image():
    m = _random_masks(5, n=1)[0]
    np.testing.assert_array_equal(t_morph.skeletonize(torch.from_numpy(m)).numpy(),
                                  np.asarray(j_morph.skeletonize(jnp.asarray(m))))


def test_neighbor_ring_and_transitions():
    m = _random_masks(6, n=1)[0].astype(np.uint8)
    ring = t_morph.neighbor_ring(torch.from_numpy(m))
    j_ring = j_morph.neighbor_ring(jnp.asarray(m))
    np.testing.assert_array_equal(ring.numpy(), np.asarray(j_ring))
    for port, ref in zip(t_morph.transitions_and_sum(ring), j_morph.transitions_and_sum(j_ring)):
        np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


def test_node_response_and_erosion():
    m = _random_masks(7, n=1)[0]
    skel = np.array(j_morph.skeletonize(jnp.asarray(m)))
    np.testing.assert_array_equal(t_morph.node_response(torch.from_numpy(skel)).numpy(),
                                  np.asarray(j_morph.node_response(jnp.asarray(skel))))
    np.testing.assert_array_equal(t_morph.erosion_2x2(torch.from_numpy(m)).numpy(),
                                  np.asarray(j_morph.erosion_2x2(jnp.asarray(m))))


def test_binarize_lane_mask():
    img = np.random.default_rng(8).random((32, 32, 3)).astype(np.float32)
    port = t_morph.binarize_lane_mask(torch.from_numpy(img), 0.5, 0.25)
    ref = j_morph.binarize_lane_mask(jnp.asarray(img), jnp.float32(0.5), jnp.float32(0.25))
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))


# ------------------------------------------------------------ packed skeletons


def _jax_skeleton_pack(q):
    """JAX's fused per-batch pass after quantization (its end_to_end
    _skel_pack): mask, (0, 2, 1) transpose, skeletonize, pack."""
    skel = j_morph.skeletonize_batch(j_lane_mask.lane_mask_batch(jnp.asarray(q)).transpose(0, 2, 1))
    b, sh, sw = skel.shape
    w = jnp.array([128, 64, 32, 16, 8, 4, 2, 1], jnp.uint8)
    return np.asarray(jnp.sum(skel.reshape(b, sh, sw // 8, 8).astype(jnp.uint8) * w, axis=-1,
                              dtype=jnp.uint8))


@pytest.mark.parametrize("source", ["rasters", "noise"])
def test_skeleton_pass_bytes_equal_jax(source):
    if source == "rasters":
        q = jax_rasters()
    else:
        rng = np.random.default_rng(9)
        q = np.full((3, 64, 48, 3), 128, np.uint8)
        q[rng.random(q.shape[:3]) < 0.3] = rng.integers(0, 256, 3, dtype=np.uint8)
    packed = t_stage2.skeleton_pass(torch.from_numpy(q)).numpy()
    assert packed.dtype == np.uint8 and packed.shape == (q.shape[0], q.shape[2], q.shape[1] // 8)
    np.testing.assert_array_equal(packed, _jax_skeleton_pack(q))


def test_fused_skeletons_equal_the_two_stage_pass():
    """The packed skeletons the fused CLI hands its workers equal those the
    vectorization CLI takes from the same PNGs."""
    q = np.stack([np.asarray(Image.open(p).convert("RGB")) for p in FIXTURE_PNGS])
    fused = np.unpackbits(t_stage2.skeleton_pass(torch.from_numpy(q)).numpy(), axis=-1).astype(bool)
    two_stage = t_vec._batch_skeletonize([str(p) for p in FIXTURE_PNGS], torch.device("cpu"), 8)
    for i, p in enumerate(FIXTURE_PNGS):
        np.testing.assert_array_equal(fused[i], two_stage[str(p)])


def test_quantize_equals_the_generation_cli():
    from drivescenegen_torch.scripts.generation import quantize

    rng = np.random.default_rng(10)
    k = np.arange(256, dtype=np.float32)
    # Values at every rounding midpoint, the clip edges, and random draws.
    x = np.concatenate([((k + 0.5) / 255.0 - 0.5) * 2, [-1.5, -1.0, 1.0, 1.5],
                        rng.standard_normal(4000)]).astype(np.float32)
    x = torch.from_numpy(x)
    np.testing.assert_array_equal(t_stage2.quantize(x).numpy(), quantize(x))


# ------------------------------------------------------------ vectorize


def _assert_records_equal(port, ref):
    assert sorted(port) == sorted(ref)
    for key in ref:
        assert port[key].dtype == ref[key].dtype and port[key].shape == ref[key].shape, key
        np.testing.assert_array_equal(port[key], ref[key], err_msg=key)


@pytest.mark.parametrize("index", range(len(SEEDS)))
def test_vectorize_equals_jax(index):
    paths = FIXTURE_PNGS[index:index + 1]
    _assert_records_equal(vectorize_record(t_vec.vectorize, paths, VectorizeConfig()),
                          vectorize_record(j_vec.vectorize, paths, JaxVectorizeConfig()))


def test_vectorize_equals_the_fixture_record():
    expected = dict(np.load(FIXTURE / "expected.npz"))
    assert expected["n_lanes"].tolist() == [8, 4, 2, 4]
    _assert_records_equal(vectorize_record(t_vec.vectorize, FIXTURE_PNGS, VectorizeConfig()),
                          expected)


def test_the_fixture_is_what_jax_makes_now():
    """The committed PNGs and expected.npz, rebuilt with the JAX package."""
    for img, path in zip(jax_rasters(), FIXTURE_PNGS):
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img, err_msg=path.name)
    _assert_records_equal(vectorize_record(j_vec.vectorize, FIXTURE_PNGS, JaxVectorizeConfig()),
                          dict(np.load(FIXTURE / "expected.npz")))


@pytest.mark.parametrize("index", [0, 3])
def test_vectorize_graph_method_equals_jax(index):
    """The legacy GRAPH vectorizer (vectorize.method: GRAPH)."""
    img = Image.open(FIXTURE_PNGS[index]).convert("RGB")
    port = t_vec.vectorize(img, method="GRAPH")
    ref = j_vec.vectorize(img, method="GRAPH")
    assert (port[0] is None) == (ref[0] is None)
    _assert_graphs_equal(port[1], ref[1])
    if ref[0] is not None:
        assert len(port[0]) == len(ref[0])
        for a, b in zip(port[0], ref[0]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.asarray(port[2]), np.asarray(ref[2]))


def test_vectorize_skeleton_given_or_taken_agree():
    """A skeleton from the batched pass gives the same record as none."""
    path = FIXTURE_PNGS[1]
    skel = t_vec._batch_skeletonize([str(path)], torch.device("cpu"))[str(path)]
    img = Image.open(path).convert("RGB")
    given = t_vec.vectorize(img, skel=skel, vcfg=VectorizeConfig())
    taken = t_vec.vectorize(img, vcfg=VectorizeConfig())
    _assert_graphs_equal(given[1], taken[1])
    for a, b in zip(given[0], taken[0]):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ native graph library


def test_native_library_builds_once_under_concurrency(tmp_path, monkeypatch):
    """Four threads building into one empty directory: each gets the same
    library, which loads, and no temporary file is left behind."""
    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    out, errors = [], []

    def build():
        try:
            out.append(t_native.build())
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors and len(set(out)) == 1
    import ctypes

    assert hasattr(ctypes.CDLL(str(out[0])), "dsg_connect_paths")
    assert sorted(p.name for p in tmp_path.iterdir()) == ["dsg_graph.lock", out[0].name]


def test_native_library_missing_compiler_warns(tmp_path, monkeypatch):
    from drivescenegen_torch.vectorize import network

    monkeypatch.setattr(t_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_lib_load_failed", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    warnings = []
    monkeypatch.setattr(t_native.logger, "warning", warnings.append)
    assert not t_native.available()
    assert len(warnings) == 1 and "unavailable" in warnings[0]
    # network's Python path then gives the native path's graph.
    skel = t_vec._batch_skeletonize([str(FIXTURE_PNGS[2])], torch.device("cpu"))[str(FIXTURE_PNGS[2])]
    python_graph = network.connect_graph(skel, 4)
    monkeypatch.setattr(t_native, "_lib_load_failed", False)
    monkeypatch.setattr(t_native, "BUILD_DIR", t_native.native.BUILD_DIR)
    monkeypatch.delenv("CXX")
    assert t_native.available()
    _assert_graphs_equal(network.connect_graph(skel, 4), python_graph)


# ------------------------------------------------------------ vectorization CLI


def _assert_graphs_equal(port, ref):
    if ref is None:
        assert port is None
        return
    assert type(port) is type(ref)
    assert list(port.nodes) == list(ref.nodes)
    port_edges, ref_edges = list(port.edges(data=True)), list(ref.edges(data=True))
    assert [e[:2] for e in port_edges] == [e[:2] for e in ref_edges]
    for (_, _, a), (_, _, b) in zip(port_edges, ref_edges):
        assert sorted(a) == sorted(b)
        for key in b:
            np.testing.assert_array_equal(np.asarray(a[key]), np.asarray(b[key]))


class _InlineProcess:
    """A stand-in for a spawned process that runs its target on start(),
    so the JAX CLI's workers run here, under the patched native_graph."""

    exitcode = 0

    def __init__(self, target, args):
        self.target, self.args = target, args

    def start(self):
        self.target(*self.args)

    def join(self):
        pass


class _InlineContext:
    Process = _InlineProcess


def _run_cli(module, src, out, n_workers, monkeypatch, extra=()):
    argv = ["--load_path", str(src), "--save_path", str(out), "--n_workers", str(n_workers),
            *extra]
    if module is t_vec:
        t_vec.main([*argv, "--device", "cpu"])
        return
    with monkeypatch.context() as m:
        m.setattr(j_vec.multiprocessing, "get_context", lambda _: _InlineContext)
        j_vec.main(argv)


def _artifacts(out):
    """Every artifact of a vectorization run, loaded."""
    names = {sub: sorted(os.listdir(out / sub)) for sub in ("vectorized", "graph", "agent")}
    names["stats"] = sorted(os.listdir(out / "stats"))
    stats = json.loads((out / "vectorization_stats.json").read_text())
    stats.pop("wall_time_s")
    return names, stats


@pytest.fixture(scope="module")
def fixture_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("pngs")
    for p in FIXTURE_PNGS:
        shutil.copy(p, d / p.name)
    # An all-background raster: its mask is empty, so it is rejected.
    Image.fromarray(np.full((256, 256, 3), 128, np.uint8)).save(d / "scene_99.png")
    return d


@pytest.mark.parametrize("n_workers", [1, 2])
def test_vectorization_cli_equals_jax(fixture_dir, tmp_path, monkeypatch, n_workers):
    port_out, jax_out = tmp_path / "port", tmp_path / "jax"
    _run_cli(t_vec, fixture_dir, port_out, n_workers, monkeypatch)
    _run_cli(j_vec, fixture_dir, jax_out, n_workers, monkeypatch)
    port_names, port_stats = _artifacts(port_out)
    jax_names, jax_stats = _artifacts(jax_out)
    assert port_names == jax_names and port_stats == jax_stats
    assert port_stats["n_images"] == 5 and port_stats["n_ok"] == 4 and port_stats["n_rejected"] == 1
    assert port_names["stats"] == [f"worker_{i}.json" for i in range(n_workers)]
    for name in port_names["stats"]:
        assert (json.loads((port_out / "stats" / name).read_text())
                == json.loads((jax_out / "stats" / name).read_text()))
    for name in port_names["graph"]:
        with open(port_out / "graph" / name, "rb") as f, open(jax_out / "graph" / name, "rb") as g:
            _assert_graphs_equal(pickle.load(f), pickle.load(g))
    for name in port_names["agent"]:
        np.testing.assert_array_equal(np.load(port_out / "agent" / name),
                                      np.load(jax_out / "agent" / name))
    for name in port_names["vectorized"]:
        port = torch.load(port_out / "vectorized" / name, weights_only=False)
        ref = torch.load(jax_out / "vectorized" / name, weights_only=False)
        assert sorted(port) == sorted(ref) and port["scenario_id"] == ref["scenario_id"]
        for key in ("object_type", "all_agent"):
            np.testing.assert_array_equal(np.asarray(port[key]), np.asarray(ref[key]))
        assert len(port["lane"]) == len(ref["lane"])
        for a, b in zip(port["lane"], ref["lane"]):
            np.testing.assert_array_equal(a, b)


def test_vectorization_cli_host_skeleton_and_limit(fixture_dir, tmp_path, monkeypatch):
    """--no_device_skeleton (each worker skeletonizes) and --limit give the
    JAX CLI's artifacts."""
    extra = ("--no_device_skeleton", "--limit", "2")
    _run_cli(t_vec, fixture_dir, tmp_path / "port", 1, monkeypatch, extra)
    _run_cli(j_vec, fixture_dir, tmp_path / "jax", 1, monkeypatch, extra)
    port, ref = _artifacts(tmp_path / "port"), _artifacts(tmp_path / "jax")
    assert port == ref and port[1]["n_images"] == 2


def test_vectorization_cli_needs_a_card_unless_told(fixture_dir, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_vec.main(["--load_path", str(fixture_dir), "--save_path", str(tmp_path)])


def test_vectorization_cli_without_pngs_exits(tmp_path):
    with pytest.raises(SystemExit, match="no PNGs"):
        t_vec.main(["--load_path", str(tmp_path), "--save_path", str(tmp_path),
                    "--device", "cpu"])


def test_plot_writes_the_figure(tmp_path):
    pytest.importorskip("matplotlib")
    cfg = VectorizeConfig(plot=True)
    dirs = tuple(tmp_path / d for d in ("vectorized", "vectorized_pics", "graph", "agent"))
    for d in dirs:
        d.mkdir()
    assert t_vec.process_one(0, str(FIXTURE_PNGS[0]), None, cfg, tuple(map(str, dirs))) == "ok"
    assert sorted(glob.glob(str(tmp_path / "vectorized_pics" / "*"))) == [
        str(tmp_path / "vectorized_pics" / "0.png")]
