"""The port's decoded-corpus sidecar and hybrid device data against the JAX
package (drivescenegen_tpu/data/dataset.py:158-430): the sidecar key, each
package reading the other's sidecar, the adoption of an old-key sidecar,
the decode's progress log, the hybrid split and its index batches, the
prefetch order, the chunked upload, and the rasterization CLI's
--save_sidecar (tests/test_cli.py:306-357 mirrored). Sidecars are written
and read only under tmp_path: adoption renames files."""

import glob
import logging
import os
import pickle

import numpy as np
import pytest
import torch
from PIL import Image

from drivescenegen_tpu.config import MeshConfig as JaxMeshConfig
from drivescenegen_tpu.data import dataset as jax_dataset
from drivescenegen_tpu.data.preprocess import decode_scenario
from drivescenegen_tpu.data.synthetic import make_synthetic_scenario
from drivescenegen_tpu.parallel import make_mesh as jax_make_mesh
from drivescenegen_torch.data import dataset
from drivescenegen_torch.scripts import data_rasterization


@pytest.fixture()
def png_dir(tmp_path):
    d = tmp_path / "imgs"
    d.mkdir()
    rng = np.random.default_rng(0)
    for i in range(10):
        Image.fromarray(rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)).save(d / f"{i}.png")
    return d


@pytest.mark.parametrize("files,res,ch,dtype", [
    (["a/b.png", "a/c.png"], 64, 3, np.uint8),
    (["./a/b.png", "./a//c.png"], 256, 3, "uint8"),
    (["/x/y/0_1.png"], 128, 1, np.float32),
    (["z.npy", "w.npy"], 16, 3, np.dtype("float16")),
])
def test_sidecar_path_is_the_jax_packages(files, res, ch, dtype):
    assert dataset.sidecar_path(files, res, ch, dtype) == \
        jax_dataset.sidecar_path(files, res, ch, dtype)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_sidecar(png_dir, writer, capsys):
    pattern = str(png_dir / "*.png")
    ours, theirs = dataset.RasterDataset(pattern, 16, raw="auto"), \
        jax_dataset.RasterDataset(pattern, 16, raw="auto")
    write, read = (jax_dataset.decoded_corpus, dataset.decoded_corpus) if writer == "jax" \
        else (dataset.decoded_corpus, jax_dataset.decoded_corpus)
    built = write(theirs if writer == "jax" else ours)
    sidecars = glob.glob(str(png_dir / ".devcache_*.npy"))
    assert sidecars == [dataset.sidecar_path(ours.files, 16, 3, np.uint8)]
    capsys.readouterr()
    got = read(ours if writer == "jax" else theirs)
    assert "using sidecar" in capsys.readouterr().out
    assert isinstance(got, np.memmap) and np.array_equal(got, built)
    assert np.array_equal(got, np.stack([ours[i] for i in range(len(ours))]))


def test_old_key_sidecar_is_adopted(png_dir, capsys):
    ds = dataset.RasterDataset(str(png_dir / "*.png"), 16, raw="auto")
    full = np.stack([ds[i] for i in range(len(ds))])
    np.save(png_dir / ".devcache_00000000000oldkey.npy", full)
    np.save(png_dir / ".devcache_0000000000wrongsz.npy", full[:3])  # other shape: left alone
    got = dataset.decoded_corpus(ds)
    assert "adopted old-key sidecar" in capsys.readouterr().out
    assert np.array_equal(got, full)
    assert sorted(os.listdir(png_dir))[:2] == [".devcache_0000000000wrongsz.npy",
                                               os.path.basename(dataset.sidecar_path(
                                                   ds.files, 16, 3, np.uint8))]
    assert not (png_dir / ".devcache_00000000000oldkey.npy").exists()


def test_decode_logs_progress_for_the_stall_watchdog(png_dir, caplog):
    ds = dataset.RasterDataset(str(png_dir / "*.png"), 16, raw="auto")
    with caplog.at_level(logging.INFO, logger="data"):
        dataset.decoded_corpus(ds, chunk=4)
    msgs = [r.message for r in caplog.records if r.name == "data"]
    assert msgs == ["decoded_corpus: decoded 4/10", "decoded_corpus: decoded 8/10",
                    "decoded_corpus: decoded 10/10"]


@pytest.mark.parametrize("n_pool,n_tail,batch,seed,align", [
    (60, 10, 16, 0, 4), (50, 20, 14, 14555, 1), (5, 95, 8, 3, 2), (40, 0, 8, 1, 1),
    (33, 17, 12, 7, 3)])
def test_hybrid_index_batches_are_the_jax_packages(n_pool, n_tail, batch, seed, align):
    ours = dataset.hybrid_index_batches(n_pool, n_tail, batch, seed=seed, align=align)
    theirs = jax_dataset.hybrid_index_batches(n_pool, n_tail, batch, seed=seed, align=align)
    for _ in range(40):  # several epochs
        (a_res, a_tail), (b_res, b_tail) = next(ours), next(theirs)
        assert a_res.dtype == b_res.dtype == np.int32
        assert np.array_equal(a_res, b_res) and np.array_equal(a_tail, b_tail)
        assert a_tail.size % align == 0 or n_tail == 0


def test_hybrid_device_data_is_the_jax_split(png_dir):
    pattern = str(png_dir / "*.png")
    ours, theirs = dataset.RasterDataset(pattern, 16, raw=True), \
        jax_dataset.RasterDataset(pattern, 16, raw=True)
    budget = 4 * 16 * 16 * 3
    data, pool, tail, full = dataset.hybrid_device_data(ours, "cpu", budget, seed=1)
    j_data, j_pool, j_tail, _ = jax_dataset.hybrid_device_data(
        theirs, jax_make_mesh(JaxMeshConfig()), budget, seed=1)
    assert np.array_equal(pool, j_pool) and np.array_equal(tail, j_tail)
    assert sorted(np.concatenate([pool, tail]).tolist()) == list(range(10))
    assert data.dtype == torch.uint8 and np.array_equal(data.numpy(), np.asarray(j_data))
    assert np.array_equal(data.numpy(), full[pool])


def test_prefetch_to_device_keeps_the_order():
    batches = [np.full((4, 2), i, np.uint8) + np.arange(4, dtype=np.uint8)[:, None]
               for i in range(5)]
    for depth in (1, 2, 3):
        got = list(dataset.prefetch_to_device(iter(batches), "cpu", depth=depth, rows=slice(2, 4)))
        assert len(got) == 5
        assert all(torch.equal(g, torch.from_numpy(b[2:4])) for g, b in zip(got, batches))


def test_chunked_array_to_device_equals_one_copy(caplog):
    full = np.random.default_rng(2).integers(0, 256, (10, 4, 4, 3), dtype=np.uint8)
    with caplog.at_level(logging.INFO, logger="data"):
        got = dataset.array_to_device(full, "cpu", chunk_bytes=3 * 48)  # 3 rows a chunk
    assert torch.equal(got, torch.from_numpy(full))
    assert [r.message for r in caplog.records if r.name == "data"] == [
        f"dataset_to_device: uploaded {n}/10" for n in (3, 6, 9, 10)]


def test_rasterization_save_sidecar_matches_decode(tmp_path):
    """--save_sidecar writes the sidecar at rasterization time, two workers
    filling disjoint rows; decoded_corpus of either package hits it (no
    decode) and its rows equal the PNG decode."""
    pre = tmp_path / "pre"
    pre.mkdir()
    for i in range(5):
        with open(pre / f"sample_{i}.pkl", "wb") as f:
            pickle.dump(decode_scenario(make_synthetic_scenario(seed=i)), f)
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("raster:\n  img_res: 64\n")
    res = data_rasterization.main(["--load_path", str(pre), "--save_path", str(tmp_path / "ras"),
                                   "--cfg_file", str(cfg), "--n_workers", "2", "--save_sidecar",
                                   "--device", "cpu"])
    out_dir = str(tmp_path / "ras" / "GT_70k_s80_dxdy_agents_img")
    pngs = sorted(glob.glob(out_dir + "/*.png"))
    assert len(pngs) == 5
    expected = dataset.sidecar_path(pngs, 64, 3, np.uint8)
    assert res["sidecar"] == expected
    assert glob.glob(out_dir + "/.devcache_*.npy") == [expected]
    ds = dataset.RasterDataset(out_dir + "/*.png", img_res=64, n_channels=3, raw=True)
    for m in (dataset.decoded_corpus(ds),
              jax_dataset.decoded_corpus(jax_dataset.RasterDataset(out_dir + "/*.png", 64,
                                                                   raw=True))):
        assert isinstance(m, np.memmap)
        assert all(np.array_equal(m[i], ds[i]) for i in range(5))
    # The key does not depend on how a path is spelled.
    assert dataset.sidecar_path(["./a/b.png", "./a/c.png"], 64, 3, np.uint8).split("/")[-1] == \
        dataset.sidecar_path(["a/b.png", "a/c.png"], 64, 3, np.uint8).split("/")[-1]
