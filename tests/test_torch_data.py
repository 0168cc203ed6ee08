"""The port's data front end against the JAX package on the CPU: CRC32-C,
the TFRecord codec and its readers (the native one built by the port into
drivescenegen_torch/build/), decode_scenario, the synthetic generator, the
pickles process_files and the preprocess CLI write, the 180° augment and
the vector-map tensor.

Every comparison is exact: both sides are the same numpy and protobuf code
on the same bytes. The JAX package's readers run with backend="python", so
these tests never build its native library (ROADMAP §3 says why).
"""

import os
import pickle
import shutil
import sys

import numpy as np
import pytest

from drivescenegen_torch.data import augment as t_augment
from drivescenegen_torch.data import native_io as t_native_io
from drivescenegen_torch.data import preprocess as t_pre
from drivescenegen_torch.data import synthetic as t_syn
from drivescenegen_torch.data import tfrecord as t_tfr
from drivescenegen_torch.data import vector_map as t_vmap
from drivescenegen_torch.scripts import data_preprocess as t_cli
from drivescenegen_tpu.data import augment as j_augment
from drivescenegen_tpu.data import preprocess as j_pre
from drivescenegen_tpu.data import synthetic as j_syn
from drivescenegen_tpu.data import tfrecord as j_tfr
from drivescenegen_tpu.data import vector_map as j_vmap
from drivescenegen_tpu.scripts import data_preprocess as j_cli

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "womd_mini.tfrecord")
SEEDS = range(8)


def assert_same(a, b, path="info"):
    """Key for key and array for array, exactly (dtype and shape too)."""
    assert type(a) is type(b), f"{path}: {type(a)} != {type(b)}"
    if isinstance(a, dict):
        assert list(a) == list(b), f"{path}: keys {list(a)} != {list(b)}"
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), f"{path}: length {len(a)} != {len(b)}"
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, f"{path}: {a.dtype}{a.shape} != {b.dtype}{b.shape}"
        assert np.array_equal(a, b, equal_nan=True), f"{path}: arrays differ"
    else:
        assert a == b, f"{path}: {a!r} != {b!r}"


def test_crc32c_known_vectors_and_native():
    # Published CRC-32C test vectors (RFC 3720 appendix).
    for data, crc in ((b"", 0x00000000), (b"123456789", 0xE3069283), (b"\x00" * 32, 0x8A9136AA)):
        assert t_tfr.crc32c(data) == crc == j_tfr.crc32c(data)
    rng = np.random.default_rng(0)
    for n in (1, 7, 8, 9, 1000):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert t_tfr.crc32c(data) == j_tfr.crc32c(data) == t_native_io.crc32c(data)
        assert t_tfr.masked_crc32c(data) == j_tfr.masked_crc32c(data)


def test_native_library_is_built_into_the_port(tmp_path):
    assert t_native_io.available()
    lib = t_native_io.library_path()
    assert lib.exists() and lib.parent.name == "build" and lib.parent.parent.name == "drivescenegen_torch"
    assert lib.name.startswith("libdsg_io-")


@pytest.mark.parametrize("writer", ["python", "native"])
def test_tfrecord_roundtrip_and_corruption(tmp_path, writer):
    path = str(tmp_path / "t.tfrecord")
    records = [b"hello", b"", b"x" * 1000]
    write = t_tfr.write_tfrecord if writer == "python" else t_native_io.write_tfrecord
    assert write(path, records) == 3
    ref = str(tmp_path / "j.tfrecord")
    j_tfr.write_tfrecord(ref, records)
    assert open(path, "rb").read() == open(ref, "rb").read()
    for backend in ("python", "native", "auto"):
        assert [bytes(r) for r in t_tfr.read_tfrecord(path, backend=backend)] == records
    assert t_tfr.count_records(path) == 3

    raw = bytearray(open(path, "rb").read())
    raw[14] ^= 0xFF  # flip a payload byte
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError):
        list(t_tfr.read_tfrecord_python(path))
    with pytest.raises(IOError):
        list(t_native_io.read_tfrecord(path))


def test_tf_backend_raises_when_tensorflow_is_absent(tmp_path, monkeypatch):
    path = str(tmp_path / "t.tfrecord")
    t_tfr.write_tfrecord(path, [b"a"])
    monkeypatch.setitem(sys.modules, "tensorflow", None)
    with pytest.raises(ImportError):
        list(t_tfr.read_tfrecord(path, backend="tf"))


def test_readers_agree_on_the_womd_fixture():
    py = list(t_tfr.read_tfrecord_python(FIXTURE))
    native = [bytes(r) for r in t_tfr.read_tfrecord(FIXTURE, backend="native")]
    assert len(py) == 3 and native == py == list(j_tfr.read_tfrecord(FIXTURE, backend="python"))


def test_decode_scenario_matches_on_the_womd_fixture():
    for data in j_tfr.read_tfrecord_python(FIXTURE):
        assert_same(t_pre.decode_scenario(data), j_pre.decode_scenario(data))


@pytest.mark.parametrize("rich", [False, True], ids=["plain", "rich"])
def test_synthetic_bytes_and_decode_match(rich):
    for seed in SEEDS:
        data = t_syn.make_synthetic_scenario(seed, rich=rich)
        assert data == j_syn.make_synthetic_scenario(seed, rich=rich)
        assert_same(t_pre.decode_scenario(data), j_pre.decode_scenario(data))


def test_synthetic_tfrecord_bytes_match(tmp_path):
    assert t_syn.make_synthetic_tfrecord(str(tmp_path / "t.tfrecord"), 3, seed=2) == 3
    j_syn.make_synthetic_tfrecord(str(tmp_path / "j.tfrecord"), 3, seed=2)
    assert (tmp_path / "t.tfrecord").read_bytes() == (tmp_path / "j.tfrecord").read_bytes()


def _pickles(directory):
    out = {}
    for name in sorted(os.listdir(directory)):
        with open(os.path.join(directory, name), "rb") as f:
            out[name] = pickle.load(f)
    return out


def test_process_files_writes_the_jax_pickles(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    shutil.copy(FIXTURE, raw / "a.tfrecord")
    j_syn.make_synthetic_tfrecord(str(raw / "b.tfrecord"), 2, seed=1)
    files = sorted(str(p) for p in raw.iterdir())
    # Two shards through the spawn pool on the port's side.
    ids = t_pre.process_files(files, str(tmp_path / "t"), n_workers=2)
    j_ids = j_pre.process_files(files, str(tmp_path / "j"), n_workers=1, backend="python")
    assert ids == j_ids and len(ids) == 5
    t, j = _pickles(tmp_path / "t"), _pickles(tmp_path / "j")
    assert list(t) == list(j)
    for name in t:
        assert_same(t[name], j[name], name)


def test_preprocess_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    for offset in ("0", "3"):
        t_cli.main(["--synthetic", "3", "--synthetic_rich", "--synthetic_offset", offset,
                    "--save_path", str(tmp_path / "t")])
        monkeypatch.setattr(sys, "argv", ["x", "--synthetic", "3", "--synthetic_rich",
                                          "--synthetic_offset", offset,
                                          "--save_path", str(tmp_path / "j")])
        j_cli.main()
    t, j = _pickles(tmp_path / "t"), _pickles(tmp_path / "j")
    assert list(t) == list(j) and len(t) == 7  # six scenes and the merged index
    for name in t:
        assert_same(t[name], j[name], name)


def test_preprocess_cli_reads_tfrecord_shards(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    shutil.copy(FIXTURE, raw / "uncompressed.tfrecord-00000-of-00001")
    ids = t_cli.main(["--load_path", str(raw), "--save_path", str(tmp_path / "pre"),
                      "--n_workers", "1", "--backend", "native"])
    assert len(ids) == 3
    with pytest.raises(SystemExit):
        t_cli.main(["--load_path", str(tmp_path / "empty"), "--save_path", str(tmp_path / "x")])


@pytest.mark.parametrize("rich", [False, True], ids=["plain", "rich"])
def test_rotate_scenario_180_matches(rich):
    for seed in SEEDS[:4]:
        info = j_pre.decode_scenario(j_syn.make_synthetic_scenario(seed, rich=rich))
        assert_same(t_augment.rotate_scenario_180(info), j_augment.rotate_scenario_180(info))


def test_vector_to_same_size_tensor_matches():
    infos = [j_pre.decode_scenario(d) for d in j_tfr.read_tfrecord_python(FIXTURE)]
    infos += [j_pre.decode_scenario(j_syn.make_synthetic_scenario(s, rich=True)) for s in SEEDS]
    for info in infos:
        for kw in ({}, {"des_column_size": 32, "des_row_size": 16, "map_range": 80.0}):
            got = t_vmap.vector_to_same_size_tensor(info, **kw)
            want = j_vmap.vector_to_same_size_tensor(info, **kw)
            assert_same(got, want)
