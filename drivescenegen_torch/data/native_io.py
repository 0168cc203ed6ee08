"""The port's copy of drivescenegen_tpu/data/native_io.py: ctypes bindings
for the native IO runtime (native/dsg_io.cpp).

The library is built at first use (utils/native.py: g++ into
drivescenegen_torch/build/ under a file lock, renamed into place). Without a
compiler, or if the build fails, the loader logs a warning and
data/tfrecord.py falls back to the tf or pure-Python readers.
"""

from __future__ import annotations

import ctypes
import mmap
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, List

from drivescenegen_torch.utils import native
from drivescenegen_torch.utils.logging import get_logger

logger = get_logger("native_io")

SOURCE = native.NATIVE_DIR / "dsg_io.cpp"
BUILD_DIR = native.BUILD_DIR

_lib = None
_lib_load_failed = False
_lib_lock = threading.Lock()


def library_path() -> Path:
    return native.library_path(SOURCE, BUILD_DIR)


def build() -> Path:
    """Compile the library unless it exists (utils/native.py); returns its
    path. Raises if there is no compiler or the build fails."""
    return native.build(SOURCE, BUILD_DIR)


def _load():
    global _lib, _lib_load_failed
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _lib_load_failed:  # don't rebuild per call once it failed
            return None
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _lib_load_failed = True
            logger.warning(f"native dsg_io unavailable ({e}); TFRecords are read in Python")
            return None
        lib.dsg_crc32c.restype = ctypes.c_uint32
        lib.dsg_crc32c.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.dsg_tfrecord_index_buffer.restype = ctypes.c_int64
        lib.dsg_tfrecord_index_buffer.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint64)),
        ]
        lib.dsg_free.restype = None
        lib.dsg_free.argtypes = [ctypes.c_void_p]
        lib.dsg_tfrecord_write.restype = ctypes.c_int
        lib.dsg_tfrecord_write.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_uint64,
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def crc32c(data: bytes) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native dsg_io not available")
    return lib.dsg_crc32c(data, len(data))


def index_tfrecord(path: str, verify_crc: bool = True) -> List[tuple]:
    """[(payload_offset, payload_length), ...] for a TFRecord file."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native dsg_io not available")
    with open(path, "rb") as f:
        size = os.fstat(f.fileno()).st_size
        if size == 0:
            return []
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            buf = (ctypes.c_char * size).from_buffer_copy(mm)
            offsets = ctypes.POINTER(ctypes.c_uint64)()
            lengths = ctypes.POINTER(ctypes.c_uint64)()
            n = lib.dsg_tfrecord_index_buffer(
                ctypes.cast(buf, ctypes.c_char_p), size, int(verify_crc),
                ctypes.byref(offsets), ctypes.byref(lengths),
            )
            if n < 0:
                raise IOError(f"corrupt TFRecord {path!r} (code {n})")
            out = [(offsets[i], lengths[i]) for i in range(n)]
            lib.dsg_free(offsets)
            lib.dsg_free(lengths)
            return out
        finally:
            mm.close()


def read_tfrecord(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield record payloads using the native index + mmap slicing."""
    index = index_tfrecord(path, verify_crc)
    if not index:
        return
    with open(path, "rb") as f:
        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
        try:
            for off, length in index:
                yield mm[off : off + length]
        finally:
            mm.close()


def write_tfrecord(path: str, records: List[bytes]) -> int:
    lib = _load()
    if lib is None:
        raise RuntimeError("native dsg_io not available")
    payload = b"".join(records)
    lens = (ctypes.c_uint64 * len(records))(*[len(r) for r in records])
    rc = lib.dsg_tfrecord_write(
        path.encode(), payload, lens, len(records)
    )
    if rc != 0:
        raise IOError(f"native TFRecord write failed for {path!r}")
    return len(records)
