"""The port's copy of drivescenegen_tpu/data/tfrecord.py.

TFRecord codec.

Read path: prefers the C++ native reader (native/dsg_io) when built, then
tf.data's C++ reader when tensorflow is importable, and always has a
dependency-free pure-Python fallback. Write path is pure Python (used to
build synthetic fixtures and repack datasets).

Format (stable since TF 1.0):
  uint64 length | uint32 masked_crc32c(length) | bytes data |
  uint32 masked_crc32c(data)
with masked_crc = ((crc >> 15 | crc << 17) + 0xa282ead8) & 0xffffffff.
"""

from __future__ import annotations

import os
import struct
from typing import Iterable, Iterator, List, Optional

# ---------------------------------------------------------------------------
# CRC32-C (Castagnoli), table-driven.
# ---------------------------------------------------------------------------

_CRC_TABLE: Optional[List[int]] = None


def _make_table() -> List[int]:
    poly = 0x82F63B78  # reflected Castagnoli polynomial
    table = []
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        table.append(crc)
    return table


def crc32c(data: bytes) -> int:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        _CRC_TABLE = _make_table()
    crc = 0xFFFFFFFF
    table = _CRC_TABLE
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Writer
# ---------------------------------------------------------------------------

def write_tfrecord(path: str, records: Iterable[bytes]) -> int:
    """Write records to a TFRecord file; returns the record count."""
    n = 0
    with open(path, "wb") as f:
        for rec in records:
            length = struct.pack("<Q", len(rec))
            f.write(length)
            f.write(struct.pack("<I", masked_crc32c(length)))
            f.write(rec)
            f.write(struct.pack("<I", masked_crc32c(rec)))
            n += 1
    return n


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def read_tfrecord_python(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Dependency-free TFRecord reader."""
    with open(path, "rb") as f:
        while True:
            header = f.read(12)
            if not header:
                return
            if len(header) < 12:
                raise IOError(f"truncated TFRecord header in {path}")
            (length,) = struct.unpack("<Q", header[:8])
            (len_crc,) = struct.unpack("<I", header[8:12])
            if verify_crc and masked_crc32c(header[:8]) != len_crc:
                raise IOError(f"length CRC mismatch in {path}")
            data = f.read(length)
            if len(data) < length:
                raise IOError(f"truncated TFRecord payload in {path}")
            (data_crc,) = struct.unpack("<I", f.read(4))
            if verify_crc and masked_crc32c(data) != data_crc:
                raise IOError(f"payload CRC mismatch in {path}")
            yield data


def _native_reader():
    try:
        from drivescenegen_torch.data import native_io

        return native_io if native_io.available() else None
    except Exception:
        return None


def read_tfrecord(path: str, backend: str = "auto") -> Iterator[bytes]:
    """Iterate serialized records. backend: auto | native | tf | python."""
    if backend in ("auto", "native"):
        native = _native_reader()
        if native is not None:
            yield from native.read_tfrecord(path)
            return
        if backend == "native":
            raise RuntimeError("native TFRecord reader not built")
    if backend in ("auto", "tf"):
        try:
            import tensorflow as tf

            tf.config.set_visible_devices([], "GPU")
            for item in tf.data.TFRecordDataset(path):
                yield bytes(item.numpy())
            return
        except ImportError:
            if backend == "tf":
                raise
    yield from read_tfrecord_python(path)


def count_records(path: str) -> int:
    return sum(1 for _ in read_tfrecord(path))
