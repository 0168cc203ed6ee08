"""Filesystem helpers: the port's copy of split_round_robin from
drivescenegen_tpu/utils/io.py."""

from __future__ import annotations

from typing import List, Sequence


def split_round_robin(items: Sequence, n_workers: int) -> List[List]:
    """Deterministic round-robin shard assignment for worker pools."""
    out: List[List] = [[] for _ in range(n_workers)]
    for i, item in enumerate(items):
        out[i % n_workers].append(item)
    return out
