"""Filesystem helpers: the port's copy of split_round_robin and the
filename cache of drivescenegen_tpu/utils/io.py (reference: utils/io.py)."""

from __future__ import annotations

import glob
import os
import pickle
from typing import List, Sequence


def split_round_robin(items: Sequence, n_workers: int) -> List[List]:
    """Deterministic round-robin shard assignment for worker pools."""
    out: List[List] = [[] for _ in range(n_workers)]
    for i, item in enumerate(items):
        out[i % n_workers].append(item)
    return out


def get_cache_name(parent_dir: str, child_dir: str) -> str:
    return os.path.join(parent_dir, f"{child_dir}_cached_filenames.pkl")


def cache_all_filenames(parent_dir: str, child_dir: str) -> str:
    """Pickle-cache a glob over a huge directory (reference: utils/io.py:33-38)."""
    filenames = glob.glob(os.path.join(parent_dir, child_dir + "/*"))
    cache = get_cache_name(parent_dir, child_dir)
    with open(cache, "wb") as f:
        pickle.dump(filenames, f)
    return cache


def get_all_filenames(parent_dir: str, child_dir: str, refresh: bool = False) -> list:
    cache = get_cache_name(parent_dir, child_dir)
    if refresh or not os.path.exists(cache):
        cache_all_filenames(parent_dir, child_dir)
    with open(cache, "rb") as f:
        return pickle.load(f)
