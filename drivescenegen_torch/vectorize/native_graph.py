"""The port's copy of drivescenegen_tpu/vectorize/native_graph.py: ctypes
bindings for the native stage-2 graph passes (native/dsg_graph.cpp).

Exposes find_paths / connect_paths — exact C++ ports of the Python BFS path
recovery in vectorize/network.py (reference: vectorization/graph/
extract_network.py:149-261).

The library is built at first use (utils/native.py: g++ into
drivescenegen_torch/build/ under a file lock, renamed into place). Without a
compiler, or if the build fails, the loader logs a warning and network.py
runs its Python path.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path
from typing import List, Tuple

import numpy as np

from drivescenegen_torch.utils import native
from drivescenegen_torch.utils.logging import get_logger

logger = get_logger("native_graph")

SOURCE = native.NATIVE_DIR / "dsg_graph.cpp"
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
        if _lib_load_failed:
            return None
        try:
            lib = ctypes.CDLL(str(build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _lib_load_failed = True
            logger.warning(f"native dsg_graph unavailable ({e}); the graph passes run in "
                           f"Python, about 100x slower")
            return None
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.dsg_find_paths.restype = ctypes.c_int64
        lib.dsg_find_paths.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int64,
            i32p, ctypes.c_int64, i32p, ctypes.c_int64,
        ]
        lib.dsg_connect_paths.restype = ctypes.c_int64
        lib.dsg_connect_paths.argtypes = [
            u8p, ctypes.c_int32, ctypes.c_int32, i32p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32,
            i32p, ctypes.c_int64, i32p, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _prep(skel: np.ndarray, nodes: list) -> Tuple[np.ndarray, np.ndarray, int, int]:
    s = np.ascontiguousarray((np.asarray(skel) > 0).astype(np.uint8))
    W, H = s.shape  # [x][y] indexing, dim0 = x (network.py convention)
    nd = np.ascontiguousarray(np.asarray(nodes, np.int32).reshape(-1, 2))
    return s, nd, W, H


def _unpack(lens: np.ndarray, pix: np.ndarray, n: int) -> List[list]:
    total = int(lens[:n].sum())
    flat = pix[:total].tolist()  # C-speed conversion to [x, y] lists
    paths = []
    k = 0
    for i in range(n):
        m = int(lens[i])
        paths.append(list(map(tuple, flat[k : k + m])))
        k += m
    return paths


def _call(fn, s, nd, W, H, extra=()) -> Tuple[List[list], int]:
    lens_cap = max(4 * len(nd) + 64, 1024)
    pix_cap = 8 * W * H + 4096
    out_iters = ctypes.c_int32(0)
    for _ in range(4):
        lens = np.empty(lens_cap, np.int32)
        pix = np.empty(pix_cap, np.int32)
        args = [s, W, H, nd, len(nd), *extra, lens, lens_cap, pix, pix_cap]
        if fn is _load().dsg_connect_paths:
            args.append(ctypes.byref(out_iters))
        n = fn(*args)
        if n >= 0:
            return _unpack(lens, pix.reshape(-1, 2), int(n)), int(out_iters.value)
        lens_cap *= 4
        pix_cap *= 4
    raise RuntimeError("dsg_graph output capacity exceeded after retries")


def find_paths(skel: np.ndarray, nodes: list) -> List[list]:
    """Pixel paths between nodes — C++ port of network.find_paths.
    Returns a list of pixel-(x, y) lists (endpoints are node pixels)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native dsg_graph not available")
    s, nd, W, H = _prep(skel, nodes)
    paths, _ = _call(lib.dsg_find_paths, s, nd, W, H)
    return paths


def connect_paths(
    skel: np.ndarray, nodes: list, min_distance: int, max_merge_iters: int = 300
) -> Tuple[List[list], int]:
    """Flood + merge-until-stable loop — C++ port of network.connect_graph's
    inner loop. Returns (paths, merge_iters_used)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native dsg_graph not available")
    s, nd, W, H = _prep(skel, nodes)
    return _call(
        lib.dsg_connect_paths, s, nd, W, H,
        extra=(int(min_distance), int(max_merge_iters)),
    )
