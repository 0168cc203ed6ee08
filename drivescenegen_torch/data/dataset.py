"""Training dataset: rasterized scene images -> batches (the port of
drivescenegen_tpu/data/dataset.py).

Globbed image files, normalized to [-1, 1] ((x - 0.5) / 0.5), shuffled
each epoch from a numpy rng seeded with the run's seed, so the sample
order is the JAX package's for the same seed. In raw mode (every file a
PNG) samples stay uint8 and the train step normalizes them on the device
as x / 127.5 - 1.

The whole corpus, decoded, is one [N, H, W, C] host array
(`decoded_corpus`), kept in a digest-keyed sidecar file beside the images
(`sidecar_path`: the JAX package's key, so either package reads a sidecar
the other wrote). Three ways feed the card:
- `dataset_to_device`: the corpus uploaded once in ~200 MB chunks into one
  preallocated tensor (`array_to_device`); each step gathers its batch
  there by index (`index_batches`), so no image crosses the host link;
- `hybrid_device_data` + `hybrid_index_batches`, for a corpus over the
  device budget: a seeded budget-sized pool stays resident, the tail
  streams from the sidecar at a fixed per-batch share;
- `prefetch_to_device`: host batches copied `depth` ahead from pinned
  memory on a side stream.

  python -m drivescenegen_torch.data.dataset --cfg_file <yaml>

prebuilds a config's sidecar on the host, touching no device.
"""

from __future__ import annotations

import collections
import glob
import logging
import os
import queue
import threading
import time
from typing import Iterator, Optional, Sequence

import numpy as np
import torch


def load_image(path: str, img_res: int = 256, n_channels: int = 3) -> np.ndarray:
    """Load one sample as float32 (H, W, n_channels) in [0, 1]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        arr = np.load(path)
        if arr.dtype == np.uint8:
            arr = arr.astype(np.float32) / 255.0
        arr = arr.astype(np.float32)
    else:
        from PIL import Image

        img = Image.open(path).convert("L" if n_channels == 1 else "RGB")
        if img.size != (img_res, img_res):
            img = img.resize((img_res, img_res), Image.BILINEAR)
        arr = np.asarray(img, np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None] if n_channels == 1 else np.stack([arr] * 3, axis=-1)
    return arr[..., :n_channels]


class RasterDataset:
    """Glob-based image dataset, normalized to [-1, 1].

    cache=True keeps decoded images in host RAM (float sources as
    float16). raw="auto"/True yields uint8 [0, 255] samples instead of
    normalized float32; "auto" is raw iff every file is a PNG (8-bit), so
    float .npy datasets keep full precision."""

    def __init__(self, pattern: str, img_res: int = 256, n_channels: int = 3,
                 cache: bool = False, raw=False):
        self.files: Sequence[str] = sorted(glob.glob(pattern))
        if not self.files:
            raise FileNotFoundError(f"no files match {pattern!r}")
        self.img_res = img_res
        self.n_channels = n_channels
        if raw == "auto":
            raw = all(f.lower().endswith(".png") for f in self.files)
        self.raw = bool(raw)
        self._cache: Optional[list] = [None] * len(self.files) if cache else None

    def __len__(self) -> int:
        return len(self.files)

    def _load(self, idx: int) -> np.ndarray:
        x = load_image(self.files[idx], self.img_res, self.n_channels)
        if self.raw:
            return np.clip(np.round(x * 255.0), 0, 255).astype(np.uint8)
        return x

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None:
            if self._cache[idx] is None:
                x = self._load(idx)
                self._cache[idx] = x if self.raw else x.astype(np.float16)
            x = self._cache[idx]
        else:
            x = self._load(idx)
        if self.raw:
            return x
        return (x.astype(np.float32) - 0.5) / 0.5


def _epoch_orders(n: int, batch_size: int, seed: int, drop_remainder: bool,
                  num_epochs: Optional[int] = None):
    """Index batches, epoch after epoch, each epoch one permutation of
    range(n) from one numpy rng stream."""
    rng = np.random.default_rng(seed)
    epoch = 0
    while num_epochs is None or epoch < num_epochs:
        order = rng.permutation(n)
        end = n - (n % batch_size if drop_remainder else 0)
        for i in range(0, end, batch_size):
            yield order[i:i + batch_size]
        epoch += 1


def batch_iterator(dataset: RasterDataset, batch_size: int, seed: int = 0,
                   num_epochs: Optional[int] = None, drop_remainder: bool = True,
                   prefetch: int = 4, num_threads: int = 8) -> Iterator[np.ndarray]:
    """Shuffled, threaded, prefetching iterator of [B, H, W, C] host
    batches (uint8 in raw mode, else float32)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def load_batch(idxs):
        if num_threads > 1 and len(idxs) > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(num_threads) as ex:
                samples = list(ex.map(dataset.__getitem__, idxs))
        else:
            samples = [dataset[i] for i in idxs]
        out = np.stack(samples)
        return out if out.dtype == np.uint8 else out.astype(np.float32)

    def worker():
        try:
            for idxs in _epoch_orders(len(dataset), batch_size, seed, drop_remainder, num_epochs):
                if stop.is_set():
                    return
                q.put(load_batch(idxs))
        finally:
            q.put(None)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            batch = q.get()
            if batch is None:
                return
            yield batch
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


def index_batches(n: int, batch_size: int, seed: int = 0,
                  drop_remainder: bool = True) -> Iterator[np.ndarray]:
    """Endless per-epoch-shuffled int64 index batches: the order
    batch_iterator gives for the same seed (the same rng stream)."""
    for idxs in _epoch_orders(n, batch_size, seed, drop_remainder):
        yield idxs.astype(np.int64)


def sidecar_path(files: Sequence[str], img_res: int, n_channels: int, dtype) -> str:
    """Digest-keyed sidecar path for a decoded corpus: the JAX package's
    key (drivescenegen_tpu/data/dataset.py:158-176) to the character. Paths
    are normalized, so "./imgs/*.png" and "imgs/*.png" key the same
    corpus."""
    import hashlib

    norm = [os.path.normpath(f) for f in files]
    digest = hashlib.sha1(
        ("\n".join(norm) + f"|{img_res}|{n_channels}" + f"|{np.dtype(dtype)}").encode()
    ).hexdigest()[:16]
    return os.path.join(os.path.dirname(files[0]), f".devcache_{digest}.npy")


def decoded_corpus(dataset: RasterDataset, chunk: int = 1024) -> np.ndarray:
    """The whole dataset as one [N, H, W, C] host array (uint8 in raw
    mode), backed by its sidecar file: a sidecar of the right shape and
    dtype is memory-mapped; failing that, one left under an older key with
    that shape and dtype is adopted (renamed to the current key); failing
    that, the corpus is decoded and saved there. The decode logs each
    chunk to the "data" logger, which the trainer's log file receives: the
    liveness signal the train CLI's --supervise watchdog reads."""
    n = len(dataset)
    sample0 = dataset[0]
    want = (n, *sample0.shape)
    cache_path = sidecar_path(dataset.files, dataset.img_res, dataset.n_channels, sample0.dtype)
    if os.path.exists(cache_path):
        try:
            m = np.load(cache_path, mmap_mode="r")
            if m.shape == want and m.dtype == sample0.dtype:
                print(f"decoded_corpus: using sidecar {cache_path}", flush=True)
                return m
        except (OSError, ValueError):
            pass
    cache_dir = os.path.dirname(cache_path)
    for f in sorted(os.listdir(cache_dir) if os.path.isdir(cache_dir) else []):
        old_path = os.path.join(cache_dir, f)
        if not (f.startswith(".devcache_") and f.endswith(".npy")) or old_path == cache_path:
            continue
        try:
            m = np.load(old_path, mmap_mode="r")
            fits = m.shape == want and m.dtype == sample0.dtype
            del m
        except (OSError, ValueError):
            continue
        if fits:
            os.replace(old_path, cache_path)
            print(f"decoded_corpus: adopted old-key sidecar {old_path} -> {cache_path}",
                  flush=True)
            return np.load(cache_path, mmap_mode="r")
    full = np.empty(want, dtype=sample0.dtype)
    full[0] = sample0
    for i in range(1, n, chunk):
        for j in range(i, min(i + chunk, n)):
            full[j] = dataset[j]
        logging.getLogger("data").info(f"decoded_corpus: decoded {min(i + chunk - 1, n)}/{n}")
        if (i - 1) % (chunk * 8) == 0:
            print(f"decoded_corpus: decoded {min(i + chunk - 1, n)}/{n}", flush=True)
    try:
        np.save(cache_path, full)
    except OSError:
        pass  # no room for the sidecar: decode again next time
    return full


def array_to_device(full: np.ndarray, device, label: str = "dataset_to_device",
                    chunk_bytes: int = 200 * 1024 * 1024) -> torch.Tensor:
    """A host array (often a sidecar mmap) in one tensor on `device`,
    uploaded in chunks of about `chunk_bytes` into that tensor,
    preallocated: never twice the array on the device, and never the whole
    array staged at once on the host. Logs each chunk to the "data"
    logger."""
    t0 = time.perf_counter()
    n = full.shape[0]
    bytes_per = int(np.prod(full.shape[1:])) * full.dtype.itemsize
    up_chunk = max(1, min(n, chunk_bytes // max(bytes_per, 1)))
    data = torch.empty(full.shape, dtype=torch.from_numpy(np.empty(0, full.dtype)).dtype,
                       device=device)
    for i in range(0, n, up_chunk):
        data[i:i + up_chunk].copy_(torch.from_numpy(np.array(full[i:i + up_chunk])))
        logging.getLogger("data").info(f"{label}: uploaded {min(i + up_chunk, n)}/{n}")
    if data.device.type == "cuda":
        torch.cuda.synchronize(data.device)
    dt = time.perf_counter() - t0
    gb = n * bytes_per / 1e9
    print(f"{label}: {n} samples ({gb:.3f} GB, {data.dtype}) in {dt:.2f}s "
          f"({gb / max(dt, 1e-9):.3f} GB/s)", flush=True)
    return data


def dataset_to_device(dataset: RasterDataset, device, chunk: int = 1024) -> torch.Tensor:
    """The whole dataset as one [N, H, W, C] tensor on `device`, uploaded
    once; a step then takes its batch with data[idx]."""
    return array_to_device(decoded_corpus(dataset, chunk=chunk), device)


def hybrid_device_data(dataset: RasterDataset, device, budget_bytes: int, seed: int = 0):
    """The resident pool of a corpus larger than the device budget: a
    seeded random R = budget // bytes_per_sample samples uploaded once, the
    rest left to stream from the sidecar. Returns (data_dev [R, ...],
    pool_idx [R], tail_idx [N - R], full), the JAX function's split for the
    same seed."""
    full = decoded_corpus(dataset)
    n = len(dataset)
    bytes_per = int(np.prod(full.shape[1:])) * full.dtype.itemsize
    r = max(1, min(n, int(budget_bytes) // max(bytes_per, 1)))
    order = np.random.default_rng(seed).permutation(n)
    pool_idx = np.sort(order[:r])
    tail_idx = np.sort(order[r:])
    pool = full[pool_idx] if r < n else full
    data_dev = array_to_device(pool, device, label="hybrid_device_data[pool]")
    return data_dev, pool_idx, tail_idx, full


def hybrid_index_batches(n_pool: int, n_tail: int, batch_size: int, seed: int = 0,
                         align: int = 1):
    """Endless (pool_slots [k_res], tail_slots [k_str]) int32 batches with
    fixed split sizes, shuffled per epoch so that every sample, resident
    or streamed, is visited once per epoch (up to the dropped remainder):
    k_str / batch_size is about n_tail / n. `align` rounds k_str up to a
    multiple of the data axis. The JAX function's stream for the same
    seed."""
    n = n_pool + n_tail
    k_str = int(round(batch_size * n_tail / n))
    if n_tail > 0:
        k_str = min(max(k_str, 1), batch_size - 1)
    if align > 1 and k_str % align:
        k_str = min(((k_str + align - 1) // align) * align, batch_size - align)
    k_res = batch_size - k_str
    rng = np.random.default_rng(seed)
    while True:
        pool_order = rng.permutation(n_pool)
        tail_order = rng.permutation(n_tail) if n_tail else np.empty(0, np.int64)
        n_batches = pool_order.size // k_res
        if k_str:
            n_batches = min(n_batches, tail_order.size // k_str)
        for b in range(n_batches):
            yield (pool_order[b * k_res:(b + 1) * k_res].astype(np.int32),
                   tail_order[b * k_str:(b + 1) * k_str].astype(np.int32))


def prefetch_to_device(iterator, device, depth: int = 2, rows: slice = slice(None)):
    """The host batches of `iterator`, rows `rows` of each (this rank's),
    as tensors on `device`, in order, with `depth` copies in flight ahead
    of the consumer. On the card each copy goes from pinned host memory on
    a side stream (non_blocking), and the consumer's stream waits on the
    copy's event before it reads the batch."""
    device = torch.device(device)
    if device.type != "cuda":
        for batch in iterator:
            yield torch.from_numpy(np.ascontiguousarray(batch[rows])).to(device)
        return
    side = torch.cuda.Stream(device)
    pending = collections.deque()

    def put(batch):
        host = torch.from_numpy(np.ascontiguousarray(batch[rows])).pin_memory()
        with torch.cuda.stream(side):
            dev = host.to(device, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        pending.append((dev, done, host))

    def take():
        dev, done, _ = pending.popleft()
        stream = torch.cuda.current_stream(device)
        stream.wait_event(done)
        dev.record_stream(stream)  # allocated on the side stream, read on this one
        return dev

    for batch in iterator:
        put(batch)
        if len(pending) >= depth:
            yield take()
    while pending:
        yield take()


if __name__ == "__main__":
    import argparse

    from drivescenegen_torch.config import load_config

    _p = argparse.ArgumentParser(description="Prebuild a config's decoded-corpus sidecar")
    _p.add_argument("--cfg_file", required=True, type=str)
    _a = _p.parse_args()
    _cfg = load_config(_a.cfg_file)
    _ds = RasterDataset(_cfg.train.dataset_glob, img_res=_cfg.model.sample_size,
                        n_channels=_cfg.model.in_channels + _cfg.model.cond_channels,
                        cache=False, raw="auto")
    _full = decoded_corpus(_ds)
    print(f"sidecar ready: {_full.shape} {_full.dtype}")
