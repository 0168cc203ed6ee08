"""Training dataset: rasterized scene images -> batches (the port's copy of
drivescenegen_tpu/data/dataset.py:21-130, :304-320, :378-389).

Globbed image files, normalized to [-1, 1] ((x - 0.5) / 0.5), shuffled
each epoch from a numpy rng seeded with the run's seed, so the sample
order is the JAX package's for the same seed. In raw mode (every file a
PNG) samples stay uint8 and the train step normalizes them on the device
as x / 127.5 - 1. `dataset_to_device` uploads the whole uint8 corpus to
GPU memory once, and each step then gathers its batch there by index
(`index_batches`), so no image crosses the host link after the upload.
"""

from __future__ import annotations

import glob
import os
import queue
import threading
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


def decoded_corpus(dataset: RasterDataset) -> np.ndarray:
    """The whole dataset as one [N, H, W, C] host array (uint8 in raw
    mode). Decoded anew on every call: the JAX package's digest-keyed
    sidecar file is not ported yet."""
    first = dataset[0]
    full = np.empty((len(dataset), *first.shape), dtype=first.dtype)
    full[0] = first
    for i in range(1, len(dataset)):
        full[i] = dataset[i]
    return full


def dataset_to_device(dataset: RasterDataset, device) -> torch.Tensor:
    """The whole dataset as one [N, H, W, C] tensor on `device`, uploaded
    once; a step then takes its batch with data[idx]."""
    return torch.from_numpy(decoded_corpus(dataset)).to(device)
