"""Random-number discipline: one seed per run, derived per purpose and step
(the port's counterpart of drivescenegen_tpu/utils/prng.py).

Every draw comes from an explicit torch.Generator whose seed is derived
from the run's seed and structured integers: a purpose ("init", "train",
...) named by the same sha256 id as the JAX package's, then a step. Runs
are reproducible whatever else draws random numbers. The bits differ from
JAX's threefry draws, so parity tests hand both sides the same numbers.
"""

from __future__ import annotations

import hashlib

import torch

_PURPOSES: dict = {}


def purpose_id(purpose: str) -> int:
    """The JAX package's id of a purpose: the first 4 bytes of its sha256,
    little-endian, as a non-negative int32."""
    if purpose not in _PURPOSES:
        digest = hashlib.sha256(purpose.encode()).digest()
        _PURPOSES[purpose] = int.from_bytes(digest[:4], "little") & 0x7FFFFFFF
    return _PURPOSES[purpose]


def derive(seed: int, *parts: int) -> int:
    """A 63-bit seed folded from `seed` and the integers `parts`."""
    data = b"".join(int(x).to_bytes(8, "little", signed=True) for x in (seed, *parts))
    return int.from_bytes(hashlib.sha256(data).digest()[:8], "little") & (2**63 - 1)


def root_generator(seed: int, device="cpu") -> torch.Generator:
    """The run's generator, seeded with `seed` itself."""
    return torch.Generator(device=device).manual_seed(int(seed))


def purpose_seed(seed: int, purpose: str) -> int:
    """The seed of a named purpose ("init", "train", ...) of a run."""
    return derive(seed, purpose_id(purpose))


def for_purpose(seed: int, purpose: str, device="cpu") -> torch.Generator:
    """A generator for a named purpose of a run."""
    return torch.Generator(device=device).manual_seed(purpose_seed(seed, purpose))


def for_step(seed: int, step: int, device="cpu") -> torch.Generator:
    """A generator for one step of the stream seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(derive(seed, step))
