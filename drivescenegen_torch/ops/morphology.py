"""Binary image morphology in PyTorch (the port's copy of
drivescenegen_tpu/ops/morphology.py): Zhang-Suen thinning (the reference's
skimage.morphology.skeletonize slot, extract_network.py:272), neighbor-ring
analysis for node detection (extract_network.py:34-93), and 2x2 erosion for
dense-node detection (extract_network.py:96-103).

Every function takes [..., H, W] and runs on its input's device, so a
whole batch of masks skeletonizes on the card in one call.

Thinning. A Zhang-Suen sub-iteration deletes a pixel by a function of its
8 neighbours alone, so the two sub-iterations are two 256-entry tables
(``_thin_tables``), built once from neighbor_ring / transitions_and_sum and
the JAX package's conditions on all 256 neighbourhoods. A sub-iteration is
then: stack the 8 neighbour views of a zero-bordered state, weigh them into
an 8-bit code, look the code up, mask the state: about six device kernels,
where one op per term of the conditions would take ~40.

Iterations. JAX's skeletonize is a while_loop that stops when an iteration
changes nothing or at max_iters. A converged mask is a fixed point of both
sub-iterations, so any count of iterations between convergence and
max_iters gives the same bits. skeletonize_batch runs exactly max_iters
iterations (check_every=0): no operation of it waits for the host, so it
can be queued behind the sampler without stalling the enqueue of the next
batch. With check_every=k it compares the state before and after every
k-th iteration and stops at the first that changed nothing, one host sync
per k iterations, never passing max_iters; skeletonize, the single-image
host helper, checks every iteration, as the while_loop does.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

_RING = ((-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1))


def _shift(img: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """Shift with zero fill: out[..., i, j] = img[..., i + di, j + dj]."""
    H, W = img.shape[-2:]
    padded = F.pad(img, (1, 1, 1, 1))
    return padded[..., 1 + di : 1 + di + H, 1 + dj : 1 + dj + W]


def neighbor_ring(img: torch.Tensor) -> torch.Tensor:
    """The 8 neighbors of each pixel in clockwise ring order
    P2..P9 = N, NE, E, SE, S, SW, W, NW (axis-0 = rows/"north"), stacked
    along a new leading axis."""
    return torch.stack([_shift(img, di, dj) for di, dj in _RING])


def transitions_and_sum(ring: torch.Tensor):
    """A(p): 0->1 transitions around the ring; B(p): neighbor count."""
    nxt = torch.roll(ring, -1, dims=0)
    A = ((ring == 0) & (nxt == 1)).sum(dim=0)
    B = ring.sum(dim=0, dtype=torch.int64)
    return A, B


@functools.lru_cache(maxsize=None)
def _thin_tables() -> torch.Tensor:
    """uint8 [2, 256]: row s keeps (1) or deletes (0) a foreground pixel whose
    neighbourhood code is c = sum_k P_(k+2) << k in sub-iteration s."""
    codes = torch.arange(256)
    ring = torch.stack([(codes >> k) & 1 for k in range(8)]).to(torch.uint8)  # [8, 256]
    P2, P3, P4, P5, P6, P7, P8, P9 = ring
    A, B = transitions_and_sum(ring)
    cond = (B >= 2) & (B <= 6) & (A == 1)
    first = cond & (P2 * P4 * P6 == 0) & (P4 * P6 * P8 == 0)
    second = cond & (P2 * P4 * P8 == 0) & (P2 * P6 * P8 == 0)
    return torch.stack([~first, ~second]).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _device_thin_state(device: torch.device):
    """The keep tables and the ring weights 1, 2, ..., 128 ([8, 1, 1, 1])
    on `device`."""
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.uint8).view(8, 1, 1, 1)
    return _thin_tables().to(device), weights.to(device)


def _thin_iteration(padded: torch.Tensor, keep: torch.Tensor, weights: torch.Tensor) -> None:
    """Both sub-iterations, in place, on a [B, H+2, W+2] uint8 0/1 state
    whose border is zero."""
    H, W = padded.shape[-2] - 2, padded.shape[-1] - 2
    inner = padded[:, 1:-1, 1:-1]
    for s in range(2):
        ring = torch.stack([padded[:, 1 + di : 1 + di + H, 1 + dj : 1 + dj + W]
                            for di, dj in _RING])  # [8, B, H, W]
        code = (ring * weights).sum(dim=0)  # int64 [B, H, W]
        inner &= keep[s][code]


def skeletonize_batch(imgs: torch.Tensor, max_iters: int = 64,
                      check_every: int = 0) -> torch.Tensor:
    """Zhang-Suen thinning of each [H, W] mask of imgs [B, H, W] (bool or
    0/1) to a 1-px-wide skeleton, bool [B, H, W]: bit for bit the JAX
    package's skeletonize_batch. check_every = 0 runs exactly max_iters
    iterations with no host sync; k > 0 stops at the first k-th iteration
    that changed nothing (see the module docstring)."""
    keep, weights = _device_thin_state(imgs.device)
    padded = F.pad(imgs.to(torch.uint8), (1, 1, 1, 1))
    i = 0
    while i < max_iters:
        last = min(max_iters, i + check_every) if check_every > 0 else max_iters
        while i < last - 1:
            _thin_iteration(padded, keep, weights)
            i += 1
        before = padded.clone() if check_every > 0 else None
        _thin_iteration(padded, keep, weights)
        i += 1
        if before is not None and torch.equal(before, padded):
            break
    return padded[:, 1:-1, 1:-1].to(torch.bool)


def skeletonize(img: torch.Tensor, max_iters: int = 64) -> torch.Tensor:
    """Zhang-Suen thinning of one [H, W] bool/0-1 mask, bool [H, W]; stops
    at the first iteration that changes nothing, as JAX's while_loop."""
    return skeletonize_batch(img[None], max_iters, check_every=1)[0]


def node_response(skel: torch.Tensor) -> torch.Tensor:
    """A(p) per skeleton pixel (0 elsewhere). Nodes are A==1 (endpoints) or
    A>=3 (branch points) — the reference's check_pixel_neighborhood
    (extract_network.py:59-85)."""
    s = skel.to(torch.uint8)
    A, _ = transitions_and_sum(neighbor_ring(s))
    return torch.where(s == 1, A, torch.zeros_like(A))


def erosion_2x2(img: torch.Tensor) -> torch.Tensor:
    """Binary erosion with a 2x2 structuring element anchored like
    scipy/skimage's origin convention (used for dense skeleton regions)."""
    s = img.to(torch.uint8)
    # 2x2 window covering (i-1, j-1)..(i, j): matches skimage
    # binary_erosion(np.pad(x,1), ones((2,2)))[1:-1,1:-1].
    w = s & _shift(s, -1, 0) & _shift(s, 0, -1) & _shift(s, -1, -1)
    return w.to(torch.bool)


def binarize_lane_mask(img: torch.Tensor, bg_r, bg_g, threshold: float = 0.1) -> torch.Tensor:
    """Lane mask: pixels whose R or G deviates from the background modes by
    more than threshold (the reference's combine_dx_dy, image_utils.py:6-11,
    where 'background' pixels satisfy BOTH |r-mr|<=t and |g-mg|<=t)."""
    r = img[..., 0]
    g = img[..., 1]
    is_bg = ((r - bg_r).abs() <= threshold) & ((g - bg_g).abs() <= threshold)
    return ~is_bg
