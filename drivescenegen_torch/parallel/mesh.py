"""Data parallelism over torch.distributed (the port's counterpart of
drivescenegen_tpu/parallel/mesh.py:31-56).

The mesh has the JAX package's two axes, ("data", "model"). Each rank is
one process on one device, started by torchrun (RANK, WORLD_SIZE and
LOCAL_RANK in its environment). The global batch is split over the data
axis: rank r holds rows [r * B / W, (r + 1) * B / W) of it, and every rank
holds the full parameters ("replicated"). Gradients are averaged over the
data axis with one coalesced all_reduce per step (all_reduce_mean_).

With none of torchrun's variables set the mesh is one rank with no
process group, and every caller runs exactly its one-process path.

Not ported: the tensor-parallel rules (DEFAULT_TP_RULES and
param_shardings, the JAX module's :58-160). Splitting the training arm's
convs by columns and rows, and the fused GN+SiLU+conv3x3 kernel at Co/tp,
is a slice of its own; a mesh with model > 1 is refused until then.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional

import torch

from drivescenegen_torch.config import MeshConfig
from drivescenegen_torch.utils.device import resolve_device

TP_SLICE = ("tensor parallelism (mesh.model > 1: DEFAULT_TP_RULES / param_shardings) is the "
            "port's next slice (ROADMAP queue 1, tensor parallelism); use mesh.model 1")


@dataclass
class Mesh:
    """This process's place in the ("data", "model") mesh."""

    shape: dict = field(default_factory=lambda: {"data": 1, "model": 1})
    rank: int = 0
    world: int = 1
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    # True when make_mesh initialized a process group (torchrun's variables
    # were set), even for a world of one.
    distributed: bool = False

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` (batch_sharding)."""
        n = self.shape["data"]
        if batch % n:
            raise ValueError(f"global batch {batch} is not divisible by the data axis {n}")
        per = batch // n
        return slice(self.rank * per, (self.rank + 1) * per)

    def barrier(self) -> None:
        if self.distributed:
            torch.distributed.barrier()

    def agree(self, flag: bool) -> bool:
        """Rank 0's `flag` on every rank: a decision every rank must take
        alike, such as stopping, read from the disk by rank 0."""
        if not self.distributed:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        torch.distributed.broadcast(t, 0)
        return bool(t.item())

    def close(self) -> None:
        """End the process group make_mesh started."""
        if self.distributed and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        self.distributed = False


def make_mesh(cfg: Optional[MeshConfig] = None, device="cuda") -> Mesh:
    """The mesh of this process. Under torchrun it initializes the process
    group: NCCL on cuda:LOCAL_RANK (set as the current device before any
    kernel runs: the kernels keep per-device state), gloo on the CPU. The
    data axis -1 means the whole world. Raises when data x model is not the
    world size, and SystemExit for model > 1 (tensor parallelism, a later
    slice)."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model)
    if model > 1:
        raise SystemExit(TP_SLICE)
    device = resolve_device(device)
    env = [os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")]
    distributed = any(v is not None for v in env)
    if distributed:
        if None in env:
            raise RuntimeError("RANK, WORLD_SIZE and LOCAL_RANK must all be set (torchrun sets "
                               "them)")
        rank, world, local_rank = (int(v) for v in env)
        if device.type == "cuda":
            torch.cuda.set_device(local_rank)
            device = torch.device("cuda", local_rank)
        if not torch.distributed.is_initialized():
            torch.distributed.init_process_group(
                "nccl" if device.type == "cuda" else "gloo", init_method="env://", rank=rank,
                world_size=world)
    else:
        rank, world = 0, 1
    data = cfg.data if cfg.data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, the world has "
                         f"{world}")
    return Mesh({"data": data, "model": model}, rank, world, device, distributed)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows [r * B / W, (r + 1) * B / W) of a global batch of B."""
    return mesh.rows(batch)


def shard_batch(mesh: Mesh, batch) -> torch.Tensor:
    """This rank's rows of a host (numpy) or device global batch, on the
    rank's device."""
    return torch.as_tensor(batch[mesh.rows(len(batch))]).to(mesh.device)


def replicated(mesh: Mesh, array) -> torch.Tensor:
    """The full array on this rank's device, as on every rank."""
    return torch.as_tensor(array).to(mesh.device)


def all_reduce_mean_(tensors: List[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Average `tensors` over the data axis in place: one all_reduce of
    their concatenation, then each divided by the world size. Nothing to do
    without a process group."""
    if mesh is None or not mesh.distributed:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    torch.distributed.all_reduce(flat)
    flat /= mesh.world
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])
