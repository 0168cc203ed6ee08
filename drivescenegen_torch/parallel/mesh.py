"""Data and tensor parallelism over torch.distributed (the port's
counterpart of drivescenegen_tpu/parallel/mesh.py).

The mesh has the JAX package's two axes, ("data", "model"). Each rank is
one process on one device, started by torchrun (RANK, WORLD_SIZE and
LOCAL_RANK in its environment). Ranks are laid out as the JAX module lays
out its devices, reshape(data, model): rank = d * model + m, so the ranks
of one model group are neighbours. The global batch is split over the
data axis: data coordinate d holds rows [d * B / D, (d + 1) * B / D) of
it, and every rank of its model group holds the same rows. Gradients are
averaged over the data group with one coalesced all_reduce per step
(all_reduce_mean_).

The model axis is Megatron tensor parallelism, by the JAX module's rules
(DEFAULT_TP_RULES, param_shardings): column-parallel layers shard their
outputs, row-parallel layers their inputs, followed by one all_reduce
(reduce_from_model). What GSPMD does from sharding annotations, the port
does by hand with the two autograd Functions copy_to_model and
reduce_from_model (models/unet2d.py uses them). The port splits whole
blocks where GSPMD splits tensor by tensor, so tp_plan replicates a whole
ResnetBlock, the attention or the time MLP when one of its sharded
tensors does not divide the model axis, and a block whose GroupNorm
groups or attention heads do not divide it; the numbers do not change.

With none of torchrun's variables set the mesh is one rank with no
process group, and every caller runs exactly its one-process path.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from drivescenegen_torch.config import MeshConfig
from drivescenegen_torch.utils.device import resolve_device


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
    # The ranks of this rank's data group (same model index) and model
    # group (same data index); None is the default group, the whole world,
    # which the data group is when the model axis is 1.
    data_group: Optional[object] = None
    model_group: Optional[object] = None

    @property
    def is_main(self) -> bool:
        return self.rank == 0

    @property
    def data_index(self) -> int:
        return self.rank // self.shape["model"]

    @property
    def model_index(self) -> int:
        return self.rank % self.shape["model"]

    def rows(self, batch: int) -> slice:
        """This rank's rows of a global batch of `batch` (batch_sharding):
        those of its data coordinate."""
        n = self.shape["data"]
        if batch % n:
            raise ValueError(f"global batch {batch} is not divisible by the data axis {n}")
        per = batch // n
        return slice(self.data_index * per, (self.data_index + 1) * per)

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


def make_mesh(cfg: Optional[MeshConfig] = None, device="cuda",
              backend: Optional[str] = None) -> Mesh:
    """The mesh of this process. Under torchrun it initializes the process
    group over `backend`, by default NCCL on CUDA and gloo on the CPU. On
    CUDA the rank runs on cuda:LOCAL_RANK, or on the device `device` names
    when it carries an index (set as the current device before any kernel
    runs: the kernels keep per-device state). The data axis -1 means the
    world over the model axis. Raises ValueError when data x model is not
    the world size."""
    cfg = cfg or MeshConfig()
    model = max(1, cfg.model)
    device = resolve_device(device)
    env = [os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK")]
    distributed = any(v is not None for v in env)
    if distributed:
        if None in env:
            raise RuntimeError("RANK, WORLD_SIZE and LOCAL_RANK must all be set (torchrun sets "
                               "them)")
        rank, world, local_rank = (int(v) for v in env)
    else:
        rank, world, local_rank = 0, 1, 0
    if cfg.data <= 0 and world % model:
        raise ValueError(f"the model axis {model} does not divide the world of {world} "
                         f"process(es)")
    data = cfg.data if cfg.data > 0 else world // model
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} needs {data * model} processes, the world has "
                         f"{world}")
    data_group = model_group = None
    if distributed:
        if device.type == "cuda":
            device = device if device.index is not None else torch.device("cuda", local_rank)
            torch.cuda.set_device(device)
        if not torch.distributed.is_initialized():
            torch.distributed.init_process_group(
                backend or ("nccl" if device.type == "cuda" else "gloo"), init_method="env://",
                rank=rank, world_size=world)
        if model > 1:
            # Every rank creates every group, in the same order.
            for m in range(model):
                g = torch.distributed.new_group([d * model + m for d in range(data)])
                if rank % model == m:
                    data_group = g
            for d in range(data):
                g = torch.distributed.new_group([d * model + m for m in range(model)])
                if rank // model == d:
                    model_group = g
    return Mesh({"data": data, "model": model}, rank, world, device, distributed, data_group,
                model_group)


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows [d * B / D, (d + 1) * B / D) of a global batch of B,
    d its data coordinate."""
    return mesh.rows(batch)


def shard_batch(mesh: Mesh, batch) -> torch.Tensor:
    """This rank's rows of a host (numpy) or device global batch, on the
    rank's device."""
    return torch.as_tensor(batch[mesh.rows(len(batch))]).to(mesh.device)


def replicated(mesh: Mesh, array) -> torch.Tensor:
    """The full array on this rank's device, as on every rank."""
    return torch.as_tensor(array).to(mesh.device)


def _all_reduce_coalesced(tensors: List[torch.Tensor], group) -> List[torch.Tensor]:
    """The sums of `tensors` over `group`, by one all_reduce of their
    concatenation, as views of it."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    torch.distributed.all_reduce(flat, group=group)
    return [f.view(t.shape) for f, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


def all_reduce_mean_(tensors: List[torch.Tensor], mesh: Optional[Mesh]) -> None:
    """Average `tensors` over the data axis in place: one all_reduce of
    their concatenation over the data group, then each divided by the
    data axis. Nothing to do without a process group."""
    if mesh is None or not mesh.distributed:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    torch.distributed.all_reduce(flat, group=mesh.data_group)
    flat /= mesh.shape["data"]
    torch._foreach_copy_(tensors, [f.view_as(t) for f, t in
                                   zip(flat.split([t.numel() for t in tensors]), tensors)])


# ---------------------------------------------------------------- tensor parallelism


@dataclass(frozen=True)
class ModelAxis:
    """What a sharded layer needs of the mesh: the model axis's size, this
    rank's index on it, and the model group."""

    size: int
    index: int
    group: Optional[object]


def model_axis(mesh: Optional[Mesh]) -> Optional[ModelAxis]:
    """The mesh's model axis, or None when it is 1 (nothing sharded)."""
    if mesh is None or mesh.shape["model"] == 1:
        return None
    if not mesh.distributed:
        raise ValueError(f"a model axis of {mesh.shape['model']} needs a process group "
                         "(torchrun)")
    return ModelAxis(mesh.shape["model"], mesh.model_index, mesh.model_group)


class _CopyToModel(torch.autograd.Function):
    """The identity forward; backward, the gradients summed over the model
    group (one coalesced all_reduce: the tensors share a dtype)."""

    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        return (None, *_all_reduce_coalesced(list(grads), ctx.group))


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group forward (all_reduce); the identity
    backward."""

    @staticmethod
    def forward(ctx, group, x):
        out = x.clone(memory_format=torch.contiguous_format)
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return None, grad


def copy_to_model(axis: ModelAxis, *xs: torch.Tensor):
    """The inputs of column-parallel layers (of one dtype), as they are;
    their gradients summed over the model group in one all_reduce. One call
    serves every consumer of its tensors, so each gradient is reduced once.
    Returns a tuple of as many tensors as it takes."""
    return _CopyToModel.apply(axis.group, *xs)


def reduce_from_model(axis: ModelAxis, x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of the partial outputs of a
    row-parallel layer, in x's dtype (GSPMD's psum on the bf16 conv
    output); its gradient passes through."""
    return _ReduceFromModel.apply(axis.group, x)


# Tensor-parallel rules: (flax path regex, sharded dimension in the flax
# layout, as an index of the leaf's shape). The same regexes on the same
# "/"-joined flax paths as drivescenegen_tpu/parallel/mesh.py
# DEFAULT_TP_RULES, whose PartitionSpecs name these dimensions: kernels are
# (in, out) for Dense and (kh, kw, in, out) for Conv, so -1 is the output
# (column-parallel) and -2 the input (row-parallel); biases and norm
# vectors shard dimension 0. tp_plan maps each onto the torch layout
# through models/convert.py's transposes (OIHW, [O, I]), so one table
# serves both layouts.
#
# The fused qkv is split by heads in the port: rank r takes its heads' rows
# of q, of k and of v (Split.parts = 3), so the attention kernel runs on
# heads / tp heads. JAX splits the 3C columns contiguously and lets GSPMD
# reshard; the numbers are the same, the layout of a shard differs.
DEFAULT_TP_RULES: List[Tuple[str, int]] = [
    # Mid-block attention: fused qkv projection -> column parallel.
    (r"attn.*/(query|key|value|qkv)/kernel$", -1),
    (r"attn.*/(query|key|value|qkv)/bias$", 0),
    # Attention output projection -> row parallel.
    (r"attn.*/proj_out/kernel$", -2),
    # Time-embedding MLP: up column-parallel, down row-parallel.
    (r"time_mlp/dense1/kernel$", -1),
    (r"time_mlp/dense1/bias$", 0),
    (r"time_mlp/dense2/kernel$", -2),
    # ResnetBlock conv pair: conv1 column-parallel ...
    (r"res_\d+/conv1/kernel$", -1),
    (r"res_\d+/conv1/bias$", 0),
    (r"res_\d+/time_proj/kernel$", 1),
    (r"res_\d+/time_proj/bias$", 0),
    (r"res_\d+/norm2/(scale|bias)$", 0),
    # ... conv2 and shortcut row-parallel (one all_reduce after).
    (r"res_\d+/conv2/kernel$", -2),
    (r"res_\d+/shortcut/kernel$", -2),
]

logger = logging.getLogger("parallel")


def _flatten(tree: Mapping, prefix: str = "") -> Dict[str, object]:
    flat = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            flat.update(_flatten(v, key))
        else:
            flat[key] = v
    return flat


def _shape(leaf) -> Optional[Tuple[int, ...]]:
    if isinstance(leaf, (tuple, list, torch.Size)):
        return tuple(leaf)
    shape = getattr(leaf, "shape", None)
    return None if shape is None else tuple(shape)


def _block(path: str) -> str:
    """The module a rule's parameter belongs to: its path without the
    layer and leaf names (".../down_0_res_0" of ".../conv1/kernel")."""
    return "/".join(path.split("/")[:-2])


def param_shardings(params: Mapping, mesh, rules=None, cfg=None) -> Dict[str, Optional[int]]:
    """The sharded dimension of every parameter in the flax layout, by its
    "/"-joined flax path: an int, or None for a replicated parameter.
    `params` is a flax tree (nested dicts) or its flat form; its leaves
    are arrays or shapes. `mesh` is a Mesh or the model axis's size.

    As the JAX module's: with a model axis of 1 everything is replicated,
    and a parameter whose sharded dimension does not divide the model axis
    stays replicated, named in one warning on logger "parallel". The port
    splits by whole blocks, so a block with such a parameter is replicated
    whole; given the ModelConfig `cfg`, so is a ResnetBlock whose GroupNorm
    groups, or an attention whose heads, do not divide the model axis (a
    group would straddle two shards, or a head). The same warning names
    those parameters."""
    rules = DEFAULT_TP_RULES if rules is None else rules
    model = mesh if isinstance(mesh, int) else mesh.shape.get("model", 1)
    flat = {k: _shape(v) for k, v in _flatten(params).items()}
    specs: Dict[str, Optional[int]] = {k: None for k in flat}
    if model == 1:
        return specs
    for key, shape in flat.items():
        if shape is None:
            continue
        for pattern, dim in rules:
            if re.search(pattern, key):
                specs[key] = dim % len(shape)
                break
    falls = {k for k, d in specs.items() if d is not None and flat[k][d] % model}
    bad_blocks = {_block(k) for k in falls}
    if cfg is not None:
        for key, dim in specs.items():
            name = _block(key).split("/")[-1]
            if dim is None:
                continue
            if re.search(r"res_\d+$", name) and cfg.norm_num_groups % model:
                bad_blocks.add(_block(key))
            if "attn" in name and re.search(r"/qkv/kernel$", key):
                channels = flat[key][dim] // 3
                if max(1, channels // cfg.attention_head_dim) % model:
                    bad_blocks.add(_block(key))
    fallbacks = [k for k, d in specs.items() if d is not None and _block(k) in bad_blocks]
    for key in fallbacks:
        specs[key] = None
    if fallbacks:
        # A silent fallback is a perf cliff on a real TP mesh: the param is
        # replicated and its product runs unsharded on every model rank.
        logger.warning(
            "TP: %d param(s) matched a shard rule but do not divide the model axis (%d), or "
            "share a block with one that does not or whose GroupNorm groups or attention heads "
            "do not; replicating them: %s", len(fallbacks), model,
            ", ".join(f"{k}{flat[k]}" for k in fallbacks))
    return specs


@dataclass(frozen=True)
class Split:
    """How a torch parameter is cut over the model axis: along `dim`,
    viewed as `parts` equal parts of which each rank takes its slice (3
    for the fused qkv, split by heads within q, k and v)."""

    dim: int
    parts: int = 1

    def take(self, t: torch.Tensor, index: int, size: int) -> torch.Tensor:
        """Shard `index` of `size` of the full tensor t."""
        n = t.shape[self.dim]
        u = t.unflatten(self.dim, (self.parts, n // self.parts))
        return u.chunk(size, dim=self.dim + 1)[index].flatten(self.dim, self.dim + 1)

    def join(self, shards: List[torch.Tensor]) -> torch.Tensor:
        """The full tensor of its shards in rank order (take's inverse)."""
        us = [s.unflatten(self.dim, (self.parts, s.shape[self.dim] // self.parts))
              for s in shards]
        return torch.cat(us, dim=self.dim + 1).flatten(self.dim, self.dim + 1)


def tp_plan(shapes: Mapping[str, Tuple[int, ...]], model: int, cfg) -> Dict[str, Split]:
    """The Split of every sharded parameter of a UNet2D state dict, by its
    torch name, from its full `shapes` and its ModelConfig (param_shardings
    on the flax paths, each dimension mapped through the torch layout).
    Empty for a model axis of 1."""
    # models/ imports this module: convert's mapping is taken at call time.
    from drivescenegen_torch.models.convert import flax_path

    if model == 1:
        return {}
    paths = {}
    for name, shape in shapes.items():
        path, perm = flax_path(name, len(shape))
        paths[path] = (name, perm, tuple(shape[p] for p in perm))
    specs = param_shardings({p: s for p, (_, _, s) in paths.items()}, model, cfg=cfg)
    plan = {}
    for path, dim in specs.items():
        if dim is not None:
            name, perm, _ = paths[path]
            plan[name] = Split(perm[dim], 3 if "/qkv/" in path else 1)
    return plan


def shard_state_dict(full: Mapping[str, torch.Tensor], mesh: Mesh,
                     plan: Mapping[str, Split]) -> Dict[str, torch.Tensor]:
    """This rank's shards of a full state dict (the flax tree's names, the
    torch layout; models/convert.py flax_to_torch gives one): the sharded
    parameters of `plan` cut to the rank's slice, the rest as they are."""
    m = mesh.shape["model"]
    return {k: plan[k].take(v, mesh.model_index, m).contiguous() if k in plan else v
            for k, v in full.items()}


def gather_state_dict(local: Mapping[str, torch.Tensor], mesh: Mesh,
                      plan: Mapping[str, Split]) -> Dict[str, torch.Tensor]:
    """The full state dict of the rank's shards (shard_state_dict's
    inverse), on every rank of the model group: an all_gather over it for
    each sharded parameter. A collective: every rank of the model group
    calls it."""
    out = dict(local)
    if mesh.shape["model"] == 1:
        return out
    for k, split in plan.items():
        if k not in local:
            continue
        v = local[k].contiguous()
        shards = [torch.empty_like(v) for _ in range(mesh.shape["model"])]
        torch.distributed.all_gather(shards, v, group=mesh.model_group)
        out[k] = split.join(shards)
    return out
