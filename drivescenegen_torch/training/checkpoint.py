"""Checkpoints of the full training state, and the params.npz export
(port of drivescenegen_tpu/training/checkpoint.py, which uses orbax).

A checkpoint is <directory>/step_<NNNNNNNN>.pt, a torch.save of the
params, the optimizer state, the step and the EMA; the newest
`max_to_keep` are kept, so a resume continues the exact run. The weights
for sampling are exported as <output_dir>/params.npz, the flat flax tree
(models/convert.py), which the port's generation CLI reads. The JAX
package's generation CLI reads only orbax <model_dir>/params
(drivescenegen_tpu/scripts/generation.py:68-74), so weights do not pass
between the two packages' CLIs without a conversion that neither package
holds yet.

Under data parallelism (parallel/mesh.py) every rank holds the same state;
given the mesh, only rank 0 writes, and every rank then waits at a
barrier, so no rank reads a file before it is whole. The state dict is the
unwrapped model's (no DDP "module." prefix). restore_params is the warm
start of the train CLI's --init_from: params and EMA only.

A checkpoint holds the full model whatever the model axis: under tensor
parallelism the params, the EMA and AdamW's moments are gathered from the
model group's shards before rank 0 writes them (a collective: every rank
calls save_checkpoint), and a restore cuts them to the rank's shards. So a
run at one tp resumes at another, and params.npz is the same.
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from drivescenegen_torch.models.convert import save_npz, torch_to_flax
from drivescenegen_torch.parallel.mesh import Mesh, gather_state_dict, shard_state_dict
from drivescenegen_torch.training.trainer import TrainState

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}.pt")


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


_MOMENTS = ("exp_avg", "exp_avg_sq")


def _param_names(state: TrainState):
    """The state-dict name of each optimizer parameter, by its index in the
    optimizer's state dict."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    return [names[id(p)] for group in state.optimizer.param_groups for p in group["params"]]


def _map_moments(opt_state: dict, names, plan, fn) -> dict:
    """The optimizer state dict with fn({name: moment}) applied to the
    moments of the parameters `plan` shards; the live state untouched."""
    out = dict(opt_state, state={})
    for idx, st in opt_state["state"].items():
        st = dict(st)
        name = names[idx]
        if name in plan:
            for key in _MOMENTS:
                st[key] = fn({name: st[key]})[name]
        out["state"][idx] = st
    return out


def full_params(state: TrainState, mesh: Optional[Mesh], ema: bool = False
                ) -> Dict[str, torch.Tensor]:
    """The whole model's params (the EMA with ema=True), gathered from the
    model group's shards under tensor parallelism: a collective then."""
    params = state.ema_params if ema else state.model.state_dict()
    plan = state.model.tp_plan
    return gather_state_dict(params, mesh, plan) if plan else dict(params)


def save_checkpoint(directory: str, state: TrainState, max_to_keep: int = 3,
                    mesh: Optional[Mesh] = None) -> str:
    """Write the state at its step (atomically: a temp file, then a
    rename), then delete all but the newest max_to_keep checkpoints. Given
    a mesh, rank 0 writes and every rank waits for it; under tensor
    parallelism every rank first takes part in gathering the full state."""
    path = checkpoint_path(directory, state.step)
    plan = state.model.tp_plan
    opt_state = state.optimizer.state_dict()
    if plan:
        opt_state = _map_moments(opt_state, _param_names(state), plan,
                                 lambda d: gather_state_dict(d, mesh, plan))
    payload = {"params": full_params(state, mesh), "opt_state": opt_state, "step": state.step}
    if state.ema_params is not None:
        payload["ema_params"] = full_params(state, mesh, ema=True)
    if mesh is None or mesh.is_main:
        os.makedirs(directory, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
        for step in _steps(directory)[:-max_to_keep]:
            os.remove(checkpoint_path(directory, step))
    if mesh is not None:
        mesh.barrier()
    return path


def _load_latest(directory: str, state: TrainState, mesh: Optional[Mesh]) -> dict:
    """The latest checkpoint, its params and EMA cut to this rank's shards
    under tensor parallelism."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    device = next(state.model.parameters()).device
    payload = torch.load(checkpoint_path(directory, step), map_location=device)
    plan = state.model.tp_plan
    if plan:
        for key in ("params", "ema_params"):
            if payload.get(key) is not None:
                payload[key] = shard_state_dict(payload[key], mesh, plan)
    return payload


def _restore_ema(state: TrainState, payload: dict) -> None:
    """The EMA from the payload, seeded from its params when it has none."""
    if state.ema_params is not None:
        ema = payload.get("ema_params") or payload["params"]
        for name, value in state.ema_params.items():
            value.copy_(ema[name])


def restore_checkpoint(directory: str, state: TrainState, mesh: Optional[Mesh] = None
                       ) -> TrainState:
    """Load the latest checkpoint into `state` (its model, optimizer, step
    and EMA) and return it; under tensor parallelism (a model built on
    `mesh`) this rank's shards of it. A checkpoint without EMA seeds the
    EMA from its params when the state keeps one."""
    payload = _load_latest(directory, state, mesh)
    state.model.load_state_dict(payload["params"])
    opt_state, plan = payload["opt_state"], state.model.tp_plan
    if plan:
        opt_state = _map_moments(opt_state, _param_names(state), plan,
                                 lambda d: shard_state_dict(d, mesh, plan))
    state.optimizer.load_state_dict(opt_state)
    state.step = int(payload["step"])
    _restore_ema(state, payload)
    return state


def restore_params(directory: str, state: TrainState, mesh: Optional[Mesh] = None) -> int:
    """Warm start (drivescenegen_tpu/scripts/train.py:288-307): load the
    latest checkpoint's params, and its EMA (seeded from its params when
    the donor has none), into `state`, cut to this rank's shards under
    tensor parallelism; its optimizer, step and schedule stay fresh.
    Returns the donor's step."""
    payload = _load_latest(directory, state, mesh)
    state.model.load_state_dict(payload["params"])
    _restore_ema(state, payload)
    return int(payload["step"])


def save_params_only(directory: str, params: Dict[str, torch.Tensor],
                     mesh: Optional[Mesh] = None) -> str:
    """Export weights for sampling: <directory>/params.npz in the flat flax
    layout (models/convert.py torch_to_flax + save_npz), of the whole model
    (full_params under tensor parallelism). Given a mesh, rank 0 writes and
    every rank waits for it."""
    path = os.path.join(directory, "params.npz")
    if mesh is None or mesh.is_main:
        os.makedirs(directory, exist_ok=True)
        tmp = os.path.join(directory, f"params.{os.getpid()}.tmp.npz")
        save_npz(tmp, torch_to_flax(params))
        os.replace(tmp, path)
    if mesh is not None:
        mesh.barrier()
    return path
