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
"""

from __future__ import annotations

import os
import re
from typing import Dict, Optional

import torch

from drivescenegen_torch.models.convert import save_npz, torch_to_flax
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


def save_checkpoint(directory: str, state: TrainState, max_to_keep: int = 3) -> str:
    """Write the state at its step (atomically: a temp file, then a
    rename), then delete all but the newest max_to_keep checkpoints."""
    os.makedirs(directory, exist_ok=True)
    path = checkpoint_path(directory, state.step)
    payload = {"params": state.model.state_dict(), "opt_state": state.optimizer.state_dict(),
               "step": state.step}
    if state.ema_params is not None:
        payload["ema_params"] = state.ema_params
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    for step in _steps(directory)[:-max_to_keep]:
        os.remove(checkpoint_path(directory, step))
    return path


def restore_checkpoint(directory: str, state: TrainState) -> TrainState:
    """Load the latest checkpoint into `state` (its model, optimizer, step
    and EMA) and return it. A checkpoint without EMA seeds the EMA from its
    params when the state keeps one."""
    step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoint found under {directory}")
    device = next(state.model.parameters()).device
    payload = torch.load(checkpoint_path(directory, step), map_location=device)
    state.model.load_state_dict(payload["params"])
    state.optimizer.load_state_dict(payload["opt_state"])
    state.step = int(payload["step"])
    if state.ema_params is not None:
        ema = payload.get("ema_params") or payload["params"]
        for name, value in state.ema_params.items():
            value.copy_(ema[name])
    return state


def save_params_only(directory: str, params: Dict[str, torch.Tensor]) -> str:
    """Export weights for sampling: <directory>/params.npz in the flat flax
    layout (models/convert.py torch_to_flax + save_npz)."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "params.npz")
    tmp = os.path.join(directory, f"params.{os.getpid()}.tmp.npz")
    save_npz(tmp, torch_to_flax(params))
    os.replace(tmp, path)
    return path
