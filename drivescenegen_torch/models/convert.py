"""Weights carried between the flax parameter tree and the port's UNet2D.

The flax tree is handled flat: keys are its "/"-joined paths
("params/down_0_res_0/conv1/kernel"), values numpy arrays, as
flax.traverse_util.flatten_dict(params, sep="/") gives them and as
`<model_dir>/params.npz` stores them. The torch keys are the same paths
joined with "." under the same module names. Conventions (the inverse of
drivescenegen_tpu/models/import_diffusers.py:118-):

  conv kernel  HWIO [kh, kw, I, O]  <->  weight OIHW [O, I, kh, kw]
  dense kernel [I, O]               <->  weight [O, I]   (qkv stays fused)
  norm scale   [C]                  <->  weight [C]
  bias                              <->  bias
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from drivescenegen_torch.config import ModelConfig
from drivescenegen_torch.models.unet2d import UNet2D


def _leaf_to_torch(leaf: str, arr: np.ndarray):
    if leaf == "kernel" and arr.ndim == 4:
        return "weight", arr.transpose(3, 2, 0, 1)
    if leaf == "kernel" and arr.ndim == 2:
        return "weight", arr.T
    if leaf == "scale" and arr.ndim == 1:
        return "weight", arr
    if leaf == "bias" and arr.ndim == 1:
        return "bias", arr
    return None, None


def flax_to_torch(flat: Dict[str, np.ndarray], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Map the flat flax tree onto UNet2D(cfg)'s state dict. Every key must
    be consumed and every torch parameter filled, with matching shapes;
    anything else raises."""
    expected = UNet2D(cfg, device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}
    leftover = []
    for key, value in flat.items():
        parts = key.split("/")
        name, arr = (None, None)
        if len(parts) >= 3 and parts[0] == "params":
            name, arr = _leaf_to_torch(parts[-1], np.asarray(value))
        tkey = ".".join(parts[1:-1] + [name]) if name else None
        if tkey not in expected:
            leftover.append(key)
            continue
        if tuple(arr.shape) != tuple(expected[tkey].shape):
            raise ValueError(f"{key}: shape {tuple(np.shape(value))} does not give "
                             f"{tkey} {tuple(expected[tkey].shape)}")
        out[tkey] = torch.from_numpy(np.array(arr, dtype=np.float32))  # a writable copy
    if leftover:
        raise ValueError(f"{len(leftover)} flax keys were not consumed by the mapping "
                         f"(architecture drift?): {sorted(leftover)[:8]}")
    missing = sorted(set(expected) - set(out))
    if missing:
        raise KeyError(f"the flax tree lacks {len(missing)} parameters: {missing[:8]}")
    return out


def flax_path(key: str, ndim: int) -> Tuple[str, Tuple[int, ...]]:
    """The flax path of the state-dict key `key` of an `ndim`-dimensional
    parameter, and the permutation from the torch layout to flax's: flax
    dimension d is torch dimension perm[d]."""
    *mods, leaf = key.split(".")
    if leaf == "bias":
        name, perm = "bias", (0,)
    elif ndim == 4:
        name, perm = "kernel", (2, 3, 1, 0)
    elif ndim == 2:
        name, perm = "kernel", (1, 0)
    else:
        name, perm = "scale", (0,)
    return "/".join(["params", *mods, name]), perm


def torch_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of flax_to_torch: the flat flax tree of a state dict."""
    flat: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        path, perm = flax_path(key, arr.ndim)
        flat[path] = np.ascontiguousarray(arr.transpose(perm))
    return flat


def save_npz(path: str, flat: Dict[str, np.ndarray]) -> None:
    np.savez(path, **flat)


def load_npz(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}
