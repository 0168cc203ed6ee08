"""The device an entry point runs on."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """torch.device(device), raising when CUDA is asked for and absent:
    an entry point never carries on quietly on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for but no CUDA device is available; "
                           "pass device='cpu' to run the plain versions on the CPU")
    return device
