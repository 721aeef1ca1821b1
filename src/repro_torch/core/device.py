"""The serving device of the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The port's entry points run on CUDA unless the caller passes a
    device; with no GPU that default raises instead of falling back."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA requested but torch.cuda.is_available() is "
                           "False; pass device='cpu' explicitly to run on "
                           "the CPU")
    return device
