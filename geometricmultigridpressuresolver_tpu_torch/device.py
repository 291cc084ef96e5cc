"""The device an entry point builds on when the caller names none.

The port runs on the card: a ``device=None`` that reaches tensor creation
means ``torch.device("cuda")``, and with no card present that raises.  It
never falls back to the CPU quietly; a CPU run says ``device="cpu"``.  A
torch tensor passed in keeps its own device (the caller chose it).
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """`device` as given, else the card; raises when no card is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")


def of(arr, device=None) -> torch.device:
    """Where to put `arr`: `device` if given, a tensor's own device, else
    the card (numpy input and other array-likes)."""
    if device is None and isinstance(arr, torch.Tensor):
        return arr.device
    return resolve(device)
