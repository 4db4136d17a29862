"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """`None` means the card. A CUDA device that is not there raises: no
    entry point falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "senas_torch: a CUDA device was asked for (device=None means "
            "'cuda') but torch.cuda.is_available() is False; pass "
            "device='cpu' to run the plain PyTorch versions on the CPU")
    return dev
