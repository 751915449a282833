"""The device rule every entry point of the port follows: the card unless the
caller names another device, and an error where the card is asked for and
there is none. Nothing falls back to the CPU silently."""

from __future__ import annotations

import torch


def run_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``. Raises
    ``RuntimeError`` when it names a CUDA device and none is present: the
    CPU runs only when it is asked for."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} asked for, but no CUDA device is present; "
                           "pass device=cpu to run on the CPU")
    return device
