"""The device rule every entry point of the port follows: the card unless the
caller names another device, and an error where the card is asked for and
there is none. Nothing falls back to the CPU silently."""

from __future__ import annotations

import collections
import threading

import numpy as np
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


class HostUploader:
    """Host-to-device copies that leave the host running. On the card each
    array is copied into a pinned buffer and from there with
    ``non_blocking=True`` on the current stream, and the buffer is held
    until that copy's event has completed: a copy from pageable memory
    would wait for the card (and raises under
    ``torch.cuda.set_sync_debug_mode("error")``). On the CPU an array
    becomes a tensor sharing its memory."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()
        self._in_flight = collections.deque()  # (event, pinned buffer), oldest first

    def __call__(self, arr) -> torch.Tensor:
        host = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return host.to(self.device)
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        out = pinned.to(self.device, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        with self._lock:
            while self._in_flight and self._in_flight[0][0].query():
                self._in_flight.popleft()
            self._in_flight.append((done, pinned))
        return out
