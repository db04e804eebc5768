"""Device resolution for the port's entry points.

Every entry point takes ``device=None`` and resolves it here: ``None``
means the CUDA device, and a CUDA request with no CUDA device raises.
There is no "CUDA if available, else CPU" policy: callers that want the
CPU (the tests) ask for it.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch


class DeviceUnavailable(RuntimeError):
    """A CUDA device was requested (explicitly or by default) and none
    is present."""


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceUnavailable(
            "no CUDA device: pass device='cpu' to run on the host"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device`` without a host sync. On CUDA it goes
    through a fresh pinned buffer and a non-blocking copy on the current
    stream: a copy from pageable memory synchronizes the stream, so a
    search would wait for every kernel queued before it. The buffer comes
    from PyTorch's caching host allocator, which records the copy's event
    on it and hands it out again only after the copy has completed. On
    the CPU the tensor shares the array's memory."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)
