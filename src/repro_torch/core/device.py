"""Device resolution and host-to-device copies for the port's entry
points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device. None means the CUDA device, and
    raises when there is none: the port never quietly runs on the CPU.
    Pass device="cpu" to ask for the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def to_device(a, device) -> torch.Tensor:
    """numpy `a` as a tensor on `device`, without waiting for the
    device: on the card through a pinned staging buffer and a
    non-blocking copy on the current stream. A copy from pageable host
    memory returns only once the work queued before it has run, which
    would stall a pipeline of queued windows."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
