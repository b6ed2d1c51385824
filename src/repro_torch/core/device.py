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


def resolve_devices(device=None, n_shards: int = 1) -> list[torch.device]:
    """One torch.device per shard of a pool of `n_shards` shards.

    device: one device, which then holds every shard (the CPU here, or
    one card); a sequence of `n_shards` devices, shard k on entry k
    (entries may repeat); or None, shard k on cuda:k, which needs
    n_shards visible CUDA devices and raises otherwise. Nothing moves a
    shard to another device quietly."""
    if isinstance(device, (list, tuple)):
        devs = [torch.device(d) for d in device]
        if len(devs) != n_shards:
            raise ValueError(
                f"device lists {len(devs)} devices for n_shards="
                f"{n_shards}; give one device per shard, or one device "
                "for every shard")
    elif device is not None or n_shards == 1:
        devs = [resolve_device(device)] * n_shards
    else:
        n_dev = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n_shards > n_dev:
            raise ValueError(
                f"Partitioning.n_shards={n_shards} but only {n_dev} CUDA "
                "device(s) are visible; pass device=<one device> (e.g. "
                "'cuda:0') to hold every shard on it, or a list of "
                f"{n_shards} devices to place shard k on entry k")
        devs = [torch.device("cuda", k) for k in range(n_shards)]
    if len({d.type for d in devs}) > 1:
        raise ValueError(
            f"the shards' devices {[str(d) for d in devs]} mix device "
            "types; put every shard on CUDA devices or every shard on "
            "the CPU")
    # an index-less "cuda" is the current device, named, so that shards
    # on one card share its stream, events and tables
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


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
