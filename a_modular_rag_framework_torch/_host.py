"""Device helpers shared by the port: host-array upload and device
validation."""
from __future__ import annotations

import numpy as np
import torch


def to_device(a: np.ndarray, device, *, non_blocking: bool = False
              ) -> torch.Tensor:
    """Upload a host array; read-only (memory-mapped) arrays are copied
    first, so no tensor ever aliases a read-only mapping.

    ``non_blocking=True`` stages a CUDA upload through pinned memory and
    queues it on the current stream: a plain copy from pageable memory
    waits for everything already queued, which would serialize a batch's
    host prep behind the previous batch's device program."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:
        a = a.copy()
    t = torch.from_numpy(a)
    if non_blocking and torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def upload_batch(batch, device) -> dict:
    """A dict of host arrays (a trainer's batch) as tensors on ``device``,
    staged through pinned memory and queued on the current stream."""
    return {k: to_device(v, device, non_blocking=True)
            for k, v in batch.items()}


def require_device(device) -> torch.device:
    """Validate a device argument ('cpu', 'cuda' or 'cuda:i'); 'cuda'
    resolves to the current CUDA device and raises where CUDA is absent."""
    if device is None:
        raise TypeError("an explicit device ('cpu' or 'cuda[:i]') is required")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev} (expected cpu or cuda)")
    return dev
