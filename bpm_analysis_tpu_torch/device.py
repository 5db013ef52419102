"""Device selection for the entry points: CUDA unless the caller asks for
the CPU.  There is no silent fallback — with no card and no explicit
``device="cpu"`` an entry point raises."""
from __future__ import annotations

import numpy as np
import torch

from .utils.profiling import span, sync


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """Array-like -> tensor on ``device``, keeping its dtype.  A copy from
    the host to a card is the span ``bpm.to_device``."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    x = torch.as_tensor(x)
    if x.device.type == "cpu" and torch.device(device).type != "cpu":
        with span("bpm.to_device"):
            return x.to(device)
    return x.to(device)


def upload(site: str, value, dtype: torch.dtype, device) -> torch.Tensor:
    """``torch.as_tensor(value, dtype=dtype, device=device)`` for a host
    number or array, whose copy to a card waits for the card: the span
    ``bpm.sync.<site>``.  A tensor is converted in place, with no span."""
    if isinstance(value, torch.Tensor) or torch.device(device).type == "cpu":
        return torch.as_tensor(value, dtype=dtype, device=device)
    with sync(site):
        return torch.as_tensor(value, dtype=dtype, device=device)
