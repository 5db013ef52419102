"""Device selection for the entry points: CUDA unless the caller asks for
the CPU.  There is no silent fallback — with no card and no explicit
``device="cpu"`` an entry point raises."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """Array-like -> tensor on ``device``, keeping its dtype."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x).to(device)
