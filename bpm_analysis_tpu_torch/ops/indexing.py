"""Gathers and scatters with the JAX package's index semantics, made explicit.

JAX normalizes a negative gather index from the end and clamps the rest into
range; a ``mode="drop"`` scatter ignores out-of-range writes.  PyTorch raises
on an out-of-range index on the CPU and hits a device-side assert on CUDA
(which poisons the context), so every gather and scatter of the port goes
through these helpers instead of bare indexing.
"""
from __future__ import annotations

import torch


def take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[b, idx[b, ...]]`` along the last axis of ``x`` (B, n) with JAX
    gather semantics.  ``idx`` has shape (B, ...); a 1-D ``x`` is shared by
    every row."""
    n = x.shape[-1]
    idx = idx.long()
    idx = torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)
    if x.dim() == 1:
        return x[idx]
    flat = idx.reshape(idx.shape[0], -1)
    return torch.gather(x, 1, flat).reshape(idx.shape)


def scatter_drop(size: int, idx: torch.Tensor, src, fill=None,
                 dtype: torch.dtype = None, base: torch.Tensor = None) -> torch.Tensor:
    """``full((B, size), fill).at[b, idx].set(src, mode="drop")``, or
    ``base.at[b, idx].set(src, mode="drop")`` when a (B, size) ``base`` is
    given: writes to indices outside [0, size) are dropped (they land in a
    spare slot that is sliced off).  ``src`` is a tensor shaped like ``idx``
    or a scalar."""
    if base is not None:
        dtype = base.dtype
        buf = torch.cat([base, base[:, :1]], dim=1)
    else:
        buf = torch.full((idx.shape[0], size + 1), fill, dtype=dtype, device=idx.device)
    idx = idx.long()
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    if not isinstance(src, torch.Tensor):
        src = torch.full(idx.shape, src, dtype=dtype, device=idx.device)
    buf.scatter_(1, idx, src.to(dtype))
    return buf[:, :size]


def arange(n: int, like: torch.Tensor, dtype=torch.int64) -> torch.Tensor:
    return torch.arange(n, dtype=dtype, device=like.device)
