"""Wrapper of the CUDA distance-suppression kernel (``csrc/distance_nms.cu``).

Counterpart of ``bpm_analysis_tpu/ops/find_peaks.py``'s ``_select_by_distance``,
an XLA ``lax.while_loop`` (not a Pallas kernel): the keep mask of the peak
finders' greedy keep-highest suppression by distance, for each row of a
(B, cap) batch of candidates, with every round on the card in one launch a
call, inside the span ``bpm.nms`` (and ``bpm.scratch`` where the rows take
global scratch).  ``ops/find_peaks._select_by_distance``
calls it for CUDA tensors and runs the plain version,
``_select_by_distance_plain``, for CPU ones.

A block holds a row's slots in shared memory, 9 bytes a slot, up to
``SHARED_BYTES // SLOT_BYTES`` (25,713) slots; :func:`plan` splits a wider
row over a cluster of up to :data:`MAX_SPLIT` blocks and, past that, puts
it in a global scratch region of its one block.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ...kernels import build
from ...utils.profiling import span, span_if

LIBRARY = build.Library(
    "distance_nms",
    # positions, priority, valid, row_distance, distance, B, cap, reach, split, chunk,
    # scratch, keep
    {f"distance_nms_{suffix}": [build.PTR, build.PTR, build.PTR, build.PTR, ctypes.c_float,
                                build.I32, build.I32, build.I32, build.I32, build.I32,
                                build.PTR, build.PTR]
     for suffix in ("f32", "f64")},
    queries={"distance_nms_scratch_row": ([build.I32], ctypes.c_longlong)})

SLOT_BYTES = 9                 # csrc kSlotBytes: key, position, state
SHARED_BYTES = 232_448 - 1024  # a block's opt-in shared memory, less room for its static part
MAX_SPLIT = 8                  # csrc kMaxSplit: the largest portable cluster
POSITION_LIMIT = 1 << 24       # float32 holds every integer position below it


class Plan(NamedTuple):
    split: int      # blocks that share a row (a cluster when above 1)
    chunk: int      # slots each block holds
    scratch: bool   # the row lives in global scratch (split 1)


def plan(cap: int) -> Plan:
    """How the kernel holds a row of ``cap`` slots: in one block's shared
    memory where it fits, split over the fewest blocks of a cluster whose
    shared memory holds it, else in global scratch."""
    split = max(1, -(-cap // (SHARED_BYTES // SLOT_BYTES)))
    if split > MAX_SPLIT:
        return Plan(1, cap, True)
    return Plan(split, -(-cap // split), False)


def check_inputs(positions: torch.Tensor, priority: torch.Tensor, valid: torch.Tensor,
                 distance, length: int) -> None:
    """Raise ``ValueError`` unless ``positions`` is a contiguous (B, cap)
    int64 tensor, ``priority`` a contiguous float32 or float64 tensor and
    ``valid`` a contiguous bool tensor of its shape on its device,
    ``distance`` a number or a contiguous (B,) float32 tensor there, and
    every position, below ``length``, is below 2^24."""
    if positions.dim() != 2:
        raise ValueError(f"positions: expected (B, cap), got {tuple(positions.shape)}")
    device, shape = positions.device, positions.shape
    build.check_tensor("positions", positions, torch.int64, shape, device)
    if priority.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"priority: expected float32 or float64, got {priority.dtype}")
    build.check_tensor("priority", priority, priority.dtype, shape, device)
    build.check_tensor("valid", valid, torch.bool, shape, device)
    if isinstance(distance, torch.Tensor):
        build.check_tensor("distance", distance, torch.float32, shape[:1], device)
    elif not isinstance(distance, (int, float)):
        raise ValueError(f"distance: expected a number or a tensor, got {type(distance)}")
    if length > POSITION_LIMIT:
        raise ValueError(f"positions up to {length - 1} reach 2^24, past float32's integers")


def select_by_distance(positions: torch.Tensor, priority: torch.Tensor, valid: torch.Tensor,
                       distance, reach: int, length: int) -> torch.Tensor:
    """(B, cap) bool: the slots of each row that the greedy keep-highest
    suppression keeps, ``keep & valid``.  ``positions`` (B, cap) int64,
    sorted ascending over the valid slots, which form each row's prefix,
    and below ``length`` (at most 2^24); ``priority`` float32 or float64,
    compared in float32; ``distance`` a number (by value) or a (B,) float32
    CUDA tensor, each rounded up to an integer; ``reach`` the slots a window
    spans at most on each side.  One launch, no host read."""
    check_inputs(positions, priority, valid, distance, length)
    device = positions.device
    if device.type != "cuda":
        raise ValueError(f"expected CUDA tensors, got ones on {device}")
    bsz, cap = positions.shape
    if bsz > 65535 or reach < 0:
        raise ValueError(f"unsupported batch {bsz} or reach {reach}")
    keep = torch.empty((bsz, cap), dtype=torch.bool, device=device)
    if bsz == 0 or cap == 0:
        return keep
    split, chunk, in_scratch = plan(cap)
    scratch = None
    if in_scratch:
        row = LIBRARY.load().distance_nms_scratch_row(chunk)
        scratch = torch.empty(bsz * row, dtype=torch.uint8, device=device)
    per_row = isinstance(distance, torch.Tensor)
    entry = "distance_nms_f32" if priority.dtype == torch.float32 else "distance_nms_f64"
    with span("bpm.nms"), span_if(in_scratch, "bpm.scratch"):
        LIBRARY.launch(entry, device, positions.data_ptr(), priority.data_ptr(),
                       valid.data_ptr(), distance.data_ptr() if per_row else None,
                       0.0 if per_row else float(distance), bsz, cap, min(reach, cap), split,
                       chunk, None if scratch is None else scratch.data_ptr(),
                       keep.data_ptr())
    return keep
