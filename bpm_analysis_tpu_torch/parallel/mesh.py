"""Process mesh + sharded batch execution on ``torch.distributed`` — the
port's scaling layer.

Port of ``bpm_analysis_tpu/parallel/mesh.py`` in SPMD form: one process per
rank, each holding the whole program and its own share of the data.

* **dp** — batch data-parallelism: recordings shard across ranks; each rank
  runs the unchanged batched pipeline on its contiguous share, and
  collectives appear only to assemble results (``gather_result``) and for
  the fleet-level reductions (``fleet_summary``).
* **sp** — intra-recording sequence sharding of the convolutional DSP
  front-end on very long recordings (``parallel.seqshard``: blockwise
  windows with halo exchange, and a state relay for the IIR filter).

``make_mesh`` reshapes the ranks of an initialized process group into a
``(dp, sp)`` grid (rank ``d * sp + s`` at ``(d, s)``), as the JAX package
reshapes its devices.  ``spawn`` starts the ranks: NCCL when each rank has a
card of its own, gloo on the CPU and when ranks share one card (NCCL
refuses two ranks on one GPU).  Every exchange goes through
:func:`all_gather` / :func:`all_reduce`: NCCL takes device tensors as they
are; under gloo, whose CUDA support does not cover every collective, a CUDA
tensor travels as a host copy and comes back to the rank's device.  Compute
never leaves the rank's device.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait as _wait_sentinels
from typing import Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import AnalyzerConfig
from ..device import resolve_device
from ..host import tree_map
from ..models import pipeline

# Collective timeout of a spawned rank, how long the other ranks of a world
# get to finish once one rank has failed, and how long a world may run.
RANK_TIMEOUT_S = 600
FAILURE_GRACE_S = 10
WORLD_TIMEOUT_S = 3600

_rank_device: Optional[torch.device] = None   # set by spawn in each rank


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's view of a ``(dp, sp)`` grid of ranks."""
    dp: int
    sp: int
    dp_index: int
    sp_index: int
    dp_group: object       # the ranks of this rank's dp column (same sp_index)
    sp_group: object       # the ranks of this rank's sp row (same dp_index)
    group: object          # every rank of the mesh
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        return self.dp * self.sp

    @property
    def index(self) -> int:
        """This rank's position in the grid, row-major."""
        return self.dp_index * self.sp + self.sp_index


def _new_group(ranks, world: int):
    if len(ranks) == world:
        return dist.group.WORLD
    return dist.new_group(ranks)


def make_mesh(sp: int = 1, group=None) -> Optional[Mesh]:
    """The ``(dp, sp)`` grid over the ranks of ``group`` (default: every
    rank of the initialized default group), ``dp = len(ranks) // sp``.
    ``group`` is a process group or a list of global ranks.

    Every rank of the default group must call this, with the same ranks:
    each dp column and sp row is a ``dist.new_group``, which all ranks enter
    in the same order.  A rank outside the group gets None; it cannot read
    the ranks of a group it is not in, so it passes them as a list.  The
    mesh's device is the one ``spawn`` gave the rank, else the current CUDA
    device (raising without a card)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group (see spawn)")
    world = dist.get_world_size()
    if group is None:
        ranks = list(range(world))
    elif isinstance(group, (list, tuple)):
        ranks = list(group)
    elif group == dist.GroupMember.NON_GROUP_MEMBER:
        raise ValueError("this rank is not in the group: pass its ranks as a list")
    else:
        ranks = list(dist.get_process_group_ranks(group))
    n = len(ranks)
    if sp < 1 or n % sp:
        raise ValueError(f"{n} ranks not divisible by sp={sp}")
    dp = n // sp
    grid = [ranks[d * sp:(d + 1) * sp] for d in range(dp)]
    dp_groups = [_new_group([grid[d][s] for d in range(dp)], world) for s in range(sp)]
    sp_groups = [_new_group(grid[d], world) for d in range(dp)]
    mesh_group = _new_group(ranks, world)
    me = dist.get_rank()
    if me not in ranks:
        return None
    dp_index, sp_index = divmod(ranks.index(me), sp)
    dev = resolve_device(_rank_device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dp, sp, dp_index, sp_index, dp_groups[sp_index], sp_groups[dp_index],
                mesh_group, dev, dist.get_backend(mesh_group))


def _axis(mesh: Mesh, axis: str):
    """(group, size) of a mesh axis, "dp" or "sp"."""
    if axis == "dp":
        return mesh.dp_group, mesh.dp
    if axis == "sp":
        return mesh.sp_group, mesh.sp
    raise ValueError(f"unknown mesh axis {axis!r}")


def _to_wire(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend's collectives take it: contiguous, bool as
    uint8, and under gloo a CUDA tensor as a host copy."""
    w = t.to(torch.uint8) if t.dtype == torch.bool else t
    if mesh.backend == "gloo" and w.device.type == "cuda":
        w = w.cpu()
    return w.contiguous()


def _from_wire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return w.to(device=like.device, dtype=like.dtype)


def all_gather(mesh: Mesh, t: torch.Tensor, axis: str = "dp") -> torch.Tensor:
    """Every rank's ``t`` along a mesh axis, stacked in axis order:
    ``(axis size, *t.shape)`` on ``t``'s device.  Every rank of the axis
    calls it with a tensor of the same shape and dtype."""
    group, n = _axis(mesh, axis)
    w = _to_wire(mesh, t)
    out = [torch.empty_like(w) for _ in range(n)]
    dist.all_gather(out, w, group=group)
    return _from_wire(torch.stack(out), t)


def all_reduce(mesh: Mesh, t: torch.Tensor, op=dist.ReduceOp.SUM,
               axis: str = "dp") -> torch.Tensor:
    """``t`` reduced with ``op`` over a mesh axis, on ``t``'s device."""
    group, _ = _axis(mesh, axis)
    w = _to_wire(mesh, t)
    w = w.clone() if w is t else w
    dist.all_reduce(w, op=op, group=group)
    return _from_wire(w, t)


def all_gather_object(mesh: Mesh, obj) -> list:
    """Every rank's picklable ``obj``, in mesh order."""
    out = [None] * mesh.size
    dist.all_gather_object(out, obj, group=mesh.group)
    return out


def shard_batch(mesh: Mesh, x):
    """This rank's contiguous share of the leading (batch) axis of ``x``;
    the batch size must be divisible by dp."""
    b = x.shape[0]
    if b % mesh.dp:
        raise ValueError(f"batch size {b} not divisible by dp={mesh.dp}")
    per = b // mesh.dp
    return x[mesh.dp_index * per:(mesh.dp_index + 1) * per]


def analyze_batch_sharded(mesh: Mesh, envelopes, sample_rate: int, cfg: AnalyzerConfig,
                          start_bpm_hints=None) -> pipeline.PipelineResult:
    """``pipeline.analyze_batch`` on this rank's share of the batch
    ``envelopes`` (B, n), which every rank passes whole.  B must be
    divisible by dp.  Returns this rank's rows of the PipelineResult, on
    the mesh's device; :func:`gather_result` assembles the whole batch."""
    hints = None if start_bpm_hints is None else shard_batch(mesh, start_bpm_hints)
    return pipeline.analyze_batch(shard_batch(mesh, envelopes), sample_rate, cfg, hints,
                                  device=mesh.device)


def gather_result(mesh: Mesh, result):
    """The whole batch of a sharded result, in row order, on every rank:
    each leaf all-gathered over dp and concatenated."""
    def gather(t):
        g = all_gather(mesh, t, "dp")
        return g.reshape(g.shape[0] * g.shape[1], *g.shape[2:])

    return tree_map(gather, result)


def fleet_summary(mesh: Mesh, result) -> dict:
    """Cross-recording reductions over the dp-sharded batch — the collective
    layer.  The same six numbers as the JAX package's, from this rank's
    partial sums, minima and maxima all-reduced over dp: counts are exact
    integers; the means are reduced sums over reduced counts in the
    result's dtype, so they may differ from a one-device sum in the last
    bits."""
    m = result.metrics
    ok, found = result.ok, m.hrr.found
    dtype = m.avg_bpm.dtype
    zero = torch.zeros((), dtype=dtype, device=ok.device)
    inf = torch.full((), float("inf"), dtype=dtype, device=ok.device)
    sums = torch.stack([torch.where(ok, m.avg_bpm, zero).sum(),
                        torch.where(found, m.hrr.hrr, zero).sum()])
    counts = torch.stack([ok.sum(), found.sum(),
                          torch.where(ok, result.final_count.long(), 0).sum()])
    sums = all_reduce(mesh, sums, dist.ReduceOp.SUM)
    counts = all_reduce(mesh, counts, dist.ReduceOp.SUM)
    lo = all_reduce(mesh, torch.where(ok, m.min_bpm, inf).amin(), dist.ReduceOp.MIN)
    hi = all_reduce(mesh, torch.where(ok, m.max_bpm, -inf).amax(), dist.ReduceOp.MAX)
    n_ok = torch.clamp(counts[0].to(dtype), min=1)
    n_found = torch.clamp(counts[1].to(dtype), min=1)
    return {
        "recordings_ok": int(counts[0]),
        "mean_avg_bpm": float(sums[0] / n_ok),
        "min_bpm": float(lo),
        "max_bpm": float(hi),
        "mean_hrr": float(sums[1] / n_found),
        "total_beats": int(counts[2]),
    }


def _rank_main(rank: int, world: int, backend: str, device: str, init: str, out_dir: str,
               fn, args) -> None:
    """One spawned rank: device, process group, ``fn(*args)``; the outcome
    is pickled to ``out_dir`` for the launcher."""
    global _rank_device
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    _rank_device = dev
    outcome = (False, "the rank did not finish")
    try:
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
        outcome = (True, fn(*args))
    except BaseException:
        outcome = (False, traceback.format_exc())
    finally:
        path = os.path.join(out_dir, f"rank{rank}.pkl")
        try:
            with open(path + ".tmp", "wb") as f:
                pickle.dump(outcome, f)
        except Exception:
            with open(path + ".tmp", "wb") as f:
                pickle.dump((False, traceback.format_exc()), f)
        os.replace(path + ".tmp", path)
        if dist.is_initialized():
            dist.destroy_process_group()
    if not outcome[0]:
        raise SystemExit(1)


def default_backend(world: int, device) -> str:
    """NCCL when each of ``world`` ranks has a card of its own, else gloo."""
    dev = resolve_device(device)
    if dev.type == "cuda" and world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def spawn(fn, world: int, backend: Optional[str] = None, device=None, *args) -> list:
    """Run ``fn(*args)`` on ``world`` new ranks and return their values in
    rank order.

    Processes start with the *spawn* method (CUDA does not survive a fork)
    and meet at a ``file://`` rendezvous in a temporary directory (no port
    to clash).  ``fn`` must be importable by module and name, and return a
    picklable value (host data, not CUDA tensors).  Rank r runs on
    ``cuda:(r % device_count)`` for ``device`` "cuda" (the default; raises
    without a card) or on the CPU for "cpu".  ``backend`` None picks
    :func:`default_backend`.  If a rank fails, the others get
    ``FAILURE_GRACE_S`` to finish before they are terminated, and this
    raises with the failures' tracebacks; a world still running after
    ``WORLD_TIMEOUT_S`` is terminated.  Every process is ended before this
    returns."""
    dev = resolve_device(device)
    backend = backend or default_backend(world, dev)
    if backend == "nccl" and (dev.type != "cuda" or world > torch.cuda.device_count()):
        raise ValueError(f"NCCL needs a card per rank: {world} ranks, device {dev}")
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="bpm_mesh_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, dev.type, init, tmp, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        try:
            _await_ranks(procs)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
        values, failures = [], []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                failures.append(f"rank {r} exited with code {p.exitcode} and no result")
                values.append(None)
                continue
            with open(path, "rb") as f:
                ok, value = pickle.load(f)
            if ok:
                values.append(value)
            else:
                failures.append(f"rank {r} failed:\n{value}")
                values.append(None)
    if failures:
        raise RuntimeError("\n".join(failures))
    return values


def _await_ranks(procs) -> None:
    """Wait for every rank; after the first failure, give the rest
    ``FAILURE_GRACE_S`` (they may be blocked in a collective)."""
    deadline = time.monotonic() + WORLD_TIMEOUT_S
    while any(p.is_alive() for p in procs):
        if any(p.exitcode not in (None, 0) for p in procs):
            deadline = min(deadline, time.monotonic() + FAILURE_GRACE_S)
        left = deadline - time.monotonic()
        if left <= 0:
            return
        _wait_sentinels([p.sentinel for p in procs if p.is_alive()], timeout=min(left, 1.0))
