"""Rank bodies for the port's multi-process tests.

``parallel.mesh.spawn`` starts each rank with the *spawn* method, so the
child imports the module of the function it runs: these bodies live here,
in a module that imports only torch, numpy and the port (the test modules
import JAX).  Each returns host data (numpy), never CUDA tensors.
"""
import numpy as np
import torch
import torch.distributed as dist

from bpm_analysis_tpu_torch import host, host_batch
from bpm_analysis_tpu_torch.parallel import mesh as tmesh
from bpm_analysis_tpu_torch.parallel import seqshard

SR = 302
ENV_WINDOW = SR // 10
FILTER_BAND = (20.0, 150.0)
QUANTILE = dict(window=603, q=0.3, min_periods=3, stride=8)


def mesh_shape(m):
    return None if m is None else (m.dp, m.sp, m.dp_index, m.sp_index)


def seqshard_outputs(m, signal: np.ndarray, series: np.ndarray, dtypes) -> dict:
    """The three sharded functions on mesh ``m``, single (row 0) and
    batched, in each dtype: {(name, batched, dtype name): whole series}."""
    out = {}
    for dtype in dtypes:
        sig = torch.from_numpy(signal).to(dtype=dtype, device=m.device)
        ser = torch.from_numpy(series).to(dtype=dtype, device=m.device)
        for batched in (False, True):
            x = sig if batched else sig[0]
            y = ser if batched else ser[0]
            runs = {
                "envelope": lambda: seqshard.sequence_sharded_envelope(
                    m, seqshard.shard_sequence(m, x), ENV_WINDOW, batched=batched),
                "filtfilt": lambda: seqshard.sequence_sharded_bandpass_filtfilt(
                    m, seqshard.shard_sequence(m, x), SR, *FILTER_BAND, batched=batched),
                "quantile": lambda: seqshard.sequence_sharded_rolling_quantile(
                    m, seqshard.shard_sequence(m, y), batched=batched, **QUANTILE),
            }
            for name, run in runs.items():
                whole = seqshard.gather_sequence(m, run())
                out[(name, batched, str(dtype).split(".")[-1])] = whole.cpu().numpy()
    return out


def parallel_cases(envelopes: np.ndarray, cfg, signal: np.ndarray, series: np.ndarray):
    """Every case of tests/test_torch_parallel.py in one world of 8 gloo
    ranks on the CPU: the mesh shapes over a 4-rank group and the world;
    ``analyze_batch_sharded`` + ``gather_result`` + ``fleet_summary`` on
    the 4-rank (4, 1) mesh; the sequence-sharded functions at sp=4 (a
    (2, 4) mesh) and sp=8."""
    rank = dist.get_rank()
    four = [0, 1, 2, 3]
    out = {"shapes": {sp: mesh_shape(tmesh.make_mesh(sp=sp, group=four))
                      for sp in (1, 4, 2)}}
    out["shapes"]["world"] = mesh_shape(tmesh.make_mesh())
    if rank < 4:
        # A member may pass the process group itself.
        group = dist.new_group(four)
        out["shapes"]["group"] = mesh_shape(tmesh.make_mesh(sp=2, group=group))
    else:
        dist.new_group(four)
        out["shapes"]["group"] = mesh_shape(tmesh.make_mesh(sp=2, group=four))

    m4 = tmesh.make_mesh(sp=1, group=four)
    if m4 is not None:
        local = tmesh.analyze_batch_sharded(m4, envelopes, SR, cfg)
        out["local_rows"] = int(local.final_count.shape[0])
        out["fleet"] = tmesh.fleet_summary(m4, local)
        out["gathered"] = host.to_host(tmesh.gather_result(m4, local))

    out["seqshard"] = {}
    for sp in (4, 8):
        m = tmesh.make_mesh(sp=sp)
        dtypes = (torch.float64, torch.float32)
        out["seqshard"][sp] = seqshard_outputs(m, signal, series, dtypes)
    out["rank"] = rank
    return out


def host_mesh_rank(files, cfg, output_dir, max_batch, min_bucket):
    """``analyze_files_batched(mesh=...)`` on this rank's share: the roster
    (final counts and positions), the errors and this rank's lanes; then the
    same call with rank 1's device program raising, which every rank must
    report as an exception (not wait on)."""
    m = tmesh.make_mesh()
    lanes = {}
    kw = dict(max_batch=max_batch, min_bucket=min_bucket, mesh=m)
    results, errors = host_batch.analyze_files_batched(files, cfg, output_dir,
                                                       lane_stats=lanes, **kw)
    roster = {p: None if r is None else r.final_positions[:int(r.final_count)].copy()
              for p, r in results.items()}
    if m.index == 1:
        def broken(*a, **k):
            raise MemoryError("injected failure")

        host_batch._analyze_padded_batch = broken
    try:
        host_batch.analyze_files_batched(files, cfg, output_dir + "_broken", **kw)
        failure = None
    except RuntimeError as e:
        failure = str(e)
    return roster, errors, lanes, failure


def failing_rank():
    """Rank 1 raises while rank 0 waits for it in a barrier."""
    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    dist.barrier()


def card_dp_rank(files, cfg, output_dir):
    """The card test's rank: ``analyze_files_batched(mesh=...)`` on the
    card, final positions per file, and the exchange helpers' round trip of
    a CUDA tensor (it must come back on the rank's device, values intact)."""
    m = tmesh.make_mesh()
    results, errors = host_batch.analyze_files_batched(
        files, cfg, output_dir, render=False, min_bucket=1 << 13, mesh=m)
    t = torch.arange(5, dtype=torch.float32, device=m.device) + 10 * m.index
    gathered = tmesh.all_gather(m, t)
    summed = tmesh.all_reduce(m, t)
    trip = {"device": str(gathered.device), "gathered": gathered.cpu().numpy(),
            "summed": summed.cpu().numpy(), "summed_device": str(summed.device),
            "rank_device": str(m.device), "backend": m.backend}
    roster = {p: r.final_positions[:int(r.final_count)].copy() for p, r in results.items()}
    return roster, errors, trip
