"""Batched multi-file analysis — the parallel replacement for the
reference's serial per-file worker loop (gui.py:202-245).

Port of ``bpm_analysis_tpu/host_batch.py``.  Files are decoded in parallel
by the native C++ loader, bucketed by (sample_rate, padded length), analyzed
as device batches with per-recording valid lengths (``n_valid``: the masked
pipeline computes each recording's unpadded analysis), and rendered to the
same per-file artifact set the serial front-end produces.

Artifact contract (tests/test_torch_host_batch.py): every decision, peak
position, count, CSV row, summary and settings file is byte-identical to
the serial path (``host.analyze_wav_file``).  The only tolerated difference
is the JAX package's: a one-quantum flip in the debug log's amplitude
*display* fields.  The port's filter products and rolling and metric means
are sums in an order fixed by the row alone, so a recording gives the same
result in any batch.

Host-to-device staging: each chunk decodes into a pinned host buffer, is
copied with ``non_blocking=True`` on a side CUDA stream, and the compute
stream waits on the copy's event; the staged tensors are recorded on the
compute stream so the caching allocator does not hand their memory out
early.  On the CPU the same code runs with no streams.  With a mesh
(``parallel.mesh.make_mesh``) each rank takes its rows of every chunk and
the ranks gather one roster.

Entry points run on CUDA unless the caller passes ``device="cpu"``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import shutil
import time
import traceback
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from . import host
from .config import AnalyzerConfig, DEFAULT_CONFIG
from .device import resolve_device
from .io import native, wav
from .models import envelope as envm
from .ops.indexing import arange, take


def length_bucket(n: int, min_bucket: int = 1 << 15) -> int:
    """Smallest size from the half-octave grid {2^k, 1.5 * 2^k} that is
    >= n (>= min_bucket).  The 1.5 * 2^k steps cap padding waste at ~33%
    (pure powers of two waste up to 2x), and padding is paid in transfer
    bytes, dense-axis compute and staging memory; the grid still yields
    O(log) distinct batch shapes across arbitrary file lengths."""
    b = min_bucket
    while b < n:
        b <<= 1
    half = 3 * (b >> 2)
    if half >= n and half >= min_bucket:
        return half
    return b


def batch_bucket(n: int, max_batch: int) -> int:
    """Smallest power-of-two >= n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b <<= 1
    return b


def doubled_capacities(cfg: AnalyzerConfig) -> AnalyzerConfig:
    """The overflow-retry config: every fixed event capacity doubled.  The
    work/slot factors are multiples of these capacities, so the derived
    buffers scale with them; analysis parameters are untouched, so results
    on non-overflowing rows are unchanged and the retried rows are exact
    (the capacity contract is exactness-or-flag, never truncation)."""
    rt = cfg.runtime
    return dataclasses.replace(cfg, runtime=dataclasses.replace(
        rt,
        max_raw_peaks=rt.max_raw_peaks * 2,
        max_troughs=rt.max_troughs * 2,
        max_candidates=rt.max_candidates * 2,
        extrema_capacity=rt.extrema_capacity * 2))


# SVG downsample-grid slots gathered on the device for the render pack: the
# SVG line reads env[::step] with step = max(1, nv // 2400), whose length
# tops out just below 2 * 2400 (nv just under a step increment).
_DS_CAP = 4800


class RenderPack(NamedTuple):
    """Device-gathered values the artifact renderers read — everything the
    debug log / SVG plot / filtered-WAV writer needs from the dense
    per-sample arrays, so render mode never fetches a dense row.  Each leaf
    has a leading batch axis."""
    peak_env: torch.Tensor    # env at raw_peak_positions (clipped)
    peak_floor: torch.Tensor  # floor at raw_peak_positions
    trough_env: torch.Tensor
    trough_floor: torch.Tensor
    ds_env: torch.Tensor      # env at the SVG grid (i*step, clipped; _DS_CAP)
    ds_floor: torch.Tensor
    filt_i16: Optional[torch.Tensor]  # int16-normalized filtered signal


def _render_pack(env, floor, filtered, res, nv_dec) -> RenderPack:
    n = env.shape[1]
    nv = nv_dec.long()[:, None]
    rp = torch.clamp(res.raw_peak_positions.long(), 0, n - 1)
    tp = torch.clamp(res.trough_positions.long(), 0, n - 1)
    step = torch.clamp(nv // 2400, min=1)
    ds_idx = torch.minimum(arange(_DS_CAP, env)[None, :] * step, nv - 1)
    norm = None
    if filtered is not None:
        mask = arange(n, env)[None, :] < nv
        peak = torch.where(mask, filtered, torch.zeros_like(filtered)).abs().amax(
            dim=1, keepdim=True)
        peak = torch.where(peak > 0, peak, torch.ones_like(peak))
        # host.save_filtered_wav's arithmetic: /peak then *32767 in the
        # compute dtype, truncating int16 cast — bit-identical samples.
        norm = (filtered / peak * 32767).to(torch.int16)
    return RenderPack(take(env, rp), take(floor, rp), take(env, tp), take(floor, tp),
                      take(env, ds_idx), take(floor, ds_idx), norm)


def _analyze_padded_batch(audio, hints, n_valid, sample_rate: int, cfg: AnalyzerConfig,
                          pre_filtered: bool, render_pack: bool):
    """One bucket: (B, L) zero-padded PCM + per-row valid lengths → (envelope,
    filtered, decimated valid lengths, PipelineResult, pack).  With
    ``render_pack`` the dense leaves the renderers read are gathered on the
    device into a RenderPack and the dense envelope/filtered rows are not
    returned."""
    env, filtered, nv_dec, res = host.analyze_padded(audio, hints, n_valid, sample_rate,
                                                     cfg, pre_filtered)
    if render_pack:
        with torch.no_grad():
            return None, None, nv_dec, res, _render_pack(env, res.floor, filtered, res,
                                                         nv_dec)
    return env, filtered, nv_dec, res, None


def _have_plotly() -> bool:
    from .reports import plot

    return plot._plotly_modules()[0] is not None


def _pack_views(pk: "RenderPack", res_i, nv: int):
    """(env view, floor view) for one recording from its fetched RenderPack
    row — the SampledEnv instances the renderers index instead of dense
    arrays.  Gathered positions are the clipped raw-peak/trough slots plus
    the SVG grid; only positions below the respective counts are read."""
    n_rp = int(res_i.raw_peak_count)
    n_tr = int(res_i.trough_count)
    rp = np.asarray(res_i.raw_peak_positions)[:n_rp]
    tp = np.asarray(res_i.trough_positions)[:n_tr]
    step = max(1, nv // 2400)
    n_ds = -(-nv // step)
    grid = np.arange(n_ds) * step
    positions = np.concatenate([rp, tp, grid])
    env_vals = np.concatenate([pk.peak_env[:n_rp], pk.trough_env[:n_tr], pk.ds_env[:n_ds]])
    floor_vals = np.concatenate([pk.peak_floor[:n_rp], pk.trough_floor[:n_tr],
                                 pk.ds_floor[:n_ds]])
    env_view = host.SampledEnv(nv, positions, env_vals, step, pk.ds_env[:n_ds])
    floor_view = host.SampledEnv(nv, positions, floor_vals, step, pk.ds_floor[:n_ds])
    return env_view, floor_view


def _staging_buffer(shape, dtype: torch.dtype, pinned: bool) -> torch.Tensor:
    """A host staging buffer; page-locked when it goes to a card, so its
    copy can run asynchronously."""
    return torch.empty(shape, dtype=dtype, pin_memory=pinned)


def prepare_wavs(paths: Sequence[str], output_dir: str,
                 errors: Optional[List[Tuple[str, str]]] = None
                 ) -> List[Tuple[Optional[str], str]]:
    """Convert-or-copy each input into ``output_dir`` (gui.py:202-245).
    Returns [(wav_path, original_path)] in input order.  A failed conversion
    is isolated per file: its entry carries ``wav_path=None`` and a message
    is appended to ``errors``."""
    os.makedirs(output_dir, exist_ok=True)
    out: List[Tuple[Optional[str], str]] = []
    for p in paths:
        base, ext = os.path.splitext(os.path.basename(p))
        target = os.path.join(output_dir, f"{base}.wav")
        try:
            if ext.lower() == ".wav":
                if os.path.abspath(target) != os.path.abspath(p):
                    shutil.copyfile(p, target)
            elif not host.convert_to_wav(p, target):
                raise RuntimeError("conversion failed")
        except Exception as e:
            logging.warning(f"conversion failed for {p}: {e}")
            if errors is not None:
                errors.append((p, str(e)))
            out.append((None, p))
            continue
        out.append((target, p))
    return out


def analyze_files_batched(
    paths: Sequence[str],
    cfg: AnalyzerConfig = DEFAULT_CONFIG,
    output_dir: str = "processed_files",
    hints: Optional[Sequence[Optional[float]]] = None,
    max_batch: int = 128,
    min_bucket: int = 1 << 15,
    pre_filtered: bool = False,
    render: bool = True,
    mesh=None,
    lane_stats: Optional[Dict[str, float]] = None,
    overflow_retries: int = 1,
    device=None,
) -> Tuple[Dict[str, object], List[Tuple[str, str]]]:
    """Analyze many files in device batches.  Returns (results, errors):
    ``results[original_path]`` is the per-file numpy PipelineResult row (or
    None when fewer than 2 beats — the reference's "no report" outcome), and
    errors is a per-file roster of (path, message).  Runs on CUDA unless
    ``device="cpu"``.

    With ``mesh`` (``parallel.mesh.make_mesh``) the batches are sharded over
    every rank of the mesh, as the JAX package shards them over its mesh's
    devices; each rank calls this with the same arguments, on the mesh's
    device.  A chunk's batch pads up to a multiple of the mesh size and
    each rank takes its contiguous rows (padding rows are discarded; a rank
    whose rows are all padding skips the chunk).  Rank r copies or
    converts only every size-th input and decodes, stages, analyzes and
    renders only its own rows' files.  The (results, errors) roster is
    gathered from every rank, so every rank returns the same pair, in the
    unsharded roster's order; ``lane_stats`` stays per rank.  If a rank
    raises, every rank raises after the gather instead of waiting on it.

    Field contract under ``render=False``: only the result fields a fleet
    summary reads are fetched from the device — ``final_positions``,
    ``final_count``, ``metrics``, ``ok`` and the overflow flags.  The dense
    per-sample leaves (``floor``, ``trace``, ``smoothed_deviation``) and the
    capacity-shaped event sets (``classes``, ``precorrection_classes``,
    ``s1_positions``, ``trough_positions``, ``raw_peak_positions``) are
    returned as ``None``.

    ``render=True`` leaf contract: artifacts are rendered from
    device-gathered values (``RenderPack``), so the dense ``floor`` and
    ``smoothed_deviation`` leaves come back ``None`` here too.  Only when the
    real plotly is importable are dense rows fetched (its figure plots
    ``envelope[::factor]``).  Serial ``host.analyze_wav_file`` keeps
    returning the full result.

    ``lane_stats``, if given, accumulates per-lane busy seconds: ``decode``
    (host decode + pad into pinned staging, decode thread), ``h2d`` (copy
    issue + wait for the copy's event, h2d thread), ``dispatch`` (issuing
    the chunk's device work, main thread — the eager pipeline is host-bound
    here), ``compute_wait`` (until the chunk's device work has finished,
    fetch thread), ``d2h`` (result fetch), ``render`` (artifact writing,
    fetch thread), plus ``chunks``.  Lanes overlap across threads, so their
    sum normally exceeds the wall clock.

    ``overflow_retries``: when a chunk trips a capacity overflow flag, the
    chunk is re-run up to this many times with all capacities doubled each
    time, on the already-staged device inputs.  Only a chunk that still
    overflows after the retries surfaces the serial path's capacity-overflow
    error on its per-file roster.  Set 0 for the serial-mode contract.
    """
    args = (paths, cfg, output_dir, hints, max_batch, min_bucket, pre_filtered, render,
            lane_stats, overflow_retries)
    if mesh is None:
        results, errors, _ = _analyze_files(*args, resolve_device(device), None)
        return results, errors
    return _analyze_files_sharded(mesh, args)


def _analyze_files_sharded(mesh, args):
    """One rank's part of ``analyze_files_batched(mesh=...)``: its share of
    the work, then the roster gathered from every rank and merged in the
    unsharded order (conversion and probe errors first, then staging
    errors, then post-processing errors, each in chunk order)."""
    from .parallel.mesh import all_gather_object

    try:
        outcome = (*_analyze_files(*args, mesh.device, mesh), None)
    except Exception:
        outcome = ({}, [], None, traceback.format_exc())
    everyone = all_gather_object(mesh, outcome)
    failed = [f"rank {r} failed:\n{o[3]}" for r, o in enumerate(everyone) if o[3]]
    if failed:
        raise RuntimeError("\n".join(failed))
    n_head, _, order = everyone[0][2]
    staged, post, merged = [], [], {}
    for results, errors, (_, n_staged, _), _ in everyone:
        staged += errors[n_head:n_staged]
        post += errors[n_staged:]
        merged.update(results)

    errors = (everyone[0][1][:n_head] + sorted(staged, key=lambda e: order[e[0]])
              + sorted(post, key=lambda e: order[e[0]]))
    return {p: merged[p] for p in sorted(merged, key=order.__getitem__)}, errors


def _prepare_shared(mesh, paths: Sequence[str], output_dir: str,
                    errors: List[Tuple[str, str]]) -> List[Tuple[Optional[str], str]]:
    """``prepare_wavs`` with every size-th input on each rank, the pairs and
    conversion errors gathered so that every rank holds all of them, in
    input order."""
    from .parallel.mesh import all_gather_object

    mine = list(range(mesh.index, len(paths), mesh.size))
    errs: List[Tuple[str, str]] = []
    local = prepare_wavs([paths[i] for i in mine], output_dir, errs)
    pairs: List[Tuple[Optional[str], str]] = [None] * len(paths)
    failed = []
    for idxs, rank_pairs, rank_errs in all_gather_object(mesh, (mine, local, errs)):
        rank_errs = iter(rank_errs)
        for i, pair in zip(idxs, rank_pairs):
            pairs[i] = pair
            if pair[0] is None:
                failed.append((i, next(rank_errs)))
    errors.extend(e for _, e in sorted(failed))
    return pairs


def _rank_share(mesh, chunks):
    """This rank's rows of each chunk: the chunk's batch pads up to a
    multiple of the mesh size and rank i takes rows [i*per, (i+1)*per);
    chunks whose share is all padding are dropped."""
    mine = []
    for sr, bucket_len, i16, fir, idxs, b in chunks:
        per = -(-max(b, mesh.size) // mesh.size)
        rows = idxs[mesh.index * per:(mesh.index + 1) * per]
        if rows:
            mine.append((sr, bucket_len, i16, fir, rows, per))
    return mine


def _analyze_files(paths, cfg, output_dir, hints, max_batch, min_bucket, pre_filtered,
                   render, lane_stats, overflow_retries, dev, mesh):
    """The body of ``analyze_files_batched`` on ``dev``: with ``mesh``, this
    rank's share of it.  Returns (results, errors, (errors before the first
    chunk, errors once every chunk was dispatched, each file's (chunk,
    row) in the unsharded chunk list))."""
    cuda = dev.type == "cuda"
    errors: List[Tuple[str, str]] = []
    results: Dict[str, object] = {}
    if hints is None:
        hints = [None] * len(paths)

    def _lane(key: str, dt: float = 1.0) -> None:
        # Each key is written from exactly one thread, so the
        # read-add-write is race-free under the GIL.
        if lane_stats is not None:
            lane_stats[key] = lane_stats.get(key, 0.0) + dt

    pairs = (prepare_wavs(paths, output_dir, errors) if mesh is None
             else _prepare_shared(mesh, paths, output_dir, errors))

    # Serial mode raises for recordings too short to odd-extend in filtfilt;
    # reject them at probe time so the masked batch never sees an n_valid
    # <= padlen (which would clamp the extension and produce garbage).
    padlen = 3 * (2 * cfg.preprocess.bandpass_order + 1)

    # Compat decimation (the default) is a pure stride slice: identical
    # elements whether taken on the host or the device, so the decoder
    # takes it and a chunk stages ~146x fewer samples of a 44.1 kHz file.
    # The antialias path runs the device FIR's taps inside the decoder's
    # streaming loop instead.  Either way the device starts at the decimated
    # rate (its own clamp resolves to factor 1 there).
    host_decimate = not pre_filtered and not cfg.compat.antialias_decimation
    host_fir = not pre_filtered and cfg.compat.antialias_decimation

    # --- probe + bucket ------------------------------------------------------
    groups: Dict[Tuple[int, int, bool, bool], List[int]] = {}
    meta = []
    for i, (wav_path, orig) in enumerate(pairs):
        if wav_path is None:
            meta.append(None)  # conversion failure already on the roster
            continue
        try:
            sr, nframes, audio_fmt, channels, bits = wav.probe_full(wav_path)
            if nframes < 16:
                raise ValueError("empty or near-empty recording")
            factor = 1
            n_dec = nframes
            if not pre_filtered:
                factor = envm.safe_downsample_factor(sr, cfg)
                n_dec = -(-nframes // factor) if factor > 1 else nframes
                if n_dec <= padlen:
                    raise ValueError(
                        f"decimated length {n_dec} must exceed filter padlen "
                        f"{padlen} (recording too short at rate {sr})")
            host_factor = factor if (host_decimate or host_fir) and factor > 1 else 1
            if host_factor > 1 and envm.safe_downsample_factor(sr // factor, cfg) > 1:
                # A source rate whose post rate the device's own clamp would
                # decimate again: ship the native signal and let the device
                # decimate once, as the serial path does.
                host_factor = 1
            fir = bool(host_fir and host_factor > 1)
            # Mono PCM16 sources stage as raw int16 (half the H2D bytes; the
            # device casts to float, exactly).  The flag is part of the group
            # key so a chunk's staging buffer has one dtype.  FIR decode
            # emits filtered floats, so it never stages int16.
            i16 = bool(audio_fmt == 1 and bits == 16 and channels == 1 and not fir)
            meta.append((sr, nframes, host_factor, i16, fir))
            if host_factor > 1:
                key = (sr // factor, length_bucket(n_dec, min_bucket), i16, fir)
            else:
                key = (sr, length_bucket(nframes, min_bucket), i16, fir)
            groups.setdefault(key, []).append(i)
        except Exception as e:
            meta.append(None)
            errors.append((orig, str(e)))
            logging.warning(f"probe failed for {orig}: {e}")

    # --- chunk work list: (rate, bucket, int16, FIR, file indices, rows) -----
    chunks: List[Tuple[int, int, bool, bool, List[int], int]] = []
    for (sr, bucket_len, i16, fir), idxs in sorted(groups.items()):
        for chunk_start in range(0, len(idxs), max_batch):
            chunk = idxs[chunk_start:chunk_start + max_batch]
            chunks.append((sr, bucket_len, i16, fir, chunk,
                           batch_bucket(len(chunk), max_batch)))
    order = {pairs[i][1]: (ci, row) for ci, c in enumerate(chunks)
             for row, i in enumerate(c[4])}
    if mesh is not None:
        chunks = _rank_share(mesh, chunks)
    n_head = len(errors)

    def decode_chunk(sr: int, bucket_len: int, i16: bool, fir: bool, chunk: List[int],
                     b: int):
        """Decode + pad one chunk into a host staging buffer of ``b`` rows,
        on the decode thread (the C++ decoder releases the GIL).  Returns
        (chunk, ok_rows, host tensors, staging_errors); errors are merged on
        the main thread to keep the roster order deterministic."""
        t0 = time.perf_counter()
        staging_errors: List[Tuple[str, str]] = []
        wav_paths = [pairs[i][0] for i in chunk]
        audio_t = _staging_buffer((b, bucket_len), torch.int16 if i16 else torch.float32,
                                  cuda)
        audio = audio_t.numpy()
        if fir:
            _, rates, lengths = native.decode_batch_fir(
                wav_paths, bucket_len, factors=[meta[i][2] for i in chunk], out=audio)
        else:
            decode = native.decode_batch_i16 if i16 else native.decode_batch_f32
            _, rates, lengths = decode(wav_paths, bucket_len,
                                       strides=[meta[i][2] for i in chunk], out=audio)
        ok_rows = []
        for row, i in enumerate(chunk):
            if lengths[row] <= 0:
                staging_errors.append((pairs[i][1], "decode failed"))
            else:
                ok_rows.append(row)
        if not ok_rows:
            return chunk, ok_rows, None, staging_errors

        n_valid_t = _staging_buffer((b,), torch.int32, cuda)
        hints_t = _staging_buffer((b,), torch.float64, cuda)
        n_valid, hint_arr = n_valid_t.numpy(), hints_t.numpy()
        if len(ok_rows) != len(chunk):
            # Rare repair path: compact failed rows out of the buffer so
            # slots stay dense (slot order == ok_rows order).
            audio[: len(ok_rows)] = audio[ok_rows]
        for slot, row in enumerate(ok_rows):
            n_valid[slot] = int(lengths[row])
            h = hints[chunk[row]]
            hint_arr[slot] = np.nan if not h else float(h)
        # Batch padding rows duplicate row 0 (results discarded).
        audio[len(ok_rows):] = audio[0]
        n_valid[len(ok_rows):] = n_valid[0]
        hint_arr[len(ok_rows):] = hint_arr[0]

        dt = time.perf_counter() - t0
        _lane("decode", dt)
        _lane("chunks")
        logging.debug("decode_chunk[%d files, bucket %d]: %.3fs", len(chunk), bucket_len, dt)
        return chunk, ok_rows, (audio_t, hints_t, n_valid_t), staging_errors

    h2d_stream = torch.cuda.Stream(device=dev) if cuda else None

    def h2d_chunk(decode_future):
        """Host->device copy of one decoded chunk, on the h2d thread: the
        copies are issued on the side stream, and the thread waits for their
        event so the lane's seconds are the transfer's.  Returns the device
        tensors and the event the compute stream must wait on."""
        chunk, ok_rows, host_arrays, staging_errors = decode_future.result()
        if host_arrays is None:
            return chunk, ok_rows, None, staging_errors
        t0 = time.perf_counter()
        if cuda:
            with torch.cuda.stream(h2d_stream):
                args = tuple(a.to(dev, non_blocking=True) for a in host_arrays)
                ready = torch.cuda.Event()
                ready.record(h2d_stream)
            ready.synchronize()
        else:
            args, ready = host_arrays, None
        dt = time.perf_counter() - t0
        _lane("h2d", dt)
        logging.debug("h2d_chunk[%d files]: %.3fs", len(chunk), dt)
        return chunk, ok_rows, (args, ready), staging_errors

    # Render-pack mode: gather the renderer-read values on the device
    # instead of fetching dense rows.  Only the real plotly figure needs
    # dense arrays; the SVG fallback reads exactly the pack.
    use_pack = render and not _have_plotly()

    def dispatch_chunk(sr: int, staged):
        """Issue the device work of one staged chunk on the main thread's
        compute stream.  The eager pipeline holds this thread for the whole
        of its host-side issue; the work itself may still be running on the
        card when it returns.  Returns what the fetch thread needs, with the
        staged inputs (for an overflow re-run) and an event that marks the
        end of the chunk's device work."""
        chunk, ok_rows, staged_args, staging_errors = staged
        errors.extend(staging_errors)
        if staged_args is None:
            return None
        t0 = time.perf_counter()
        args, ready = staged_args
        stream = torch.cuda.current_stream(dev) if cuda else None
        if cuda:
            stream.wait_event(ready)
            for a in args:
                a.record_stream(stream)
        out = _analyze_padded_batch(*args, sr, cfg, pre_filtered, use_pack)
        done = None
        if cuda:
            done = torch.cuda.Event()
            done.record(stream)
        _lane("dispatch", time.perf_counter() - t0)
        return chunk, ok_rows, out, args, stream, done

    def finish_chunk(sr: int, dispatched) -> List[Tuple[str, str]]:
        """Wait for, fetch and render one dispatched chunk on the fetch
        thread.  Returns its post-processing errors; the caller merges them
        in chunk order after all fetch futures resolve, so the roster order
        is deterministic (staging errors first, in chunk order, then
        post-processing errors in chunk order)."""
        post_errors: List[Tuple[str, str]] = []
        if dispatched is None:
            return post_errors
        chunk, ok_rows, (env_b, filt_b, nvd_b, res_b, pack_b), args, stream, done = dispatched
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        with torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext():
            # Overflow auto-retry: re-run this chunk with doubled capacities
            # (exact results) instead of surfacing the serial path's error.
            retry_cfg = cfg
            for _ in range(overflow_retries):
                if not bool(res_b.overflowed[: len(ok_rows)].any()):
                    break
                retry_cfg = doubled_capacities(retry_cfg)
                logging.warning(
                    "capacity overflow in a %d-file chunk; retrying with "
                    "capacities %dx the configured sizes",
                    len(chunk), retry_cfg.runtime.max_raw_peaks // cfg.runtime.max_raw_peaks)
                env_b, filt_b, nvd_b, res_b, pack_b = _analyze_padded_batch(
                    *args, sr, retry_cfg, pre_filtered, use_pack)
            if stream is not None:
                stream.synchronize()
            t_ready = time.perf_counter()
            if render and pack_b is not None:
                # The pack plus the result without its dense per-sample
                # leaves: the renderers read event/grid values from the pack.
                res_np, pack_np, nvd_np = host.to_host(
                    (res_b._replace(floor=None, smoothed_deviation=None), pack_b, nvd_b))
                env_np = filt_np = None
            elif render:
                res_np, env_np, filt_np, nvd_np = host.to_host((res_b, env_b, filt_b, nvd_b))
                pack_np = None
            else:
                # No artifacts to draw: fetch only what render=False callers
                # (fleet summaries, benchmarks) read.
                env_np = filt_np = pack_np = None
                res_np, nvd_np = host.to_host((res_b._replace(
                    floor=None, trace=None, smoothed_deviation=None,
                    classes=None, precorrection_classes=None,
                    s1_positions=None, trough_positions=None,
                    raw_peak_positions=None), nvd_b))
        t1 = time.perf_counter()
        _lane("compute_wait", t_ready - t0)
        _lane("d2h", t1 - t_ready)
        new_rate = sr if pre_filtered else host.post_rate(sr, cfg)
        for slot, row in enumerate(ok_rows):
            orig = pairs[chunk[row]][1]
            res_i = host.tree_row(res_np, slot)
            nv_dec = int(nvd_np[slot])
            beside = pairs[chunk[row]][0] if cfg.compat.filtered_wav_beside_input else None
            try:
                if render and pack_np is not None:
                    pk = host.tree_row(pack_np, slot)
                    if pk.filt_i16 is not None and cfg.preprocess.save_filtered_wav:
                        host.write_filtered_wav_i16(pk.filt_i16[:nv_dec], new_rate, orig,
                                                    output_dir, beside_wav_path=beside)
                    env_view, floor_view = _pack_views(pk, res_i, nv_dec)
                    out = host.render_artifacts(
                        res_i._replace(floor=floor_view), cfg, env_view,
                        new_rate, orig, output_dir, hints[chunk[row]])
                    if out is not None:
                        # The same leaf contract as render=False for the
                        # dense arrays (the artifacts hold the views).
                        out = out._replace(floor=None)
                elif render:
                    if filt_np is not None and cfg.preprocess.save_filtered_wav:
                        host.save_filtered_wav(filt_np[slot][:nv_dec], new_rate, orig,
                                               output_dir, beside_wav_path=beside)
                    out = host.render_artifacts(res_i, cfg, env_np[slot][:nv_dec], new_rate,
                                                orig, output_dir, hints[chunk[row]])
                else:
                    host.check_overflow(res_i, orig)
                    out = res_i if bool(res_i.ok) else None
                results[orig] = out
            except Exception as e:
                logging.exception(f"post-processing failed for {orig}")
                post_errors.append((orig, str(e)))
        _lane("render", time.perf_counter() - t1)
        logging.debug("finish_chunk[%d files]: compute-wait %.3fs d2h %.3fs render %.3fs",
                      len(chunk), t_ready - t0, t1 - t_ready, time.perf_counter() - t1)
        return post_errors

    # --- four lanes ------------------------------------------------------------
    # One single-worker pool each, so chunk order (and with it the
    # result/error rosters) stays deterministic:
    #   decode thread: chunk k+2 decodes into a pinned host buffer, while
    #   h2d thread:    chunk k+1 is copied on the side stream,
    #   main thread:   chunk k's device work is issued, and
    #   fetch thread:  chunk k-1's results are fetched and rendered.
    # Decode look-ahead is bounded by buffer bytes.
    if chunks:
        max_chunk_bytes = max(b * bl * (2 if i16 else 4)
                              for (_, bl, i16, _fir, _c, b) in chunks)
        lookahead = max(1, min(3, int((256 << 20) // max(max_chunk_bytes, 1))))
        with ThreadPoolExecutor(max_workers=1) as decode_pool, \
                ThreadPoolExecutor(max_workers=1) as h2d_pool, \
                ThreadPoolExecutor(max_workers=1) as fetch_pool:
            dec: deque = deque()
            h2ds: deque = deque()
            next_decode = 0
            for _ in range(min(lookahead, len(chunks))):
                dec.append(decode_pool.submit(decode_chunk, *chunks[next_decode]))
                next_decode += 1
            h2ds.append(h2d_pool.submit(h2d_chunk, dec.popleft()))
            fetches = []
            for ci in range(len(chunks)):
                staged = h2ds.popleft().result()
                if next_decode < len(chunks):
                    dec.append(decode_pool.submit(decode_chunk, *chunks[next_decode]))
                    next_decode += 1
                if dec:
                    h2ds.append(h2d_pool.submit(h2d_chunk, dec.popleft()))
                dispatched = dispatch_chunk(chunks[ci][0], staged)
                fetches.append(fetch_pool.submit(finish_chunk, chunks[ci][0], dispatched))
            n_staged = len(errors)
            for f in fetches:
                errors.extend(f.result())
    else:
        n_staged = len(errors)

    return results, errors, (n_head, n_staged, order)

