"""The port's batched front-end, ``host_batch.analyze_files_batched``, on the
CPU.

Held to the contract tests/test_host_batch.py holds the JAX package's
batched path to: on tests/test_host_batch.py's five mixed-length files and
its ``CFG``, every CSV, summary and settings file is byte-equal to the
port's serial path (``host.analyze_wav_file``) once the timestamp lines are
stripped, and the debug logs are equal but for one 0.1 quantum on their
amplitude display lines.  Also: the error roster, the bucketing helpers
against JAX, the overflow retry, the ``render=False`` and ``render=True``
leaf contracts, the dense (plotly) path against the render-pack path, and
the antialias host-FIR path against the serial antialias path.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from bpm_analysis_tpu import host_batch as jhost_batch
from bpm_analysis_tpu_torch import host as thost
from bpm_analysis_tpu_torch import host_batch as thb
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.io import wav as twav

from test_host_batch import ARTIFACTS, CFG as JAX_CFG, _assert_log_equal, _normalized, make_wav
from test_host_batch_antialias import make_wav_native

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

CFG = config_from_dict(dataclasses.asdict(JAX_CFG))
SECONDS = [21.0, 34.5, 47.2, 22.8, 61.0]


@pytest.fixture(scope="module")
def mixed_runs(tmp_path_factory):
    """The five files of tests/test_host_batch.py through the serial path
    and the batched path (max_batch 4; four length buckets, so four
    chunks)."""
    d = tmp_path_factory.mktemp("mixed")
    files = []
    for i, sec in enumerate(SECONDS):
        p = str(d / f"rec{i}.wav")
        make_wav(p, sec, seed=10 + i, bpm=95.0 + 7 * i)
        files.append(p)
    serial = {f: thost.analyze_any_file(f, CFG, None, str(d / "serial"), device="cpu")
              for f in files}
    lanes = {}
    results, errors = thb.analyze_files_batched(
        files, CFG, str(d / "batched"), max_batch=4, min_bucket=1 << 13, lane_stats=lanes,
        device="cpu")
    return d, files, serial, results, errors, lanes


@pytest.mark.parametrize("suffix", ARTIFACTS)
def test_batched_artifacts_match_serial(mixed_runs, suffix):
    d, files, _, results, errors, _ = mixed_runs
    assert errors == []
    assert set(results) == set(files) and all(r is not None for r in results.values())
    for i in range(len(files)):
        a = str(d / "serial" / f"rec{i}{suffix}")
        b = str(d / "batched" / f"rec{i}{suffix}")
        assert os.path.exists(a) and os.path.exists(b), (a, b)
        if suffix == "_Debug_Log.md":
            _assert_log_equal(a, b, f"rec{i}{suffix}")
        else:
            assert _normalized(a) == _normalized(b), f"artifact mismatch: rec{i}{suffix}"


def test_batched_results_and_lanes(mixed_runs):
    """Final beats equal the serial path's; the render=True leaf contract
    (dense floor and smoothed deviation not fetched, the rest present); and
    the lanes each chunk passed through."""
    _, files, serial, results, _, lanes = mixed_runs
    for f in files:
        got, exp = results[f], serial[f]
        count = int(exp.final_count)
        assert int(got.final_count) == count
        np.testing.assert_array_equal(got.final_positions[:count],
                                      exp.final_positions[:count])
        assert got.floor is None and got.smoothed_deviation is None
        for field in ("trace", "classes", "raw_peak_positions", "trough_positions",
                      "precorrection_classes", "s1_positions"):
            assert getattr(got, field) is not None, field
    assert lanes["chunks"] == 4
    for lane in ("decode", "h2d", "dispatch", "compute_wait", "d2h", "render"):
        assert lanes[lane] >= 0.0, lane
    assert lanes["dispatch"] > 0.0 and lanes["render"] > 0.0


def test_render_false_leaf_contract(tmp_path):
    p = str(tmp_path / "one.wav")
    make_wav(p, 20.0, seed=3)
    results, errors = thb.analyze_files_batched([p], CFG, str(tmp_path / "out"),
                                                render=False, min_bucket=1 << 13,
                                                device="cpu")
    assert errors == []
    res = results[p]
    for field in ("floor", "trace", "smoothed_deviation", "classes", "precorrection_classes",
                  "s1_positions", "trough_positions", "raw_peak_positions"):
        assert getattr(res, field) is None, field
    assert int(res.final_count) > 10 and bool(res.ok) and not bool(res.overflowed)
    assert res.final_positions.shape == (CFG.runtime.max_candidates,)
    assert int(res.metrics.bpm.count) > 0
    assert not os.path.exists(tmp_path / "out" / "one_bpm_plot.csv")


def test_error_roster(tmp_path, monkeypatch):
    """Conversion failures (a .mp3 with no ffmpeg on PATH), then probe
    failures (not a WAV, an empty recording, one too short for the filter
    once decimated), in input order; the good files come back, three in one
    chunk padded to four rows."""
    monkeypatch.setattr(thost.shutil, "which", lambda name: None)
    goods = []
    for i, sec in enumerate((20.0, 21.0, 19.0)):
        goods.append(str(tmp_path / f"good{i}.wav"))
        make_wav(goods[-1], sec, seed=1 + i)
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as f:
        f.write(b"not a wav at all")
    mp3 = str(tmp_path / "take.mp3")
    with open(mp3, "wb") as f:
        f.write(b"\xff\xfb\x90\x00")
    empty = str(tmp_path / "empty.wav")
    twav.write(empty, 302, np.zeros(0, np.int16))
    short = str(tmp_path / "short.wav")
    twav.write(short, 44100, np.ones(2000, np.int16) * 9)   # 14 samples once decimated
    out = str(tmp_path / "out")
    lanes = {}
    results, errors = thb.analyze_files_batched(
        [bad, goods[0], mp3, goods[1], empty, short, goods[2]], CFG, out, render=False,
        min_bucket=1 << 13, lane_stats=lanes, device="cpu")
    assert set(results) == set(goods) and all(results[g] is not None for g in goods)
    assert lanes["chunks"] == 1
    assert [p for p, _ in errors] == [mp3, bad, empty, short]
    assert "ffmpeg" in errors[0][1]
    assert "RIFF" in errors[1][1]
    assert "empty" in errors[2][1]
    assert "padlen" in errors[3][1]


def test_length_and_batch_buckets_equal_jax():
    rng = np.random.RandomState(0)
    ns = np.unique(np.concatenate([np.arange(1, 300), rng.randint(1, 1 << 20, size=3000),
                                   [1 << k for k in range(21)], [3 << k for k in range(19)],
                                   [(1 << k) + 1 for k in range(20)]]))
    for min_bucket in (1 << 13, 1 << 15):
        for n in ns:
            n = int(n)
            assert thb.length_bucket(n, min_bucket) == jhost_batch.length_bucket(n, min_bucket)
    for max_batch in (1, 4, 16, 128):
        for n in range(1, 300):
            assert thb.batch_bucket(n, max_batch) == jhost_batch.batch_bucket(n, max_batch)
    assert thb.length_bucket(181233, 1 << 15) == 196608


def _tiny_cfg():
    """Capacities that two 25 s recordings (82 and 90 raw peaks) overflow;
    one doubling holds them."""
    return CFG.replace(runtime=dataclasses.replace(
        CFG.runtime, max_raw_peaks=128, max_troughs=128, max_candidates=64,
        extrema_capacity=2048))


def test_overflow_retry_equals_a_direct_run_at_doubled_capacities(tmp_path):
    files = []
    for i in range(2):
        p = str(tmp_path / f"rec{i}.wav")
        make_wav(p, 25.0, seed=40 + i, bpm=100.0 + 9 * i)
        files.append(p)
    tiny = _tiny_cfg()
    doubled = thb.doubled_capacities(tiny)
    assert doubled.runtime.max_raw_peaks == 256 and doubled.runtime.extrema_capacity == 4096

    kw = dict(render=False, max_batch=2, min_bucket=1 << 13, device="cpu")
    retried, errors = thb.analyze_files_batched(files, tiny, str(tmp_path / "a"),
                                                overflow_retries=1, **kw)
    assert errors == []
    direct, errors = thb.analyze_files_batched(files, doubled, str(tmp_path / "b"),
                                               overflow_retries=0, **kw)
    assert errors == []
    for f in files:
        a, b = retried[f], direct[f]
        assert not bool(a.overflowed)
        np.testing.assert_array_equal(a.final_positions, b.final_positions)
        assert int(a.final_count) == int(b.final_count)
        np.testing.assert_array_equal(a.metrics.bpm.smoothed, b.metrics.bpm.smoothed)

    # Retries disabled: the serial path's capacity-overflow error, per file.
    _, errors0 = thb.analyze_files_batched(files, tiny, str(tmp_path / "c"),
                                           overflow_retries=0, **kw)
    assert [p for p, _ in errors0] == files
    with pytest.raises(RuntimeError) as serial_error:
        thost.analyze_wav_file(files[0], tiny, output_directory=str(tmp_path / "s"),
                               device="cpu")
    assert errors0[0][1] == str(serial_error.value)
    assert "capacity overflow" in errors0[0][1]


def test_dense_path_equals_render_pack_path(tmp_path, monkeypatch):
    """With a plotly figure to feed (``_have_plotly`` patched to True; the
    figure itself falls back to SVG here) the chunk fetches dense rows; the
    artifacts equal the render-pack path's bit for bit, and the filtered
    WAV normalised on the host equals the one normalised on the device."""
    files = []
    for i, sec in enumerate((22.0, 30.0)):
        p = str(tmp_path / f"rec{i}.wav")
        make_wav(p, sec, seed=20 + i, bpm=90.0 + 10 * i)
        files.append(p)
    kw = dict(max_batch=2, min_bucket=1 << 13, device="cpu")
    pack, errors = thb.analyze_files_batched(files, CFG, str(tmp_path / "pack"), **kw)
    assert errors == []
    monkeypatch.setattr(thb, "_have_plotly", lambda: True)
    dense, errors = thb.analyze_files_batched(files, CFG, str(tmp_path / "dense"), **kw)
    assert errors == []
    assert dense[files[0]].floor is not None and pack[files[0]].floor is None
    for i in range(len(files)):
        for suffix in (*ARTIFACTS, "_filtered_debug.wav"):
            a = str(tmp_path / "pack" / f"rec{i}{suffix}")
            b = str(tmp_path / "dense" / f"rec{i}{suffix}")
            assert _normalized(a) == _normalized(b), f"rec{i}{suffix}"


def test_antialias_host_fir_matches_serial_antialias(tmp_path):
    """The antialias path's host FIR decode (native ``decode_batch_fir``)
    against the serial path's device FIR (``ops/filter.fir_decimate``): the
    same decimated grid and taps, float32 rounding the only difference, so
    the beat sets agree to one sample (tests/test_host_batch_antialias.py's
    criterion)."""
    cfg = CFG.replace(compat=dataclasses.replace(CFG.compat, antialias_decimation=True))
    paths = []
    for seed in (0, 1):
        p = str(tmp_path / f"native_{seed}.wav")
        make_wav_native(p, 50 + 10 * seed, seed)
        paths.append(p)
    serial = {p: thost.analyze_wav_file(p, cfg, output_directory=str(tmp_path / "ser"),
                                        device="cpu") for p in paths}
    results, errors = thb.analyze_files_batched(paths, cfg, str(tmp_path / "bat"),
                                                render=False, max_batch=2, device="cpu")
    assert not errors, errors
    for p in paths:
        got = results[p].final_positions[: int(results[p].final_count)]
        exp = serial[p].final_positions[: int(serial[p].final_count)]
        assert len(got) == len(exp) > 50
        assert np.max(np.abs(got.astype(np.int64) - exp)) <= 1


def test_pre_filtered_batched_matches_serial(tmp_path):
    """Pre-filtered inputs (a ``*_filtered_debug.wav``): no decimation, no
    band-pass, no filtered WAV written; batched equals serial."""
    p = str(tmp_path / "rec_filtered_debug.wav")
    make_wav(p, 26.0, seed=7)
    serial = thost.analyze_wav_file(p, CFG, output_directory=str(tmp_path / "ser"),
                                    pre_filtered=True, device="cpu")
    results, errors = thb.analyze_files_batched([p], CFG, str(tmp_path / "bat"),
                                                pre_filtered=True, min_bucket=1 << 13,
                                                device="cpu")
    assert errors == []
    count = int(serial.final_count)
    np.testing.assert_array_equal(results[p].final_positions[:count],
                                  serial.final_positions[:count])
    for suffix in ARTIFACTS:
        assert _normalized(str(tmp_path / "ser" / f"rec_filtered_debug{suffix}")) == \
            _normalized(str(tmp_path / "bat" / f"rec_filtered_debug{suffix}")), suffix
    assert not os.path.exists(tmp_path / "bat" / "rec_filtered_debug_filtered_debug.wav")
