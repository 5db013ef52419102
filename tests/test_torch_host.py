"""Port vs JAX: the serial host path, ``host.analyze_wav_file``.

tests/test_host.py's synthetic 40 s WAV at its ``SMALL_CFG``, through the
port on the CPU and through the JAX host (one JAX run per dtype, in module
fixtures, to bound the compile time).  In float64 every artifact is
byte-equal once the timestamp lines are stripped.  In float32 the summary,
the settings and the debug log meet tests/test_host_batch.py's contract
(byte-equal but for one 0.1 quantum on the debug log's amplitude display
lines); the BPM CSV, the plot and the filtered WAV may move by one print
quantum (0.001 BPM, 0.1 of an SVG coordinate, one int16 step) where the
port's float32 rounds the last bit differently from XLA's fusions
(ROADMAP C3), with every line, count and position equal.
"""
import dataclasses
import os
import re

import numpy as np
import pytest
import torch

from bpm_analysis_tpu import host as jhost
from bpm_analysis_tpu_torch import host as thost
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.io import wav as twav

from test_host import SMALL_CFG, SR, _synthetic_wav
from test_host_batch import _assert_log_equal, _normalized

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

SUFFIXES = ("_bpm_plot.csv", "_bpm_plot.html", "_Analysis_Summary.md", "_Debug_Log.md",
            "_Analysis_Settings.json", "_filtered_debug.wav")


def _run_both(tmp_path_factory, dtype):
    d = tmp_path_factory.mktemp(f"host_{dtype}")
    src = str(d / "rec.wav")
    _synthetic_wav(src)
    cfg = dataclasses.replace(SMALL_CFG, runtime=dataclasses.replace(SMALL_CFG.runtime,
                                                                     dtype=dtype))
    jres = jhost.analyze_wav_file(src, cfg, None, output_directory=str(d / "jax"))
    tres = thost.analyze_wav_file(src, config_from_dict(dataclasses.asdict(cfg)), None,
                                  output_directory=str(d / "port"), device="cpu")
    return d, jres, tres


@pytest.fixture(scope="module")
def float64_runs(tmp_path_factory):
    return _run_both(tmp_path_factory, "float64")


@pytest.fixture(scope="module")
def float32_runs(tmp_path_factory):
    return _run_both(tmp_path_factory, "float32")


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_float64_artifacts_byte_equal_jax(float64_runs, suffix):
    d, jres, tres = float64_runs
    a, b = str(d / "jax" / f"rec{suffix}"), str(d / "port" / f"rec{suffix}")
    assert os.path.exists(a) and os.path.exists(b), suffix
    assert _normalized(a) == _normalized(b), f"rec{suffix} differs from the JAX host's"


def test_float64_result_equal_jax(float64_runs):
    _, jres, tres = float64_runs
    assert jres is not None and tres is not None
    count = int(jres.final_count)
    assert int(tres.final_count) == count
    np.testing.assert_array_equal(tres.final_positions[:count],
                                  np.asarray(jres.final_positions)[:count])
    n = int(jres.raw_peak_count)
    np.testing.assert_array_equal(tres.classes[:n], np.asarray(jres.classes)[:n])
    assert 90 < float(tres.metrics.avg_bpm) < 110


_NUMBER = re.compile(rb"-?\d+\.(\d+)")


def _assert_within_print_quantum(path_a, path_b, label):
    """Line for line equal but for numbers that differ by at most one unit
    of their last printed decimal."""
    la, lb = _normalized(path_a).split(b"\n"), _normalized(path_b).split(b"\n")
    assert len(la) == len(lb), f"{label}: line count {len(la)} != {len(lb)}"
    for i, (a, b) in enumerate(zip(la, lb)):
        if a == b:
            continue
        assert _NUMBER.sub(b"#", a) == _NUMBER.sub(b"#", b), f"{label} line {i + 1} differs"
        for ma, mb in zip(_NUMBER.finditer(a), _NUMBER.finditer(b)):
            quantum = 10.0 ** -len(ma.group(1))
            assert len(ma.group(1)) == len(mb.group(1)), f"{label} line {i + 1}"
            assert abs(float(ma.group(0)) - float(mb.group(0))) <= 1.001 * quantum, \
                f"{label} line {i + 1}: {ma.group(0)!r} vs {mb.group(0)!r}"


@pytest.mark.parametrize("suffix", SUFFIXES)
def test_float32_artifacts_equal_jax_within_one_quantum(float32_runs, suffix):
    d, _, _ = float32_runs
    a, b = str(d / "jax" / f"rec{suffix}"), str(d / "port" / f"rec{suffix}")
    if suffix in ("_Analysis_Summary.md", "_Analysis_Settings.json"):
        assert _normalized(a) == _normalized(b), suffix
    elif suffix == "_Debug_Log.md":
        _assert_log_equal(a, b, suffix)
    elif suffix == "_filtered_debug.wav":
        sr_a, x = twav.read(a)
        sr_b, y = twav.read(b)
        assert sr_a == sr_b and x.shape == y.shape
        assert np.abs(x.astype(np.int32) - y).max() <= 1
    else:
        _assert_within_print_quantum(a, b, suffix)


def test_float32_beats_equal_jax(float32_runs):
    _, jres, tres = float32_runs
    count = int(jres.final_count)
    assert int(tres.final_count) == count
    np.testing.assert_array_equal(tres.final_positions[:count],
                                  np.asarray(jres.final_positions)[:count])


def test_too_short_returns_none_and_writes_settings(tmp_path):
    src = str(tmp_path / "tiny.wav")
    twav.write(src, SR, np.zeros(SR, np.int16))
    cfg = config_from_dict(dataclasses.asdict(SMALL_CFG))
    assert thost.analyze_wav_file(src, cfg, 97.0, output_directory=str(tmp_path),
                                  device="cpu") is None
    path = tmp_path / "tiny_Analysis_Settings.json"
    assert path.exists()
    assert '"start_bpm_hint": 97.0' in path.read_text()


def test_too_short_for_the_filter_raises(tmp_path):
    src = str(tmp_path / "two.wav")
    twav.write(src, SR, np.ones(12, np.int16))
    with pytest.raises(ValueError, match="padlen"):
        thost.analyze_wav_file(src, config_from_dict(dataclasses.asdict(SMALL_CFG)),
                               output_directory=str(tmp_path), device="cpu")


def test_sampled_env_raises_on_accesses_it_was_not_built_for():
    dense = np.arange(100, dtype=np.float64) * 0.5
    positions = np.array([40, 3, 17])
    view = thost.SampledEnv(100, positions, dense[positions], 10, dense[::10])
    assert len(view) == 100
    assert view[17] == dense[17]
    np.testing.assert_array_equal(view[np.array([3, 40])], dense[[3, 40]])
    np.testing.assert_array_equal(view[::10], dense[::10])
    with pytest.raises(KeyError):
        view[5]
    with pytest.raises(KeyError):
        view[np.array([3, 4])]
    with pytest.raises(KeyError):
        view[::5]
    with pytest.raises(KeyError):
        view[10:20]


def test_to_host_maps_nested_results_with_none_leaves():
    from bpm_analysis_tpu_torch.models.pipeline import PipelineResult

    fields = {f: torch.arange(6).reshape(2, 3) for f in PipelineResult._fields}
    fields["trace"] = None
    res = thost.to_host((PipelineResult(**fields), None, torch.ones(2)))
    assert isinstance(res[0], PipelineResult) and res[0].trace is None and res[1] is None
    assert isinstance(res[0].floor, np.ndarray)
    row = thost.tree_row(res, 1)
    np.testing.assert_array_equal(row[0].classes, [3, 4, 5])


def test_entry_points_need_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    src = str(tmp_path / "rec.wav")
    _synthetic_wav(src, seconds=5)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thost.analyze_wav_file(src, output_directory=str(tmp_path))
