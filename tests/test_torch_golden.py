"""The port alone (no JAX) on the vulpine golden, on the CPU.

``DEFAULT_CONFIG`` (stride 1: the exact wavelet-tree noise floor), float64,
``envelope_from_filtered`` of the oracle's ``raw_signal`` →
``analyze_batch``, with both prominence backends, held to the checks of
tests/test_pipeline_golden.py::test_pipeline_stage_outputs and
::test_pipeline_classifications, and the noise floor to the oracle's at
tests/test_noise_floor.py's rtol 1e-9.  The metrics of the float64 run are
held to the oracle's series (rtol 1e-9), to the summary constants of
::test_pipeline_summary_metrics and to the golden HRR of
tests/test_analytics.py::test_hrr_compat_truncated_interp, and its trace
strings to tests/golden/vulpine_debug_info.json; the float32 run to
::test_pipeline_float32's beat F1.
"""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from bpm_analysis_tpu_torch import config as tcfg
from bpm_analysis_tpu_torch import host
from bpm_analysis_tpu_torch import types as ttypes
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import noise_floor as tnf
from bpm_analysis_tpu_torch.models import pipeline as tpipe
from bpm_analysis_tpu_torch.reports import trace

GOLDEN_DEBUG_INFO = os.path.join(os.path.dirname(__file__), "golden", "vulpine_debug_info.json")

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)


@pytest.mark.parametrize("prominence_backend", ["auto", "dense"])
def test_vulpine_golden_port_only(oracle, prominence_backend):
    """The port alone (no JAX) on the vulpine golden at DEFAULT_CONFIG
    (stride 1: the wavelet-tree floor), float64, on the CPU."""
    sr = int(oracle["sample_rate"])
    cfg = tcfg.DEFAULT_CONFIG
    cfg = cfg.replace(runtime=dataclasses.replace(cfg.runtime,
                                                  prominence_backend=prominence_backend))
    assert tnf.quantile_path(cfg) == "exact"
    x = torch.from_numpy(oracle["raw_signal"].astype(np.float64))[None]
    res = tpipe.analyze_batch(tenv.envelope_from_filtered(x, sr), sr, cfg, device="cpu")
    # test_pipeline_golden.py::test_pipeline_stage_outputs
    assert bool(res.ok[0])
    assert int(res.trough_count[0]) == len(oracle["sanitized_troughs"])
    assert int(res.raw_peak_count[0]) == len(oracle["all_raw_peaks"])
    np.testing.assert_allclose(float(res.start_bpm[0]), oracle["start_bpm"], rtol=1e-9)
    np.testing.assert_allclose(float(res.peak_bpm_time[0]), oracle["peak_time"], rtol=1e-9)
    count = int(res.final_count[0])
    np.testing.assert_array_equal(res.final_positions.numpy()[0, :count], oracle["final_peaks"])
    # ::test_pipeline_classifications
    n = len(oracle["all_raw_peaks"])
    mism = np.nonzero(res.classes.numpy()[0, :n] != ttypes.labels_to_codes(
        oracle["final_labels"]))[0]
    assert mism.size == 0, f"{mism.size} mismatches"
    # test_noise_floor.py::test_noise_floor_on_vulpine
    k = int(res.trough_count[0])
    np.testing.assert_array_equal(res.trough_positions.numpy()[0, :k],
                                  oracle["sanitized_troughs"])
    np.testing.assert_allclose(res.floor.numpy()[0], oracle["noise_floor"], rtol=1e-9)


def _run_default(oracle, dtype):
    sr = int(oracle["sample_rate"])
    x = torch.from_numpy(oracle["raw_signal"].astype(dtype))[None]
    return tpipe.analyze_batch(tenv.envelope_from_filtered(x, sr), sr, tcfg.DEFAULT_CONFIG,
                               device="cpu")


@pytest.fixture(scope="module")
def result64(oracle):
    return _run_default(oracle, np.float64)


def test_vulpine_golden_bpm_and_hrv_series(oracle, result64):
    """The BPM curve and the HRV windows of the port's own beats, float64,
    against the oracle's series at rtol 1e-9."""
    m = result64.metrics
    count = int(m.bpm.count[0])
    assert count == len(oracle["bpm_times"])
    np.testing.assert_allclose(m.bpm.times.numpy()[0, :count], oracle["bpm_times"],
                               rtol=1e-9)
    np.testing.assert_allclose(m.bpm.smoothed.numpy()[0, :count], oracle["smoothed_bpm"],
                               rtol=1e-9)
    count = int(m.hrv.count[0])
    assert count == len(oracle["hrv_time"])
    for field in ("time", "rmssdc", "sdnn", "bpm"):
        np.testing.assert_allclose(getattr(m.hrv, field).numpy()[0, :count],
                                   oracle[f"hrv_{field}"], rtol=1e-9, err_msg=field)


def test_vulpine_golden_summary_metrics(result64):
    """tests/test_pipeline_golden.py::test_pipeline_summary_metrics'
    constants and tolerances, and the golden summary's HRR (58.9)."""
    m = result64.metrics
    np.testing.assert_allclose(float(m.avg_bpm[0]), 122.2, atol=0.05)
    np.testing.assert_allclose(float(m.min_bpm[0]), 78.6, atol=0.05)
    np.testing.assert_allclose(float(m.max_bpm[0]), 163.3, atol=0.05)
    np.testing.assert_allclose(float(m.avg_rmssdc[0]), 117.97, atol=0.005)
    np.testing.assert_allclose(float(m.avg_sdnn[0]), 70.29, atol=0.005)
    np.testing.assert_allclose(float(m.peak_exertion.slope[0]), 3.35, atol=0.005)
    np.testing.assert_allclose(float(m.peak_recovery.slope[0]), -3.11, atol=0.005)
    assert bool(m.hrr.found[0])
    assert abs(float(m.hrr.hrr[0]) - 58.9) < 0.05


def test_vulpine_golden_trace_strings(result64):
    """The port's ``reports.trace.debug_strings`` of the float64 result equal
    tests/golden/vulpine_debug_info.json string for string (the check of
    tests/test_reports.py::test_debug_strings_match_oracle_strings)."""
    with open(GOLDEN_DEBUG_INFO) as f:
        golden = {int(k): v for k, v in json.load(f).items()}
    ours = trace.debug_strings(host.tree_row(host.to_host(result64), 0), tcfg.DEFAULT_CONFIG)
    assert set(ours) == set(golden)
    mismatches = [k for k in golden if ours[k] != golden[k]]
    assert not mismatches, (
        f"{len(mismatches)} differing debug strings; first at {mismatches[0]}:\n"
        f"OURS:   {ours[mismatches[0]]!r}\nGOLDEN: {golden[mismatches[0]]!r}")


def test_vulpine_golden_float32(oracle):
    """tests/test_pipeline_golden.py::test_pipeline_float32 on the port: beat
    F1 >= 0.99 against the golden's final beats at float32."""
    res = _run_default(oracle, np.float32)
    count = int(res.final_count[0])
    got = set(res.final_positions.numpy()[0, :count].tolist())
    exp = set(oracle["final_peaks"].tolist())
    inter = len(got & exp)
    precision = inter / max(len(got), 1)
    recall = inter / len(exp)
    f1 = 2 * precision * recall / (precision + recall)
    assert f1 >= 0.99, f"float32 beat F1 {f1:.4f} (got {len(got)} peaks, exp {len(exp)})"
