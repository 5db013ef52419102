"""The port alone (no JAX) on the vulpine golden, on the CPU.

``DEFAULT_CONFIG`` (stride 1: the exact wavelet-tree noise floor), float64,
``envelope_from_filtered`` of the oracle's ``raw_signal`` →
``analyze_batch``, with both prominence backends, held to the checks of
tests/test_pipeline_golden.py::test_pipeline_stage_outputs and
::test_pipeline_classifications, and the noise floor to the oracle's at
tests/test_noise_floor.py's rtol 1e-9.
"""
import dataclasses

import numpy as np
import pytest
import torch

from bpm_analysis_tpu_torch import config as tcfg
from bpm_analysis_tpu_torch import types as ttypes
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import noise_floor as tnf
from bpm_analysis_tpu_torch.models import pipeline as tpipe

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
