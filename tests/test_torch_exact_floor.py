"""The exact stride-1 noise floor of the port against the plain reference
``bench_port/reference/exact_floor.py`` (sorted windows, pandas semantics),
on the CPU: ``ops/quantile.rolling_quantile_centered`` on seeded series with
NaN runs and ties, and ``models/noise_floor.dynamic_noise_floor`` at stride
1 on two 20-second synthetic rows against the floor rebuilt from its own
sanitized troughs; the spans of the exact floor.

Every tolerance is 0: both sides select the same order statistics, which
are values of the series, and finish with the same operations in the same
dtype (``v_lo + frac * (v_hi - v_lo)``, the trough interpolation's
``v0 + frac * (v1 - v0)``)."""
import dataclasses
import json

import numpy as np
import pandas as pd
import pytest
import torch

from bench_port.reference import exact_floor as ref
from bench_port.traffic import synth
from bpm_analysis_tpu_torch.config import AnalyzerConfig, RuntimeConfig
from bpm_analysis_tpu_torch.models import envelope, noise_floor
from bpm_analysis_tpu_torch.ops import quantile as tq
from bpm_analysis_tpu_torch.utils import profiling

torch.set_num_threads(1)

SR = 302
DTYPES = [torch.float64, torch.float32]


def _series(seed: int, kind: str, dtype) -> torch.Tensor:
    """(3, 301) values with NaN runs of 1-40 samples, one all-NaN row
    head, and for ``ties`` values on a coarse grid (many equal values)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((3, 301)) * 5
    if kind == "ties":
        x = np.round(x)
    for r in range(3):
        for _ in range(4):
            a = int(rng.integers(0, 301))
            x[r, a:a + int(rng.integers(1, 41))] = np.nan
    x[1, :60] = np.nan
    return torch.from_numpy(x).to(dtype)


def _assert_same(got: torch.Tensor, exp: torch.Tensor):
    assert got.dtype == exp.dtype and got.shape == exp.shape
    torch.testing.assert_close(got, exp, rtol=0, atol=0, equal_nan=True)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("kind", ["noise", "ties"])
@pytest.mark.parametrize("min_periods", [1, 3])
@pytest.mark.parametrize("window", [1, 2, 7, 8, 64, 65, 400])
def test_rolling_quantile_equals_sorted_windows(window, min_periods, kind, dtype):
    """Odd and even windows (one longer than the rows), q at both ends, the
    noise floor's 0.2 and the median; windows cut at the row ends and by
    NaN runs, some below ``min_periods``."""
    x = _series(window * 10 + min_periods, kind, dtype)
    for q in (0.0, 0.2, 0.5, 1.0):
        got = tq.rolling_quantile_centered(x, window, q, min_periods=min_periods)
        _assert_same(got, ref.rolling_quantile_centered(x, window, q, min_periods, block=37))


@pytest.mark.parametrize("kind", ["noise", "ties"])
@pytest.mark.parametrize("min_periods", [1, 3])
@pytest.mark.parametrize("window", [3, 8, 65, 400])
def test_reference_equals_pandas(window, min_periods, kind):
    """The reference is pandas' ``rolling(center=True).quantile`` bit for
    bit (its ``roll_quantile`` interpolates with the same operations)."""
    x = _series(window + min_periods, kind, torch.float64)
    for q in (0.0, 0.2, 0.5, 1.0):
        exp = np.stack([pd.Series(row).rolling(window, min_periods=min_periods, center=True)
                        .quantile(q).to_numpy() for row in x.numpy()])
        _assert_same(ref.rolling_quantile_centered(x, window, q, min_periods),
                     torch.from_numpy(exp))


def test_reference_helpers_follow_pandas():
    """The interpolation and the fills against pandas' ``interpolate`` and
    ``bfill().ffill()`` on hand-made rows."""
    pos = torch.tensor([2, 5, 9])
    val = torch.tensor([1.0, 4.0, -4.0], dtype=torch.float64)
    exp = pd.Series(val.numpy(), index=pos.numpy()).reindex(range(12)).interpolate()
    _assert_same(ref.interpolate(pos, val, 12), torch.tensor(exp.to_numpy()))
    nan = float("nan")
    for row in ([nan, nan, 1.0, nan, 3.0, nan], [nan] * 3, [2.0, nan, nan]):
        x = torch.tensor(row, dtype=torch.float64)
        exp = pd.Series(x.numpy()).bfill().ffill().to_numpy()
        _assert_same(ref.bfill_ffill(x), torch.tensor(exp))


def _config(dtype) -> AnalyzerConfig:
    return AnalyzerConfig(runtime=RuntimeConfig(
        noise_quantile_stride=1, dtype="float64" if dtype == torch.float64 else "float32"))


@pytest.fixture(scope="module", params=DTYPES, ids=str)
def floor_run(request):
    """Two 20-second rows of the benchmark's synthetic family, through
    ``preprocess`` and ``dynamic_noise_floor`` at stride 1."""
    dtype = request.param
    cfg = _config(dtype)
    rows = np.stack([synth.quantize_int16(synth.synth_recording(s, 20 / 60)) for s in (3, 8)])
    env = envelope.preprocess(rows.astype(np.float64 if dtype == torch.float64 else np.float32),
                              SR, cfg, device="cpu")[0]
    return cfg, env, noise_floor.dynamic_noise_floor(env, SR, cfg)


def test_stride_one_is_the_exact_path(floor_run):
    cfg, env, res = floor_run
    assert noise_floor.quantile_path(cfg) == "exact"
    assert env.dtype == res.floor.dtype
    # The main path of the fallback ladder: the floor of the sanitized troughs.
    assert (res.raw_trough_count >= 5).all() and (res.trough_count > 2).all()


def test_dynamic_noise_floor_equals_the_reference_floor(floor_run):
    cfg, env, res = floor_run
    exp = ref.floors(env, res.trough_positions, res.trough_count,
                     int(cfg.noise.noise_window_sec * SR), cfg.noise.noise_floor_quantile)
    _assert_same(res.floor, exp)


def test_exact_floor_spans(tmp_path):
    """Each exact rolling quantile opens ``bpm.rolling_exact`` with one
    ``.build`` and one ``.select`` inside: two a floor (draft, final)."""
    cfg = _config(torch.float64)
    rows = np.stack([synth.quantize_int16(synth.synth_recording(5, 20 / 60))]).astype(np.float64)
    env = envelope.preprocess(rows, SR, cfg, device="cpu")[0]
    with profiling.device_trace(str(tmp_path)):
        noise_floor.dynamic_noise_floor(env, SR, cfg)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation"
                    and e["name"].startswith("bpm.rolling_exact")), key=lambda s: s[1])
    assert [s[0] for s in spans] == ["bpm.rolling_exact", "bpm.rolling_exact.build",
                                     "bpm.rolling_exact.select"] * 2
    for k in (0, 3):
        outer = spans[k]
        assert all(outer[1] <= s[1] and s[2] <= outer[2] for s in spans[k + 1:k + 3])


def test_exact_floor_opens_no_span_without_a_capture(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function called without a capture")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    x = _series(1, "noise", torch.float64)
    _assert_same(tq.rolling_quantile_centered(x, 8, 0.2, 3),
                 ref.rolling_quantile_centered(x, 8, 0.2, 3))


def test_stride_one_ignores_the_backend():
    """The exact floor reads only the stride: the backend has no effect."""
    cfg = _config(torch.float64)
    for backend in ("auto", "knots", "pallas", "xla"):
        other = dataclasses.replace(cfg, runtime=dataclasses.replace(
            cfg.runtime, quantile_backend=backend))
        assert noise_floor.quantile_path(other) == "exact"
