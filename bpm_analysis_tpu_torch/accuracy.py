"""Accuracy metrics against the CPU reference: copies of ``bench.beat_f1``
and ``bench.bpm_mae`` (the repo's north-star gate: worst-case beat F1 >= 0.99
and BPM MAE < 0.5)."""
import numpy as np

F1_FLOOR = 0.99
MAE_CEIL = 0.5


def beat_f1(times_a, times_b, tol=0.05):
    """Beat-level F1 with a time-match tolerance (BASELINE accuracy metric)."""
    a = np.sort(np.asarray(times_a))
    b = np.sort(np.asarray(times_b))
    if len(a) == 0 or len(b) == 0:
        return 0.0
    idx = np.searchsorted(b, a)
    near = np.minimum(
        np.abs(a - b[np.clip(idx, 0, len(b) - 1)]),
        np.abs(a - b[np.clip(idx - 1, 0, len(b) - 1)]),
    )
    tp = np.sum(near <= tol)
    precision = tp / len(a)
    recall = tp / len(b)
    return 2 * precision * recall / max(precision + recall, 1e-9)


def bpm_mae(ref_times, ref_values, times, values) -> float:
    """MAE of the smoothed BPM curve vs the reference curve, evaluated at the
    reference's beat times (BASELINE north-star: MAE < 0.5)."""
    ref_times = np.asarray(ref_times, float)
    ref_values = np.asarray(ref_values, float)
    times = np.asarray(times, float)
    values = np.asarray(values, float)
    if len(ref_times) == 0 or len(times) == 0:
        return float("nan")
    return float(np.mean(np.abs(np.interp(ref_times, times, values) - ref_values)))


def result_curves(res, rate: int) -> list:
    """Per-recording (beat_times, bpm_times, bpm_values) of a batched
    ``PipelineResult``, as ``bench._tpu_curves`` reads them."""
    counts = res.final_count.cpu().numpy()
    positions = res.final_positions.cpu().numpy()
    m = res.metrics.bpm
    ctimes = m.times.cpu().numpy()
    csmooth = m.smoothed.cpu().numpy()
    ccount = m.count.cpu().numpy()
    out = []
    for s in range(len(counts)):
        k = int(ccount[s])
        out.append((positions[s][: counts[s]] / rate, ctimes[s][:k],
                    csmooth[s][:k]))
    return out
