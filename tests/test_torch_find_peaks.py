"""Port vs JAX: the extrema decomposition and the peak finder.

Positions, counts and the overflow flag must be equal: the extrema-domain
path of the trough and raw-peak finders (candidates from the shared
extrema, sweep + residual prominences, distance NMS), the dense path the
BPM-curve slope search uses (per-row distance), ties, and capacities that
truncate."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from bpm_analysis_tpu.ops import find_peaks as jfp
from bpm_analysis_tpu_torch.ops import find_peaks as tfp

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)


def _envelope_like(seed, n=3000, quantize=True):
    """Smoothed |noise| with beat-like bumps; quantized so plateaus and equal
    heights occur (the int16-quantized synthetics have both)."""
    rng = np.random.RandomState(seed)
    x = np.abs(rng.randn(n))
    bumps = np.zeros(n)
    bumps[rng.choice(n, 40, replace=False)] = rng.uniform(5, 20, 40)
    x = np.convolve(x + bumps, np.ones(9) / 9, mode="same")
    return np.round(x * 8) / 8 if quantize else x


def _jax_finders(x, thr, ext_cap, cap, prom, dist, W, R, ccap):
    """Trough + raw-peak finders as the JAX pipeline calls them."""
    ext = jfp.build_extrema(x, ext_cap)
    troughs = jfp.find_peaks(
        -x, cap, prominence=prom, distance=dist, prominence_capacity=int(1.5 * cap),
        extrema=ext, extrema_negated=True,
        candidates=jfp.Peaks(ext.min_positions, ext.min_count, ext.overflowed),
        priorities=-ext.min_heights[1:-1], prominence_sweep_window=W,
        prominence_residual_capacity=R)
    mh = ext.max_heights[1:-1]
    keep = (jnp.arange(mh.shape[0]) < ext.max_count) & (mh >= thr)
    (cpos, chts), ccount, cover = jfp.compact_slots(
        keep, ccap, [(ext.max_positions, x.shape[0]), (mh, jnp.array(-jnp.inf, mh.dtype))])
    peaks = jfp.find_peaks(
        x, cap, prominence=prom, distance=dist, prominence_capacity=int(1.5 * cap),
        extrema=ext, candidates=jfp.Peaks(cpos, ccount, cover | ext.overflowed),
        priorities=chts, prominence_sweep_window=W, prominence_residual_capacity=R)
    return ext, troughs, peaks


def _port_finders(x, thr, ext_cap, cap, prom, dist, W, R, ccap):
    ext = tfp.build_extrema(x, ext_cap)
    troughs = tfp.find_peaks(
        -x, cap, prominence=prom, distance=dist, prominence_capacity=int(1.5 * cap),
        extrema=ext, extrema_negated=True,
        candidates=tfp.Peaks(ext.min_positions, ext.min_count, ext.overflowed),
        priorities=-ext.min_heights[:, 1:-1], prominence_sweep_window=W,
        prominence_residual_capacity=R)
    mh = ext.max_heights[:, 1:-1]
    keep = (torch.arange(mh.shape[1])[None, :] < ext.max_count.long()[:, None]) & (mh >= thr)
    (cpos, chts), ccount, cover = tfp.compact_slots(
        keep, ccap, [(ext.max_positions, x.shape[1]), (mh, float("-inf"))])
    peaks = tfp.find_peaks(
        x, cap, prominence=prom, distance=dist, prominence_capacity=int(1.5 * cap),
        extrema=ext, candidates=tfp.Peaks(cpos, ccount, cover | ext.overflowed),
        priorities=chts, prominence_sweep_window=W, prominence_residual_capacity=R)
    return ext, troughs, peaks


def _assert_peaks_equal(got, exp, row):
    np.testing.assert_array_equal(got.positions.numpy()[row], np.asarray(exp.positions))
    assert int(got.count[row]) == int(exp.count)
    assert bool(got.overflowed[row]) == bool(exp.overflowed)


@pytest.mark.parametrize("ext_cap,cap,W,R,ccap", [
    (1200, 256, 64, 256, 600),   # roomy: every capacity holds
    (1200, 256, 4, 64, 600),     # narrow sweep: the residual descent does the work
    (400, 64, 8, 8, 100),        # every capacity truncates, overflow flags set
])
def test_extrema_finders_match_jax(ext_cap, cap, W, R, ccap):
    xs = np.stack([_envelope_like(s) for s in (0, 1, 2)])
    prom, dist = 0.4, 15
    thr = np.median(xs, axis=1)                  # raw-peak height threshold
    got_e, got_t, got_p = _port_finders(torch.from_numpy(xs), torch.from_numpy(thr)[:, None],
                                        ext_cap, cap, prom, dist, W, R, ccap)
    fn = jax.jit(lambda x, t: _jax_finders(x, t, ext_cap, cap, prom, dist, W, R, ccap))
    for r, x in enumerate(xs):
        exp_e, exp_t, exp_p = fn(jnp.asarray(x), jnp.asarray(thr[r]))
        for f in ("max_heights", "min_heights", "max_positions", "min_positions",
                  "union_rank"):
            np.testing.assert_array_equal(getattr(got_e, f).numpy()[r],
                                          np.asarray(getattr(exp_e, f)), err_msg=f)
        for f in ("first_is_max", "max_count", "min_count", "overflowed"):
            assert int(getattr(got_e, f)[r]) == int(getattr(exp_e, f)), f
        _assert_peaks_equal(got_t, exp_t, r)
        _assert_peaks_equal(got_p, exp_p, r)
    if ext_cap == 400:
        assert got_e.overflowed.all() and got_t.overflowed.all() and got_p.overflowed.all()


def test_distance_ties_go_to_the_later_peak():
    """Equal heights inside one distance window: the later peak survives, on
    both paths, for several tie layouts."""
    x = np.zeros((3, 60))
    x[0, [10, 14, 18]] = 5.0                      # a chain of equal peaks
    x[1, [10, 14]] = 5.0
    x[1, 30] = 7.0
    x[1, [33, 36]] = 7.0
    x[2, [5, 9, 40, 44, 48]] = [3.0, 3.0, 2.0, 2.0, 2.0]
    xt = torch.from_numpy(x)
    ext = tfp.build_extrema(xt, 40)
    got = tfp.find_peaks(xt, 16, prominence=0.1, distance=6, extrema=ext,
                         candidates=tfp.Peaks(ext.max_positions, ext.max_count,
                                              ext.overflowed),
                         priorities=ext.max_heights[:, 1:-1], prominence_sweep_window=8)
    dense = tfp.find_peaks(xt, 16, prominence=0.1, distance=torch.tensor([6, 6, 6]))
    @jax.jit
    def jax_paths(xr):
        e = jfp.build_extrema(xr, 40)
        ext_path = jfp.find_peaks(xr, 16, prominence=0.1, distance=6, extrema=e,
                                  candidates=jfp.Peaks(e.max_positions, e.max_count,
                                                       e.overflowed),
                                  priorities=e.max_heights[1:-1], prominence_sweep_window=8)
        return ext_path, jfp.find_peaks(xr, 16, prominence=0.1, distance=jnp.asarray(6))

    for r in range(3):
        exp, exp_d = jax_paths(jnp.asarray(x[r]))
        _assert_peaks_equal(got, exp, r)
        _assert_peaks_equal(dense, exp_d, r)
    kept = got.positions.numpy()[0][:int(got.count[0])]
    assert 18 in kept and 14 not in kept


@pytest.mark.parametrize("seed", [3, 4])
def test_dense_path_with_per_row_distance_matches_jax(seed):
    """The slope search's call: dense local maxima, sparse-table
    prominences, a per-row (traced) distance."""
    rng = np.random.RandomState(seed)
    xs = np.stack([np.cumsum(rng.randn(300)) for _ in range(3)])
    xs[2, 200:] = xs[2, 199]                       # a flat tail
    dist = np.array([1, 4, 9], np.int32)
    got = tfp.find_peaks(torch.from_numpy(xs), 64, prominence=1.5,
                         distance=torch.from_numpy(dist))
    got_tr = tfp.find_peaks(-torch.from_numpy(xs), 8, prominence=1.5,
                            distance=torch.from_numpy(dist))
    fn = jax.jit(lambda x, d, c: jfp.find_peaks(x, c, prominence=1.5, distance=d),
                 static_argnums=2)
    for r in range(3):
        _assert_peaks_equal(got, fn(jnp.asarray(xs[r]), jnp.asarray(dist[r]), 64), r)
        _assert_peaks_equal(got_tr, fn(-jnp.asarray(xs[r]), jnp.asarray(dist[r]), 8), r)


def test_distance_capacity_bound_is_the_reference_formula():
    for n, d in ((181200, 15), (18120, 15), (1000, 7.5), (50, 100)):
        assert tfp.distance_capacity_bound(n, d) == jfp.distance_capacity_bound(n, d)
