"""The port's fixed-order sums: the rolling means and the metric means that
give a recording the same bits in any batch.

On the card a library scan or reduction picks its association from the
whole tensor shape, so the serial host path (a batch of one) and the
batched path (16 rows) once printed different BPM curves (ROADMAP C5).
These sums now run in one ascending or pairwise order that depends only on
the row: on the CPU each is held bit for bit against a numpy loop in that
order, and against the JAX functions at float64 (rtol 1e-12).  The card
test (tests/test_torch_cuda.py) holds a row alone against the same row in
a batch of 16.
"""
import datetime

import numpy as np
import jax.numpy as jnp
import pandas as pd
import pytest
import torch

from bpm_analysis_tpu.ops import rolling as jrolling
from bpm_analysis_tpu_torch.ops import rolling as trolling
from bpm_analysis_tpu_torch.ops import series as tseries


def _tree_sum_np(row: np.ndarray) -> np.ndarray:
    width = 1 << max(0, (len(row) - 1).bit_length())
    x = np.concatenate([row, np.zeros(width - len(row), row.dtype)])
    while len(x) > 1:
        x = x[: len(x) // 2] + x[len(x) // 2:]
    return x[0]


@pytest.mark.parametrize("n", [1, 2, 7, 30, 1536])
def test_fixed_order_sum_is_the_pairwise_tree(n):
    rng = np.random.RandomState(n)
    x = (rng.rand(3, n) * 200).astype(np.float32)
    got = tseries.fixed_order_sum(torch.from_numpy(x)).numpy()
    exp = np.array([_tree_sum_np(r) for r in x], np.float32)
    np.testing.assert_array_equal(got, exp)
    # A row's sum does not depend on its batch.
    alone = tseries.fixed_order_sum(torch.from_numpy(x[1:2])).numpy()
    np.testing.assert_array_equal(alone, got[1:2])


def test_nanmean_fixed():
    rng = np.random.RandomState(0)
    x = rng.rand(4, 100)
    x[0, ::3] = np.nan
    x[3] = np.nan
    got = tseries.nanmean_fixed(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[:3], np.nanmean(x[:3], axis=1), rtol=1e-14)
    assert np.isnan(got[3])


def _ascending_window_sums(x, lo, hi):
    out = np.zeros_like(x)
    for b in range(x.shape[0]):
        for i in range(x.shape[1]):
            acc = x.dtype.type(0)
            for j in range(lo[b, i], hi[b, i]):
                acc = acc + x[b, j]
            out[b, i] = acc
    return out


def test_window_sum_adds_in_ascending_order():
    rng = np.random.RandomState(1)
    x = (rng.rand(2, 60) * 100).astype(np.float32)
    idx = np.arange(60)[None, :]
    lo = np.clip(idx - rng.randint(0, 6, size=(2, 60)), 0, 60)
    hi = np.clip(idx + 1 + rng.randint(0, 5, size=(2, 60)), 0, 60)
    got = trolling._window_sum(torch.from_numpy(x), torch.from_numpy(lo),
                               torch.from_numpy(hi), 5, 4).numpy()
    np.testing.assert_array_equal(got, _ascending_window_sums(x, lo, hi))


@pytest.mark.parametrize("window", [5, 8, 73])
def test_dynamic_window_equals_jax_and_pandas(window):
    rng = np.random.RandomState(2)
    n, cap = 211, 256
    xp = np.zeros(cap)
    xp[:n] = rng.rand(n)
    valid = np.arange(cap) < n
    got = trolling.rolling_mean_dynamic_window(
        torch.from_numpy(xp)[None], torch.from_numpy(valid)[None],
        torch.tensor([window]), max_window=80).numpy()[0]
    exp = np.asarray(jrolling.rolling_mean_dynamic_window(jnp.asarray(xp), jnp.asarray(valid),
                                                          window))
    np.testing.assert_allclose(got, exp, rtol=1e-12, equal_nan=True)
    ref = pd.Series(xp[:n]).rolling(window=window, min_periods=1, center=True).mean().values
    np.testing.assert_allclose(got[:n], ref, rtol=1e-12)


@pytest.mark.parametrize("max_slots", [None, 40])
def test_time_window_equals_jax_and_pandas(max_slots):
    rng = np.random.RandomState(3)
    n, cap = 180, 256
    times = np.sort(rng.rand(n) * 300.0)
    times += np.arange(n) * 0.2           # >= 0.2 s apart: <= 13 slots in a half window
    values = rng.rand(n) * 100
    tp, vp = np.zeros(cap), np.zeros(cap)
    tp[:n], vp[:n] = times, values
    valid = np.arange(cap) < n
    got = trolling.rolling_mean_time_window(
        torch.from_numpy(tp)[None], torch.from_numpy(vp)[None], torch.from_numpy(valid)[None],
        5.0, max_slots_in_half_window=max_slots).numpy()[0]
    exp = np.asarray(jrolling.rolling_mean_time_window(
        jnp.asarray(tp), jnp.asarray(vp), jnp.asarray(valid), 5.0,
        max_slots_in_half_window=max_slots))
    np.testing.assert_allclose(got, exp, rtol=1e-12, equal_nan=True)
    idx = [datetime.datetime.fromtimestamp(0) + datetime.timedelta(seconds=s) for s in times]
    ref = pd.Series(values, index=idx).rolling(window="5s", min_periods=1,
                                               center=True).mean().values
    np.testing.assert_allclose(got[:n], ref, rtol=1e-12)
