"""Port vs JAX: the order statistics and series helpers of the noise floor.

Inputs include NaN, all-invalid and length-1 rows.  Integer outputs are
equal; floats are held at the JAX suite's tolerances for the same functions
(rtol 1e-12 in float64, tests/test_quantile.py and tests/test_series.py) —
the selections are exact and pick the same element."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from bpm_analysis_tpu.ops import quantile as jq
from bpm_analysis_tpu.ops import series as jseries
from bpm_analysis_tpu_torch.ops import quantile as tq
from bpm_analysis_tpu_torch.ops import series as tseries

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)


def _rows(dtype, n=257, seed=0):
    """Rows: plain, duplicates + NaN, all-NaN, negative values and ±0."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n) * 50
    b = np.round(rng.randn(n) * 3)
    b[rng.rand(n) < 0.3] = np.nan
    c = np.full(n, np.nan)
    d = -np.abs(rng.randn(n))
    d[:5] = [0.0, -0.0, -0.0, 0.0, -1e-30]
    return np.stack([a, b, c, d]).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_select_kth_matches_jax(dtype):
    x = _rows(dtype)
    valid = ~np.isnan(x)
    valid[2, :] = False
    nvalid = valid.sum(axis=1)
    k = np.where(nvalid > 0, (nvalid * np.array([0.0, 0.37, 0.5, 0.99])).astype(int), 0)
    got = tq.select_kth(torch.from_numpy(x), torch.from_numpy(valid),
                        torch.from_numpy(k)).numpy()
    for r in range(x.shape[0]):
        if nvalid[r] == 0:
            continue
        exp = np.asarray(jq.select_kth(jnp.asarray(x[r]), jnp.asarray(valid[r]), int(k[r])))
        assert got[r].tobytes() == exp.tobytes()
        assert got[r] == np.sort(x[r][valid[r]])[k[r]]


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("q", [0.1, 0.2, 0.5])
def test_quantile_exact_matches_jax(dtype, q):
    x = _rows(dtype)
    got = tq.quantile_exact_plain(torch.from_numpy(x), q).numpy()
    exp = np.array([np.asarray(jq.quantile_exact(jnp.asarray(r), q)) for r in x])
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got, exp, rtol=rtol, equal_nan=True)
    assert np.isnan(got[2])


def test_quantile_exact_length_one_and_masked():
    x = np.array([[4.5], [np.nan]])
    got = tq.quantile_exact_plain(torch.from_numpy(x), 0.2).numpy()
    assert got[0] == 4.5 and np.isnan(got[1])
    y = _rows(np.float64)
    valid = np.arange(y.shape[1])[None, :] < np.array([[200], [100], [0], [1]])
    valid &= ~np.isnan(y)
    got = tq.quantile_exact_plain(torch.from_numpy(y), 0.1, valid=torch.from_numpy(valid)).numpy()
    exp = np.array([np.asarray(jq.quantile_exact(jnp.asarray(y[r]), 0.1,
                                                 valid=jnp.asarray(valid[r])))
                    for r in range(y.shape[0])])
    np.testing.assert_allclose(got, exp, rtol=1e-12, equal_nan=True)


def _nan_runs():
    rng = np.random.RandomState(4)
    x = rng.randn(6, 40)
    x[0, :7] = np.nan                 # leading run
    x[1, -5:] = np.nan                # trailing run
    x[2, :3] = np.nan
    x[2, -9:] = np.nan                # both
    x[3, :] = np.nan                  # all NaN
    x[4, rng.rand(40) < 0.4] = np.nan  # interior holes
    return x


def test_bfill_ffill_and_edge_fill_match_jax():
    x = _nan_runs()
    got = tq.bfill_ffill(torch.from_numpy(x)).numpy()
    exp = np.stack([np.asarray(jq.bfill_ffill(jnp.asarray(r))) for r in x])
    np.testing.assert_array_equal(got, exp)
    got = tq.edge_fill(torch.from_numpy(x)).numpy()
    exp = np.stack([np.asarray(jq.edge_fill(jnp.asarray(r))) for r in x])
    np.testing.assert_array_equal(got, exp)
    one = tq.bfill_ffill(torch.tensor([[np.nan], [2.0]])).numpy()
    assert np.isnan(one[0, 0]) and one[1, 0] == 2.0


def test_interp_anchors_matches_jax():
    rng = np.random.RandomState(5)
    a = rng.randn(3, 9)
    a[1, 0] = np.nan
    a[2, -1] = np.nan
    got = tq.interp_anchors(torch.from_numpy(a), 9 * 8 - 5, 8).numpy()
    exp = np.asarray(jq.interp_anchors(jnp.asarray(a), 9 * 8 - 5, 8, jnp.float64))
    np.testing.assert_array_equal(got, exp)


def test_compact_valid_matches_jax():
    rng = np.random.RandomState(6)
    idx = rng.randint(0, 1000, size=(4, 33)).astype(np.int32)
    valid = rng.rand(4, 33) < 0.5
    valid[2] = False
    valid[3] = True
    got, cnt = tseries.compact_valid(torch.from_numpy(idx), torch.from_numpy(valid), fill=1000)
    for r in range(4):
        e, c = jseries.compact_valid(jnp.asarray(idx[r]), jnp.asarray(valid[r]), fill=1000)
        np.testing.assert_array_equal(got.numpy()[r], np.asarray(e))
        assert int(cnt[r]) == int(c)


def test_masked_median_and_quantile_match_jax():
    rng = np.random.RandomState(7)
    x = rng.randn(4, 50)
    valid = rng.rand(4, 50) < 0.6
    valid[1] = False
    valid[2] = np.arange(50) == 17           # one valid entry
    got = tseries.masked_median(torch.from_numpy(x), torch.from_numpy(valid)).numpy()
    exp = np.array([np.asarray(jseries.masked_median(jnp.asarray(x[r]), jnp.asarray(valid[r])))
                    for r in range(4)])
    np.testing.assert_allclose(got, exp, rtol=1e-12, equal_nan=True)
    assert np.isnan(got[1]) and got[2] == x[2, 17]
    got = tseries.masked_quantile(torch.from_numpy(x), torch.from_numpy(valid), 0.25).numpy()
    np.testing.assert_allclose(got[[0, 3]], [np.quantile(x[r][valid[r]], 0.25) for r in (0, 3)],
                               rtol=1e-12)


def test_asof_matches_jax():
    index = np.array([[3.0, 8.0, 20.0, 0, 0], [1.0, 2.0, 0, 0, 0]])
    values = np.array([[10.0, 20.0, 30.0, -1, -1], [5.0, 6.0, -1, -1, -1]])
    count = np.array([3, 2])
    query = np.array([[2.0, 3.0, 9.5, 25.0], [0.5, 1.0, 1.5, 99.0]])
    got = tseries.asof(torch.from_numpy(index), torch.from_numpy(values),
                       torch.from_numpy(count), torch.from_numpy(query)).numpy()
    exp = np.stack([np.asarray(jseries.asof(jnp.asarray(index[r]), jnp.asarray(values[r]),
                                            int(count[r]), jnp.asarray(query[r])))
                    for r in range(2)])
    np.testing.assert_array_equal(got, exp)


def test_fill_pairs_match_associative_scan():
    x = _nan_runs()
    valid = ~np.isnan(x)
    for port, ref in ((tseries._ffill_pairs, jseries._ffill_pairs),
                      (tseries._bfill_pairs, jseries._bfill_pairs)):
        v, f = port(torch.from_numpy(x), torch.from_numpy(valid))
        for r in range(x.shape[0]):
            ev, ef = ref(jnp.asarray(x[r]), jnp.asarray(valid[r]))
            np.testing.assert_array_equal(v.numpy()[r], np.asarray(ev))
            np.testing.assert_array_equal(f.numpy()[r], np.asarray(ef))


def test_rolling_quantile_sort_matches_jax_and_the_wavelet_tree():
    """The sort cross-check (``rolling_quantile_centered_sort``) against JAX's
    on tests/test_quantile.py's cross-check input (rows of a batch, one of
    them short of ``min_periods`` at its edges), and against the port's
    wavelet tree, both at rtol 1e-12 in float64."""
    rng = np.random.RandomState(7)
    x = rng.randn(2, 1000) * 100
    x[rng.rand(2, 1000) < 0.15] = np.nan
    x[1, 40:200] = np.nan
    got = tq.rolling_quantile_centered_sort(torch.from_numpy(x), 73, 0.37, 4, chunk=128)
    exp = np.stack([np.asarray(jq.rolling_quantile_centered_sort(jnp.asarray(r), 73, 0.37, 4,
                                                                 chunk=128)) for r in x])
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-12, equal_nan=True)
    tree = tq.rolling_quantile_centered(torch.from_numpy(x), 73, 0.37, 4).numpy()
    np.testing.assert_allclose(got.numpy(), tree, rtol=1e-12, equal_nan=True)
    assert np.isnan(got.numpy()[1, 100])
