"""The row-quantile kernel's surroundings on the CPU
(``ops/cuda/row_quantile_kernel``, ``csrc/row_quantile.cu``):
``ops/quantile.quantile_exact`` takes the plain version for a CPU tensor
and rejects what the kernel does not take; the plain version matches the
JAX package's ``quantile_exact`` on adversarial rows
(``chip_smoke.row_quantile_cases``); and the kernel's design, emulated in
numpy (11-bit digits of the key, a row split into the slices of a
cluster's blocks, the float-compare pass for v_hi), equals the plain
version bit for bit.  The kernel itself runs in
``tests/test_torch_cuda.py`` on a card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from bpm_analysis_tpu.ops import quantile as jq
from bpm_analysis_tpu_torch.ops import quantile as tq
from bpm_analysis_tpu_torch.kernels import build

torch.set_num_threads(1)

QS = chip_smoke.ROW_QUANTILE_QS
DTYPES = (np.float32, np.float64)
CASES = chip_smoke.row_quantile_cases(37)
CASE_IDS = [c[0] for c in CASES]


def _tensors(case, dtype):
    _, x, valid = case
    return (torch.from_numpy(x.astype(dtype)),
            None if valid is None else torch.from_numpy(valid))


def emulate(x: np.ndarray, q: float, valid, split: int) -> np.ndarray:
    """The kernel's algorithm on one dtype's rows: per pass an 11-bit digit
    of the sortable key from the top, each of ``split`` blocks counting the
    valid keys of its slice of whole items (4 float32 or 2 float64 elements)
    whose higher bits match the prefix, the cluster's counts summed; then
    the float-compare pass for v_hi and the interpolation in the dtype."""
    dt = x.dtype.type
    ut = np.uint32 if x.dtype == np.float32 else np.uint64
    width, vec = (32, 4) if x.dtype == np.float32 else (64, 2)
    sign = ut(1) << ut(width - 1)
    out = np.empty(x.shape[0], x.dtype)
    n = x.shape[1]
    items = -(-n // vec)
    per = -(-items // split)
    slices = [(min(items, r * per) * vec, min(items, r * per + per) * vec)
              for r in range(split)]
    for row in range(x.shape[0]):
        xr = x[row]
        ok = ~np.isnan(xr) if valid is None else valid[row]
        bits = xr.view(ut)
        keys = np.where(bits & sign, ~bits, bits ^ sign)
        prefix, hi_shift, k = ut(0), width, 0
        n_valid = 0
        while hi_shift > 0:
            shift = max(hi_shift - 11, 0)
            mask = ut((1 << (hi_shift - shift)) - 1)
            hist = np.zeros(2048, np.int64)
            for a, b in slices:
                kk = keys[a:b][ok[a:b]]
                if hi_shift < width:
                    kk = kk[(kk >> ut(hi_shift)) == (prefix >> ut(hi_shift))]
                np.add.at(hist, ((kk >> ut(shift)) & mask).astype(np.int64), 1)
            if hi_shift == width:
                n_valid = int(hist.sum())
                if n_valid == 0:
                    break
                pos = dt(q) * dt(n_valid - 1)
                k_lo = min(max(int(np.floor(pos)), 0), n_valid - 1)
                frac = pos - dt(k_lo)
                k = k_lo
            cum = np.cumsum(hist)
            d = int(np.searchsorted(cum, k, side="right"))
            k -= int(cum[d] - hist[d])
            prefix |= ut(d) << ut(shift)
            hi_shift = shift
        if n_valid == 0:
            out[row] = np.nan
            continue
        v_lo = (prefix ^ sign if prefix & sign else ~prefix).view(x.dtype)
        res = v_lo
        if frac > 0:
            v_hi = v_lo
            if k_lo + 1 < n_valid:
                cnt, mn = 0, dt(np.inf)
                for a, b in slices:
                    xs, oks = xr[a:b], ok[a:b]
                    cnt += int((oks & (xs <= v_lo)).sum())
                    above = xs[oks & (xs > v_lo)]
                    if above.size:
                        mn = min(mn, above.min())
                v_hi = v_lo if cnt >= k_lo + 2 else mn
            with np.errstate(invalid="ignore"):     # inf - inf, as on the card
                res = v_lo + frac * (v_hi - v_lo)
        out[row] = res
    return out


@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_wrapper_takes_the_plain_version_on_the_cpu(case, q):
    x, valid = _tensors(case, np.float64)
    before = build.launches["row_quantile"]
    got = tq.quantile_exact(x, q, valid)
    exp = tq.quantile_exact_plain(x, q, valid)
    assert build.launches["row_quantile"] == before
    assert chip_smoke.same_values(got, exp)


def _bad_inputs():
    x = torch.ones((2, 8))
    valid = torch.ones((2, 8), dtype=torch.bool)
    return [("non_contiguous", x[:, ::2], None), ("one_dim", x[0], None),
            ("three_dim", x[None], None), ("integer", x.to(torch.int32), None),
            ("float16", x.half(), None), ("valid_shape", x, valid[:, :4]),
            ("valid_not_bool", x, valid.to(torch.uint8)),
            ("valid_non_contiguous", x, torch.ones((2, 16), dtype=torch.bool)[:, ::2])]


@pytest.mark.parametrize("bad", _bad_inputs(), ids=lambda b: b[0])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    _, x, valid = bad
    with pytest.raises(ValueError):
        tq.quantile_exact(x, 0.5, valid)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("q", QS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_plain_version_matches_jax_on_adversarial_rows(case, q, dtype):
    x, valid = _tensors(case, dtype)
    got = tq.quantile_exact_plain(x, q, valid).numpy()
    xs = x.numpy()
    exp = np.array([np.asarray(jq.quantile_exact(
        jnp.asarray(xs[r]), q, valid=None if valid is None else jnp.asarray(valid[r].numpy())))
        for r in range(xs.shape[0])])
    rtol = 1e-12 if dtype == np.float64 else 1e-6
    np.testing.assert_allclose(got, exp, rtol=rtol, equal_nan=True)


@pytest.mark.parametrize("split", [1, 2, 8])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [7, 37, 1001])
def test_kernel_design_equals_the_plain_version(n, dtype, split):
    """Every case and q at a ragged small row, one that leaves a block of an
    8-way split without items, and a longer one."""
    for case in chip_smoke.row_quantile_cases(n, seed=n):
        x, valid = _tensors(case, dtype)
        for q in QS:
            exp = tq.quantile_exact_plain(x, q, valid)
            got = emulate(x.numpy(), q, None if valid is None else valid.numpy(), split)
            assert chip_smoke.same_values(torch.from_numpy(got), exp), (case[0], q, got, exp)
