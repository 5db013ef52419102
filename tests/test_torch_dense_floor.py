"""Port vs JAX: the dense noise floor and the alternate backends around it.

* ``series.interpolate_dense``, both branches (searchsorted; the 128-sample
  block form for spaced knots): count 0, the first knot past 0, a full
  capacity; equal in float64 and float32.
* ``noise_floor.dynamic_noise_floor`` on its dense branch, a 2-row batch
  with a padded row (``n_valid``): stride 64 "xla" and stride 1 (the
  wavelet tree) in float64 against the same JAX backend, rtol 1e-12 on the
  floor; stride 64 "pallas" (the strided-quantile kernel's plain version on
  the CPU) in float32 against JAX "xla", rtol 1e-6 (the TPU kernel's
  tolerance, tests/test_pallas_quantile.py; JAX's own "pallas" backend
  cannot run on the CPU inside the floor).  Trough positions and counts are
  equal.
* ``find_peaks`` with a height and shared / negated tables, and
  ``analyze_batch`` with ``prominence_backend="dense"``: every integer field
  of ``PipelineResult`` equal in float64.
* ``fir_decimate`` (tests/test_decimate.py's shapes, rtol 1e-12 in float64)
  and ``preprocess`` with ``antialias_decimation=True`` on a 44.1 kHz batch
  with a masked row.
* ``analyze_batch`` runs every backend configuration on the CPU.
The vulpine golden of the default (stride-1) configuration is
tests/test_torch_golden.py.
"""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from bpm_analysis_tpu.config import DEFAULT_CONFIG
from bpm_analysis_tpu.models import envelope as jenv
from bpm_analysis_tpu.models import noise_floor as jnf
from bpm_analysis_tpu.models import pipeline as jpipe
from bpm_analysis_tpu.ops import filter as jfilter
from bpm_analysis_tpu.ops import find_peaks as jfp
from bpm_analysis_tpu.ops import series as jseries
from bpm_analysis_tpu_torch import config as tcfg
from bpm_analysis_tpu_torch.accuracy import beat_f1, result_curves
from bpm_analysis_tpu_torch.kernels import build
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import noise_floor as tnf
from bpm_analysis_tpu_torch.models import pipeline as tpipe
from bpm_analysis_tpu_torch.ops import filter as tfilter
from bpm_analysis_tpu_torch.ops import find_peaks as tfp
from bpm_analysis_tpu_torch.ops import series as tseries
from test_torch_pipeline import _leaves

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

SR = 302
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _config(dtype="float64", **runtime):
    """Small capacities (tests/test_torch_pipeline.py's), an extrema and a
    dense work capacity that these 60 s recordings do not truncate."""
    return dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
        DEFAULT_CONFIG.runtime, max_raw_peaks=512, max_troughs=512, max_candidates=256,
        extrema_capacity=4096, find_peaks_work_factor=8, dtype=dtype, **runtime))


def _recordings(dtype, seconds=60, seeds=(0, 1)) -> np.ndarray:
    n = SR * seconds
    return np.stack([bench._quantize_int16(bench.synth_recording(s)[:n]).astype(dtype)
                     for s in seeds])


def _knots():
    """(B, 64) sorted knots in [0, 1000): spaced 15-40 apart, none, the
    first past 0, a full capacity, a single knot."""
    rng = np.random.RandomState(0)
    n, cap = 1000, 64
    rows, counts = [], []
    for c, first in ((40, 0), (0, 0), (30, 120), (64, 3), (1, 500)):
        gaps = rng.randint(15, 40, size=max(c, 1))
        p = np.cumsum(gaps) - gaps[0] + first
        p = p[p < n][:c]
        full = np.full(cap, n, np.int64)
        full[:len(p)] = p
        rows.append(full)
        counts.append(len(p))
    return np.stack(rows), np.abs(rng.randn(len(rows), cap)) * 50, np.array(counts), n


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("min_spacing", [None, 15], ids=["searchsorted", "blocks"])
def test_interpolate_dense_matches_jax(min_spacing, dtype):
    pos, val, cnt, n = _knots()
    got = tseries.interpolate_dense(torch.from_numpy(pos), torch.from_numpy(val),
                                    torch.from_numpy(cnt), n, dtype=TDTYPE[dtype],
                                    min_spacing=min_spacing).numpy()
    exp = np.stack([np.asarray(jseries.interpolate_dense(
        jnp.asarray(pos[r]), jnp.asarray(val[r]), int(cnt[r]), n, dtype=dtype,
        min_spacing=min_spacing)) for r in range(len(pos))])
    assert got.dtype == exp.dtype
    np.testing.assert_array_equal(got, exp)
    assert np.isnan(got[1]).all() and np.isnan(got[2, :120]).all()


@pytest.fixture(scope="module")
def padded_envelopes():
    """Envelopes (float64) of two 60 s recordings, row 1 padded after 45 s."""
    x = _recordings(np.float64)
    nv = np.array([x.shape[1], SR * 45])
    x[1, nv[1]:] = 0.0
    cfg = tcfg.config_from_dict(dataclasses.asdict(_config()))
    env, _, _, nv_dec = tenv.preprocess(x, SR, cfg, n_valid=nv, device="cpu")
    return env.numpy(), nv_dec.numpy()


def _floors(env, nv, jax_cfg, port_cfg):
    """(port, JAX) noise floors of ``env`` (B, n) with ``n_valid``, each on
    its configuration and on the shared extrema of the edge-held
    envelope."""
    ext_cap = jax_cfg.runtime.extrema_capacity

    @jax.jit
    def jax_floor(e, v):
        _, env_m = jenv.edge_held(e, v)
        return jnf.dynamic_noise_floor(e, SR, jax_cfg, n_valid=v,
                                       extrema=jfp.build_extrema(env_m, ext_cap))

    exp = jax.tree_util.tree_map(np.asarray, jax.vmap(jax_floor)(jnp.asarray(env),
                                                                 jnp.asarray(nv)))
    tc = tcfg.config_from_dict(dataclasses.asdict(port_cfg))
    env_t, nv_t = torch.from_numpy(env), torch.from_numpy(nv)
    _, env_m = tenv.edge_held(env_t, nv_t)
    got = tnf.dynamic_noise_floor(env_t, SR, tc, n_valid=nv_t,
                                  extrema=tfp.build_extrema(env_m, ext_cap))
    return got, exp


@pytest.mark.parametrize("port_backend,stride,dtype,rtol", [
    ("xla", 64, np.float64, 1e-12),
    ("pallas", 64, np.float32, 1e-6),
    ("auto", 1, np.float64, 1e-12),
], ids=["xla_stride64", "pallas_stride64", "exact_stride1"])
def test_dense_noise_floor_matches_jax(padded_envelopes, port_backend, stride, dtype, rtol):
    env, nv = padded_envelopes
    name = np.dtype(dtype).name
    port_cfg = _config(name, noise_quantile_stride=stride, quantile_backend=port_backend)
    jax_cfg = _config(name, noise_quantile_stride=stride,
                      quantile_backend="xla" if port_backend == "pallas" else port_backend)
    assert tnf.quantile_path(tcfg.config_from_dict(dataclasses.asdict(port_cfg))) == {
        "xla": "strided", "pallas": "strided_kernel", "auto": "exact"}[port_backend]
    before = build.launches.copy()
    got, exp = _floors(env.astype(dtype), nv, jax_cfg, port_cfg)
    assert build.launches == before          # no kernel launch on the CPU
    np.testing.assert_array_equal(got.trough_count.numpy(), exp.trough_count)
    np.testing.assert_array_equal(got.trough_positions.numpy(), exp.trough_positions)
    np.testing.assert_array_equal(got.raw_trough_positions.numpy(), exp.raw_trough_positions)
    assert not exp.overflowed.any() and (exp.trough_count > 100).all()
    assert got.floor.dtype == TDTYPE[dtype]
    for r in range(2):
        k = int(nv[r])
        np.testing.assert_allclose(got.floor.numpy()[r, :k], exp.floor[r, :k], rtol=rtol,
                                   err_msg=f"row {r}")


def _signal():
    rng = np.random.RandomState(3)
    x = np.cumsum(rng.randn(3, 600), axis=1)
    x[1, 100:140] = np.round(x[1, 100:140])       # plateaus
    return x


@pytest.mark.parametrize("height", ["scalar", "per_row", "per_sample"])
def test_find_peaks_height_and_shared_tables_match_jax(height):
    """Height (scalar, (B,) or per sample), and the dense prominences on
    shared tables: the tables of x for peaks of x, and the same tables read
    negated for troughs (peaks of -x)."""
    x = _signal()
    h = {"scalar": np.float64(np.median(x)),
         "per_row": np.array([np.quantile(r, f) for r, f in zip(x, (0.3, 0.5, 0.7))]),
         "per_sample": x.mean(axis=1, keepdims=True) + np.sin(np.arange(600) / 40)}[height]
    xt = torch.from_numpy(x)
    tables = (tfp._sparse_table(xt, torch.maximum), tfp._sparse_table(xt, torch.minimum))
    kw = dict(prominence=0.5, distance=4.0, work_capacity=256)
    peaks = tfp.find_peaks(xt, 96, height=torch.as_tensor(h), max_table=tables[0],
                           min_table=tables[1], **kw)
    troughs = tfp.find_peaks(-xt, 96, max_table=tables[0], min_table=tables[1],
                             tables_negated=True, **kw)
    for r in range(3):
        hr = h if np.ndim(h) == 0 else h[r]
        xr = jnp.asarray(x[r])
        jt = (jfp._sparse_table(xr, jnp.maximum), jfp._sparse_table(xr, jnp.minimum))
        ep = jfp.find_peaks(xr, 96, height=jnp.asarray(hr), max_table=jt[0], min_table=jt[1],
                            **kw)
        et = jfp.find_peaks(-xr, 96, max_table=jt[0], min_table=jt[1], tables_negated=True,
                            **kw)
        for got, exp in ((peaks, ep), (troughs, et)):
            assert int(got.count[r]) == int(exp.count) > 3
            np.testing.assert_array_equal(got.positions.numpy()[r], np.asarray(exp.positions))
            assert bool(got.overflowed[r]) == bool(exp.overflowed)
    # Own tables give the same peaks as the shared ones.
    own = tfp.find_peaks(-xt, 96, **kw)
    np.testing.assert_array_equal(own.positions.numpy(), troughs.positions.numpy())


def test_analyze_batch_dense_prominences_match_jax():
    """prominence_backend="dense" end to end (one table pair shared by the
    trough and raw-peak finders), float64, the knot-domain floor: every
    integer field of ``PipelineResult`` equals JAX's."""
    cfg = _config(noise_quantile_stride=64, quantile_backend="knots",
                  prominence_backend="dense")
    x = _recordings(np.float64)
    fn = jax.jit(lambda xs: jpipe.analyze_batch(
        jax.vmap(lambda a: jenv.preprocess(a, SR, cfg)[0])(xs), SR, cfg))
    exp = jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(x)))
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    got = tpipe.analyze_batch(tenv.preprocess(x, SR, tc, device="cpu")[0], SR, tc,
                              device="cpu")
    n_int = 0
    for name, g, e in _leaves(got, exp):
        if e.dtype.kind in "biu":
            np.testing.assert_array_equal(g, e, err_msg=name)
            n_int += 1
    assert n_int > 10
    assert not got.overflowed.any() and (got.final_count.numpy() > 50).all()


@pytest.mark.parametrize("n,factor,tpp", [(1000, 7, 8), (4096, 16, 8), (5001, 44, 8),
                                          (300, 146, 4)])
def test_fir_decimate_matches_jax(n, factor, tpp):
    x = np.random.RandomState(7).randn(2, n)
    got = tfilter.fir_decimate(torch.from_numpy(x), factor, taps_per_phase=tpp).numpy()
    exp = np.stack([np.asarray(jfilter.fir_decimate(jnp.asarray(r), factor,
                                                    taps_per_phase=tpp)) for r in x])
    assert got.shape == exp.shape == (2, -(-n // factor))
    np.testing.assert_allclose(got, exp, rtol=1e-12)
    np.testing.assert_array_equal(tfilter.fir_decimate(torch.from_numpy(x), 1).numpy(), x)


def test_preprocess_antialias_masked_matches_jax():
    """antialias_decimation=True at 44.1 kHz (factor 146 → 302 Hz), float64,
    row 1 masked after 7 s of 10: envelope, filtered signal and decimated
    lengths equal JAX's at rtol 1e-9 (tests/test_torch_envelope.py's filter
    tolerance)."""
    sr = 44100
    rng = np.random.RandomState(11)
    t = np.arange(10 * sr) / sr
    x = np.stack([np.sin(2 * np.pi * 60 * t) * (1 + np.sin(2 * np.pi * 1.7 * t))
                  + 0.3 * np.sin(2 * np.pi * 2000 * t) + 0.05 * rng.randn(t.size)
                  for _ in range(2)])
    nv = np.array([x.shape[1], 7 * sr])
    cfg = DEFAULT_CONFIG.replace(compat=dataclasses.replace(DEFAULT_CONFIG.compat,
                                                            antialias_decimation=True))
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    env, filt, rate, nv_dec = tenv.preprocess(x, sr, tc, n_valid=nv, device="cpu")
    assert rate == 302
    fn = jax.jit(jax.vmap(lambda a, v: jenv.preprocess(a, sr, cfg, n_valid=v)))
    e_env, e_filt, _, e_nv = fn(jnp.asarray(x), jnp.asarray(nv))
    np.testing.assert_array_equal(nv_dec.numpy(), np.asarray(e_nv))
    for r in range(2):
        k = int(nv_dec[r])
        np.testing.assert_allclose(env.numpy()[r, :k], np.asarray(e_env)[r, :k], rtol=1e-9)
        np.testing.assert_allclose(filt.numpy()[r, :k], np.asarray(e_filt)[r, :k],
                                   rtol=1e-9, atol=1e-12)
    unmasked = tenv.preprocess(x[:1], sr, tc, device="cpu")[0]
    e_unmasked = jenv.preprocess(jnp.asarray(x[0]), sr, cfg)[0]
    np.testing.assert_allclose(unmasked.numpy()[0], np.asarray(e_unmasked), rtol=1e-9)


BACKENDS = [dict(noise_quantile_stride=64, quantile_backend=b)
            for b in ("auto", "knots", "knots_pallas", "xla", "pallas")] + [
    dict(noise_quantile_stride=1),
    dict(noise_quantile_stride=64, prominence_backend="dense"),
    dict(noise_quantile_stride=64, antialias=True)]


@pytest.fixture(scope="module")
def knots_float32_run():
    tc = tcfg.config_from_dict(dataclasses.asdict(_config(
        "float32", noise_quantile_stride=64, quantile_backend="knots")))
    x = _recordings(np.float32, seconds=40)
    return x, tpipe.analyze_batch(tenv.preprocess(x, SR, tc, device="cpu")[0], SR, tc,
                                  device="cpu")


@pytest.mark.parametrize("runtime", BACKENDS, ids=[
    "_".join(f"{k}={v}" for k, v in r.items()) for r in BACKENDS])
def test_analyze_batch_runs_every_backend_on_the_cpu(knots_float32_run, runtime):
    """Each configuration runs preprocess → analyze_batch on the CPU in
    float32 with no overflow, and its beats agree with the knot-domain
    floor's (beat F1 >= 0.99, the repo's accuracy gate)."""
    runtime = dict(runtime)
    antialias = runtime.pop("antialias", False)
    cfg = _config("float32", **runtime)
    if antialias:
        cfg = cfg.replace(compat=dataclasses.replace(cfg.compat, antialias_decimation=True))
    tc = tcfg.config_from_dict(dataclasses.asdict(cfg))
    x, ref = knots_float32_run
    got = tpipe.analyze_batch(tenv.preprocess(x, SR, tc, device="cpu")[0], SR, tc,
                              device="cpu")
    assert got.floor.dtype == torch.float32
    assert not got.overflowed.any() and (got.final_count.numpy() > 30).all()
    for (beats, _, _), (ref_beats, _, _) in zip(result_curves(got, SR), result_curves(ref, SR)):
        assert beat_f1(beats, ref_beats) >= 0.99


def test_config_carries_the_backend_fields():
    jc = _config(noise_quantile_stride=16, quantile_backend="pallas",
                 prominence_backend="dense")
    jc = jc.replace(compat=dataclasses.replace(jc.compat, antialias_decimation=True))
    tc = tcfg.config_from_dict(dataclasses.asdict(jc))
    assert (tc.runtime.noise_quantile_stride, tc.runtime.quantile_backend,
            tc.runtime.prominence_backend, tc.compat.antialias_decimation) == (
        16, "pallas", "dense", True)
    assert tnf.quantile_path(tc) == "strided_kernel"
    for stride, backend, path in ((24, "pallas", "strided"), (64, "xla", "strided"),
                                  (1, "pallas", "exact"), (8, "knots", "knots"),
                                  (8, "knots_pallas", "knots_kernel")):
        rt = dataclasses.replace(tc.runtime, noise_quantile_stride=stride,
                                 quantile_backend=backend)
        assert tnf.quantile_path(tc.replace(runtime=rt)) == path
