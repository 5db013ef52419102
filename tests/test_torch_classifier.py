"""Port vs JAX: the beat classifier and its 26-field decision trace.

One 60 s synthetic recording at 302 Hz, float64.  The envelope, noise floor,
raw peaks and start BPM come from the port and feed both classifiers, so the
two see identical inputs.  Integer and boolean fields are equal; float
fields agree to rtol 1e-9 (JAX's CPU ``interp`` fuses a multiply-add that
the port rounds separately, a last-bit difference)."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from bpm_analysis_tpu.config import DEFAULT_CONFIG
from bpm_analysis_tpu.models import classifier as jcls
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.models import classifier as tcls
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import noise_floor as tnf
from bpm_analysis_tpu_torch.models import pipeline as tpipe
from bpm_analysis_tpu_torch.ops import find_peaks as tfp

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

SR = 302


def _config(kickstart: bool):
    return dataclasses.replace(
        DEFAULT_CONFIG,
        runtime=dataclasses.replace(DEFAULT_CONFIG.runtime, max_raw_peaks=512,
                                    max_troughs=512, max_candidates=256,
                                    noise_quantile_stride=64, quantile_backend="knots",
                                    dtype="float64"),
        compat=dataclasses.replace(DEFAULT_CONFIG.compat, kickstart_effective=kickstart))


def _inputs(cfg, seed):
    """Envelope, floor, raw peaks and the preliminary pass from the port."""
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    x = bench._quantize_int16(bench.synth_recording(seed)[:SR * 60]).astype(np.float64)
    env = tenv.preprocess(x[None], SR, tcfg, device="cpu")[0]
    ext = tfp.build_extrema(env, tcfg.runtime.find_peaks_work_factor
                            * tcfg.runtime.max_raw_peaks)
    nf = tnf.dynamic_noise_floor(env, SR, tcfg, extrema=ext)
    peaks = tpipe.raw_peaks(env, nf.floor, SR, tcfg, extrema=ext)
    hint = torch.full((1,), float("nan"), dtype=torch.float64)
    start, peak_t, rec_end = tpipe.preliminary_pass(env, nf.floor, peaks, SR, hint, tcfg)
    return tcfg, env, nf.floor, peaks, start, peak_t, rec_end


@pytest.mark.parametrize("kickstart,seed", [(False, 0), (True, 5)])
def test_classifier_trace_matches_jax(kickstart, seed):
    cfg = _config(kickstart)
    tcfg, env, floor, peaks, start, peak_t, rec_end = _inputs(cfg, seed)
    got = tcls.classify(env, floor, peaks.positions, peaks.count, SR, start, tcfg,
                        peak_bpm_time_sec=peak_t, recovery_end_time_sec=rec_end)
    fn = jax.jit(lambda e, f, p, c, s, lo, hi: jcls.classify(
        e, f, p, c, SR, s, cfg, peak_bpm_time_sec=lo, recovery_end_time_sec=hi))
    exp = fn(*(jnp.asarray(t.numpy()[0]) for t in
               (env, floor, peaks.positions, peaks.count, start, peak_t, rec_end)))

    assert len(tcls.ClassifierTrace._fields) == 26
    assert tcls.ClassifierTrace._fields == jcls.ClassifierTrace._fields
    for field in jcls.ClassifierTrace._fields:
        g = getattr(got.trace, field).numpy()[0]
        e = np.asarray(getattr(exp.trace, field))
        if e.dtype.kind in "biu":
            np.testing.assert_array_equal(g, e, err_msg=field)
        else:
            np.testing.assert_allclose(g, e, rtol=1e-9, atol=1e-12, equal_nan=True,
                                       err_msg=field)
    np.testing.assert_array_equal(got.s1_positions.numpy()[0], np.asarray(exp.s1_positions))
    assert int(got.s1_count[0]) == int(exp.s1_count)
    assert bool(got.s1_overflowed[0]) == bool(exp.s1_overflowed)
    np.testing.assert_allclose(got.smoothed_deviation.numpy()[0],
                               np.asarray(exp.smoothed_deviation), rtol=1e-9, equal_nan=True)
    classes = got.trace.peak_class.numpy()[0][:int(peaks.count[0])]
    assert (classes == 1).sum() > 20           # pairs were formed
    assert (classes != 0).all()


def test_classifier_without_trace_keeps_the_beats():
    cfg = _config(False)
    tcfg, env, floor, peaks, start, peak_t, rec_end = _inputs(cfg, 1)
    full = tcls.classify(env, floor, peaks.positions, peaks.count, SR, start, tcfg)
    lean = tcls.classify(env, floor, peaks.positions, peaks.count, SR, start, tcfg,
                         want_trace=False)
    assert lean.trace is None
    np.testing.assert_array_equal(full.s1_positions.numpy(), lean.s1_positions.numpy())
    np.testing.assert_array_equal(full.s1_count.numpy(), lean.s1_count.numpy())


def test_interp_matches_jax():
    """The constant-knot interpolation the classifier runs every step."""
    rng = np.random.RandomState(0)
    xp, fp = (0.0, 0.15, 0.30, 0.50), (1.0, 0.8, 0.4, 0.0)
    x = np.concatenate([rng.uniform(-0.2, 0.7, 500), [np.nan, np.inf, -np.inf, 0.15, 0.5]])
    got = tcls.Interp(xp, fp, torch.float64, "cpu")(torch.from_numpy(x)).numpy()
    exp = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(fp)))
    np.testing.assert_allclose(got, exp, rtol=1e-14, atol=1e-15, equal_nan=True)
    rows = rng.uniform(0, 1, (x.shape[0], 4))
    got = tcls.Interp(xp, None, torch.float64, "cpu")(torch.from_numpy(x),
                                                      torch.from_numpy(rows)).numpy()
    exp = np.asarray(jax.vmap(lambda a, f: jnp.interp(a, jnp.asarray(xp), f))(
        jnp.asarray(x), jnp.asarray(rows)))
    np.testing.assert_allclose(got, exp, rtol=1e-14, atol=1e-15, equal_nan=True)
