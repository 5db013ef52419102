"""Port vs JAX: the whole slice, ``preprocess`` → ``analyze_batch``.

B=2 synthetic 60 s recordings at 302 Hz with the small capacities of
tests/test_host.py (512 raw peaks / 512 troughs / 256 candidates), stride 64,
and an extrema capacity of 4096 (the derived 2048 truncates these
recordings' ~2.1k maxima per minute).
JAX runs the "knots" backend: on the CPU its "auto" is the dense path, which
differs from the knot-domain floor by up to one sample step
(ops/knot_quantile.py:28-31).  In float64 every integer and boolean field of
``PipelineResult`` is equal and every float field agrees to rtol 1e-8; in
float32 the port's beats and BPM curve meet the repo's accuracy gate
(beat F1 >= 0.99, BPM MAE < 0.5) against the JAX float64 result."""
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import bench
from bpm_analysis_tpu.config import DEFAULT_CONFIG
from bpm_analysis_tpu.models import envelope as jenv
from bpm_analysis_tpu.models import pipeline as jpipe
from bpm_analysis_tpu_torch.accuracy import beat_f1, bpm_mae, result_curves
from bpm_analysis_tpu_torch.config import config_from_dict
from bpm_analysis_tpu_torch.models import envelope as tenv
from bpm_analysis_tpu_torch.models import pipeline as tpipe

# The suite runs several worker processes at once; these small tensors gain
# nothing from intra-op threads, and oversubscribed threads stall each other.
torch.set_num_threads(1)

SR = 302
SEEDS = (0, 1)


def _config(dtype: str):
    return dataclasses.replace(DEFAULT_CONFIG, runtime=dataclasses.replace(
        DEFAULT_CONFIG.runtime, max_raw_peaks=512, max_troughs=512, max_candidates=256,
        extrema_capacity=4096, noise_quantile_stride=64, quantile_backend="knots",
        dtype=dtype))


def _batch(dtype) -> np.ndarray:
    return np.stack([bench._quantize_int16(bench.synth_recording(s)[:SR * 60]).astype(dtype)
                     for s in SEEDS])


def _port(batch, cfg, n_valid=None):
    tcfg = config_from_dict(dataclasses.asdict(cfg))
    if n_valid is None:
        env = tenv.preprocess(batch, SR, tcfg, device="cpu")[0]
        return tpipe.analyze_batch(env, SR, tcfg, device="cpu")
    env, _, _, nv = tenv.preprocess(batch, SR, tcfg, n_valid=n_valid, device="cpu")
    return tpipe.analyze_batch(env, SR, tcfg, n_valid=nv, device="cpu")


@pytest.fixture(scope="module")
def float64_results():
    cfg = _config("float64")
    batch = _batch(np.float64)
    fn = jax.jit(lambda xs: jpipe.analyze_batch(
        jax.vmap(lambda x: jenv.preprocess(x, SR, cfg)[0])(xs), SR, cfg))
    exp = jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(batch)))
    return _port(batch, cfg), exp


def _leaves(got, exp, prefix=""):
    """(name, port array, JAX array) over every leaf of the result."""
    for name in exp._fields:
        g, e = getattr(got, name), getattr(exp, name)
        if hasattr(e, "_fields"):
            yield from _leaves(g, e, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", g.numpy(), np.asarray(e)


def test_integer_fields_equal_jax(float64_results):
    got, exp = float64_results
    names = []
    for name, g, e in _leaves(got, exp):
        if e.dtype.kind in "biu":
            assert g.shape == e.shape, name
            np.testing.assert_array_equal(g, e, err_msg=name)
            names.append(name)
    for name in ("trough_positions", "trough_count", "raw_peak_positions", "raw_peak_count",
                 "trace.peak_class", "classes", "precorrection_classes", "s1_positions",
                 "s1_count", "final_positions", "final_count", "overflowed", "ok"):
        assert name in names
    assert got.trough_positions.dtype == torch.int32
    assert got.final_count.dtype == torch.int32
    assert (got.final_count.numpy() > 50).all() and not got.overflowed.any()


def test_float_fields_close_to_jax(float64_results):
    got, exp = float64_results
    n_float = 0
    for name, g, e in _leaves(got, exp):
        if e.dtype.kind == "f":
            np.testing.assert_allclose(g, e, rtol=1e-8, atol=1e-9, equal_nan=True,
                                       err_msg=name)
            n_float += 1
    assert n_float > 50


def test_float32_meets_the_accuracy_gate(float64_results):
    _, exp = float64_results
    got = _port(_batch(np.float32), _config("float32"))
    assert got.floor.dtype == torch.float32
    for r, (beats, times, values) in enumerate(result_curves(got, SR)):
        ref_beats = exp.final_positions[r][:exp.final_count[r]] / SR
        k = int(exp.metrics.bpm.count[r])
        ref_t, ref_v = exp.metrics.bpm.times[r][:k], exp.metrics.bpm.smoothed[r][:k]
        assert beat_f1(beats, ref_beats) >= 0.99
        assert bpm_mae(ref_t, ref_v, times, values) < 0.5


def test_padded_batch_equals_unpadded_run():
    """n_valid batching: a recording padded to the batch length gives the
    beats of its unpadded run."""
    cfg = _config("float64")
    full = _batch(np.float64)
    short = SR * 45
    padded = full.copy()
    padded[1, short:] = 0.0
    res = _port(padded, cfg, n_valid=np.array([full.shape[1], short]))
    alone = _port(full[1:, :short], cfg)
    k = int(alone.final_count[0])
    assert int(res.final_count[1]) == k
    np.testing.assert_array_equal(res.final_positions.numpy()[1][:k],
                                  alone.final_positions.numpy()[0][:k])
    np.testing.assert_allclose(res.floor.numpy()[1][:short], alone.floor.numpy()[0],
                               rtol=1e-12)
